"""Setup script for the TPU-native SISR framework.

Console-script names preserve the reference's CLI contract
(ref: /root/reference/Code/setup.py:13-22).
"""
from setuptools import setup, find_packages

setup(
    name="sisr-tpu",
    version='0.1.0',
    description="TPU-native (JAX/Flax/Pallas) SISR framework: model zoo, meta-attention, "
                "train/eval harness and degradation tooling.",
    packages=find_packages(include=['sisr_tpu', 'sisr_tpu.*', 'sisr_tpu_torch',
                                    'sisr_tpu_torch.*']),
    include_package_data=True,
    python_requires='>=3.10',
    entry_points={
        'console_scripts': [
            'train_sisr=sisr_tpu.net_train:experiment_setup',
            'eval_sisr=sisr_tpu.net_eval:eval_run',
            'image_manipulate=sisr_tpu.tools.data_converter:manipulation_hub',
            'images_to_video=sisr_tpu.tools.helper_cli:click_image_sequence_to_movie',
            'extract_best_model=sisr_tpu.tools.helper_cli:extract_best_models',
            'clean_models=sisr_tpu.tools.helper_cli:click_clean',
            'model_report=sisr_tpu.tools.helper_cli:model_compare',
            'import_reference_model=sisr_tpu.tools.convert_weights:import_reference_model_cli',
            'export_serving=sisr_tpu.tools.export_serving:export_serving_cli',
            'run_serving=sisr_tpu.tools.run_serving:run_serving_cli',
            'train_sisr_torch=sisr_tpu_torch.net_train:experiment_setup',
        ],
    },
)
