"""sisr_tpu_torch and chip_smoke import nothing of JAX, Flax or sisr_tpu, and the
port's entry points (eval, training, the feature extractors, serving export and
run_serving, the benchmark tools) run on CUDA unless told otherwise (raising where
there is none)."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = textwrap.dedent('''
    import importlib, pkgutil, sys
    for name in ('jax', 'jaxlib', 'flax', 'sisr_tpu'):
        sys.modules[name] = None  # any import of these now raises ImportError
    import sisr_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(sisr_tpu_torch.__path__,
                                                     'sisr_tpu_torch.')]
    for name in names + ['chip_smoke']:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules
                    if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sisr_tpu')
                    and sys.modules[m] is not None)
    assert not leaked, leaked

    import torch
    torch.cuda.is_available = lambda: False
    from click.testing import CliRunner
    from sisr_tpu_torch import net_eval
    from sisr_tpu_torch.evaluation.standard_eval import EvalHub
    from sisr_tpu_torch.models.handlers import define_model
    from sisr_tpu_torch.utils.helpers import resolve_device, training_device
    from sisr_tpu_torch.models import feature_extractors as fx
    from sisr_tpu_torch.tools import export_serving, run_serving
    from sisr_tpu_torch.tools import (bench_bucketed, bench_ca_epilogue,
                                      bench_decode_cache, bench_models,
                                      bench_quantization, e2e_bench, train_soak)
    weights = sisr_tpu_torch.__file__  # a file: the device is resolved before it is read
    for call in (lambda: resolve_device(), lambda: define_model('rcan', n_resgroups=1,
                 n_resblocks=1, n_feats=16), lambda: EvalHub._select_device(True),
                 lambda: training_device(), lambda: training_device('single'),
                 lambda: training_device('multi'),
                 lambda: fx.load_vgg_extractor(weights),
                 lambda: fx.load_face_extractor('lightcnn', weights),
                 lambda: export_serving.export_experiment('m', 'e', 0, 1, 8, 8),
                 lambda: run_serving.serve_directory('a.pt2', 'in'),
                 lambda: e2e_bench.measure_e2e('l', 'h', 'm', 'o', 'e', 8, 8),
                 lambda: e2e_bench.run_train_bench(), lambda: e2e_bench.run_val_bench(),
                 lambda: e2e_bench.measure_train_torch(),
                 lambda: bench_models.main([]), lambda: bench_models.main(['--paper']),
                 lambda: bench_models.main(['--train']), lambda: bench_models.main(['--val']),
                 lambda: bench_quantization.main(['--all']),
                 lambda: bench_ca_epilogue.main([]), lambda: bench_bucketed.main([]),
                 lambda: bench_decode_cache.main([]),
                 lambda: train_soak.main(['--out', 'never_written'])):
        try:
            call()
        except RuntimeError as exc:
            assert 'CUDA' in str(exc), exc
        else:
            raise AssertionError('an entry point ran without CUDA instead of raising')
    result = CliRunner().invoke(net_eval.eval_run, ['--hr_dir', 'h', '--lr_dir', 'l',
                                '-me', 'e', '0', '-m', 'PSNR', '--fused_eval',
                                '--no_image_comparison'])
    assert isinstance(result.exception, RuntimeError), result.exception
    assert 'no-gpu' in str(result.exception)
    for extra in (['--mesh'], ['--mesh', '--no-gpu']):  # --mesh runs on CUDA unless asked
        result = CliRunner().invoke(net_eval.eval_run, ['--hr_dir', 'h', '--lr_dir', 'l',
                                    '-me', 'e', '0', '-m', 'PSNR', *extra])
        assert isinstance(result.exception, RuntimeError), result.exception
        assert ('CUDA' in str(result.exception)) == (extra == ['--mesh']), result.exception
    print('modules imported:', len(names) + 1)
''')


def test_port_imports_nothing_of_jax_and_defaults_to_cuda():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', CHECK], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'modules imported:' in proc.stdout
