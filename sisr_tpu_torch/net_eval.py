"""eval_sisr CLI for the PyTorch port (flags of sisr_tpu's ``net_eval.py``, ref:
Code/SISR/net_eval.py).

``--config`` loads a TOML file whose keys become option defaults; explicit CLI flags
still win.  Run as ``python -m sisr_tpu_torch.net_eval ...``; ``--no-gpu`` runs on the CPU.
"""
import sys

import click

from .configuration import constants as sconst
from .utils import toml_io

results_directory = sconst.results_directory


def _config_callback(ctx, param, value):
    if value:
        cfg = toml_io.load(value)
        for key, val in list(cfg.items()):
            if isinstance(val, list) and val and isinstance(val[0], list):
                cfg[key] = [tuple(v) for v in val]
        ctx.default_map = {**(ctx.default_map or {}), **cfg}
    return value


@click.command()
# Data Config
@click.option("--hr_dir", default=None, help='HR image directory.')
@click.option("--lr_dir", default=None, help='LR image directory.')
@click.option("--lr_dir_interp", default=None, help='LR (interpolated) image directory.')
@click.option('--data_attributes', default=None,
              help='Additional data attributes (such as gender etc)')
@click.option("--batch_size", default=1, help='Batch size for parallel data loading.',
              show_default=True)
@click.option('--full_directory', is_flag=True,
              help='Set this flag to ignore any data partitions or splits.')
@click.option('--qpi_selection', type=(int, int), default=(None, None),
              help='Set these values to enforce qpi range when selecting validation data.')
@click.option('--dataset_name', default=None,
              help='Specify dataset name to use associated eval split.')
@click.option('--image_shortlist', default=None,
              help='Location of text file containing image names to select from target '
                   'folder')
@click.option('--data_split', default=None,
              help='Specifies data split to extract (train/test/eval). Defaults to eval.')
@click.option('--metadata_file', default=None,
              help='Location of datafile containing metadata information. Defaults to '
                   'degradation_metadata.csv if not specified.')
@click.option('--use_test_group', is_flag=True,
              help='Set this flag to run results only on typical 100 images.')
@click.option('--recursive', default=False,
              help='Specify whether to search for further images in sub-folders of the '
                   'main lr directory.')
# Model Config
@click.option("-me", "--model_and_epoch", multiple=True, type=(str, str),
              help='Experiments to evaluate.')
@click.option("--gpu/--no-gpu", default=True,
              help='Run on the CUDA card (the default; raises when there is none) or, '
                   'with --no-gpu, on the CPU.')
@click.option('--mesh', is_flag=True,
              help='Shard eval over all local devices (not ported yet: raises).')
@click.option('--eval_buckets', type=int, default=None,
              help='Pad eval images up to multiples of this size (not ported yet: '
                   'raises).')
@click.option('--fused_eval', is_flag=True,
              help='Metrics-only fast path: forward + LR baseline + YCbCr + PSNR/SSIM '
                   'in one device step per batch; only scalars return to the host. '
                   'Needs --no_image_comparison and no image saving. The LR baseline '
                   'uses the device bicubic (<=1 uint8 LSB vs PIL). The only protocol '
                   'ported so far.')
@click.option('--device_metrics', is_flag=True,
              help='Compute PSNR/SSIM on the device (the fused protocol always does).')
@click.option('--face_model', default='lightcnn',
              type=click.Choice(['lightcnn', 'vggface']), show_default=True,
              help='Face-embedding network for the FACE_SIM metric '
                   '(request it with -m FACE_SIM).')
@click.option('--face_weights', default=None,
              help='Path to the face-network torch weights (defaults to the '
                   'reference external-package paths in configuration/constants).')
@click.option('--int8', 'int8', is_flag=True,
              help='int8 serving fast path (not ported yet: raises).')
@click.option("--sp_gpu", default=0, show_default=True,
              help='Specify specific device to use for computation.')
@click.option('--scale', default=4, help='Scale of SR to perform.', show_default=True)
# Processing/Output Config
@click.option("--results_name", default='delete_me',
              help='Unique folder name for this output evaluation run.')
@click.option("-m", "--metrics", multiple=True, default=None,
              help='The metrics to calculate on provided test set.')
@click.option('--save_im', is_flag=True,
              help='Set this flag to save all generated SR images to results folder.')
@click.option('--model_only', is_flag=True,
              help='Set this flag to skip all metrics and simply output results.')
@click.option('--model_loc', default=results_directory,
              help='Model save location for loading.')
@click.option("--out_loc", default=results_directory, help='Output directory')
@click.option('--no_image_comparison', is_flag=True,
              help='Set this flag to prevent any image comparisons being generated.')
@click.option('--num_image_save', default=100, show_default=True,
              help='Set the maximum number of images to save when running comparisons.')
@click.option('--time_models/--no-time_models', default=True,
              help='Specify whether to time model execution. Defaults to on.')
@click.option('--cache_decoded/--no-cache_decoded', default=True,
              help='Cache decoded images in memory (capped at 4 GiB) so repeated '
                   'protocol passes skip PNG re-decode. Default on.')
@click.option('--decoded_cache_dir', default=None,
              help="Persist decoded uint8 '.npy' sidecars (not ported yet: raises).")
@click.option('--config', type=click.Path(exists=True), callback=_config_callback,
              is_eager=True, expose_value=False,
              help='Read option defaults from a TOML config file.')
def eval_run(model_only, **kwargs):
    """
    Main function that controls the creation, configuration and running of a SISR
    evaluation experiment.
    """
    from .evaluation.standard_eval import EvalHub
    eval_hub = EvalHub(model_only=model_only, **kwargs)
    eval_hub.full_image_protocol()


if __name__ == '__main__':
    eval_run(sys.argv[1:])
