"""train_sisr CLI for the PyTorch port (flags of sisr_tpu's ``net_train.py``, ref:
Code/SISR/net_train.py).

    python -m sisr_tpu_torch.net_train --parameters config.toml [--num_epochs N]
        [--continue_from_epoch N] [--gpu off|single|multi] [--sp_gpu I] [--overwrite_data]

Everything else comes from the TOML file's [data], [model] and [training] tables, as
for sisr_tpu.  Training runs on cuda:<sp_gpu> unless ``gpu = "off"`` asks for the
CPU.  ``gpu = "multi"`` trains data-parallel, one process per card: under a launcher
(sisr_tpu's ``SISR_TPU_COORDINATOR`` / ``SISR_TPU_NUM_PROCESSES`` /
``SISR_TPU_PROCESS_ID``, or torchrun's environment) this process is one rank; without
one the command starts a rank for every visible card itself, with a localhost
rendezvous (``parallel/distributed.py``).  Under a launcher ``gpu = "off"`` trains
data-parallel on CPU ranks.
"""
import os
import sys

import click

from .parallel import distributed
from .utils import toml_io
from .utils.helpers import read_metadata_list


@click.command()
@click.option("--parameters", required=True,
              help='location of TOML parameters file, containing configs for this '
                   'experiment')
@click.option("--num_epochs", type=int, help='Number of epochs to run through dataset.')
@click.option("--gpu", default=None, show_default=True,
              type=click.Choice(['off', 'single', 'multi'], case_sensitive=False),
              help='Device selection: single = one CUDA card (the default), off = the CPU, '
                   'multi = data parallelism, one process per card (without a launcher '
                   'environment: every visible card).')
@click.option("--sp_gpu", default=None, show_default=True,
              help='Specify which base device to use.')
@click.option("--experiment_name", help='Experiment name to use for saving models/data.')
@click.option("--seed", help='Random seed.', default=None, type=int,
              show_default='8 (config [training] seed wins if set)')
@click.option("--continue_from_epoch", help='Epoch number from which to resume training.',
              type=int)
@click.option("--overwrite_data", is_flag=True, default=None,
              help='Set this flag to overwrite any existing data in experiment directory.')
def experiment_setup(parameters, experiment_name, **kwargs):
    """
    Main function that controls the creation, configuration and running of a SISR
    experiment.  All functionality can be controlled via the PARAMETERS config toml file.
    """
    kwargs = {k: v for (k, v) in kwargs.items() if v is not None}
    params = toml_io.load(parameters)
    params['training'] = {**params.get('training', {}), **kwargs}
    gpu = params['training'].get('gpu')
    if gpu == 'multi' and not distributed.launcher_present():
        # no launcher: a rank for every visible card, each this command again
        return distributed.spawn_local_ranks(_rank_main, parameters, experiment_name,
                                             kwargs)
    distributed.maybe_init_distributed(device='cpu' if gpu in ('off', False) else None)
    run_experiment(params, experiment_name)


def _rank_main(parameters, experiment_name, kwargs):
    experiment_setup.callback(parameters=parameters, experiment_name=experiment_name,
                              **kwargs)


def run_experiment(params, experiment_name):
    """Build the experiment from the TOML ``params`` and train it; rank 0 writes the
    config snapshot and the metadata."""
    from .training.handler import TrainingHandler
    params = toml_io.convert_default_none_dict(params)
    if experiment_name is not None:
        params['experiment'] = experiment_name

    for dataset_type in ['training_sets', 'eval_sets']:
        for val in (params['data'][dataset_type] or {}).values():
            if val['metadata_list'] is not None:
                val['metadata'] = read_metadata_list(val['metadata_list'])
    internal = params['model']['internal_params']
    if internal is not None and internal['metadata_list'] is not None:
        internal['metadata'] = read_metadata_list(internal['metadata_list'])

    experiment = TrainingHandler(experiment_name=params['experiment'],
                                 experiment_group=params['experiment_group'],
                                 save_loc=params['experiment_save_loc'],
                                 model_params=params['model'], **params['training'],
                                 data_params=dict(params['data']))

    if params['training']['continue_from_epoch'] is not None:
        config_file = 'config_from_epoch_%s.toml' % params['training']['continue_from_epoch']
    else:
        config_file = 'config.toml'
    if distributed.is_primary_host():  # rank 0 owns the experiment directory
        with open(os.path.join(experiment.model.base_folder, config_file), 'w') as f:
            toml_io.dump(params, f)
        experiment.model.save_metadata()
    experiment.run_experiment()


if __name__ == '__main__':
    experiment_setup(sys.argv[1:])
