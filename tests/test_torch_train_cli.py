"""train_sisr of sisr_tpu_torch (``python -m sisr_tpu_torch.net_train``) on the CPU
(``gpu = "off"``, ``fused_val = true``) for a tiny Q-RCAN (standard + q_node, 1 group x
2 blocks, 16 features, scale 2) on a seeded PNG folder with a degradation_metadata.csv:
summary.csv, checkpoints, plots and samples; a resume with the same next epoch as an
uninterrupted run; a branch; eval_sisr --fused_eval from 'best'.  Then the same run in
both packages from the same weights (the port's init, through sisr_tpu's converter):
per-epoch train-loss, val-loss, val-PSNR and val-SSIM compared."""
import os

import numpy as np
import pandas as pd
import pytest
import torch
from click.testing import CliRunner

from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.net_train import experiment_setup as jax_experiment_setup
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch import net_eval, net_train
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.utils import toml_io

INTERNAL = {'scale': 2, 'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16,
            'style': 'standard', 'include_q_layer': True, 'metadata': ['blur_kernel'],
            'lr': 1e-3, 'scheduler': 'cosine_annealing_warm_restarts',
            'scheduler_params': {'restart_period': 3, 'lr_min': 1e-6}}


def _config(path, root, lr_dir, hr_dir, experiment, training, train_set=None,
            batch_size=2):
    data_set = {'lr': lr_dir, 'hr': hr_dir, 'degradation_metadata': 'on_site',
                'metadata': ['blur_kernel']}
    toml_io.dump({
        'experiment': experiment, 'experiment_save_loc': root,
        'data': {'batch_size': batch_size, 'dataloader_threads': 1,
                 'training_sets': {'data_1': {**data_set, **(train_set or {})}},
                 'eval_sets': {'data_1': {**data_set, 'cutoff': 3}}},
        'model': {'name': 'qrcan', 'internal_params': INTERNAL},
        'training': {'gpu': 'off', 'seed': 8, 'metrics': ['PSNR', 'SSIM'],
                     'logging': 'visual', 'fused_val': True, **training}}, path)
    return path


def _train(cli, cfg, *args):
    result = CliRunner().invoke(cli, ['--parameters', cfg, *args], catch_exceptions=False)
    assert result.exit_code == 0, result.output


def _summary(root, experiment, sub=''):
    return pd.read_csv(os.path.join(root, experiment, 'result_outputs', sub, 'summary.csv'))


@pytest.fixture(scope='module')
def workload(tmp_path_factory):
    root = tmp_path_factory.mktemp('train_cli')
    lr_dir, hr_dir = build_workload(str(root / 'data'), 6, lr_size=10, scale=2,
                                    metadata_cols=10)
    return str(root), lr_dir, hr_dir


def test_train_resume_branch_and_eval(workload):
    """Whole-set batches without crops (one deterministic step an epoch): 3 epochs
    straight, against 2 epochs then a resume from epoch 1; the resumed epoch 2 equals
    the straight one up to the shuffle's order within the batch."""
    root, lr_dir, hr_dir = workload
    results = os.path.join(root, 'Results')
    straight = _config(os.path.join(root, 'straight.toml'), results, lr_dir, hr_dir,
                       'straight', {}, batch_size=6)
    _train(net_train.experiment_setup, straight, '--num_epochs', '3')
    split = _config(os.path.join(root, 'split.toml'), results, lr_dir, hr_dir, 'split', {},
                    batch_size=6)
    _train(net_train.experiment_setup, split, '--num_epochs', '2')
    _train(net_train.experiment_setup, split, '--num_epochs', '1',
           '--continue_from_epoch', '1')

    ours, theirs = _summary(results, 'split'), _summary(results, 'straight')
    assert list(ours['epoch']) == list(theirs['epoch']) == [0, 1, 2]
    for key in ('train-loss', 'val-loss', 'val-PSNR', 'val-SSIM', 'learning-rate'):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    base = os.path.join(results, 'split')
    for name in ('config.toml', 'config_from_epoch_1.toml', 'extra_metadata.csv',
                 'result_outputs/loss_plots.pdf', 'result_outputs/epoch_2_samples/im_000.png'):
        assert os.path.isfile(os.path.join(base, name)), name
    saved = torch.load(os.path.join(base, 'saved_models', 'train_model_2'),
                       weights_only=True)
    assert saved['step'] == 3 and saved['model_epoch'] == 2 and saved['optimizer']['state']
    assert not [f for f in os.listdir(os.path.join(base, 'saved_models'))
                if not f.startswith('train_model_')]

    # a branch from epoch 1: its own folders, the parent's history up to epoch 1
    branch = _config(os.path.join(root, 'branch.toml'), results, lr_dir, hr_dir, 'split',
                     {'new_branch': True}, batch_size=6)
    _train(net_train.experiment_setup, branch, '--num_epochs', '1',
           '--continue_from_epoch', '1')
    branched = _summary(results, 'split', 'branch_epoch_1')
    assert list(branched['epoch']) == [0, 1, 2]
    np.testing.assert_allclose(branched['train-loss'], theirs['train-loss'], rtol=1e-5)
    assert os.path.isfile(os.path.join(base, 'saved_models', 'branch_epoch_1',
                                       'train_model_2'))

    # eval_sisr --fused_eval from 'best' reproduces that epoch's val-PSNR
    out = os.path.join(root, 'eval_out')
    net_eval.eval_run.main(args=[
        '--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'split', 'best', '--model_loc',
        results, '--out_loc', out, '--results_name', 'best', '-m', 'PSNR', '-m', 'SSIM',
        '--scale', '2', '--full_directory', '--fused_eval', '--no_image_comparison',
        '--no-time_models', '--no-gpu'], standalone_mode=False)
    frame = pd.read_csv(os.path.join(out, 'best', 'standard_metrics',
                                     'individual_metrics.csv'), header=[0, 1], index_col=0)
    best = ours.loc[ours['val-PSNR'].idxmax()]
    assert frame[('split', 'PSNR')].iloc[:3].mean() == pytest.approx(best['val-PSNR'],
                                                                     abs=1e-4)


def _seed_experiment(results, name, handler):
    """An experiment at epoch 0 with ``handler``'s weights (either package):
    config.toml, train_model_0 and a one-row summary.csv, so both packages resume it."""
    base = os.path.join(results, name)
    os.makedirs(os.path.join(base, 'saved_models'))
    os.makedirs(os.path.join(base, 'result_outputs'))
    toml_io.dump({'model': {'name': 'qrcan', 'internal_params': INTERNAL}},
                 os.path.join(base, 'config.toml'))
    handler.save_model('train_model', 0, os.path.join(base, 'saved_models'))
    handler.wait_pending_checkpoints()
    pd.DataFrame({'epoch': [0], 'train-loss': [1.0], 'learning-rate': [1e-3],
                  'val-loss': [1.0], 'val-PSNR': [0.0], 'val-SSIM': [0.0]}).to_csv(
        os.path.join(base, 'result_outputs', 'summary.csv'), index=False)


def test_train_matches_sisr_tpu(workload):
    """Both packages resume the same epoch-0 weights for 2 epochs of crops, flips and
    shuffled batches of 2 (the same batches, seeded alike): train-loss and val-loss
    within rtol 2e-4, val-PSNR within 0.01 dB, val-SSIM within 1e-3 per epoch."""
    root, lr_dir, hr_dir = workload
    results = os.path.join(root, 'Results_both')
    port = define_model('qrcan', device='cpu', seed=5, **INTERNAL)
    theirs = jax_define_model('qrcan', eval_mode=False, **INTERNAL)
    theirs.set_metadata_keys(['blur_kernel'] * 10)
    theirs.init_state(spatial=(5, 5), batch=2)
    sd = {k: v.numpy().copy() for k, v in port.module.state_dict().items()}
    theirs.state = theirs.state.replace(params=convert_torch_state_dict(
        'qrcan', sd, n_resgroups=1, n_resblocks=2, scale=2, style='standard',
        include_q_layer=True))
    _seed_experiment(results, 'port', port)
    _seed_experiment(results, 'jax', theirs)
    crops = {'crop': 5, 'random_augment': True}
    training = {'save_samples': False, 'logging': 'none'}
    for cli, name in ((net_train.experiment_setup, 'port'), (jax_experiment_setup, 'jax')):
        cfg = _config(os.path.join(root, name + '.toml'), results, lr_dir, hr_dir, name,
                      training, train_set=crops)
        _train(cli, cfg, '--num_epochs', '2', '--continue_from_epoch', '0')
    ours, theirs = _summary(results, 'port'), _summary(results, 'jax')
    assert list(ours['epoch']) == list(theirs['epoch']) == [0, 1, 2]
    ours, theirs = ours.iloc[1:], theirs.iloc[1:]
    for key, tol in (('train-loss', {'rtol': 2e-4, 'atol': 2e-6}),
                     ('val-loss', {'rtol': 2e-4, 'atol': 2e-6}),
                     ('val-PSNR', {'rtol': 0, 'atol': 0.01}),
                     ('val-SSIM', {'rtol': 0, 'atol': 1e-3}),
                     ('learning-rate', {'rtol': 1e-5, 'atol': 0})):
        np.testing.assert_allclose(ours[key], theirs[key], err_msg=key, **tol)


def test_epoch_cutoff_and_early_stopping(workload):
    """epoch_cutoff overrides --num_epochs (the reference's quirk); with a constant
    lr of 0 the val-PSNR never improves after epoch 0, so patience 1 stops after
    epoch 1."""
    root, lr_dir, hr_dir = workload
    results = os.path.join(root, 'Results_stop')
    cutoff = _config(os.path.join(root, 'cutoff.toml'), results, lr_dir, hr_dir, 'cutoff',
                     {'epoch_cutoff': 2, 'save_samples': False, 'logging': 'none'})
    _train(net_train.experiment_setup, cutoff, '--num_epochs', '5')
    assert list(_summary(results, 'cutoff')['epoch']) == [0, 1]
    stop = _config(os.path.join(root, 'stop.toml'), results, lr_dir, hr_dir, 'stop',
                   {'early_stopping_patience': 1, 'save_samples': False, 'logging': 'none'})
    config = toml_io.load(stop)
    config['model']['internal_params'] = {k: v for k, v in INTERNAL.items()
                                          if not k.startswith('scheduler')}
    config['model']['internal_params']['lr'] = 0.0
    toml_io.dump(config, stop)
    _train(net_train.experiment_setup, stop, '--num_epochs', '4')
    summary = _summary(results, 'stop')
    assert list(summary['epoch']) == [0, 1]
    assert summary['val-PSNR'][0] == summary['val-PSNR'][1]
