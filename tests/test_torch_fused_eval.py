"""sisr_tpu_torch's fused eval against sisr_tpu's on a small RCAN with the same weights:
the per-batch metric matrix in f32 and in bf16, and eval_sisr --fused_eval end to end
(the port's CLI with --no-gpu against sisr_tpu's EvalHub).  Bars: PSNR within 0.01 dB,
SSIM within 1e-3 per image."""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch import net_eval
from sisr_tpu_torch.data.loader import DataLoader, device_prefetch
from sisr_tpu_torch.evaluation.standard_eval import EvalHub
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.tools.convert_weights import state_dict_from_jax
from sisr_tpu_torch.utils import toml_io

RCAN = {'scale': 4, 'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 32, 'reduction': 16}
BARS = {'PSNR': 0.01, 'SSIM': 1e-3}


@pytest.fixture(scope='module')
def jax_rcan():
    handler = jax_define_model('rcan', eval_mode=True, **RCAN)
    handler.init_state(spatial=(16, 16))
    return handler


def _port_rcan(jax_handler, **kwargs):
    handler = define_model('rcan', device='cpu', **{**RCAN, **kwargs})
    params = jax.tree.map(np.asarray, jax_handler.state.params)
    handler.module.load_state_dict(state_dict_from_jax('rcan', params))
    return handler


def _assert_metric_rows(keys, ours, theirs):
    for i, key in enumerate(keys):
        bar = BARS[key.split('>')[1]]
        np.testing.assert_allclose(ours[i], theirs[i], atol=bar, rtol=0, err_msg=key)


@pytest.mark.parametrize('include_lr', [True, False])
def test_run_eval_fused_matches_sisr_tpu(jax_rcan, include_lr):
    rng = np.random.RandomState(0)
    batch = {'lr': rng.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8),
             'hr': rng.randint(0, 256, (3, 64, 64, 3)).astype(np.uint8)}
    (keys, theirs), _ = jax_rcan.run_eval_fused(batch, include_lr=include_lr)
    (our_keys, ours), runtime = _port_rcan(jax_rcan).run_eval_fused(
        batch, include_lr=include_lr)
    assert our_keys == keys and runtime is None
    assert ours.shape == (len(keys), 3) and ours.dtype == torch.float32
    _assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize('include_lr', [True, False])
def test_run_eval_fused_bf16_matches_sisr_tpu(include_lr):
    """bf16: the port's autocast RCAN against sisr_tpu's ``dtype='bf16'`` RCAN.  The
    two round in other places (sisr_tpu's CALayer pools and excites in bf16, the
    port's CA kernel in f32; conv accumulation), and still meet the metric bars."""
    jax_bf16 = jax_define_model('rcan', eval_mode=True, dtype='bf16', **RCAN)
    jax_bf16.init_state(spatial=(16, 16))
    rng = np.random.RandomState(7)
    batch = {'lr': rng.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8),
             'hr': rng.randint(0, 256, (3, 64, 64, 3)).astype(np.uint8)}
    (keys, theirs), _ = jax_bf16.run_eval_fused(batch, include_lr=include_lr)
    port = _port_rcan(jax_bf16, dtype='bf16')
    assert port.dtype == torch.bfloat16
    (our_keys, ours), _ = port.run_eval_fused(batch, include_lr=include_lr)
    assert our_keys == keys
    _assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))


def test_run_eval_fused_ragged_and_timed(jax_rcan):
    """Differently sized images at bs>1 run per image; float inputs that are exact
    uint8 travel as uint8; timing returns a runtime."""
    rng = np.random.RandomState(1)
    lrs = [rng.randint(0, 256, s + (3,)).astype(np.uint8) for s in ((16, 16), (12, 20))]
    hrs = [rng.randint(0, 256, (4 * s[0], 4 * s[1], 3)).astype(np.uint8)
           for s in ((16, 16), (12, 20))]
    port = _port_rcan(jax_rcan)
    (keys, ours), runtime = port.run_eval_fused(
        {'lr': [a.astype(np.float32) / 255.0 for a in lrs], 'hr': hrs}, timing=True)
    assert runtime > 0 and ours.shape == (4, 2)
    for i in range(2):
        (_, theirs), _ = jax_rcan.run_eval_fused({'lr': lrs[i][None], 'hr': hrs[i][None]})
        _assert_metric_rows(keys, ours.numpy()[:, i:i + 1], np.asarray(theirs))


def test_device_prefetch_on_cpu_keeps_order():
    class Items:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return {'lr': np.full((2, 2, 3), i, np.uint8), 'tag': 'im_%d' % i}

    batches = list(device_prefetch(iter(DataLoader(Items(), batch_size=2)), 'cpu'))
    assert [b['tag'] for b in batches] == [['im_0', 'im_1'], ['im_2', 'im_3'], ['im_4']]
    assert all(isinstance(b['lr'], torch.Tensor) for b in batches)
    assert [int(b['lr'][0, 0, 0, 0]) for b in batches] == [0, 2, 4]


def _write_experiments(root, jax_handler):
    """The same weights as a sisr_tpu experiment and as a sisr_tpu_torch one."""
    for name in ('jax_exp', 'torch_exp'):
        os.makedirs(os.path.join(root, name, 'saved_models'))
        toml_io.dump({'model': {'name': 'rcan', 'internal_params': RCAN}},
                     os.path.join(root, name, 'config.toml'))
    jax_handler.save_model('train_model', 0, os.path.join(root, 'jax_exp', 'saved_models'))
    jax_handler.wait_pending_checkpoints()
    _port_rcan(jax_handler).save_model('train_model', 0,
                                       os.path.join(root, 'torch_exp', 'saved_models'))


def _read_metrics(out_loc, name):
    return pd.read_csv(os.path.join(out_loc, name, 'standard_metrics',
                                    'individual_metrics.csv'), header=[0, 1], index_col=0)


def test_cli_fused_eval_matches_sisr_tpu(tmp_path, jax_rcan):
    from sisr_tpu.evaluation.standard_eval import EvalHub as JaxEvalHub
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 4, lr_size=16)
    model_loc, out_loc = str(tmp_path / 'Results'), str(tmp_path / 'out')
    _write_experiments(model_loc, jax_rcan)

    net_eval.eval_run.main(
        args=['--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'torch_exp', '0',
              '--model_loc', model_loc, '--out_loc', out_loc, '--results_name', 'port',
              '-m', 'PSNR', '-m', 'SSIM', '--batch_size', '2', '--full_directory',
              '--fused_eval', '--no_image_comparison', '--no-gpu'],
        standalone_mode=False)
    JaxEvalHub(hr_dir=hr_dir, lr_dir=lr_dir, model_and_epoch=[('jax_exp', '0')],
               results_name='ref', gpu=False, metrics=['PSNR', 'SSIM'], data_split=None,
               save_im=False, batch_size=2, full_directory=True, lr_dir_interp=None,
               model_only=False, scale=4, model_loc=model_loc, out_loc=out_loc,
               use_test_group=False, no_image_comparison=True, num_image_save=0,
               qpi_selection=(None, None), data_attributes=None, dataset_name=None,
               image_shortlist=None, metadata_file=None, sp_gpu=0, time_models=True,
               recursive=False, fused_eval=True).full_image_protocol()

    ours, theirs = _read_metrics(out_loc, 'port'), _read_metrics(out_loc, 'ref')
    assert list(ours.index) == list(theirs.index) and len(ours) == 4
    for side_ours, side_theirs in (('LR', 'LR'), ('torch_exp', 'jax_exp')):
        for met, bar in BARS.items():
            np.testing.assert_allclose(ours[(side_ours, met)], theirs[(side_theirs, met)],
                                       atol=bar, rtol=0, err_msg='%s %s' % (side_ours, met))
    assert ours[('torch_exp', 'runtime')].gt(0).all()  # --time_models is on by default
    assert ours[('LR', 'runtime')].isna().all()
    assert os.path.isfile(os.path.join(out_loc, 'port', 'standard_metrics',
                                       'average_metrics.csv'))


@pytest.mark.parametrize('override', [
    {'fused_eval': False}, {'save_im': True}, {'no_image_comparison': False},
    {'decoded_cache_dir': 'decoded'}, {'eval_buckets': 128}, {'lr_dir_interp': 'lr'},
])
def test_ported_options_run(override, jax_rcan, tmp_path):
    """Each option that once refused (the standard protocol's) now runs: the metrics
    CSV has a finite row per image, and the fused request falls back to the standard
    protocol where the option needs it."""
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 2, lr_size=16)
    model_loc, out_loc = str(tmp_path / 'Results'), str(tmp_path / 'out')
    _write_experiments(model_loc, jax_rcan)
    if 'decoded_cache_dir' in override:
        override = {'decoded_cache_dir': str(tmp_path / 'decoded')}
    if 'lr_dir_interp' in override:  # LR images already at the HR size
        override = {'lr_dir_interp': hr_dir}
    kwargs = dict(hr_dir=hr_dir, lr_dir=lr_dir, model_and_epoch=[('torch_exp', '0')],
                  results_name='r', gpu=False, metrics=['PSNR'], data_split=None,
                  save_im=False, batch_size=1, full_directory=True, lr_dir_interp=None,
                  model_only=False, scale=4, model_loc=model_loc, out_loc=out_loc,
                  use_test_group=False, no_image_comparison=True, num_image_save=10,
                  qpi_selection=(None, None), data_attributes=None, dataset_name=None,
                  image_shortlist=None, metadata_file=None, sp_gpu=0, time_models=False,
                  recursive=False, fused_eval=True)
    EvalHub(**{**kwargs, **override}).full_image_protocol()
    frame = _read_metrics(out_loc, 'r')
    assert len(frame) == 2 and np.isfinite(frame[('torch_exp', 'PSNR')]).all()
    if 'lr_dir_interp' in override:  # the HR images themselves: the LR baseline is exact
        assert (frame[('LR', 'PSNR')] == 100).all()


@pytest.mark.parametrize('override', [
    {'mesh': True}, {'data_attributes': 'list_attr_celeba.txt'},
    {'metrics': ['PSNR', 'FACE_SIM']},
])
def test_unported_options_raise(override, tmp_path, monkeypatch):
    """Multi-device eval (--mesh: one CPU rank here, with --no-gpu and no launcher),
    CelebA attributes and FACE_SIM are ported now: the hub takes them and goes on to
    load the model, missing here."""
    monkeypatch.chdir(tmp_path)  # the hub writes under out_loc before it loads models
    kwargs = dict(hr_dir='hr', lr_dir='lr', model_and_epoch=[('e', '0')], results_name='r',
                  gpu=False, metrics=['PSNR'], data_split=None, save_im=False, batch_size=1,
                  full_directory=True, lr_dir_interp=None, model_only=False, scale=4,
                  model_loc='m', out_loc='o', use_test_group=False,
                  no_image_comparison=True, num_image_save=0, qpi_selection=(None, None),
                  data_attributes=None, dataset_name=None, image_shortlist=None,
                  metadata_file=None, sp_gpu=0, time_models=False, recursive=False,
                  fused_eval=True)
    with pytest.raises(RuntimeError, match='No config.toml'):
        EvalHub(**{**kwargs, **override})
