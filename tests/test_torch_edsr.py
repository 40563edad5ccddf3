"""sisr_tpu_torch's EDSR against sisr_tpu's on the same weights: the forward in f32,
the weights bridge both ways and through sisr_tpu's own converter, the fused eval in
f32 and bf16, and eval_sisr --fused_eval end to end, without and with --int8.
Bars: forward 5e-4 abs, PSNR within 0.01 dB and SSIM within 1e-3 per image."""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch import net_eval
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import channel_attention as ca
from sisr_tpu_torch.tools.convert_weights import params_from_state_dict, state_dict_from_jax
from sisr_tpu_torch.utils import toml_io

EDSR = {'scale': 4, 'num_features': 32, 'num_blocks': 3}
BARS = {'PSNR': 0.01, 'SSIM': 1e-3}


@pytest.fixture(scope='module')
def jax_edsr():
    cache = {}

    def get(dtype=None):
        if dtype not in cache:
            handler = jax_define_model('edsr', eval_mode=True, dtype=dtype, **EDSR)
            handler.init_state(spatial=(16, 16))
            cache[dtype] = handler
        return cache[dtype]
    return get


def _params(jax_handler):
    return jax.tree.map(np.asarray, jax_handler.state.params)


def _port(jax_handler, **kwargs):
    handler = define_model('edsr', device='cpu', **{**EDSR, **kwargs})
    handler.module.load_state_dict(state_dict_from_jax('edsr', _params(jax_handler)))
    return handler


def _assert_metric_rows(keys, ours, theirs):
    for i, key in enumerate(keys):
        bar = BARS[key.split('>')[1]]
        np.testing.assert_allclose(ours[i], theirs[i], atol=bar, rtol=0, err_msg=key)


def test_forward_matches_sisr_tpu_f32(jax_edsr):
    """res_scale 0.1 by default, as sisr_tpu's EDSRHandler; no CA kernel call."""
    x = np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32)
    theirs = np.asarray(jax_edsr().state.apply_fn({'params': jax_edsr().state.params}, x))
    port = _port(jax_edsr())
    assert port.module.body[0].res_scale == 0.1 and not port.uses_metadata
    launches = ca.fused_channel_attention.launches
    with torch.inference_mode():
        ours = port.forward(torch.from_numpy(x)).numpy()
    assert ca.fused_channel_attention.launches == launches
    assert ours.shape == theirs.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(ours, theirs, atol=5e-4, rtol=0)


def test_bridge_round_trips_through_sisr_tpu_converter(jax_edsr):
    params = _params(jax_edsr())
    port = _port(jax_edsr())
    assert 'body.3.weight' in port.module.state_dict()  # the body's tail conv
    state = {k: v.numpy() for k, v in port.module.state_dict().items()}
    back = convert_torch_state_dict('edsr', state, num_blocks=3, scale=4)
    ours = jax.tree.map(np.asarray, params_from_state_dict('edsr', port.module.state_dict()))
    for tree in (back, ours):
        assert jax.tree.structure(tree) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)


def test_bridge_rejects_mismatched_trees(jax_edsr):
    params = _params(jax_edsr())
    with pytest.raises(RuntimeError, match='unconsumed'):
        state_dict_from_jax('edsr', {**params, 'stray': {'kernel': np.zeros(1)}})
    with pytest.raises(KeyError, match='body_tail'):
        state_dict_from_jax('edsr', {k: v for k, v in params.items() if k != 'body_tail'})


@pytest.mark.parametrize('dtype', [None, 'bf16'])
def test_run_eval_fused_matches_sisr_tpu(jax_edsr, dtype):
    rng = np.random.RandomState(1)
    batch = {'lr': rng.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8),
             'hr': rng.randint(0, 256, (3, 64, 64, 3)).astype(np.uint8)}
    (keys, theirs), _ = jax_edsr(dtype).run_eval_fused(batch)
    port = _port(jax_edsr(dtype), dtype=dtype)
    (our_keys, ours), _ = port.run_eval_fused(batch)
    assert our_keys == keys and ours.shape == (len(keys), 3)
    _assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))


def test_seeded_init_and_checkpoint_keys(tmp_path):
    a = define_model('edsr', device='cpu', seed=3, **EDSR)
    b = define_model('edsr', device='cpu', seed=3, **EDSR)
    sb = b.module.state_dict()
    assert all(torch.equal(v, sb[k]) for k, v in a.module.state_dict().items())
    a.save_model('train_model', 0, str(tmp_path))
    saved = torch.load(os.path.join(tmp_path, 'train_model_0'), weights_only=True)
    assert saved['model_name'] == 'edsr'
    assert {'head.0.weight', 'body.2.body.2.bias', 'body.3.weight', 'tail.0.2.weight',
            'tail.1.bias'} <= set(saved['network'])


def _read_metrics(out_loc, name):
    return pd.read_csv(os.path.join(out_loc, name, 'standard_metrics',
                                    'individual_metrics.csv'), header=[0, 1], index_col=0)


def test_cli_fused_eval_matches_sisr_tpu(tmp_path, jax_edsr):
    """eval_sisr --fused_eval --no-gpu against sisr_tpu's EvalHub, same weights, on a
    folder whose degradation_metadata.csv EDSR, taking no metadata, ignores."""
    from sisr_tpu.evaluation.standard_eval import EvalHub as JaxEvalHub
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 3, lr_size=16, metadata_cols=10)
    model_loc, out_loc = str(tmp_path / 'Results'), str(tmp_path / 'out')
    for name in ('jax_exp', 'torch_exp'):
        os.makedirs(os.path.join(model_loc, name, 'saved_models'))
        toml_io.dump({'model': {'name': 'edsr', 'internal_params': EDSR}},
                     os.path.join(model_loc, name, 'config.toml'))
    jax_edsr().save_model('train_model', 0, os.path.join(model_loc, 'jax_exp', 'saved_models'))
    jax_edsr().wait_pending_checkpoints()
    _port(jax_edsr()).save_model('train_model', 0,
                                 os.path.join(model_loc, 'torch_exp', 'saved_models'))
    args = ['--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'torch_exp', '0', '--model_loc',
            model_loc, '--out_loc', out_loc, '-m', 'PSNR', '-m', 'SSIM', '--batch_size', '2',
            '--full_directory', '--fused_eval', '--no_image_comparison', '--no-time_models',
            '--no-gpu']
    net_eval.eval_run.main(args=args + ['--results_name', 'port'], standalone_mode=False)
    JaxEvalHub(hr_dir=hr_dir, lr_dir=lr_dir, model_and_epoch=[('jax_exp', '0')],
               results_name='ref', gpu=False, metrics=['PSNR', 'SSIM'], data_split=None,
               save_im=False, batch_size=2, full_directory=True, lr_dir_interp=None,
               model_only=False, scale=4, model_loc=model_loc, out_loc=out_loc,
               use_test_group=False, no_image_comparison=True, num_image_save=0,
               qpi_selection=(None, None), data_attributes=None, dataset_name=None,
               image_shortlist=None, metadata_file=None, sp_gpu=0, time_models=False,
               recursive=False, fused_eval=True).full_image_protocol()
    ours, theirs = _read_metrics(out_loc, 'port'), _read_metrics(out_loc, 'ref')
    assert list(ours.index) == list(theirs.index) and len(ours) == 3
    for side_ours, side_theirs in (('LR', 'LR'), ('torch_exp', 'jax_exp')):
        for met, bar in BARS.items():
            np.testing.assert_allclose(ours[(side_ours, met)], theirs[(side_theirs, met)],
                                       atol=bar, rtol=0, err_msg='%s %s' % (side_ours, met))
    # --int8: each package calibrates on the first batch and serves its int8 program
    net_eval.eval_run.main(args=args + ['--results_name', 'port_int8', '--int8'],
                           standalone_mode=False)
    JaxEvalHub(hr_dir=hr_dir, lr_dir=lr_dir, model_and_epoch=[('jax_exp', '0')],
               results_name='ref_int8', gpu=False, metrics=['PSNR', 'SSIM'], data_split=None,
               save_im=False, batch_size=2, full_directory=True, lr_dir_interp=None,
               model_only=False, scale=4, model_loc=model_loc, out_loc=out_loc,
               use_test_group=False, no_image_comparison=True, num_image_save=0,
               qpi_selection=(None, None), data_attributes=None, dataset_name=None,
               image_shortlist=None, metadata_file=None, sp_gpu=0, time_models=False,
               recursive=False, fused_eval=True, int8=True).full_image_protocol()
    ours_int8, theirs_int8 = _read_metrics(out_loc, 'port_int8'), _read_metrics(out_loc,
                                                                                'ref_int8')
    for met, bar in BARS.items():
        np.testing.assert_allclose(ours_int8[('torch_exp', met)], theirs_int8[('jax_exp', met)],
                                   atol=bar, rtol=0, err_msg='int8 %s' % met)
    assert not np.array_equal(ours_int8[('torch_exp', 'PSNR')], ours[('torch_exp', 'PSNR')])
