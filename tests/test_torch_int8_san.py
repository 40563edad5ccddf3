"""sisr_tpu_torch's int8 serving of SAN and Q-SAN against sisr_tpu's on the same weights
(gamma, the non-local output conv and the SOCA MLPs drawn: test_torch_san.py's
``with_live_attention``), on the CPU: the non-local block, the quadrant wrapper and SOCA
as the int8 programs run them (f32), at even and odd h and w; quantisation;
calibration (Q-SAN on the handler-prepared metadata), also on the tile-sized centre
crop that a tiled family calibrates on; the int8 forward on the same int8 state (no
channel-attention kernel call: SAN has no CA); the handler's int8 fused eval, with and
without the tile grid inside the step; the standard protocol's int8 run_eval on the
grid; eval_sisr --fused_eval --int8 end to end; sisr_tpu's int8 state run by the port's
handler.

Bars: the attention helpers 1e-5 abs; quantised weights bit-identical; calibration
scales rtol 1e-5; the int8 forward >= 60 dB PSNR against sisr_tpu's; fused and CLI
metrics, and each SR image's PSNR and SSIM against its HR, within 0.01 dB and 1e-3."""
import os
import re

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from sisr_tpu.evaluation.standard_eval import EvalHub as JaxEvalHub
from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.ops import quantization as jq
from sisr_tpu.ops.metrics import psnr, structural_similarity
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch import net_eval
from sisr_tpu_torch.models import handlers
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import channel_attention as ca
from sisr_tpu_torch.ops import quantization as tq
from sisr_tpu_torch.tools.convert_weights import (int8_state_from_jax,
                                                  params_from_state_dict,
                                                  state_dict_from_jax)
from sisr_tpu_torch.utils import toml_io
from test_torch_san import with_live_attention

SMALL = {'scale': 4, 'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 4}
FAMILIES = {'san': SMALL, 'qsan': {**SMALL, 'metadata': ['blur_kernel']}}
KEYS = ['blur_kernel'] * 10
BARS = {'PSNR': 0.01, 'SSIM': 1e-3}
QUANTIZE = {'san': (jq.quantize_san_params, tq.quantize_san_params),
            'qsan': (jq.quantize_qsan_params, tq.quantize_qsan_params)}


def _jax_handler(name, params=None, **kwargs):
    handler = jax_define_model(name, eval_mode=True, **FAMILIES[name], **kwargs)
    if name == 'qsan':
        handler.set_metadata_keys(KEYS)
    handler.init_state(spatial=(16, 16))
    if params is None:
        params = with_live_attention(handler.state.params, seed=1)
    handler.state = handler.state.replace(params=jax.tree.map(jnp.asarray, params))
    return handler


def _port(name, jax_params, **kwargs):
    handler = define_model(name, device='cpu', **{**FAMILIES[name], **kwargs})
    if name == 'qsan':
        handler.set_metadata_keys(KEYS)
    handler.module.load_state_dict(state_dict_from_jax(name, jax_params))
    return handler


@pytest.fixture(scope='module')
def bridged():
    """name -> (sisr_tpu handler, its params as numpy, the port's handler on the same
    weights, the port's params in sisr_tpu's tree naming)."""
    cache = {}

    def get(name):
        if name not in cache:
            jax_handler = _jax_handler(name)
            jax_params = jax.tree.map(np.asarray, jax_handler.state.params)
            port = _port(name, jax_params)
            cache[name] = (jax_handler, jax_params, port,
                           params_from_state_dict(name, port.module.state_dict()))
        return cache[name]
    return get


def _inputs(bridged, name, seed, n=2, size=(12, 12)):
    """An f32 LR batch and its metadata as the handlers prepare it (numpy), or None for
    SAN."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, *size, 3).astype(np.float32)
    if name == 'san':
        return x, None
    jax_handler, _, port, _ = bridged(name)
    meta = rng.rand(n, 10).astype(np.float32)
    theirs = np.asarray(jax_handler.prepare_metadata(jnp.asarray(x), jnp.asarray(meta)))
    ours = port.prepare_metadata(torch.from_numpy(x), torch.from_numpy(meta))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    return x, theirs


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize('size', [(12, 16), (13, 15)], ids=['even', 'odd'])
@pytest.mark.parametrize('part', ['nonlocal_block', 'nonlocal_ca', 'soca'])
def test_attention_helpers_match_sisr_tpu(bridged, part, size):
    _, jax_params, _, params = bridged('san')
    h = (0.5 * np.random.RandomState(0).randn(2, *size, 16)).astype(np.float32)
    if part == 'nonlocal_block':
        theirs = jq._nonlocal_block_apply(jax_params['non_local']['non_local'], jnp.asarray(h))
        ours = tq._nonlocal_block_apply(params['non_local']['non_local'], torch.from_numpy(h))
    elif part == 'nonlocal_ca':
        theirs = jq._nonlocal_ca_apply(jax_params['non_local'], jnp.asarray(h))
        ours = tq._nonlocal_ca_apply(params['non_local'], torch.from_numpy(h))
    else:
        theirs = jq._soca_apply(jax_params['rg_0']['soca'], jnp.asarray(h))
        ours = tq._soca_apply(params['rg_0']['soca'], torch.from_numpy(h))
    theirs = np.asarray(theirs)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == theirs.shape == h.shape
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5, rtol=0)
    assert np.abs(theirs - h).max() > 0.05


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_quantize_params_bit_identical(bridged, name):
    _, jax_params, _, params = bridged(name)
    theirs = dict(_walk(QUANTIZE[name][0](jax_params, 2, 2)))
    ours = dict(_walk(QUANTIZE[name][1](params, 2, 2)))
    assert set(theirs) == {p for p in ours if p[-1] != 'matrix'}
    block = 'qrb_1' if name == 'qsan' else 'rb_1'
    assert {('gamma',), ('non_local', 'non_local', 'w', 'kernel'),
            ('rg_1', 'soca', 'du_0', 'kernel'), ('rg_1', block, 'conv_1', 'matrix'),
            ('rg_1', 'conv_last', 'scale')} <= set(ours)
    if name == 'qsan':
        assert ('rg_1', 'qrb_1', 'q_layer', 'fc_1', 'kernel') in ours
    for path, value in theirs.items():
        np.testing.assert_array_equal(ours[path].numpy(), np.asarray(value),
                                      err_msg='/'.join(path))


def _calibrate(module, name, params, x, meta):
    if name == 'san':
        return module.calibrate_san_scales(params, [x], n_resgroups=2, n_resblocks=2,
                                           margin=1.1)
    return module.calibrate_qsan_scales(params, [x], [meta], n_resgroups=2, n_resblocks=2,
                                        margin=1.1)


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_calibrate_scales_matches(bridged, name):
    _, jax_params, _, params = bridged(name)
    x, meta = _inputs(bridged, name, 2, size=(13, 15))
    theirs = _calibrate(jq, name, jax_params, x, meta)
    ours = _calibrate(tq, name, params, x, meta)
    assert sorted(ours) == sorted(theirs)
    block = 'qrb_1' if name == 'qsan' else 'rb_1'
    assert {'head', 'rg_1.conv_last', 'rg_1.%s.conv_0' % block, 'upsampler.conv_1',
            'tail'} <= set(ours)
    for k in theirs:
        assert isinstance(ours[k], np.float32)
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=0, err_msg=k)


def test_calibrate_qsan_scales_refuses_a_count_mismatch(bridged):
    _, _, _, params = bridged('qsan')
    x, meta = _inputs(bridged, 'qsan', 3)
    with pytest.raises(ValueError, match='1 sample batches but 2 metadata'):
        tq.calibrate_qsan_scales(params, [x], [meta, meta], 2, 2)
    with pytest.raises(ValueError, match='no calibration batches'):
        tq.calibrate_san_scales(params, [], 2, 2)


@pytest.mark.parametrize('residual_dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_int8_forward_matches_sisr_tpu(bridged, name, residual_dtype, monkeypatch):
    """The same int8 state (sisr_tpu's, carried across) through both forwards, on an
    odd-sized batch; neither CA op is called."""
    _, jax_params, _, _ = bridged(name)
    x, meta = _inputs(bridged, name, 4)
    qp = QUANTIZE[name][0](jax_params, 2, 2)
    scales = _calibrate(jq, name, jax_params, x, meta)
    x2, meta2 = _inputs(bridged, name, 5, size=(13, 15))
    if name == 'san':
        theirs = jq.san_int8_forward_static(qp, scales, jnp.asarray(x2), 2, 2,
                                            residual_dtype=residual_dtype)
    else:
        theirs = jq.qsan_int8_forward_static(qp, scales, jnp.asarray(x2), jnp.asarray(meta2),
                                             2, 2, residual_dtype=residual_dtype)
    monkeypatch.setattr(tq, 'fused_channel_attention_residual', None)
    monkeypatch.setattr(tq, 'fused_channel_attention', None)
    state = int8_state_from_jax(qp, scales)
    with torch.inference_mode():
        if name == 'san':
            ours = tq.san_int8_forward_static(*state, torch.from_numpy(x2), 2, 2,
                                              residual_dtype=residual_dtype)
        else:
            ours = tq.qsan_int8_forward_static(*state, torch.from_numpy(x2),
                                               torch.from_numpy(meta2), 2, 2,
                                               residual_dtype=residual_dtype)
    assert ours.dtype == torch.float32 and ours.shape == (2, 52, 60, 3)
    assert psnr(ours.numpy(), np.asarray(theirs), max_value=1.0) >= 60


def _spy_calibration(monkeypatch, name):
    """Record the inputs and the scales of sisr_tpu's handler calibration."""
    seen = {}
    calibrate = getattr(jq, 'calibrate_%s_scales' % name)

    def spy(params, batches, *args, **kwargs):
        seen['x'] = np.asarray(batches[0])
        seen['scales'] = calibrate(params, batches, *args, **kwargs)
        return seen['scales']
    monkeypatch.setattr(jq, 'calibrate_%s_scales' % name, spy)
    return seen


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_tile_crop_calibration_matches_sisr_tpu(bridged, name, monkeypatch):
    """A tiled family calibrates on the centre crop of max(16, int(sqrt(limit))) a side
    (24 at 600) of its first eval image, as sisr_tpu's handler does: the same crop of
    a 41 x 43 image, and scales within rtol 1e-5; a smaller image is taken whole."""
    _, jax_params, _, _ = bridged(name)
    jax_handler = _jax_handler(name, jax_params, max_combined_im_size=600)
    port = _port(name, jax_params, max_combined_im_size=600)
    rng = np.random.RandomState(9)
    lr = rng.rand(1, 41, 43, 3).astype(np.float32)
    hr = rng.rand(1, 164, 172, 3).astype(np.float32)
    meta = rng.rand(1, 10).astype(np.float32) if name == 'qsan' else None
    crop = port._int8_calibration_input(torch.from_numpy(lr)).numpy()
    np.testing.assert_array_equal(crop, lr[:, 8:32, 9:33])
    np.testing.assert_array_equal(
        crop, np.asarray(jax_handler._int8_calibration_input(jnp.asarray(lr))))
    small = torch.rand(1, 20, 12, 3)
    assert port._int8_calibration_input(small) is small or torch.equal(
        port._int8_calibration_input(small), small)
    seen = _spy_calibration(monkeypatch, name)
    jax_handler.set_int8(True)
    jax_handler.run_eval(lr, hr, metadata=meta)
    port.set_int8(True)
    port.run_eval(lr, hr, metadata=meta)
    np.testing.assert_array_equal(seen['x'], crop)
    ours = port._int8_ctx[2]
    assert sorted(ours) == sorted(seen['scales'])
    for k, v in seen['scales'].items():
        np.testing.assert_allclose(ours[k], v, rtol=1e-5, atol=0, err_msg=k)


def _image_metrics(sr, hr):
    return [(psnr(a, b, max_value=1.0),
             structural_similarity(a, b, data_range=1.0, multichannel=True))
            for a, b in zip(sr, hr)]


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_run_eval_int8_on_the_grid_matches_sisr_tpu(bridged, name):
    """The standard protocol's int8 step on a 41 x 43 image at max_combined_im_size 600:
    calibrated on the tile-sized crop, then the int8 program on the 16 tiles of a 4 x 4
    grid; each SR image's PSNR and SSIM against its HR within the bars of sisr_tpu's."""
    _, jax_params, _, _ = bridged(name)
    jax_handler = _jax_handler(name, jax_params, max_combined_im_size=600)
    port = _port(name, jax_params, max_combined_im_size=600)
    rng = np.random.RandomState(10)
    lr = rng.rand(1, 41, 43, 3).astype(np.float32)
    hr = np.clip(np.repeat(np.repeat(lr, 4, 1), 4, 2) + 0.05 * rng.randn(1, 164, 172, 3),
                 0, 1).astype(np.float32)
    meta = rng.rand(1, 10).astype(np.float32) if name == 'qsan' else None
    jax_handler.set_int8(True)
    theirs = jax_handler.run_eval(lr, hr, metadata=meta)[0]
    port.set_int8(True)
    tiles = []
    program = None

    def spy(x, m=None):
        tiles.append(tuple(x.shape))
        return program(x, m)
    out = port.run_eval(lr, hr, metadata=meta, timing=True)
    program = port._int8_ctx[0]
    port._int8_ctx = (spy,) + port._int8_ctx[1:]
    ours = port.run_eval(lr, hr, metadata=meta)[0]
    np.testing.assert_array_equal(ours, out[0])
    assert tiles == [(16, 31, 31, 3)]
    for (p_ours, s_ours), (p_theirs, s_theirs) in zip(_image_metrics(ours, hr),
                                                      _image_metrics(theirs, hr)):
        assert abs(p_ours - p_theirs) <= BARS['PSNR'] and abs(s_ours - s_theirs) <= BARS['SSIM']


def _assert_metric_rows(keys, ours, theirs):
    for i, key in enumerate(keys):
        bar = BARS[key.split('>')[1]]
        np.testing.assert_allclose(ours[i], theirs[i], atol=bar, rtol=0, err_msg=key)


@pytest.mark.parametrize('limit', [None, 1000], ids=['no_grid', 'grid2'])
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_run_eval_fused_int8_matches_sisr_tpu(bridged, name, limit):
    """Each handler calibrates on the first batch (the tile-sized crop with the grid,
    and the prepared metadata) and runs its int8 program inside the fused step, on the
    2 x 2 grid of the 40^2 maps at max_combined_im_size 1000; the module does not
    run."""
    _, jax_params, _, _ = bridged(name)
    kwargs = {'max_combined_im_size': limit} if limit else {}
    jax_handler, port = _jax_handler(name, jax_params, **kwargs), _port(name, jax_params,
                                                                        **kwargs)
    rng = np.random.RandomState(6)
    size = 40 if limit else 16
    batch = {'lr': rng.randint(0, 256, (3, size, size, 3)).astype(np.uint8),
             'hr': rng.randint(0, 256, (3, 4 * size, 4 * size, 3)).astype(np.uint8),
             'metadata': rng.rand(3, 10).astype(np.float32)}
    (_, f32), _ = port.run_eval_fused(batch)
    jax_handler.set_int8(True)
    port.set_int8(True)
    (keys, theirs), _ = jax_handler.run_eval_fused(batch)
    forward = port.module.forward
    port.module.forward = None  # the module must not run
    launches = ca.fused_channel_attention.launches, \
        ca.fused_channel_attention_residual.launches
    try:
        (our_keys, ours), _ = port.run_eval_fused(batch)
    finally:
        port.module.forward = forward
    assert launches == (ca.fused_channel_attention.launches,
                        ca.fused_channel_attention_residual.launches)
    assert our_keys == keys and port._int8_ctx is not None
    program, qparams, scales = port._int8_ctx
    assert 'rg_1.conv_last' in scales and 'non_local' in qparams and 'gamma' in qparams
    _assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))
    assert not torch.equal(ours, f32)


def _read_metrics(out_loc, results):
    return pd.read_csv(os.path.join(out_loc, results, 'standard_metrics',
                                    'individual_metrics.csv'), header=[0, 1], index_col=0)


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_cli_fused_eval_int8_matches_sisr_tpu(tmp_path, bridged, name):
    """eval_sisr --fused_eval --int8 --no-gpu on a folder with a blur-kernel
    degradation_metadata.csv, against sisr_tpu's EvalHub with int8=True on the same
    weights."""
    jax_handler, _, port, _ = bridged(name)
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 4, lr_size=16, metadata_cols=10)
    model_loc, out_loc = str(tmp_path / 'Results'), str(tmp_path / 'out')
    for exp in ('jax_exp', 'torch_exp'):
        os.makedirs(os.path.join(model_loc, exp, 'saved_models'))
        toml_io.dump({'model': {'name': name, 'internal_params': FAMILIES[name]}},
                     os.path.join(model_loc, exp, 'config.toml'))
    jax_handler.save_model('train_model', 0, os.path.join(model_loc, 'jax_exp', 'saved_models'))
    jax_handler.wait_pending_checkpoints()
    port.save_model('train_model', 0, os.path.join(model_loc, 'torch_exp', 'saved_models'))
    net_eval.eval_run.main(
        args=['--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'torch_exp', '0',
              '--model_loc', model_loc, '--out_loc', out_loc, '--results_name', 'port',
              '-m', 'PSNR', '-m', 'SSIM', '--batch_size', '2', '--full_directory',
              '--fused_eval', '--no_image_comparison', '--no-time_models', '--no-gpu',
              '--int8'], standalone_mode=False)
    JaxEvalHub(hr_dir=hr_dir, lr_dir=lr_dir, model_and_epoch=[('jax_exp', '0')],
               results_name='ref', gpu=False, metrics=['PSNR', 'SSIM'], data_split=None,
               save_im=False, batch_size=2, full_directory=True, lr_dir_interp=None,
               model_only=False, scale=4, model_loc=model_loc, out_loc=out_loc,
               use_test_group=False, no_image_comparison=True, num_image_save=0,
               qpi_selection=(None, None), data_attributes=None, dataset_name=None,
               image_shortlist=None, metadata_file=None, sp_gpu=0, time_models=False,
               recursive=False, fused_eval=True, int8=True).full_image_protocol()
    ours, theirs = _read_metrics(out_loc, 'port'), _read_metrics(out_loc, 'ref')
    assert list(ours.index) == list(theirs.index) and len(ours) == 4
    for side_ours, side_theirs in (('LR', 'LR'), ('torch_exp', 'jax_exp')):
        for met, bar in BARS.items():
            np.testing.assert_allclose(ours[(side_ours, met)], theirs[(side_theirs, met)],
                                       atol=bar, rtol=0, err_msg='%s %s' % (side_ours, met))


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_int8_state_from_jax_runs_in_the_handler(bridged, name):
    """sisr_tpu's int8 state carried across: the int8 convs get their packed matrix,
    the non-local, SOCA and q_layer entries none; a handler given it runs
    program(x, meta) exactly as the plain function does."""
    _, jax_params, _, _ = bridged(name)
    x, meta = _inputs(bridged, name, 8)
    qp = QUANTIZE[name][0](jax_params, 2, 2)
    scales = _calibrate(jq, name, jax_params, x, meta)
    ours, _ = int8_state_from_jax(qp, scales)
    assert 'matrix' in ours['rg_0']['conv_last'] and 'matrix' in ours['head']
    assert 'matrix' not in ours['non_local']['non_local']['w']
    assert 'matrix' not in ours['rg_0']['soca']['du_0']
    port = _port(name, jax_params)
    port.set_int8(True)
    port.load_int8_state(*int8_state_from_jax(qp, scales))
    xt = torch.from_numpy(x)
    mt = None if meta is None else torch.from_numpy(meta)
    with torch.inference_mode():
        via_handler = port._int8_ctx[0](xt, mt)
        state = int8_state_from_jax(qp, scales)
        direct = tq.san_int8_forward_static(*state, xt, 2, 2) if name == 'san' else \
            tq.qsan_int8_forward_static(*state, xt, mt, 2, 2)
    torch.testing.assert_close(via_handler, direct, atol=0, rtol=0)


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_set_int8_warns_with_the_cards_ratio(name):
    """SAN and Q-SAN were measured slower in int8 than in bf16 on the card: set_int8
    warns with that ratio, the card's name and power limit, and no TPU figure."""
    handler = define_model(name, device='cpu', **{**FAMILIES[name], 'n_resgroups': 1,
                                                  'n_resblocks': 1})
    with pytest.warns(UserWarning) as record:
        handler.set_int8(True)
    message = str(record[0].message)
    assert re.fullmatch(r'\d\.\d\dx', handlers.INT8_MEASURED_SLOWER[name])
    assert message.startswith('int8 measured slower than bf16 for the %s family on an '
                              'NVIDIA H100 80GB HBM3, 700.00 W (%s bf16 img/s'
                              % (name, handlers.INT8_MEASURED_SLOWER[name]))
    assert not re.search(r'v5e|v4|TPU', message) and handler.int8_mode
