"""sisr_tpu_torch's int8 serving of HAN and Q-HAN against sisr_tpu's on the same weights
(LAM's and CSAM's gammas non-zero), on the CPU: LAM and CSAM as the int8 programs run
them (f32 for calibration, bf16 in the forward); quantisation; calibration (Q-HAN on
the handler-prepared metadata); the int8 forward on the same int8 state (HAN against
sisr_tpu's ``ca_epilogue='pallas'``, in interpret mode; every RCAB tail one
fused_channel_attention_residual call, every Q-HAN QRCAB tail one with the q_node's
gate, cast first, their plain versions here); the handler's int8 fused eval;
eval_sisr --fused_eval --int8 end to end; and sisr_tpu's int8 state run by the
port's handler.

Bars: quantised weights bit-identical; calibration scales rtol 1e-5; LAM and CSAM
5e-5 in f32 (LAM's softmax takes differences of energies near D/3, which the gram's
f32 summation order moves by about 1e-5) and 2 bf16 ULPs of their magnitude in bf16;
the int8 forward >= 60 dB PSNR against sisr_tpu's; fused and CLI metrics within 0.01
dB PSNR and 1e-3 SSIM per image."""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.ops import quantization as jq
from sisr_tpu.ops.metrics import psnr
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch import net_eval
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import channel_attention as ca
from sisr_tpu_torch.ops import quantization as tq
from sisr_tpu_torch.tools.convert_weights import (int8_state_from_jax,
                                                  params_from_state_dict,
                                                  state_dict_from_jax)
from sisr_tpu_torch.utils import toml_io

SMALL = {'scale': 4, 'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 16}
FAMILIES = {'han': SMALL, 'qhan': {**SMALL, 'metadata': ['blur_kernel']}}
KEYS = ['blur_kernel'] * 10
BARS = {'PSNR': 0.01, 'SSIM': 1e-3}


def _jax_handler(name, params=None):
    """sisr_tpu's handler of ``name``, on ``params`` or on fresh ones with LAM's and
    CSAM's gammas non-zero."""
    handler = jax_define_model(name, eval_mode=True, **FAMILIES[name])
    if name == 'qhan':
        handler.set_metadata_keys(KEYS)
    handler.init_state(spatial=(16, 16))
    if params is None:
        params = jax.tree.map(np.asarray, handler.state.params)
        params = {**params, 'la': {'gamma': np.array([0.5], np.float32)},
                  'csa': {**params['csa'], 'gamma': np.array([-0.7], np.float32)}}
    handler.state = handler.state.replace(params=jax.tree.map(jnp.asarray, params))
    return handler


def _port(name, jax_params):
    handler = define_model(name, device='cpu', **FAMILIES[name])
    if name == 'qhan':
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


def _inputs(bridged, name, seed, n=2, size=12):
    """An f32 LR batch and its metadata as the handlers prepare it (numpy), or None
    for HAN."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, size, size, 3).astype(np.float32)
    if name == 'han':
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


@pytest.mark.parametrize('compute_dtype', [None, 'bfloat16'])
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_lam_and_csam_helpers_match_sisr_tpu(bridged, name, compute_dtype):
    """_lam_apply on a (B, N, H, W, C) stack and _csam_apply on a map, with the
    family's la and csa entries, f32 (calibration) and bf16 (the int8 forwards)."""
    _, jax_params, _, params = bridged(name)
    rng = np.random.RandomState(0)
    stack = rng.rand(2, 3, 5, 7, 16).astype(np.float32)
    h = rng.randn(2, 5, 7, 16).astype(np.float32)
    jdt = None if compute_dtype is None else jnp.bfloat16
    tdt = None if compute_dtype is None else torch.bfloat16
    theirs = (jq._lam_apply(jax_params['la'], jnp.asarray(stack), compute_dtype=jdt),
              jq._csam_apply(jax_params['csa'], jnp.asarray(h), compute_dtype=jdt))
    ours = (tq._lam_apply(params['la'], torch.from_numpy(stack), compute_dtype=tdt),
            tq._csam_apply(params['csa'], torch.from_numpy(h), compute_dtype=tdt))
    for a, b in zip(ours, theirs):
        b = np.asarray(b.astype(jnp.float32))
        assert a.dtype == (tdt or torch.float32) and a.shape == b.shape
        bar = 5e-5 if compute_dtype is None else 2 * 2.0 ** -8 * np.abs(b).max()
        np.testing.assert_allclose(a.float().numpy(), b, atol=bar, rtol=0)


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_quantize_params_bit_identical(bridged, name):
    _, jax_params, _, params = bridged(name)
    quantize = {'han': (jq.quantize_han_params, tq.quantize_han_params),
                'qhan': (jq.quantize_qhan_params, tq.quantize_qhan_params)}[name]
    theirs = dict(_walk(quantize[0](jax_params, 2, 2)))
    ours = dict(_walk(quantize[1](params, 2, 2)))
    assert set(theirs) == {p for p in ours if p[-1] != 'matrix'}
    assert {('la', 'gamma'), ('csa', 'conv3d_kernel'), ('last_conv', 'matrix'),
            ('body_tail', 'scale')} <= set(ours)
    for path, value in theirs.items():
        np.testing.assert_array_equal(ours[path].numpy(), np.asarray(value),
                                      err_msg='/'.join(path))


def _calibrate(module, name, params, x, meta):
    if name == 'han':
        return module.calibrate_han_scales(params, [x], n_resgroups=2, n_resblocks=2,
                                           margin=1.1)
    return module.calibrate_qhan_scales(params, [x], [meta], n_resgroups=2, n_resblocks=2,
                                        margin=1.1)


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_calibrate_scales_matches(bridged, name):
    _, jax_params, _, params = bridged(name)
    x, meta = _inputs(bridged, name, 2)
    theirs = _calibrate(jq, name, jax_params, x, meta)
    ours = _calibrate(tq, name, params, x, meta)
    assert sorted(ours) == sorted(theirs)
    assert {'body_tail', 'last_conv', 'last', 'upsampler.conv_1', 'tail'} <= set(ours)
    for k in theirs:
        assert isinstance(ours[k], np.float32)
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=0, err_msg=k)


def test_calibrate_qhan_scales_refuses_a_count_mismatch(bridged):
    _, _, _, params = bridged('qhan')
    x, meta = _inputs(bridged, 'qhan', 3)
    with pytest.raises(ValueError, match='1 sample batches but 2 metadata'):
        tq.calibrate_qhan_scales(params, [x], [meta, meta], 2, 2)
    with pytest.raises(ValueError, match='no calibration batches'):
        tq.calibrate_han_scales(params, [], 2, 2)


@pytest.mark.parametrize('residual_dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_int8_forward_matches_sisr_tpu(bridged, name, residual_dtype, monkeypatch):
    """The same int8 state (sisr_tpu's, carried across) through both forwards; one CA +
    residual call a block on the f32 branch and the carry: HAN's the RCAB tail, Q-HAN's
    the QRCAB tail with its q_node's gate and no metadata, cast first."""
    _, jax_params, _, _ = bridged(name)
    x, meta = _inputs(bridged, name, 4)
    if name == 'han':
        qp = jq.quantize_han_params(jax_params, 2, 2)
        scales = _calibrate(jq, name, jax_params, x, meta)
    else:
        qp = jq.quantize_qhan_params(jax_params, 2, 2)
        scales = _calibrate(jq, name, jax_params, x, meta)
    x2, meta2 = _inputs(bridged, name, 5)
    if name == 'han':
        theirs = jq.han_int8_forward_static(qp, scales, jnp.asarray(x2), 2, 2,
                                            residual_dtype=residual_dtype,
                                            ca_epilogue='pallas')
    else:
        theirs = jq.qhan_int8_forward_static(qp, scales, jnp.asarray(x2),
                                             jnp.asarray(meta2), 2, 2,
                                             residual_dtype=residual_dtype)
    calls = []

    def spy(y, r, *weights, meta=None, gate=None, cast_first=False):
        calls.append((y.dtype, r.dtype, meta is not None, gate is not None, cast_first))
        return ca.fused_channel_attention_residual(y, r, *weights, meta=meta, gate=gate,
                                                   cast_first=cast_first)

    monkeypatch.setattr(tq, 'fused_channel_attention_residual', spy)
    monkeypatch.setattr(tq, 'fused_channel_attention', None)  # no CA call of its own
    state = int8_state_from_jax(qp, scales)
    with torch.inference_mode():
        if name == 'han':
            ours = tq.han_int8_forward_static(*state, torch.from_numpy(x2), 2, 2,
                                              residual_dtype=residual_dtype)
        else:
            ours = tq.qhan_int8_forward_static(*state, torch.from_numpy(x2),
                                               torch.from_numpy(meta2), 2, 2,
                                               residual_dtype=residual_dtype)
    assert ours.dtype == torch.float32 and ours.shape == (2, 48, 48, 3)
    assert psnr(ours.numpy(), np.asarray(theirs), max_value=1.0) >= 60
    carry = torch.float32 if residual_dtype == 'float32' else torch.bfloat16
    assert calls == [(torch.float32, carry, False, name == 'qhan', name == 'qhan')] * 4


def _assert_metric_rows(keys, ours, theirs):
    for i, key in enumerate(keys):
        bar = BARS[key.split('>')[1]]
        np.testing.assert_allclose(ours[i], theirs[i], atol=bar, rtol=0, err_msg=key)


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_run_eval_fused_int8_matches_sisr_tpu(bridged, name):
    """Each handler calibrates on the first batch (and its prepared metadata) and runs
    its int8 program inside the fused step; the module (and so the CA kernel's
    wrapper) does not run."""
    _, jax_params, _, _ = bridged(name)
    jax_handler, port = _jax_handler(name, jax_params), _port(name, jax_params)
    rng = np.random.RandomState(6)
    batch = {'lr': rng.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8),
             'hr': rng.randint(0, 256, (3, 64, 64, 3)).astype(np.uint8),
             'metadata': rng.rand(3, 10).astype(np.float32)}
    (_, f32), _ = port.run_eval_fused(batch)
    jax_handler.set_int8(True)
    with pytest.warns(UserWarning, match='int8 measured slower'):
        port.set_int8(True)
    (keys, theirs), _ = jax_handler.run_eval_fused(batch)
    launches = ca.fused_channel_attention.launches
    (our_keys, ours), _ = port.run_eval_fused(batch)
    assert ca.fused_channel_attention.launches == launches
    assert our_keys == keys and port._int8_ctx is not None
    program, qparams, scales = port._int8_ctx
    assert 'last_conv' in scales and 'la' in qparams and 'csa' in qparams
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
    from sisr_tpu.evaluation.standard_eval import EvalHub as JaxEvalHub
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
    """sisr_tpu's int8 state carried across: the int8 convs (the fusion convs too) get
    their packed matrix, LAM's and CSAM's f32 entries none; a handler given it runs
    program(x, meta) exactly as the plain function does."""
    _, jax_params, _, _ = bridged(name)
    x, meta = _inputs(bridged, name, 8)
    qp = (jq.quantize_han_params if name == 'han' else jq.quantize_qhan_params)(
        jax_params, 2, 2)
    scales = _calibrate(jq, name, jax_params, x, meta)
    ours, _ = int8_state_from_jax(qp, scales)
    assert 'matrix' in ours['last_conv'] and 'matrix' in ours['last']
    assert set(ours['csa']) == {'gamma', 'conv3d_kernel', 'conv3d_bias'}
    port = _port(name, jax_params)
    with pytest.warns(UserWarning):
        port.set_int8(True)
    port.load_int8_state(*int8_state_from_jax(qp, scales))
    xt = torch.from_numpy(x)
    mt = None if meta is None else torch.from_numpy(meta)
    with torch.inference_mode():
        via_handler = port._int8_ctx[0](xt, mt)
        state = int8_state_from_jax(qp, scales)
        direct = tq.han_int8_forward_static(*state, xt, 2, 2) if name == 'han' else \
            tq.qhan_int8_forward_static(*state, xt, mt, 2, 2)
    torch.testing.assert_close(via_handler, direct, atol=0, rtol=0)
