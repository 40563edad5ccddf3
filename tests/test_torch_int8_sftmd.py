"""sisr_tpu_torch's int8 serving of SFTMD and SRMD against sisr_tpu's on the same
weights, on the CPU: quantisation; the int32 sums of SRMD's first conv (13 input
channels: K = 117 padded to 120) and of SFTMD's 9 x 9 ``conv_output``, gathered whole
and in bands of rows; calibration (SFTMD on the handler-prepared metadata, SRMD on the
input with its maps concatenated); the int8 forward on the same int8 state; the
handler's int8 fused eval and standard-protocol step (calibrated on the first batch);
eval_sisr --fused_eval --int8 end to end; the refusal of int8 with SFTMD's
``concat_strategy``.  SFTMD's cases are sisr_tpu's own int8 cases
(tests/test_quantization.py: standard, standard with q-injection, concat, weak).

Bars: quantised weights and int32 sums bit-identical (the banded gather bit-equal to
the whole one); calibration scales rtol 1e-5; the int8 forward >= 60 dB PSNR against
sisr_tpu's; fused and CLI metrics, and each SR image's PSNR and SSIM against its HR,
within 0.01 dB and 1e-3."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sisr_tpu.ops import quantization as jq
from sisr_tpu.ops.metrics import psnr, structural_similarity
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch.models import handlers
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import channel_attention as ca
from sisr_tpu_torch.ops import quantization as tq
from sisr_tpu_torch.tools.convert_weights import int8_state_from_jax, params_from_state_dict
from test_torch_sftmd import CASES as SFTMD_CASES
from test_torch_srmd import (BARS, FAMILIES as SRMD_FAMILIES, assert_metric_rows,
                             cli_against_sisr_tpu, jax_handler, params_of, port_handler,
                             uint8_batch)

FAMILIES = {'srmd': SRMD_FAMILIES['srmd'],
            **{case: SFTMD_CASES[case] for case in ('standard', 'q_injection', 'concat',
                                                    'weak')}}


def n_meta(case):
    return 1 if FAMILIES[case][1]['metadata'] == ['qpi'] else 10


def scale_of(case):
    return FAMILIES[case][1]['scale']


def config(case):
    """The structure arguments of sisr_tpu's SFTMD int8 functions."""
    cfg = FAMILIES[case][1]
    return dict(num_blocks=2, scale=cfg['scale'],
                sft_type=cfg.get('sft_type') or cfg.get('SFT_type') or 'standard')


@pytest.fixture(scope='module')
def bridged():
    """case -> (sisr_tpu handler, its params as numpy, the port's handler on the same
    weights, the port's params in sisr_tpu's tree naming)."""
    cache = {}

    def get(case):
        if case not in cache:
            jax_h = jax_handler(case, families=FAMILIES)
            params = params_of(jax_h)
            port = port_handler(case, params, families=FAMILIES)
            cache[case] = (jax_h, params, port,
                           params_from_state_dict(FAMILIES[case][0], port.module.state_dict()))
        return cache[case]
    return get


def _inputs(bridged, case, seed, n=2, size=(12, 12)):
    """The f32 input the int8 program takes (SRMD's with its maps concatenated, as each
    handler's _prep_batch gives it: equal) and the metadata it takes (None for SRMD)."""
    jax_h, _, port, _ = bridged(case)
    rng = np.random.RandomState(seed)
    x = rng.rand(n, *size, 3).astype(np.float32)
    meta = rng.rand(n, n_meta(case)).astype(np.float32)
    xj, _, mj = jax_h._prep_batch({'lr': jnp.asarray(x), 'metadata': jnp.asarray(meta)})
    if case == 'srmd':
        xt, _, _ = port._prep_batch({'lr': torch.from_numpy(x),
                                     'metadata': torch.from_numpy(meta)})
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        return np.asarray(xj), None
    return x, np.asarray(mj)


def _quantize(module, case, params):
    if case == 'srmd':
        return module.quantize_srmd_params(params)
    return module.quantize_sftmd_params(params, 2, scale_of(case))


def _calibrate(module, case, params, x, meta):
    if case == 'srmd':
        return module.calibrate_srmd_scales(params, [x], 4, margin=1.1)
    return module.calibrate_sftmd_scales(params, [x], [meta], margin=1.1, **config(case))


def _forward(module, case, qp, scales, x, meta):
    if case == 'srmd':
        return module.srmd_int8_forward_static(qp, scales, x, 4)
    return module.sftmd_int8_forward_static(qp, scales, x, meta, **config(case))


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize('case', sorted(FAMILIES))
def test_quantize_params_bit_identical(bridged, case):
    _, jax_params, _, params = bridged(case)
    theirs = dict(_walk(_quantize(jq, case, jax_params)))
    ours = dict(_walk(_quantize(tq, case, params)))
    assert set(theirs) == {p for p in ours if p[-1] != 'matrix'}
    if case == 'srmd':
        assert {('conv_0', 'matrix'), ('conv_tail', 'scale')} <= set(ours)
        assert tuple(ours['conv_0', 'matrix'].shape) == (120, 16)  # K = 117 padded
    else:
        assert {('conv_output', 'matrix'), ('sft_residual_2', 'conv2', 'scale')} <= set(ours)
        assert (('sft', 'sft_module', 'mul_conv1', 'kernel') in ours) == (case in (
            'standard', 'q_injection'))
        assert (('sft_residual_1', 'q_2', 'fc_1', 'kernel') in ours) == (case == 'q_injection')
    for path, value in theirs.items():
        np.testing.assert_array_equal(ours[path].numpy(), np.asarray(value),
                                      err_msg='/'.join(path))


@pytest.mark.parametrize('layer', [('srmd', 'conv_0'), ('standard', 'conv_output'),
                                   ('standard', 'sft_residual_1', 'conv1')])
def test_int32_sums_match_whole_and_in_bands(bridged, layer, monkeypatch):
    """The int32 sums of SRMD's first conv (K = 117 padded to 120), SFTMD's 9 x 9
    conv_output (K = 1296) and a block conv, bit-identical to sisr_tpu's; the gather cut
    into bands of 1, 2 and 5 rows gives the same sums."""
    case, names = layer[0], layer[1:]
    _, jax_params, _, _ = bridged(case)
    entry = _quantize(jq, case, jax_params)
    for k in names:
        entry = entry[k]
    cin = entry['kernel'].shape[2]
    x = (np.random.RandomState(1).randn(2, 13, 11, cin) * 0.5).astype(np.float32)
    x_scale = np.float32(0.01)
    x_q = jnp.clip(jnp.round(jnp.asarray(x) / x_scale), -127, 127).astype(jnp.int8)
    dn = jax.lax.conv_dimension_numbers(x_q.shape, entry['kernel'].shape,
                                        ('NHWC', 'HWIO', 'NHWC'))
    theirs = np.asarray(jax.lax.conv_general_dilated(x_q, entry['kernel'], (1, 1), 'SAME',
                                                     dimension_numbers=dn,
                                                     preferred_element_type=jnp.int32))
    ours_entry = int8_state_from_jax({'e': entry}, {})[0]['e']
    x_q_t = tq.quantize_activations_static(torch.from_numpy(x), x_scale)
    whole = tq.conv_int8_accumulate(x_q_t, ours_entry['kernel'], ours_entry['matrix'])
    assert whole.dtype == torch.int32
    np.testing.assert_array_equal(whole.numpy(), theirs)
    k_cols = ours_entry['matrix'].shape[0]
    for rows in (1, 2, 5):
        monkeypatch.setattr(tq, 'IM2COL_BAND_BYTES', rows * 2 * 11 * k_cols)
        assert tq.band_rows(2, 13, 11, k_cols) == rows
        banded = tq.conv_int8_accumulate(x_q_t, ours_entry['kernel'], ours_entry['matrix'])
        assert torch.equal(banded, whole)


def test_the_gather_is_bounded_at_hr_size(monkeypatch):
    """SFTMD's 9 x 9 conv_output at the fused shape (8 x 512^2, 64 features: 5184 bytes
    a row, 10.9 GB whole) and on a DIV2K image (2040 x 1356: 14.3 GB) is gathered in
    bands of at most IM2COL_BAND_BYTES; RCAN's 3 x 3 tail at 8 x 512^2 (1.2 GB) is
    gathered in two bands, its body's convs at 8 x 128^2 whole."""
    budget = tq.IM2COL_BAND_BYTES
    for (n, h, w, k), bands in (((8, 512, 512, 5184), 11), ((1, 1356, 2040, 5184), 14),
                                ((8, 512, 512, 576), 2), ((8, 128, 128, 576), 1)):
        rows = tq.band_rows(n, h, w, k)
        assert rows * n * w * k <= budget or rows == 1
        assert -(-h // rows) == bands, (n, h, w, k)
    seen = []
    im2col = tq._im2col
    monkeypatch.setattr(tq, '_im2col', lambda *a: seen.append(im2col(*a)) or seen[-1])
    q = torch.randint(-127, 128, (9, 9, 4, 3), dtype=torch.int8)
    x = torch.randint(-127, 128, (1, 20, 7, 4), dtype=torch.int8)
    whole = tq.conv_int8_accumulate(x, q)
    monkeypatch.setattr(tq, 'IM2COL_BAND_BYTES', 3 * 7 * 328)
    assert torch.equal(whole, tq.conv_int8_accumulate(x, q))
    assert [a.shape[0] for a in seen] == [140] + [21] * 6 + [14]


@pytest.mark.parametrize('case', sorted(FAMILIES))
def test_calibrate_scales_matches(bridged, case):
    _, jax_params, _, params = bridged(case)
    x, meta = _inputs(bridged, case, 2, size=(13, 15))
    theirs = _calibrate(jq, case, jax_params, x, meta)
    ours = _calibrate(tq, case, params, x, meta)
    assert sorted(ours) == sorted(theirs)
    assert ({'conv_0', 'conv_tail'} if case == 'srmd' else
            {'conv1', 'sft_residual_2.conv2', 'conv_mid', 'conv_output'}) <= set(ours)
    for k in theirs:
        assert isinstance(ours[k], np.float32)
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=0, err_msg=k)


def test_calibrate_sftmd_scales_refuses_a_count_mismatch(bridged):
    _, _, _, params = bridged('standard')
    x, meta = _inputs(bridged, 'standard', 3)
    with pytest.raises(ValueError, match='1 sample batches but 2 metadata'):
        tq.calibrate_sftmd_scales(params, [x], [meta, meta], **config('standard'))
    with pytest.raises(ValueError, match='no calibration batches'):
        tq.calibrate_srmd_scales(params, [], 4)


@pytest.mark.parametrize('case', sorted(FAMILIES))
def test_int8_forward_matches_sisr_tpu(bridged, case, monkeypatch):
    """sisr_tpu's int8 state carried across, through both forwards on an odd-sized
    batch (SFTMD's SFT branches in bf16, its gates in f32); neither CA op is called."""
    _, jax_params, _, _ = bridged(case)
    x, meta = _inputs(bridged, case, 4)
    qp = _quantize(jq, case, jax_params)
    scales = _calibrate(jq, case, jax_params, x, meta)
    x2, meta2 = _inputs(bridged, case, 5, size=(13, 15))
    theirs = np.asarray(_forward(jq, case, qp, scales, jnp.asarray(x2),
                                 None if meta2 is None else jnp.asarray(meta2)))
    monkeypatch.setattr(tq, 'fused_channel_attention_residual', None)
    monkeypatch.setattr(tq, 'fused_channel_attention', None)
    state = int8_state_from_jax(qp, scales)
    with torch.inference_mode():
        ours = _forward(tq, case, *state, torch.from_numpy(x2),
                        None if meta2 is None else torch.from_numpy(meta2))
    s = scale_of(case)
    assert ours.dtype == torch.float32 and ours.shape == (2, 13 * s, 15 * s, 3)
    assert psnr(ours.numpy(), theirs, max_value=1.0) >= 60


def _image_metrics(sr, hr):
    return [(psnr(a, b, max_value=1.0),
             structural_similarity(a, b, data_range=1.0, multichannel=True))
            for a, b in zip(sr, hr)]


@pytest.mark.parametrize('case', ['srmd', 'standard', 'q_injection'])
def test_handler_int8_paths_match_sisr_tpu(bridged, case):
    """Each handler calibrates on its first batch (and its prepared metadata) and runs
    its int8 program: inside the fused step (the module does not run, no CA launch),
    and in the standard protocol's run_eval; metrics within the bars of sisr_tpu's."""
    jax_h, jax_params, _, _ = bridged(case)
    fresh_jax = jax_handler(case, params=jax_params, families=FAMILIES)
    port = port_handler(case, jax_params, families=FAMILIES)
    batch = uint8_batch(6, n_meta=n_meta(case))
    (_, f32), _ = port.run_eval_fused(batch)
    fresh_jax.set_int8(True)
    port.set_int8(True)
    (keys, theirs), _ = fresh_jax.run_eval_fused(batch)
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
    assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))
    assert not torch.equal(ours, f32)
    rng = np.random.RandomState(10)
    lr = rng.rand(1, 15, 13, 3).astype(np.float32)
    hr = np.clip(np.repeat(np.repeat(lr, 4, 1), 4, 2) + 0.05 * rng.randn(1, 60, 52, 3),
                 0, 1).astype(np.float32)
    meta = rng.rand(1, n_meta(case)).astype(np.float32)
    ours_sr = port.run_eval(lr, hr, metadata=meta)[0]
    theirs_sr = fresh_jax.run_eval(lr, hr, metadata=meta)[0]
    for (p_ours, s_ours), (p_theirs, s_theirs) in zip(_image_metrics(ours_sr, hr),
                                                      _image_metrics(theirs_sr, hr)):
        assert abs(p_ours - p_theirs) <= BARS['PSNR'] and abs(s_ours - s_theirs) <= BARS['SSIM']


@pytest.mark.parametrize('case', ['srmd', 'standard'])
def test_cli_fused_eval_int8_matches_sisr_tpu(tmp_path, bridged, case):
    """eval_sisr --fused_eval --int8 --no-gpu against sisr_tpu's EvalHub with int8 on
    the same weights."""
    jax_h, _, port, _ = bridged(case)
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 4, lr_size=16, metadata_cols=10)
    cli_against_sisr_tpu(tmp_path, jax_h, port, FAMILIES[case][0], FAMILIES[case][1],
                         lr_dir, hr_dir, True, 4, int8=True)


def test_int8_refuses_concat_strategy():
    """int8 SFTMD with concat_strategy raises at calibration, with sisr_tpu's message."""
    handler = define_model('sftmd', device='cpu', **SFTMD_CASES['concat_strategy'][1])
    handler.set_metadata_keys(['blur_kernel'] * 10)
    handler.set_int8(True)
    batch = uint8_batch(7)
    with pytest.raises(RuntimeError, match='int8 SFTMD does not support concat_strategy'):
        handler.run_eval_fused(batch)
    with pytest.raises(RuntimeError, match='concat_strategy'):
        handler.run_eval(batch['lr'][:1] / 255.0, metadata=batch['metadata'][:1])


@pytest.mark.parametrize('name', ['srmd', 'sftmd'])
def test_set_int8_warns_with_the_cards_ratio(name):
    """SRMD and SFTMD were measured slower in int8 than in bf16 on the card: set_int8
    warns with that ratio, the card's name and power limit, never sisr_tpu's TPU
    figure ('0.83x bf16' for SFTMD)."""
    cfg = FAMILIES['srmd' if name == 'srmd' else 'standard'][1]
    handler = define_model(name, device='cpu', **cfg)
    ratio = handlers.INT8_MEASURED_SLOWER[name]
    assert name in handlers._INT8_PROGRAMS and re.fullmatch(r'\d\.\d\dx', ratio)
    with pytest.warns(UserWarning) as record:
        handler.set_int8(True)
    message = str(record[0].message)
    assert message.startswith('int8 measured slower than bf16 for the %s family on an '
                              'NVIDIA H100 80GB HBM3, 700.00 W (%s bf16 img/s' % (name, ratio))
    assert not re.search(r'v5e|v4|TPU|0\.83x', message) and handler.int8_mode
