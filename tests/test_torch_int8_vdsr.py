"""sisr_tpu_torch's int8 serving of VDSR against sisr_tpu's on the same weights, on the
CPU: quantisation; the int32 sums of the first conv (one input channel: K = 9 padded to
16, one bias per 64 outputs) and of a body conv; calibration on the Y channel of the
pre-upscaled LR (the handler's fused path upscales the RGB LR on the device first, as
sisr_tpu's ``_int8_calibration_input`` does); the int8 forward on the same int8 state;
the handler's int8 fused eval and standard-protocol step; eval_sisr --fused_eval
--int8 end to end, within 1 dB of the bf16 run; the refusal of valid padding.  Model:
VDSR 4 convs of 16 features, and the default 20 x 64 for the sums.

Bars: quantised weights and int32 sums bit-identical; calibration scales rtol 1e-5;
the int8 forward >= 60 dB PSNR against sisr_tpu's; fused and CLI metrics, and each SR
image's PSNR and SSIM against its HR, within 0.01 dB and 1e-3 of sisr_tpu's; the int8
run's mean PSNR within 1 dB of the bf16 run's."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sisr_tpu.ops import quantization as jq
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch.models import handlers
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import quantization as tq
from sisr_tpu_torch.tools.convert_weights import int8_state_from_jax, params_from_state_dict
from test_torch_int8_sftmd import _image_metrics, _walk
from test_torch_srcnn_vdsr import CASES, jax_handler, port_handler
from test_torch_srmd import (BARS, assert_metric_rows, cli_against_sisr_tpu, params_of,
                             read_metrics, uint8_batch)


@pytest.fixture(scope='module')
def bridged():
    """(sisr_tpu handler, its params as numpy, the port's handler, the port's params in
    sisr_tpu's naming) of the 4 x 16 VDSR."""
    jax_h = jax_handler('vdsr', eval_mode=True)
    params = params_of(jax_h)
    port = port_handler('vdsr', params)
    return jax_h, params, port, params_from_state_dict('vdsr', port.module.state_dict())


def y_batch(seed, n=2, size=(12, 12)):
    return np.random.RandomState(seed).rand(n, *size, 1).astype(np.float32)


def test_quantize_params_bit_identical(bridged):
    _, jax_params, _, params = bridged
    theirs = dict(_walk(jq.quantize_vdsr_params(jax_params)))
    ours = dict(_walk(tq.quantize_vdsr_params(params)))
    assert set(theirs) == {p for p in ours if p[-1] != 'matrix'}
    assert tuple(ours['conv_0', 'matrix'].shape) == (16, 16)  # K = 9 padded to 16
    assert tuple(ours['conv_3', 'matrix'].shape) == (144, 8)  # one output padded to 8
    for path, value in theirs.items():
        np.testing.assert_array_equal(ours[path].numpy(), np.asarray(value),
                                      err_msg='/'.join(path))


@pytest.mark.parametrize('conv', ['conv_0', 'conv_1', 'conv_19'])
def test_int32_sums_match(conv):
    """The int32 sums of the default VDSR's first conv (1 -> 64: K = 9), a body conv
    (64 -> 64) and the last (64 -> 1), bit-identical to sisr_tpu's conv."""
    params = jax.tree.map(np.asarray, jax_handler('vdsr', kernel_pattern=None,
                                                  channel_pattern=None).state.params)
    entry = jq.quantize_vdsr_params({conv: params[conv]})[conv]
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
    sums = tq.conv_int8_accumulate(tq.quantize_activations_static(torch.from_numpy(x),
                                                                  x_scale),
                                   ours_entry['kernel'], ours_entry['matrix'])
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(), theirs)


def test_calibrate_scales_matches(bridged):
    _, jax_params, _, params = bridged
    x = y_batch(2, size=(13, 15))
    theirs = jq.calibrate_vdsr_scales(jax_params, [x], margin=1.1)
    ours = tq.calibrate_vdsr_scales(params, [x], margin=1.1)
    assert sorted(ours) == sorted(theirs) == ['conv_%d' % i for i in range(4)]
    for k in theirs:
        assert isinstance(ours[k], np.float32)
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=0, err_msg=k)
    with pytest.raises(ValueError, match='no calibration batches'):
        tq.calibrate_vdsr_scales(params, [])


def test_int8_forward_matches_sisr_tpu(bridged):
    """sisr_tpu's int8 state carried across, through both forwards on an odd-sized Y
    batch."""
    _, jax_params, _, _ = bridged
    qp = jq.quantize_vdsr_params(jax_params)
    scales = jq.calibrate_vdsr_scales(jax_params, [y_batch(4)], margin=1.1)
    x = y_batch(5, size=(13, 15))
    theirs = np.asarray(jq.vdsr_int8_forward_static(qp, scales, jnp.asarray(x)))
    with torch.inference_mode():
        ours = tq.vdsr_int8_forward_static(*int8_state_from_jax(qp, scales),
                                           torch.from_numpy(x))
    assert ours.dtype == torch.float32 and ours.shape == (2, 13, 15, 1)
    mse = float(np.mean((ours.numpy() - theirs) ** 2))
    assert 10 * np.log10(1.0 / max(mse, 1e-20)) >= 60


def test_calibration_takes_the_upscaled_y(bridged, monkeypatch):
    """The fused path calibrates on the Y channel of the LR's device bicubic at HR size
    (N, 32, 32, 1), the image the program then takes: sisr_tpu's calibration input."""
    jax_h, jax_params, _, _ = bridged
    port = port_handler('vdsr', jax_params)
    seen = []
    ensure = port._ensure_int8_ctx
    monkeypatch.setattr(port, '_ensure_int8_ctx',
                        lambda x, meta=None: seen.append(x) or ensure(x, meta))
    port.set_int8(True)
    batch = uint8_batch(3, n=2, lr=8)
    port.run_eval_fused(batch)
    theirs = np.asarray(jax_h._int8_calibration_input(
        jnp.asarray(batch['lr'].astype(np.float32) / 255.0), hr_hw=(32, 32)))
    assert len(seen) == 1 and tuple(seen[0].shape) == (2, 32, 32, 1)
    np.testing.assert_allclose(seen[0].numpy(), theirs, atol=2e-6, rtol=0)
    expected = tq.calibrate_vdsr_scales(params_from_state_dict('vdsr',
                                                               port.module.state_dict()),
                                        [seen[0]], margin=1.1)
    assert port._int8_ctx[2] == expected


def test_handler_int8_paths_match_sisr_tpu(bridged):
    """The handler calibrates on its first batch and runs the int8 program inside the
    fused step (the module does not run) and in the standard protocol's run_eval (the Y
    channel already at HR size); metrics within the bars of sisr_tpu's."""
    _, jax_params, _, _ = bridged
    fresh_jax = jax_handler('vdsr', params=jax_params, eval_mode=True)
    port = port_handler('vdsr', jax_params)
    batch = uint8_batch(6, lr=8)
    (_, f32), _ = port.run_eval_fused(batch)
    fresh_jax.set_int8(True)
    port.set_int8(True)
    (keys, theirs), _ = fresh_jax.run_eval_fused(batch)
    forward = port.module.forward
    port.module.forward = None  # the module must not run
    try:
        (our_keys, ours), _ = port.run_eval_fused(batch)
    finally:
        port.module.forward = forward
    assert our_keys == keys and port._int8_ctx is not None
    assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))
    assert not torch.equal(ours, f32)
    fresh_jax.set_int8(True)  # recalibrate both on the standard protocol's Y batch
    port.set_int8(True)
    rng = np.random.RandomState(10)
    y = rng.rand(1, 30, 26, 1).astype(np.float32)
    hr = np.clip(y + 0.05 * rng.randn(1, 30, 26, 1), 0, 1).astype(np.float32)
    ours_sr = port.run_eval(y, hr)[0]
    theirs_sr = fresh_jax.run_eval(y, hr)[0]
    for (p_ours, s_ours), (p_theirs, s_theirs) in zip(_image_metrics(ours_sr, hr),
                                                      _image_metrics(theirs_sr, hr)):
        assert abs(p_ours - p_theirs) <= BARS['PSNR'] and abs(s_ours - s_theirs) <= BARS['SSIM']


def test_cli_fused_eval_int8_matches_sisr_tpu_and_bf16(tmp_path, bridged):
    """eval_sisr --fused_eval --int8 --no-gpu of a bf16 experiment against sisr_tpu's
    EvalHub with int8 on the same weights; its mean PSNR within 1 dB of the port's bf16
    run of that experiment."""
    jax_h, _, port, _ = bridged
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 4, lr_size=16)
    cli_against_sisr_tpu(tmp_path, jax_h, port, 'vdsr', {**CASES['vdsr'][1], 'dtype': 'bf16'},
                         lr_dir, hr_dir, True, 4, int8=True)
    int8 = read_metrics(str(tmp_path / 'out'), 'port')
    from sisr_tpu_torch import net_eval
    net_eval.eval_run.main(
        args=['--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'torch_exp', '0',
              '--model_loc', str(tmp_path / 'Results'), '--out_loc', str(tmp_path / 'out'),
              '--results_name', 'bf16', '-m', 'PSNR', '-m', 'SSIM', '--full_directory',
              '--no_image_comparison', '--no-gpu', '--fused_eval', '--batch_size', '2'],
        standalone_mode=False)
    bf16 = read_metrics(str(tmp_path / 'out'), 'bf16')
    gap = float(np.mean(int8[('torch_exp', 'PSNR')]) - np.mean(bf16[('torch_exp', 'PSNR')]))
    assert abs(gap) <= 1.0


def test_int8_refuses_valid_padding():
    """int8 VDSR takes padding='same' only, as sisr_tpu's (raised at calibration)."""
    handler = define_model('vdsr', device='cpu', padding='valid', **CASES['vdsr'][1])
    handler.set_int8(True)
    with pytest.raises(RuntimeError, match="int8 VDSR supports padding='same' only"):
        handler.run_eval_fused(uint8_batch(7, lr=8))


def test_set_int8_warns_with_the_cards_ratio():
    """int8 VDSR was measured slower than bf16 on the card (the whole chain's im2col
    gathers at HR size): set_int8 warns with that ratio and the card's name and power
    limit, and engages."""
    handler = define_model('vdsr', device='cpu', **CASES['vdsr'][1])
    ratio = handlers.INT8_MEASURED_SLOWER['vdsr']
    assert 'vdsr' in handlers._INT8_PROGRAMS and re.fullmatch(r'\d\.\d\dx', ratio)
    with pytest.warns(UserWarning) as record:
        handler.set_int8(True)
    assert str(record[0].message).startswith(
        'int8 measured slower than bf16 for the vdsr family on an NVIDIA H100 80GB HBM3, '
        '700.00 W (%s bf16 img/s' % ratio)
    assert handler.int8_mode
