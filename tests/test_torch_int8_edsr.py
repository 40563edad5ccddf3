"""sisr_tpu_torch's int8 serving of EDSR against sisr_tpu's on the same weights, on the
CPU: quantisation, calibration (with the int16 grid ``residual16``, and the x3
upsampler), the int8 conv of an already quantised input, the int8 forward with each
of the three residual carries on the same int8 state, and the handler's fused eval.

Bars: quantised weights and int32 conv sums bit-identical; calibration scales rtol
1e-5 (f32 conv summation order); the int8 forward >= 60 dB PSNR against sisr_tpu's;
fused metrics within 0.01 dB PSNR and 1e-3 SSIM per image."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.ops import quantization as jq
from sisr_tpu.ops.metrics import psnr
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import quantization as tq
from sisr_tpu_torch.tools.convert_weights import (int8_state_from_jax,
                                                  params_from_state_dict,
                                                  state_dict_from_jax)

EDSR = {'num_features': 32, 'num_blocks': 3}
BARS = {'PSNR': 0.01, 'SSIM': 1e-3}


@pytest.fixture(scope='module')
def bridged():
    """scale -> (sisr_tpu handler, its params as numpy, the port's params in sisr_tpu's
    tree naming, read back from the port's module on the same weights)."""
    cache = {}

    def get(scale=4):
        if scale not in cache:
            jax_handler = jax_define_model('edsr', eval_mode=True, scale=scale, **EDSR)
            jax_handler.init_state(spatial=(16, 16))
            jax_params = jax.tree.map(np.asarray, jax_handler.state.params)
            port = _port(jax_params, scale)
            cache[scale] = (jax_handler, jax_params,
                            params_from_state_dict('edsr', port.module.state_dict()))
        return cache[scale]
    return get


def _port(jax_params, scale=4, **kwargs):
    handler = define_model('edsr', device='cpu', scale=scale, **{**EDSR, **kwargs})
    handler.module.load_state_dict(state_dict_from_jax('edsr', jax_params))
    return handler


def _x(seed, n=2, size=12):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def test_quantize_edsr_params_bit_identical(bridged):
    _, jax_params, params = bridged()
    theirs = dict(_walk(jq.quantize_edsr_params(jax_params)))
    ours = dict(_walk(tq.quantize_edsr_params(params)))
    assert set(theirs) == {p for p in ours if p[-1] != 'matrix'}
    assert ('block_2', 'conv_1', 'matrix') in ours
    for path, value in theirs.items():
        np.testing.assert_array_equal(ours[path].numpy(), np.asarray(value),
                                      err_msg='/'.join(path))


@pytest.mark.parametrize('scale', [4, 3, 2])
def test_calibrate_edsr_scales_matches(bridged, scale):
    """Every conv input's scale and the int16 grid residual16, at x4, x2 and x3 (one
    conv and a x3 shuffle)."""
    _, jax_params, params = bridged(scale)
    batch = _x(0)
    theirs = jq.calibrate_edsr_scales(jax_params, [batch], num_blocks=3, scale=scale,
                                      margin=1.1)
    ours = tq.calibrate_edsr_scales(params, [batch], 3, scale, margin=1.1)
    assert sorted(ours) == sorted(theirs)
    assert {'residual16', 'block_2.conv_1', 'body_tail', 'upsampler.conv_0'} <= set(ours)
    for k in theirs:
        assert isinstance(ours[k], np.float32)
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=0, err_msg=k)


def test_calibration_refuses_no_batches(bridged):
    with pytest.raises(ValueError, match='no calibration batches'):
        tq.calibrate_edsr_scales(bridged()[2], [], 3, 4)


def test_conv_int8_of_a_quantised_input_matches(bridged):
    """sisr_tpu's conv_int8 with x_scale given (the int16 carry's requantised convs):
    the same int32 sums, the dequantised output to 1e-6."""
    _, jax_params, _ = bridged()
    entry = jq.quantize_edsr_params(jax_params)['block_1']['conv_0']
    x_q = np.random.RandomState(1).randint(-127, 128, (2, 9, 7, 32)).astype(np.int8)
    x_scale = np.float32(0.0123)
    theirs = jq.conv_int8(jnp.asarray(x_q), entry['kernel'], entry['scale'],
                          bias=entry['bias'], x_scale=x_scale)
    ours = int8_state_from_jax({'e': entry}, {})[0]['e']
    out = tq.conv_int8(torch.from_numpy(x_q), ours['kernel'], ours['scale'], x_scale,
                       ours['bias'], ours['matrix'])
    np.testing.assert_allclose(out.numpy(), np.asarray(theirs), atol=1e-6, rtol=0)


@pytest.mark.parametrize('scale,residual_dtype', [(4, 'float32'), (4, 'bfloat16'),
                                                  (4, 'int16'), (3, 'float32'),
                                                  (3, 'int16')])
def test_int8_forward_matches_sisr_tpu(bridged, scale, residual_dtype):
    """The same int8 state (sisr_tpu's, carried across) through both forwards, with
    each residual carry."""
    _, jax_params, _ = bridged(scale)
    qp = jq.quantize_edsr_params(jax_params)
    scales = jq.calibrate_edsr_scales(jax_params, [_x(0)], num_blocks=3, scale=scale,
                                      margin=1.1)
    x = _x(2)
    theirs = np.asarray(jq.edsr_int8_forward_static(
        qp, scales, jnp.asarray(x), num_blocks=3, scale=scale, res_scale=0.1,
        residual_dtype=residual_dtype))
    with torch.inference_mode():
        ours = tq.edsr_int8_forward_static(*int8_state_from_jax(qp, scales),
                                           torch.from_numpy(x), 3, scale, 0.1,
                                           residual_dtype=residual_dtype)
    assert ours.dtype == torch.float32 and ours.shape == (2, 12 * scale, 12 * scale, 3)
    assert psnr(ours.numpy(), theirs, max_value=1.0) >= 60


def test_int16_carry_needs_its_grid(bridged):
    _, _, params = bridged()
    qp = tq.quantize_edsr_params(params)
    scales = tq.calibrate_edsr_scales(params, [_x(0)], 3, 4)
    scales.pop('residual16')
    with pytest.raises(KeyError, match='residual16'):
        tq.edsr_int8_forward_static(qp, scales, torch.from_numpy(_x(1)), 3, 4,
                                    residual_dtype='int16')
    with pytest.raises(ValueError, match='residual_dtype'):
        tq.edsr_int8_forward_static(qp, scales, torch.from_numpy(_x(1)), 3, 4,
                                    residual_dtype='float16')


def _assert_metric_rows(keys, ours, theirs):
    for i, key in enumerate(keys):
        bar = BARS[key.split('>')[1]]
        np.testing.assert_allclose(ours[i], theirs[i], atol=bar, rtol=0, err_msg=key)


@pytest.mark.parametrize('residual_dtype', ['bfloat16', 'int16'])
def test_run_eval_fused_int8_matches_sisr_tpu(bridged, residual_dtype, capsys):
    """Each handler calibrates on the first batch and runs its int8 program inside
    the fused step; 'int16' is EDSR's own carry in both (no message)."""
    _, jax_params, _ = bridged()
    jax_handler = jax_define_model('edsr', eval_mode=True, scale=4, **EDSR)
    jax_handler.init_state(spatial=(16, 16))
    jax_handler.state = jax_handler.state.replace(params=jax.tree.map(jnp.asarray,
                                                                      jax_params))
    port = _port(jax_params)
    rng = np.random.RandomState(5)
    batch = {'lr': rng.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8),
             'hr': rng.randint(0, 256, (3, 64, 64, 3)).astype(np.uint8)}
    (_, f32), _ = port.run_eval_fused(batch)
    jax_handler.set_int8(True, residual_dtype=residual_dtype)
    port.set_int8(True, residual_dtype=residual_dtype)
    (keys, theirs), _ = jax_handler.run_eval_fused(batch)
    (our_keys, ours), _ = port.run_eval_fused(batch)
    assert our_keys == keys and port.int8_residual_dtype == residual_dtype
    assert 'EDSR-only' not in capsys.readouterr().out
    assert set(port._int8_ctx[2]) >= {'residual16', 'block_0.conv_0'}
    _assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))
    assert not torch.equal(ours, f32)  # the metrics are of the quantised output


def test_int8_state_from_jax_runs_in_the_handler(bridged):
    """A handler given sisr_tpu's int8 state (residual16 included) runs its int16
    program exactly as the plain function does on that state."""
    _, jax_params, _ = bridged()
    qp = jq.quantize_edsr_params(jax_params)
    scales = jq.calibrate_edsr_scales(jax_params, [_x(0)], num_blocks=3, scale=4,
                                      margin=1.1)
    port = _port(jax_params)
    port.set_int8(True, residual_dtype='int16')
    port.load_int8_state(*int8_state_from_jax(qp, scales))
    x = torch.from_numpy(_x(3))
    with torch.inference_mode():
        via_handler = port._int8_ctx[0](x)
        direct = tq.edsr_int8_forward_static(*int8_state_from_jax(qp, scales), x, 3, 4,
                                             residual_dtype='int16')
    torch.testing.assert_close(via_handler, direct, atol=0, rtol=0)
