"""sisr_tpu_torch's dynamic-scale int8 conv against sisr_tpu's on the CPU: the
per-tensor activation quantisation, ``conv_int8`` without ``x_scale`` (its int32 sums
and its output), and the dynamic ``edsr_int8_forward`` on the same quantised EDSR
(sisr_tpu's tree carried across), at x4 and x3.

Bars: int8 maps, scales and int32 sums equal; outputs <= 1e-5 (the same f32
dequantisation of the same sums)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sisr_tpu.ops import quantization as jq
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import quantization as tq
from sisr_tpu_torch.tools.convert_weights import int8_state_from_jax, params_from_state_dict

EDSR = {'num_features': 16, 'num_blocks': 1}


def _x(seed, shape=(2, 12, 10, 16), scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize('scale', [1.0, 1e-3])
def test_quantize_activations_matches(scale):
    x = _x(0, scale=scale)
    q, s = tq.quantize_activations(torch.from_numpy(x))
    jq_, js = jq.quantize_activations(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dim() == 0 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    assert s.item() == float(js)


def test_dynamic_conv_int8_matches():
    rng = np.random.RandomState(2)
    kernel = (rng.randn(3, 3, 16, 24) * 0.2).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    qk, ws = jq.quantize_kernel_int8(jnp.asarray(kernel))
    x = _x(3)
    theirs = np.asarray(jq.conv_int8(jnp.asarray(x), qk, ws, bias=jnp.asarray(bias)))
    entry = int8_state_from_jax({'e': {'kernel': qk, 'scale': ws, 'bias': bias}}, {})[0]['e']
    ours = tq.conv_int8(torch.from_numpy(x), entry['kernel'], entry['scale'],
                        bias=entry['bias'], matrix=entry['matrix'])
    assert ours.dtype == torch.float32 and ours.shape == (2, 12, 10, 24)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5, rtol=0)
    # the int32 sums of the same quantised input
    x_q, _ = jq.quantize_activations(jnp.asarray(x))
    dn = jax.lax.conv_dimension_numbers(x_q.shape, qk.shape, ('NHWC', 'HWIO', 'NHWC'))
    sums = jax.lax.conv_general_dilated(x_q, qk, (1, 1), 'SAME', dimension_numbers=dn,
                                        preferred_element_type=jnp.int32)
    acc = tq.conv_int8_accumulate(torch.from_numpy(np.array(x_q)), entry['kernel'],
                                  entry['matrix'])
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(sums))


@pytest.mark.parametrize('scale', [4, 3])
def test_dynamic_edsr_int8_forward_matches(scale):
    # the port's random EDSR in sisr_tpu's tree naming, quantised by sisr_tpu
    handler = define_model('edsr', device='cpu', scale=scale, **EDSR)
    params = params_from_state_dict('edsr', handler.module.state_dict())
    qp = jq.quantize_edsr_params(jax.tree.map(lambda t: t.numpy(), params))
    x = np.random.RandomState(5).rand(2, 9, 11, 3).astype(np.float32)
    # op by op, as sisr_tpu's tests run it: under jit XLA may rewrite the division by
    # the dynamic scale, and an int8 rounding then moves
    theirs = np.asarray(jq.edsr_int8_forward(qp, jnp.asarray(x), num_blocks=1,
                                             scale=scale, res_scale=0.1))
    with torch.inference_mode():
        ours = tq.edsr_int8_forward(int8_state_from_jax(qp, {})[0], torch.from_numpy(x),
                                    num_blocks=1, scale=scale, res_scale=0.1)
    assert ours.shape == (2, 9 * scale, 11 * scale, 3)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5, rtol=0)
