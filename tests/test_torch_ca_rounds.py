"""The rounds route of the channel attention and the int8 QRCAB tail in one call, on
the CPU: the CA op's route and plan (on chip, in rounds, three passes) as a table and
as properties, the rounds layout counting the meta values and no r; the CA + residual
op with ``meta``, ``gate`` and ``cast_first`` (its plain version, its argument
checks, its grads under autograd, and the cast-first tail against sisr_tpu's QRCAB
tail in jnp); and ``qrcan_int8_forward_static`` bit-equal to the two-step tail it
replaces (the CA op, then the cast and the add as plain ops) in every QCALayer style,
with and without pa_node and q_node.  The kernel itself is tested on the card by
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from sisr_tpu.ops import quantization as jq
from sisr_tpu_torch.models import q_layers
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import channel_attention as ca
from sisr_tpu_torch.ops import quantization as tq
from sisr_tpu_torch.tools.convert_weights import params_from_state_dict

H100 = {'sm_count': 132, 'smem_optin': 232448}  # SMs, opt-in shared memory per block
MAIN = (8, 128 * 128, 64, 4)  # n, H * W, C, Cr of the 128^2 eval maps


@pytest.mark.parametrize('n,hw,c,cr,itemsize,aligned,m,expect', [
    # int8 Q-RCAN's f32 map with its 10 blur-kernel values: 2 rounds of 4 images, 33
    # blocks of 497 pixels (127 KB slabs of x, no r)
    (*MAIN, 4, True, 10, ('rounds', (2, 4, 33, 497, 135440))),
    (*MAIN, 4, True, 0, ('rounds', (2, 4, 33, 497, 135232))),   # the f32 eval's map
    (*MAIN, 2, True, 10, ('onchip', (16, 1024, 143376))),       # bf16: on chip at once
    (*MAIN, 2, True, 0, ('onchip', (16, 1024, 143168))),
    (7, 128 * 128, 64, 4, 4, True, 10, ('rounds', (2, 4, 33, 497, 135440))),  # 4 + 3
    (200, 4 * 4, 64, 4, 4, True, 0, ('rounds', (2, 100, 1, 16, 12096))),  # > 132 images
    (8, 64 * 64, 64, 4, 4, True, 0, ('onchip', (16, 256, 73536))),  # the training map
    # one image: 508 KB slabs fit no round, so it streams (876 of 1986 pixels on chip)
    (1, 512 * 512, 64, 4, 4, True, 0, ('stream', (1, 132, 1986, 876, 232272))),
    (1, 512 * 512, 64, 4, 2, True, 0, ('stream', (1, 132, 1986, 1721, 232400))),
    (1, 7 * 5, 20, 5, 2, True, 0, ('three_pass', None)),      # 40-byte pixels
    (*MAIN, 4, False, 0, ('three_pass', None)),                # misaligned x
])
def test_ca_plan(n, hw, c, cr, itemsize, aligned, m, expect):
    assert ca.ca_plan(n, hw, c, cr, itemsize, aligned, m=m, **H100) == expect


@pytest.mark.parametrize('m,r_itemsize,expect', [
    (0, 0, 135232), (10, 0, 135440), (20, 0, 135632),  # the CA: no slab of r
    (0, 2, 198848), (10, 2, 199056), (20, 2, 199248),  # the tail with a bf16 carry
])
def test_rounds_layout_counts_meta_and_no_r(m, r_itemsize, expect):
    """M meta values take M rows of w1 and M floats beside pooled (M * (Cr + 1)
    floats, to a 16-byte boundary); no r takes no bytes of r."""
    assert ca.res_onchip_smem_bytes(497, 64, 4, 4, r_itemsize, m) == expect


@pytest.mark.parametrize('n,hw,c,cr,x_itemsize,r_itemsize,expect', [
    (8, 128 * 128, 64, 4, 4, 2, (2, 4, 33, 497, 198848)),   # int8 RCAN's main path
    (8, 128 * 128, 64, 4, 4, 4, (3, 3, 44, 373, 198976)),
    (8, 128 * 128, 64, 4, 2, 2, (2, 4, 33, 497, 139328)),
    (3, 37 * 29, 64, 4, 4, 2, (1, 3, 43, 25, 17600)),
    (200, 4 * 4, 64, 4, 4, 2, (2, 100, 1, 16, 14144)),
    (1, 512 * 512, 64, 4, 4, 2, None),
])
def test_res_onchip_plan_without_meta_is_unchanged(n, hw, c, cr, x_itemsize, r_itemsize,
                                                   expect):
    """m = 0, given or not, plans the CA + residual's cases as before meta counted."""
    for kwargs in ({}, {'m': 0}):
        assert ca.res_onchip_plan(n, hw, c, cr, x_itemsize, r_itemsize, True, **H100,
                                  **kwargs) == expect


@pytest.mark.parametrize('n,hw,m', [(8, 128 * 128, 10), (7, 128 * 128, 0), (10, 50000, 10),
                                    (200, 16, 0), (133, 9, 10), (3, 1000, 20)])
def test_ca_rounds_cover_each_pixel_once(n, hw, m):
    """Every (image, pixel) of an f32 map owned by exactly one (round, block)."""
    plan = ca.res_onchip_plan(n, hw, 64, 4, 4, 0, True, m=m, **H100)
    rounds, images, blocks, slab, _ = plan
    owners = np.zeros((n, hw), np.int64)
    for k in range(rounds):
        for i in range(images):
            if k * images + i < n:
                for s in range(blocks):
                    owners[k * images + i, s * slab:min(hw, (s + 1) * slab)] += 1
    assert np.array_equal(owners, np.ones((n, hw), np.int64))


@given(n=st.integers(1, 300), hw=st.integers(1, 300000),
       c=st.sampled_from([8, 16, 32, 64, 128]), itemsize=st.sampled_from([2, 4]),
       m=st.sampled_from([0, 10, 20]))
@settings(max_examples=200, deadline=None, derandomize=True)
def test_ca_rounds_plan_fewest_rounds_no_empty_block_within_limit(n, hw, c, itemsize, m):
    cr = max(1, c // 16)
    plan = ca.res_onchip_plan(n, hw, c, cr, itemsize, 0, True, m=m, **H100)

    def fits(images):
        return images <= H100['sm_count'] and ca.res_onchip_smem_bytes(
            -(-hw // (H100['sm_count'] // images)), c, cr, itemsize, 0, m) <= H100['smem_optin']

    if plan is None:
        assert not fits(1)
        return
    rounds, images, blocks, slab, smem = plan
    assert rounds == -(-n // images) and (rounds - 1) * images < n <= rounds * images
    assert (blocks - 1) * slab < hw <= blocks * slab  # each pixel once, no empty block
    assert images * blocks <= H100['sm_count']
    assert smem == ca.res_onchip_smem_bytes(slab, c, cr, itemsize, 0, m)
    assert smem <= H100['smem_optin'] and fits(images)
    assert rounds == 1 or not fits(-(-n // (rounds - 1)))  # one round fewer does not fit
    route, _ = ca.ca_plan(n, hw, c, cr, itemsize, True, m=m, **H100)
    assert route in ('onchip', 'rounds')


# --- the CA + residual op with meta, gate and cast_first -----------------------------------
def _tail_inputs(x_dtype, r_dtype, m=10, with_gate=True, seed=0, shape=(2, 6, 5, 32)):
    """x (a signed conv output), r (the carry), w1 (C + M, Cr) as a transposed view,
    b1, w2, b2, meta (N, M) or None, gate (N, C) or None."""
    rng = np.random.RandomState(seed)
    n, c = shape[0], shape[-1]
    cr = c // 4
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 2).to(x_dtype)
    r = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(r_dtype)
    w1 = torch.from_numpy(rng.randn(cr, c + m).astype(np.float32) * 0.1).t()
    w2 = torch.from_numpy(rng.randn(cr, c).astype(np.float32) * 0.1)
    b1, b2 = (torch.from_numpy(rng.randn(k).astype(np.float32) * 0.1) for k in (cr, c))
    meta = torch.from_numpy(rng.rand(n, m).astype(np.float32)) if m else None
    gate = torch.from_numpy(rng.rand(n, c).astype(np.float32)) if with_gate else None
    return (x, r, w1, b1, w2, b2), {'meta': meta, 'gate': gate}


@pytest.mark.parametrize('x_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('r_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('m,with_gate', [(10, True), (10, False), (0, True), (0, False)])
def test_cast_first_is_the_ca_then_cast_then_add(x_dtype, r_dtype, m, with_gate):
    """With cast_first the op is, bit for bit, the CA op's output cast to r's type
    and added to r in r's type; the output has r's type."""
    (x, r, *weights), extra = _tail_inputs(x_dtype, r_dtype, m, with_gate, seed=1)
    launches = ca.fused_channel_attention_residual.launches
    ours = ca.fused_channel_attention_residual(x, r, *weights, cast_first=True, **extra)
    assert ca.fused_channel_attention_residual.launches == launches  # CPU: no launch
    expect = ca.reference_channel_attention(x, *weights, **extra).to(r_dtype) + r
    assert ours.dtype == r_dtype
    assert torch.equal(ours, expect)
    assert torch.equal(ca.reference_channel_attention_residual(x, r, *weights, cast_first=True,
                                                               **extra), expect)


@pytest.mark.parametrize('r_dtype', [torch.float32, torch.bfloat16])
def test_plain_tail_takes_meta_and_gate_and_is_unchanged_without(r_dtype):
    """Without cast_first the tail adds in f32 and casts once, att taking meta and the
    gate's product; with neither, the same bits as the tail without those arguments."""
    (x, r, *weights), extra = _tail_inputs(torch.float32, r_dtype, seed=2)
    att = ca._attention(x, *weights, meta=extra['meta']) * extra['gate']
    expect = (x * att[:, None, None, :] + r.float()).to(r_dtype)
    assert torch.equal(ca.fused_channel_attention_residual(x, r, *weights, **extra), expect)
    (x, r, *weights), _ = _tail_inputs(torch.float32, r_dtype, m=0, with_gate=False, seed=3)
    bare = ca._attention(x, *weights)
    assert torch.equal(ca.fused_channel_attention_residual(x, r, *weights),
                       (x * bare[:, None, None, :] + r.float()).to(r_dtype))


@pytest.mark.parametrize('carry', ['float32', 'bfloat16'])
def test_cast_first_tail_matches_sisr_tpu_qrcab_tail(carry):
    """The cast-first tail against sisr_tpu's int8 QRCAB tail in jnp (max_concat with a
    q_node: ``y * att``, ``* gate``, ``.astype(carry) + r``) on the same inputs.  The
    port rounds ``att * gate`` once where sisr_tpu multiplies twice: f32 within 1e-5;
    bf16 within one bf16 ULP (rtol 3.9e-3)."""
    r_dtype = torch.float32 if carry == 'float32' else torch.bfloat16
    (x, r, w1, b1, w2, b2), extra = _tail_inputs(torch.float32, r_dtype, seed=4)
    ours = ca.fused_channel_attention_residual(x, r, w1, b1, w2, b2, cast_first=True,
                                               **extra)
    entry = {'du_0': {'kernel': jnp.asarray(w1.numpy()), 'bias': jnp.asarray(b1.numpy())},
             'du_1': {'kernel': jnp.asarray(w2.numpy()), 'bias': jnp.asarray(b2.numpy())}}
    y, meta, gate = (jnp.asarray(t.numpy()) for t in (x, extra['meta'], extra['gate']))
    att = jq._qca_apply(entry, y.mean(axis=(1, 2)), meta, 'max_concat')
    branch = y * att[:, None, None, :] * gate[:, None, None, :]
    r_jax = jnp.asarray(r.float().numpy()).astype(jnp.bfloat16 if carry == 'bfloat16'
                                                  else jnp.float32)
    theirs = np.asarray((branch.astype(r_jax.dtype) + r_jax).astype(jnp.float32))
    if carry == 'float32':
        np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(ours.float().numpy(), theirs, rtol=3.9e-3, atol=1e-6)


def _tail_args():
    (x, r, w1, b1, w2, b2), extra = _tail_inputs(torch.float32, torch.bfloat16, seed=5)
    return {'x': x, 'r': r, 'w1': w1, 'b1': b1, 'w2': w2, 'b2': b2, **extra}


@pytest.mark.parametrize('mutate,error', [
    (lambda a: a, None),
    (lambda a: {**a, 'meta': None}, ValueError),              # w1 has C + M rows
    (lambda a: {**a, 'meta': a['meta'][:1]}, ValueError),     # one row for two images
    (lambda a: {**a, 'meta': a['meta'][:, :4]}, ValueError),  # M disagrees with w1
    (lambda a: {**a, 'gate': a['gate'][:, :31]}, ValueError),
    (lambda a: {**a, 'gate': a['gate'].long()}, TypeError),
    (lambda a: {**a, 'gate': torch.empty(2, 32, device='meta')}, ValueError),
    (lambda a: {**a, 'gate': a['gate'].requires_grad_()}, None),  # has a backward
])
def test_residual_meta_and_gate_argument_checks(mutate, error):
    args = mutate(_tail_args())
    if error is None:
        ca._check_residual_args(**args)
        return
    with pytest.raises(error, match='fused_channel_attention_residual'):
        ca._check_residual_args(**args)


@pytest.mark.parametrize('cast_first', [True, False])
@pytest.mark.parametrize('r_dtype', [torch.float32, torch.bfloat16])
def test_residual_grads_with_meta_gate_match_plain_autograd(cast_first, r_dtype,
                                                            monkeypatch):
    """Under autograd the op runs as its Function (the forward, then the plain
    version's VJP): output and every grad (x, r, the weights, meta, gate) equal to
    plain autograd through reference_channel_attention_residual."""
    applied = []
    monkeypatch.setattr(ca._ChannelAttentionResidual, 'apply',
                        classmethod(lambda cls, *a: applied.append(a) or
                                    torch.autograd.Function.apply.__func__(cls, *a)))
    (x, r, *weights), extra = _tail_inputs(torch.float32, r_dtype, seed=6)
    names = ['x', 'r', 'w1', 'b1', 'w2', 'b2', 'meta', 'gate']
    tensors = [x, r, *weights, extra['meta'], extra['gate']]
    cot = torch.from_numpy(np.random.RandomState(7).randn(*x.shape).astype(np.float32))

    def grads(op):
        leaves = [t.detach().clone().requires_grad_() for t in tensors]
        out = op(*leaves[:6], meta=leaves[6], gate=leaves[7], cast_first=cast_first)
        out.backward(cot.to(out.dtype))
        return out.detach(), [t.grad for t in leaves]

    ours, our_grads = grads(ca.fused_channel_attention_residual)
    assert len(applied) == 1 and applied[0][-1] is cast_first
    theirs, their_grads = grads(ca.reference_channel_attention_residual)
    assert torch.equal(ours, theirs)
    for name, a, b in zip(names, our_grads, their_grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=lambda m: name + ': ' + m)


# --- the int8 Q-RCAN program ----------------------------------------------------------------
def _two_step_qrcan_forward(qparams, act_scales, x, metadata, style, n_resgroups,
                            n_resblocks, residual_dtype):
    """qrcan_int8_forward_static with each QRCAB tail in two steps, as before the
    one-call tail: the f32 branch through fused_channel_attention (or plain
    _qca_apply), then the pa_node and the q_node's gate, then ``.to(carry) + r``."""
    carry_t = tq._carry_type(residual_dtype)
    meta = metadata.float()
    qconv = tq._qconv_with(act_scales)
    h = qconv('head', qparams['head'], x).to(carry_t)
    res = h
    for g in range(n_resgroups):
        grp = qparams['group_%d' % g]
        r = res
        for b in range(n_resblocks):
            blk = grp['qrcab_%d' % b]
            pre = 'group_%d.qrcab_%d' % (g, b)
            y = torch.relu(qconv(pre + '.conv_0', blk['conv_0'], r))
            y = qconv(pre + '.conv_1', blk['conv_1'], y)
            q_gate = tq._para_ca_apply(blk['q_node'], meta) if 'q_node' in blk else None
            if style in ca.KERNEL_STYLES:
                gate = None
                if 'pa_node' not in blk:
                    gate, q_gate = q_gate, None
                if style == 'modulate':
                    gate = meta if gate is None else meta * gate
                qca = blk['qca']
                y = ca.fused_channel_attention(
                    y, qca['du_0']['kernel'], qca['du_0']['bias'], qca['du_1']['kernel'],
                    qca['du_1']['bias'], meta=meta if style == 'max_concat' else None,
                    gate=gate)
            else:
                y = y * tq._qca_apply(blk['qca'], y.mean(dim=(1, 2)), meta,
                                      style)[:, None, None, :]
            if 'pa_node' in blk:
                y = tq._pa_apply(blk['pa_node'], y)
            if q_gate is not None:
                y = y * q_gate[:, None, None, :]
            r = y.to(carry_t) + r
        res = qconv('group_%d.final_body' % g, grp['final_body'], r).to(carry_t) + res
    res = qconv('final_body', qparams['final_body'], res) + h.float()
    res = tq._pow2_upsample(qconv, qparams['upsampler'], res)
    return qconv('tail', qparams['tail'], res)


@pytest.mark.parametrize('style', q_layers.STYLES)
@pytest.mark.parametrize('pa,q', [(False, False), (False, True), (True, False), (True, True)])
def test_qrcan_int8_forward_bit_equal_to_the_two_step_tail(style, pa, q):
    """A seeded 2 x 2 Q-RCAN (32 features) quantised and calibrated on the CPU: the
    program's output is the same bits as the two-step tail's, with a bfloat16 carry
    and, for the max_concat + q_node block, an f32 carry too."""
    handler = define_model('qrcan', device='cpu', scale=2, n_resgroups=2, n_resblocks=2,
                           n_feats=32, seed=1, style=style, include_pixel_attention=pa,
                           include_q_layer=q,
                           metadata=['qpi'] if style == 'modulate' else ['blur_kernel'])
    handler.set_metadata_keys(['qpi'] if style == 'modulate' else ['blur_kernel'] * 10)
    params = params_from_state_dict('qrcan', handler.module.state_dict())
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.rand(2, 10, 10, 3).astype(np.float32))
    raw = torch.from_numpy(rng.rand(2, 1 if style == 'modulate' else 10).astype(np.float32))
    meta = handler.prepare_metadata(x, raw)
    scales = tq.calibrate_qrcan_scales(params, [x], [meta], style, 2, 2)
    qp = tq.quantize_qrcan_params(params, 2, 2)
    carries = ['bfloat16'] + (['float32'] if (style, pa, q) == ('max_concat', False, True)
                              else [])
    with torch.inference_mode():
        for carry in carries:
            ours = tq.qrcan_int8_forward_static(qp, scales, x, meta, style, 2, 2, carry)
            theirs = _two_step_qrcan_forward(qp, scales, x, meta, style, 2, 2, carry)
            assert ours.shape == (2, 20, 20, 3) and torch.isfinite(ours).all()
            assert torch.equal(ours, theirs), carry
