"""sisr_tpu_torch's channel attention, and its CA + residual block tail, against
sisr_tpu's Pallas kernels (interpret mode) and plain references, on the CPU; the CA
with ``meta`` and ``gate`` against sisr_tpu's flax meta-attention layers (QCALayer in
every style, ParaCALayer, PALayer); the launch plan, alignment rule, argument checks,
build command and CALayer wiring in Python; the backward of both ops (the plain
version's VJP) against jax.grad through sisr_tpu's custom_vjp ops and against plain
autograd.  The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from sisr_tpu.models import q_layers as jax_q_layers
from sisr_tpu.ops.pallas import channel_attention as pallas_ca
from sisr_tpu.ops.pallas.channel_attention import (_fused_ca_forward, _fused_ca_res_forward,
                                                   _reference_ca, _reference_ca_res)
from sisr_tpu_torch.models import blocks, q_layers
from sisr_tpu_torch.ops import channel_attention as ca
from sisr_tpu_torch.ops.cuda import build
from sisr_tpu_torch.tools import ca_res_timeline


def _inputs(shape, seed, red=4):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return (rng.rand(*shape).astype(np.float32),
            (rng.randn(c, c // red) * 0.1).astype(np.float32),
            (rng.randn(c // red) * 0.1).astype(np.float32),
            (rng.randn(c // red, c) * 0.1).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32))


@pytest.mark.parametrize('shape', [(2, 16, 8, 32), (1, 13, 8, 32)])
def test_cpu_path_matches_pallas_interpret_and_reference(shape):
    arrays = _inputs(shape, seed=0)
    launches = ca.fused_channel_attention.launches
    onchip = ca.fused_channel_attention.onchip_launches
    ours = ca.fused_channel_attention(*map(torch.from_numpy, arrays)).numpy()
    assert ca.fused_channel_attention.launches == launches  # CPU: plain version, no launch
    assert ca.fused_channel_attention.onchip_launches == onchip
    pallas = np.asarray(_fused_ca_forward(*map(jnp.asarray, arrays), interpret=True))
    ref = np.asarray(_reference_ca(*map(jnp.asarray, arrays)))
    np.testing.assert_allclose(ours, pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_without_meta_or_gate_the_op_is_unchanged(dtype):
    """No meta, no gate: the same bits as the plain CA of earlier slices."""
    x, w1, b1, w2, b2 = map(torch.from_numpy, _inputs((2, 8, 8, 32), seed=11))
    x = x.to(dtype)
    att = torch.sigmoid(torch.relu(x.float().mean(dim=(1, 2)) @ w1 + b1) @ w2 + b2)
    before = x * att[:, None, None, :].to(dtype)
    assert torch.equal(ca.fused_channel_attention(x, w1, b1, w2, b2), before)
    assert torch.equal(ca.fused_channel_attention(x, w1, b1, w2, b2, meta=None, gate=None),
                       before)


def test_meta_and_gate_in_the_plain_version():
    """meta joins the pooled vector before w1's C + M rows; gate scales att after the
    sigmoid, before the rounding to x's type."""
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.rand(2, 5, 4, 32).astype(np.float32)).bfloat16()
    meta = torch.from_numpy(rng.rand(2, 10).astype(np.float32))
    gate = torch.from_numpy(rng.rand(2, 32).astype(np.float32))
    w1, b1, w2, b2 = (torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1)
                      for s in ((42, 2), (2,), (2, 32), (32,)))
    pooled = torch.cat([x.float().mean(dim=(1, 2)), meta], dim=1)
    att = torch.sigmoid(torch.relu(pooled @ w1 + b1) @ w2 + b2) * gate
    out = ca.fused_channel_attention(x, w1, b1, w2, b2, meta=meta, gate=gate)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, x * att[:, None, None, :].bfloat16())
    with torch.autocast('cpu', dtype=torch.bfloat16):  # the excite stays f32
        assert torch.equal(ca.fused_channel_attention(x, w1, b1, w2, b2, meta=meta,
                                                      gate=gate), out)


def _flax_dense(layer):
    """A port 1x1 conv's weights as a flax Dense param (kernel (I, O), bias)."""
    w = layer.weight.detach().numpy()
    return {'kernel': w.reshape(w.shape[0], w.shape[1]).T,
            'bias': layer.bias.detach().numpy()}


def _qca_params(layer, style):
    if style == 'mini_concat':
        return {'pre_concat': _flax_dense(layer.pre_concat),
                'du_1': _flax_dense(layer.conv_du[1])}
    if style == 'extended_attention':
        out = {'feature_%d' % i: _flax_dense(f[0]) for i, f in enumerate(layer.feature_convs)}
        return {**out, 'final': _flax_dense(layer.final_conv[0])}
    return {'du_0': _flax_dense(layer.conv_du[0]), 'du_1': _flax_dense(layer.conv_du[2])}


def _q_inputs(seed, c=32, m=10):
    rng = np.random.RandomState(seed)
    return (rng.rand(2, 6, 5, c).astype(np.float32) - 0.3,
            rng.rand(2, m).astype(np.float32))


def _port_layer(cls, seed, *args, **kwargs):
    torch.manual_seed(seed)
    return blocks.torch_default_init_(cls(*args, **kwargs), torch.Generator().manual_seed(seed))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize('style', q_layers.STYLES)
@pytest.mark.parametrize('with_q_node', [False, True])
def test_qcalayer_matches_flax_for_every_style(style, with_q_node, monkeypatch):
    """The port's QCALayer (the plain CA with meta/gate for the kernel styles, plain
    ops for the others), and with a ParaCALayer's gate folded in, against sisr_tpu's
    QCALayer (then its ParaCALayer) in f32.  'modulate' takes an (N, C) metadata
    vector, as the handler's scale_qpi expansion gives."""
    c, m = 32, 32 if style == 'modulate' else 10
    x, meta = _q_inputs(13, c, m)
    qca = _port_layer(q_layers.QCALayer, 1, c, style, 16, m)
    calls = []
    monkeypatch.setattr(q_layers, 'fused_channel_attention',
                        lambda *a, **k: calls.append(k) or ca.fused_channel_attention(*a, **k))
    theirs = jax_q_layers.QCALayer(c, style, 16, m).apply(
        {'params': _qca_params(qca, style)}, jnp.asarray(x), jnp.asarray(meta))
    gate = None
    if with_q_node:
        q_node = _port_layer(q_layers.ParaCALayer, 2, c, m, nonlinearity=True)
        gate = q_node.gate(torch.from_numpy(meta))
        theirs = jax_q_layers.ParaCALayer(c, m, nonlinearity=True).apply(
            {'params': {'fc_%d' % i: _flax_dense(q_node.attribute_integrator[2 * i])
                        for i in range(2)}}, theirs, jnp.asarray(meta))
    with torch.no_grad():
        ours = qca(_nchw(x), torch.from_numpy(meta), gate).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=1e-5, rtol=0)
    assert len(calls) == (1 if style in q_layers.KERNEL_STYLES else 0)
    if calls:
        assert (calls[0]['meta'] is not None) == (style == 'max_concat')
        assert (calls[0]['gate'] is not None) == (style == 'modulate' or with_q_node)


@pytest.mark.parametrize('num_metadata', [10, 20])  # 20: the size ladder for > 15
def test_paracalayer_and_palayer_match_flax(num_metadata):
    c = 32
    x, meta = _q_inputs(14, c, num_metadata)
    para = _port_layer(q_layers.ParaCALayer, 3, c, num_metadata, nonlinearity=True)
    pa = _port_layer(q_layers.PALayer, 4, c)
    para_params = {'fc_%d' % i: _flax_dense(para.attribute_integrator[2 * i])
                   for i in range(2)}
    pa_params = {'pa_%d' % i: {'kernel': pa.pa[2 * i].weight.detach().numpy()
                               .transpose(2, 3, 1, 0),
                               'bias': pa.pa[2 * i].bias.detach().numpy()} for i in range(2)}
    flax_para = jax_q_layers.ParaCALayer(c, num_metadata, nonlinearity=True)
    theirs_para = flax_para.apply({'params': para_params}, jnp.asarray(x), jnp.asarray(meta))
    theirs_pa = jax_q_layers.PALayer(c).apply({'params': pa_params}, jnp.asarray(x))
    assert [l.out_channels for l in para.attribute_integrator if hasattr(l, 'out_channels')] \
        == [p['kernel'].shape[1] for p in para_params.values()]
    with torch.no_grad():
        ours_para = para(_nchw(x), torch.from_numpy(meta)).permute(0, 2, 3, 1).numpy()
        ours_pa = pa(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours_para, np.asarray(theirs_para), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours_pa, np.asarray(theirs_pa), atol=1e-5, rtol=0)


@pytest.mark.parametrize('reduction,channel,error', [(8, 64, RuntimeError),
                                                     (32, 16, ValueError)])
def test_qcalayer_guards(reduction, channel, error):
    """reduction < 16 is refused (the reference's guard, kept verbatim); so is a
    channel count below the reduction."""
    with pytest.raises(error):
        q_layers.QCALayer(channel, 'max_concat', reduction, 10)


@pytest.mark.parametrize('n,hw,c,itemsize,aligned,expect', [
    (8, 128 * 128, 64, 2, True, (True, 66)),   # main path: 16-byte vectors, 66 slabs
    (8, 128 * 128, 64, 4, True, (True, 66)),   # int8 path's f32 x: 4 floats a vector
    (1, 13 * 8, 32, 4, True, (True, 1)),
    (1, 512 * 512, 64, 2, True, (True, 528)),  # one large map: many slabs per image
    (1, 7 * 5, 20, 2, True, (False, 1)),       # 40-byte pixels: one element a thread
    (1, 16, 64, 2, False, (False, 1)),         # misaligned x: scalar path
])
def test_launch_plan(n, hw, c, itemsize, aligned, expect):
    assert ca.launch_plan(n, hw, c, itemsize, aligned, sm_count=132) == expect


H100 = {'sm_count': 132, 'smem_optin': 232448}  # SMs, opt-in shared memory per block


@pytest.mark.parametrize('n,hw,c,cr,itemsize,aligned,expect', [
    # main path: on chip, 16 blocks of 1024 pixels (128 KB slabs) per image
    (8, 128 * 128, 64, 4, 2, True, (16, 1024, 143168)),
    (8, 128 * 128, 64, 4, 4, True, None),       # f32: a 256 KB slab does not fit
    (1, 512 * 512, 64, 4, 2, True, None),       # one 33.6 MB map: 248 KB slabs
    (1, 7 * 5, 20, 5, 2, True, None),           # 40-byte pixels: no bulk copy
    (8, 128 * 128, 64, 4, 2, False, None),      # misaligned x
    (133, 4 * 4, 64, 4, 2, True, None),         # more images than SMs
    (3, 37 * 29, 64, 4, 2, True, (43, 25, 15296)),  # ragged: the last slab 23 pixels
    (1, 7 * 5, 20, 5, 4, True, (35, 1, 6240)),  # f32 C = 20: 80-byte pixels
])
def test_onchip_plan(n, hw, c, cr, itemsize, aligned, expect):
    assert ca.onchip_plan(n, hw, c, cr, itemsize, aligned, **H100) == expect


@pytest.mark.parametrize('m,expect', [
    (0, (16, 1024, 143168)),
    (10, (16, 1024, 143376)),  # Q-RCAN's blur kernel: 10 more rows of w1 and meta
    (20, (16, 1024, 143568)),  # 20 values: 100 more floats, 400 bytes
])
def test_onchip_plan_counts_meta(m, expect):
    """The main shape in bf16 with M meta values: M * Cr more floats of w1 and M of
    meta in the scratch, the same layout ca_onchip's OnchipScratch lays out."""
    assert ca.onchip_plan(8, 128 * 128, 64, 4, 2, True, m=m, **H100) == expect
    assert ca.onchip_smem_bytes(1024, 64, 4, 2, m) == expect[2]


def _slab_cover(hw, blocks, slab):
    """How many blocks own each pixel of one image."""
    owners = np.zeros(hw, np.int64)
    for s in range(blocks):
        owners[s * slab:min(hw, (s + 1) * slab)] += 1
    return owners


@pytest.mark.parametrize('n,hw,c,itemsize', [
    (8, 128 * 128, 64, 2), (3, 37 * 29, 64, 2), (1, 104, 32, 4), (2, 128, 32, 2),
    (7, 1000, 16, 2), (1, 128 * 128, 64, 2), (66, 9, 64, 4), (132, 1, 8, 2)])
def test_onchip_slabs_cover_each_pixel_once(n, hw, c, itemsize):
    blocks, slab, smem = ca.onchip_plan(n, hw, c, max(1, c // 16), itemsize, True, **H100)
    assert n * blocks <= H100['sm_count']  # all co-resident: one block per SM at most
    assert smem <= H100['smem_optin']
    assert np.array_equal(_slab_cover(hw, blocks, slab), np.ones(hw, np.int64))
    assert 0 < hw - (blocks - 1) * slab <= slab  # the last block has pixels


@given(n=st.integers(1, 140), hw=st.integers(1, 300000), c=st.sampled_from([8, 16, 32, 64, 128]),
       itemsize=st.sampled_from([2, 4]))
@settings(max_examples=200, deadline=None, derandomize=True)
def test_onchip_plan_covers_and_fits(n, hw, c, itemsize):
    plan = ca.onchip_plan(n, hw, c, max(1, c // 16), itemsize, True, **H100)
    if n > H100['sm_count']:
        assert plan is None
    if plan is None:
        return
    blocks, slab, smem = plan
    assert n * blocks <= H100['sm_count'] and smem <= H100['smem_optin']
    assert smem == ca.onchip_smem_bytes(slab, c, max(1, c // 16), itemsize)
    assert (blocks - 1) * slab < hw <= blocks * slab  # each pixel once, no empty block


@pytest.mark.parametrize('n,hw,c,cr,x_itemsize,r_itemsize,aligned,expect', [
    # main path, x f32 and r bf16: 2 rounds of 4 images, 33 blocks of 497 pixels each
    # (127 KB of x and 64 KB of r)
    (8, 128 * 128, 64, 4, 4, 2, True, (2, 4, 33, 497, 198848)),
    (8, 128 * 128, 64, 4, 4, 4, True, (3, 3, 44, 373, 198976)),   # r f32: 3 rounds
    # x bf16: one round would need 1024-pixel slabs, 256 KB of x and r together
    (8, 128 * 128, 64, 4, 2, 2, True, (2, 4, 33, 497, 139328)),
    (7, 128 * 128, 64, 4, 4, 2, True, (2, 4, 33, 497, 198848)),   # ragged round: 4 + 3
    (3, 37 * 29, 64, 4, 4, 2, True, (1, 3, 43, 25, 17600)),  # 44 blocks: the last empty
    (200, 4 * 4, 64, 4, 4, 2, True, (2, 100, 1, 16, 14144)),  # more images than SMs
    (1, 7 * 5, 20, 5, 4, 4, True, (1, 1, 35, 1, 6368)),       # C = 20 f32: 80-byte pixels
    (1, 512 * 512, 64, 4, 4, 2, True, None),  # one image of x is 67 MB: 508 KB slabs
    (2, 9 * 3, 18, 6, 4, 4, True, None),      # 72-byte pixels: no bulk copy
    (1, 7 * 5, 20, 5, 4, 2, True, None),      # C = 20, r bf16: 40-byte pixels of r
    (1, 7 * 5, 20, 5, 2, 2, True, None),      # x bf16 C = 20: 40-byte pixels of x
    (8, 128 * 128, 64, 4, 4, 2, False, None),  # misaligned r
])
def test_res_onchip_plan(n, hw, c, cr, x_itemsize, r_itemsize, aligned, expect):
    assert ca.res_onchip_plan(n, hw, c, cr, x_itemsize, r_itemsize, aligned, **H100) == expect


def _check_res_plan(n, hw, c, cr, x_itemsize, r_itemsize, plan):
    """The plan's invariants, by intervals: every image in exactly one round (the last
    round not empty), every pixel in exactly one block (the last not empty), at most
    one block per SM, the layout's shared memory within the limit."""
    rounds, images, blocks, slab, smem = plan
    assert rounds == -(-n // images) and (rounds - 1) * images < n <= rounds * images
    assert (blocks - 1) * slab < hw <= blocks * slab
    assert images * blocks <= H100['sm_count']
    assert smem == ca.res_onchip_smem_bytes(slab, c, cr, x_itemsize, r_itemsize)
    assert smem <= H100['smem_optin']


@pytest.mark.parametrize('n,hw,c,x_itemsize,r_itemsize', [
    (8, 128 * 128, 64, 4, 2), (7, 128 * 128, 64, 4, 2), (8, 128 * 128, 64, 2, 2),
    (3, 37 * 29, 64, 4, 4), (200, 16, 64, 4, 2), (10, 50000, 64, 4, 2), (2, 128, 32, 2, 4),
    (133, 9, 16, 4, 4)])
def test_res_onchip_rounds_cover_each_pixel_once(n, hw, c, x_itemsize, r_itemsize):
    cr = max(1, c // 16)
    plan = ca.res_onchip_plan(n, hw, c, cr, x_itemsize, r_itemsize, True, **H100)
    rounds, images, blocks, slab, _ = plan
    _check_res_plan(n, hw, c, cr, x_itemsize, r_itemsize, plan)
    owners = np.zeros((n, hw), np.int64)  # how many (round, block) own each pixel
    for k in range(rounds):
        for i in range(images):
            if k * images + i < n:
                owners[k * images + i] += _slab_cover(hw, blocks, slab)
    assert np.array_equal(owners, np.ones((n, hw), np.int64))


@given(n=st.integers(1, 300), hw=st.integers(1, 300000),
       c=st.sampled_from([8, 16, 20, 32, 64, 128]), x_itemsize=st.sampled_from([2, 4]),
       r_itemsize=st.sampled_from([2, 4]))
@settings(max_examples=200, deadline=None, derandomize=True)
def test_res_onchip_plan_covers_fits_and_takes_fewest_rounds(n, hw, c, x_itemsize,
                                                             r_itemsize):
    cr = max(1, c // 16)
    plan = ca.res_onchip_plan(n, hw, c, cr, x_itemsize, r_itemsize, True, **H100)
    fits = lambda images: images <= H100['sm_count'] and ca.res_onchip_smem_bytes(
        -(-hw // (H100['sm_count'] // images)), c, cr, x_itemsize,
        r_itemsize) <= H100['smem_optin']
    if plan is None:  # not even one image a round fits, or pixels not whole 16 bytes
        assert (c * x_itemsize) % 16 or (c * r_itemsize) % 16 or not fits(1)
        return
    _check_res_plan(n, hw, c, cr, x_itemsize, r_itemsize, plan)
    rounds, images = plan[:2]
    assert fits(images)
    assert rounds == 1 or not fits(-(-n // (rounds - 1)))  # one round fewer does not fit


@pytest.mark.parametrize('mutate,error', [
    (lambda a: {**a, 'x': a['x'].permute(0, 2, 1, 3)}, ValueError),      # not contiguous
    (lambda a: {**a, 'x': a['x'].half()}, TypeError),
    (lambda a: {**a, 'x': a['x'][0]}, ValueError),
    (lambda a: {**a, 'w1': a['w1'].t()}, ValueError),
    (lambda a: {**a, 'b2': a['b2'][:-1]}, ValueError),
    (lambda a: {**a, 'w1': a['w1'].requires_grad_()}, None),  # the op has a backward
])
def test_kernel_argument_checks(mutate, error):
    arrays = _inputs((2, 4, 4, 32), seed=1)
    args = dict(zip(('x', 'w1', 'b1', 'w2', 'b2'), map(torch.from_numpy, arrays)))
    if error is None:
        ca._check_args(**mutate(args))
        return
    with pytest.raises(error):
        ca._check_args(**mutate(args))


def _meta_args():
    x, w1, b1, w2, b2 = map(torch.from_numpy, _inputs((2, 4, 4, 32), seed=1))
    w1 = torch.cat([w1, torch.rand(10, w1.shape[1])])  # C + M rows
    return {'x': x, 'w1': w1, 'b1': b1, 'w2': w2, 'b2': b2, 'meta': torch.rand(2, 10),
            'gate': torch.rand(2, 32)}


@pytest.mark.parametrize('mutate,error', [
    (lambda a: a, None),
    (lambda a: {**a, 'meta': None}, ValueError),              # w1 has C + M rows
    (lambda a: {**a, 'meta': a['meta'][:1]}, ValueError),     # one row for two images
    (lambda a: {**a, 'meta': a['meta'][:, :4]}, ValueError),  # M disagrees with w1
    (lambda a: {**a, 'meta': a['meta'].reshape(2, 10, 1)}, ValueError),
    (lambda a: {**a, 'gate': a['gate'][:, :31]}, ValueError),
    (lambda a: {**a, 'gate': a['gate'].long()}, TypeError),
    (lambda a: {**a, 'gate': torch.empty(2, 32, device='meta')}, ValueError),
    (lambda a: {**a, 'meta': a['meta'].requires_grad_()}, None),  # has a backward
])
def test_meta_and_gate_argument_checks(mutate, error):
    args = mutate(_meta_args())
    if error is None:
        ca._check_args(**args)
        return
    with pytest.raises(error):
        ca._check_args(**args)


def test_nvcc_command_targets_sm90a(monkeypatch):
    monkeypatch.setattr(build, 'nvcc_path', lambda: '/opt/cuda/bin/nvcc')
    path = build.library_path('channel_attention')
    cmd = build.nvcc_command('channel_attention', path)
    assert cmd[0] == '/opt/cuda/bin/nvcc'
    assert 'arch=compute_90a,code=sm_90a' in cmd and '-shared' in cmd
    assert cmd[-1] == build.source_path('channel_attention')
    assert path.startswith(build.BUILD_DIR + '/libchannel_attention-')


def test_diagnostic_build_gets_its_own_library(monkeypatch):
    monkeypatch.setattr(build, 'nvcc_path', lambda: 'nvcc')
    define = ca_res_timeline.DEFINE
    path = build.library_path('channel_attention', (define,))
    assert path != build.library_path('channel_attention')
    cmd = build.nvcc_command('channel_attention', path, (define,))
    assert '-D' + define in cmd and cmd[-1] == build.source_path('channel_attention')
    assert '-D' + define not in build.nvcc_command('channel_attention', path)


def test_timeline_reads_stamps_per_block():
    """Two launches of 3 blocks over 2 rounds; block 2 has no image in round 1, so its
    round-1 stamps are stale (older than the launch) and are left out."""
    names = ca_res_timeline.stamp_names(2)
    assert names[:3] == ['entry', 'round0_pooled', 'round0_past_barrier']
    assert len(names) == 9
    stamps = np.zeros((2, ca_res_timeline.STAMP_BLOCKS, ca_res_timeline.STAMPS), np.uint64)
    for launch, base in enumerate((10**9, 2 * 10**9)):
        for block in range(3):
            stamps[launch, block, :9] = base + 1000 * block + 1000 * np.arange(9)
        stamps[launch, 2, 5:9] = 5  # stale
    got = ca_res_timeline.timeline(stamps, blocks=3, rounds=2)
    assert got['entry'] == [0.0, 1.0, 2.0]
    assert got['round0_pooled'] == [1.0, 2.0, 3.0]
    assert got['round1_scaled'] == [8.0, 8.5, 9.0]  # blocks 0 and 1 only


def test_timeline_tool_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip('this host has a card: the tool would run')
    assert ca_res_timeline.main([]) == 1
    assert 'needs a CUDA card' in capsys.readouterr().err


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(build, 'DEFAULT_NVCC', str(tmp_path / 'nvcc'))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        build.build(['channel_attention'])


def test_calayer_passes_a_contiguous_nhwc_view(monkeypatch):
    """A channels_last activation reaches the kernel as a contiguous NHWC view (no
    copy), with conv_du's weights as (C, Cr) / (Cr, C)."""
    seen = {}

    def spy(x, w1, b1, w2, b2, valid_hw=None):
        seen.update(contiguous=x.is_contiguous(), shape=tuple(x.shape),
                    w1=tuple(w1.shape), w2=tuple(w2.shape), ptr=x.data_ptr(),
                    valid_hw=valid_hw)
        return ca.reference_channel_attention(x, w1, b1, w2, b2)

    monkeypatch.setattr(blocks, 'fused_channel_attention', spy)
    layer = blocks.CALayer(32, 4)
    x = torch.rand(2, 32, 6, 5).contiguous(memory_format=torch.channels_last)
    out = layer(x)
    assert seen == {'contiguous': True, 'shape': (2, 6, 5, 32), 'w1': (32, 8),
                    'w2': (8, 32), 'ptr': x.data_ptr(), 'valid_hw': None}
    assert out.shape == x.shape
    assert out.is_contiguous(memory_format=torch.channels_last)



def _force_multi_tile(monkeypatch, rows_per_tile=4):
    """sisr_tpu's two-phase tiled grid with several small tiles (as
    tests/test_pallas.py forces it)."""
    orig = pallas_ca._pick_tile

    def small_tiles(h, w, c, itemsize):
        return orig(h, w, c, itemsize, budget=rows_per_tile * w * c * itemsize)

    monkeypatch.setattr(pallas_ca, '_RES_SINGLE_BLOCK_BUDGET', 1)
    monkeypatch.setattr(pallas_ca, '_pick_tile', small_tiles)


@pytest.mark.parametrize('shape', [(2, 16, 8, 32), (1, 13, 8, 32)])
@pytest.mark.parametrize('r_dtype', [np.float32, 'bfloat16'])
@pytest.mark.parametrize('force_tiled', [False, True])
def test_residual_cpu_path_matches_pallas_interpret_and_reference(shape, r_dtype,
                                                                  force_tiled, monkeypatch):
    """x f32 (the dequantised conv output) with an f32 or bf16 carry r; the output
    has r's type.  Bars: f32 1e-5 abs; bf16 one bf16 ULP (rtol 3.9e-3)."""
    if force_tiled:
        _force_multi_tile(monkeypatch)
    x, w1, b1, w2, b2 = _inputs(shape, seed=3)
    r = np.random.RandomState(4).rand(*shape).astype(np.float32)
    r_jax = jnp.asarray(r, jnp.bfloat16 if r_dtype == 'bfloat16' else jnp.float32)
    r_torch = torch.from_numpy(np.array(r_jax.astype(jnp.float32))).to(
        torch.bfloat16 if r_dtype == 'bfloat16' else torch.float32)
    launches = ca.fused_channel_attention_residual.launches
    ours = ca.fused_channel_attention_residual(torch.from_numpy(x), r_torch,
                                               *map(torch.from_numpy, (w1, b1, w2, b2)))
    assert ca.fused_channel_attention_residual.launches == launches  # CPU: no launch
    assert ours.dtype == r_torch.dtype and ours.shape == shape
    args = [jnp.asarray(x), r_jax] + [jnp.asarray(a) for a in (w1, b1, w2, b2)]
    for theirs in (_fused_ca_res_forward(*args, interpret=True), _reference_ca_res(*args)):
        assert theirs.dtype == r_jax.dtype
        if r_dtype == 'bfloat16':
            np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32),
                                       rtol=3.9e-3, atol=1e-6)
        else:
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5, rtol=0)


def test_residual_reference_multiplies_by_the_f32_attention():
    """Unlike the plain CA (x * att rounded to x's type), the block tail multiplies
    float(x) by the f32 att, as sisr_tpu's Pallas body does."""
    x, w1, b1, w2, b2 = map(torch.from_numpy, _inputs((1, 4, 4, 32), seed=5))
    x = x.bfloat16()
    r = torch.zeros(1, 4, 4, 32)
    att = ca._attention(x, w1, b1, w2, b2)[:, None, None, :]
    out = ca.reference_channel_attention_residual(x, r, w1, b1, w2, b2)
    torch.testing.assert_close(out, x.float() * att, atol=0, rtol=0)


@pytest.mark.parametrize('x_offset,r_offset,r_dtype,expect', [
    (0, 0, torch.bfloat16, True),
    (4, 4, torch.bfloat16, True),     # x 16 bytes in, r 8 bytes in: still aligned
    (1, 0, torch.bfloat16, False),    # x 4 bytes in
    (0, 2, torch.bfloat16, False),    # r 4 bytes in: not one 8-byte vector
    (0, 2, torch.float32, False),     # r f32 8 bytes in: not one 16-byte vector
])
def test_residual_alignment_rule(x_offset, r_offset, r_dtype, expect):
    def at_offset(offset, dtype):
        """64 elements starting ``offset`` elements past a 16-byte boundary."""
        t = torch.zeros(64 + 16 + offset, dtype=dtype)
        start = (-t.data_ptr() % 16) // t.element_size() + offset
        return t[start:start + 64]

    x, r = at_offset(x_offset, torch.float32), at_offset(r_offset, r_dtype)
    assert ca.residual_aligned(x, r, at_offset(0, r_dtype)) == expect


@pytest.mark.parametrize('r_offset,r_dtype,expect', [
    (0, torch.bfloat16, True),
    (4, torch.bfloat16, False),   # r 8 bytes in: vectors, but no bulk copy
    (8, torch.bfloat16, True),
    (2, torch.bfloat16, False),
    (4, torch.float32, True),
])
def test_res_onchip_alignment_rule(r_offset, r_dtype, expect):
    def aligned(n, dtype):
        t = torch.zeros(n + 16, dtype=dtype)
        return t[(-t.data_ptr() % 16) // t.element_size():][:n]

    x, out = aligned(64, torch.float32), aligned(64, r_dtype)
    r = aligned(64 + r_offset, r_dtype)[r_offset:]
    assert ca.res_onchip_aligned(x, r, out) == expect


@pytest.mark.parametrize('mutate,error', [
    (lambda a: {**a, 'r': a['r'][:, :3]}, ValueError),                     # shape
    (lambda a: {**a, 'r': torch.empty(a['r'].shape, device='meta')}, ValueError),
    (lambda a: {**a, 'r': a['r'].transpose(1, 2).contiguous().transpose(1, 2)},
     ValueError),                                                           # strided
    (lambda a: {**a, 'r': a['r'].half()}, TypeError),
    (lambda a: {**a, 'r': a['r'].requires_grad_()}, None),  # the op has a backward
    (lambda a: {**a, 'x': a['x'].requires_grad_()}, None),
    (lambda a: {**a, 'b1': a['b1'][:-1]}, ValueError),
])
def test_residual_argument_checks(mutate, error):
    arrays = _inputs((2, 4, 4, 32), seed=6)
    args = dict(zip(('x', 'w1', 'b1', 'w2', 'b2'), map(torch.from_numpy, arrays)))
    args['r'] = torch.rand(2, 4, 4, 32).bfloat16()
    if error is None:
        ca._check_residual_args(**mutate(args))
        return
    with pytest.raises(error, match='fused_channel_attention_residual'):
        ca._check_residual_args(**mutate(args))


# --- the backward (the autograd.Function of each op) ------------------------------------
def _grad_inputs(shape, seed, red=4):
    x, w1, b1, w2, b2 = _inputs(shape, seed, red)
    x = x - 0.4  # a signed map, as a conv output
    cot = np.random.RandomState(seed + 100).randn(*shape).astype(np.float32)
    return (x, w1, b1, w2, b2), cot


def _torch_grads(fn, arrays, cot):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*leaves)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax_grads(fn, arrays, cot):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


@pytest.mark.parametrize('shape', [(2, 8, 8, 32), (1, 7, 5, 16), (3, 4, 6, 64)])
def test_ca_grads_match_jax_grad_of_sisr_tpu_op(shape):
    """dx, dw1, db1, dw2, db2 through the port's Function (CPU: the plain forward)
    against jax.vjp of sisr_tpu's custom_vjp fused_channel_attention: <= 1e-5 abs."""
    arrays, cot = _grad_inputs(shape, seed=20, red=4 if shape[-1] < 64 else 16)
    launches = ca.fused_channel_attention.launches
    ours, our_grads = _torch_grads(ca.fused_channel_attention, arrays, cot)
    assert ca.fused_channel_attention.launches == launches  # CPU: no kernel launch
    theirs, their_grads = _jax_grads(pallas_ca.fused_channel_attention, arrays, cot)
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)
    for name, a, b in zip(('x', 'w1', 'b1', 'w2', 'b2'), our_grads, their_grads):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize('shape', [(2, 8, 8, 32), (1, 13, 8, 32)])
def test_ca_residual_grads_match_jax_grad_of_sisr_tpu_op(shape):
    """The CA + residual tail (x, r f32): the grads of x, r and the excite's weights
    against jax.vjp of sisr_tpu's fused_channel_attention_residual: <= 1e-5 abs."""
    (x, w1, b1, w2, b2), cot = _grad_inputs(shape, seed=21)
    r = np.random.RandomState(22).rand(*shape).astype(np.float32)
    arrays = (x, r, w1, b1, w2, b2)
    ours, our_grads = _torch_grads(ca.fused_channel_attention_residual, arrays, cot)
    theirs, their_grads = _jax_grads(pallas_ca.fused_channel_attention_residual, arrays,
                                     cot)
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)
    for name, a, b in zip(('x', 'r', 'w1', 'b1', 'w2', 'b2'), our_grads, their_grads):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize('with_meta,with_gate', [(True, True), (True, False),
                                                 (False, True)])
def test_ca_grads_with_meta_and_gate_match_plain_autograd(with_meta, with_gate):
    """With meta (w1 has C + M rows) and gate, every grad (meta's and gate's too)
    against torch.autograd through reference_channel_attention."""
    (x, w1, b1, w2, b2), cot = _grad_inputs((2, 6, 5, 32), seed=23)
    rng = np.random.RandomState(24)
    arrays = [x, np.concatenate([w1, rng.randn(10, w1.shape[1]).astype(np.float32) * 0.1])
              if with_meta else w1, b1, w2, b2]
    names = ['x', 'w1', 'b1', 'w2', 'b2']
    if with_meta:
        arrays.append(rng.rand(2, 10).astype(np.float32))
        names.append('meta')
    if with_gate:
        arrays.append(rng.rand(2, 32).astype(np.float32))
        names.append('gate')

    def call(op):
        return lambda *a: op(*a[:5], **dict(zip(names[5:], a[5:])))

    ours, our_grads = _torch_grads(call(ca.fused_channel_attention), arrays, cot)
    theirs, their_grads = _torch_grads(call(ca.reference_channel_attention), arrays, cot)
    np.testing.assert_array_equal(ours, theirs)
    for name, a, b in zip(names, our_grads, their_grads):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=name)


def test_function_only_where_autograd_records(monkeypatch):
    """Under no_grad, or with no input needing a grad, the op is the plain forward
    with no graph; with a grad needed it is the Function, whose backward returns a
    grad only for the inputs that need one."""
    applied = []
    monkeypatch.setattr(ca._ChannelAttention, 'apply',
                        classmethod(lambda cls, *a: applied.append(a) or
                                    torch.autograd.Function.apply.__func__(cls, *a)))
    x, w1, b1, w2, b2 = map(torch.from_numpy, _inputs((2, 4, 4, 32), seed=25))
    assert ca.fused_channel_attention(x, w1, b1, w2, b2).grad_fn is None
    w1.requires_grad_()
    with torch.no_grad():
        assert ca.fused_channel_attention(x, w1, b1, w2, b2).grad_fn is None
    assert not applied
    out = ca.fused_channel_attention(x, w1, b1, w2, b2)
    assert len(applied) == 1 and out.grad_fn is not None
    out.sum().backward()
    assert w1.grad is not None and x.grad is None and b1.grad is None


def test_calayer_grads_reach_conv_du_through_the_views():
    """CALayer hands the kernel transposed views of conv_du's weights: the backward's
    grads land on the Conv2d parameters, equal to a plain-torch CALayer's."""
    torch.manual_seed(0)
    layer = blocks.CALayer(32, 4)
    x = torch.rand(2, 32, 6, 5).contiguous(memory_format=torch.channels_last) - 0.5
    layer(x).square().sum().backward()
    ours = [p.grad.clone() for p in layer.parameters()]
    layer.zero_grad()
    reduce, expand = layer.conv_du[0], layer.conv_du[2]
    pooled = x.mean(dim=(2, 3), keepdim=True)
    att = torch.sigmoid(expand(torch.relu(reduce(pooled))))
    (x * att).square().sum().backward()
    for a, b in zip(ours, (p.grad for p in layer.parameters())):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
