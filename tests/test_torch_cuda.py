"""sisr_tpu_torch on an NVIDIA card: the CUDA channel-attention kernel (with and
without Q-RCAN's meta and gate) on each of its routes (on chip, in rounds, three
passes, and streaming one image a round) and the CA + residual block-tail kernel
(also with meta, gate and the cast-first rounding of int8 Q-RCAN's tail, in rounds,
streaming or in three passes) against their plain versions, the CA's valid-extent
pool (bucketed eval) on each route and its refusals, the rounds and the stream
routes against three passes, the stream route's layout, the int8 conv's int32 sums
against an int64 reference, a small RCAN (f32, and int8), Q-RCAN and EDSR on the card
against the CPU, the int8 programs of EDSR (three carries), Q-RCAN and Q-EDSR card
against CPU, and the CA op's backward (the kernel forward, the plain VJP) and one
training step of a small Q-RCAN on the card against plain autograd and the CPU.
Every test here needs the card and skips without one.  Imports torch only (no JAX),
so the card's machine runs it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import channel_attention as ca
from sisr_tpu_torch.ops import quantization as qz

pytestmark = pytest.mark.cuda
# the CA op's (on-chip, rounds, stream) launch counts over two calls on each route
ROUTE_LAUNCHES = {'onchip': (2, 0, 0), 'rounds': (0, 2, 0), 'stream': (0, 0, 2),
                  'three_pass': (0, 0, 0)}


def _ca_route_counts():
    return (ca.fused_channel_attention.onchip_launches,
            ca.fused_channel_attention.rounds_launches,
            ca.fused_channel_attention.stream_launches)


def _res_route_counts():
    """The CA + residual op's (rounds, stream) launch counts."""
    op = ca.fused_channel_attention_residual
    return op.onchip_launches, op.stream_launches


# the CA + residual's (rounds, stream) launch counts over two calls on each route
RES_ROUTE_LAUNCHES = {'onchip': (2, 0), 'stream': (0, 2), 'three_pass': (0, 0)}


def _ca_route_took(before):
    return tuple(a - b for a, b in zip(_ca_route_counts(), before))


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


@pytest.mark.parametrize('shape,red,dtype,path', [
    ((8, 128, 128, 64), 16, torch.bfloat16, 'onchip'),      # the main path
    ((8, 128, 128, 64), 16, torch.float32, 'rounds'),       # 2 rounds of 4 images
    ((1, 13, 8, 32), 4, torch.float32, 'onchip'),
    ((2, 16, 8, 32), 4, torch.bfloat16, 'onchip'),
    ((1, 7, 5, 20), 4, torch.bfloat16, 'three_pass'),       # 40-byte pixels
    ((3, 37, 29, 64), 16, torch.bfloat16, 'onchip'),        # ragged last slab
    ((1, 512, 512, 64), 16, torch.bfloat16, 'stream'),      # one 33.6 MB map
])
@pytest.mark.parametrize('transposed_weights', [False, True])
def test_kernel_matches_plain_version(shape, red, dtype, path, transposed_weights):
    rng = np.random.RandomState(0)
    c, cr = shape[-1], shape[-1] // red
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dtype).cuda()
    w1, w2 = (torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1).cuda()
              for s in ((c, cr), (cr, c)))
    if transposed_weights:  # conv_du's layout, as CALayer passes it
        w1, w2 = w1.t().contiguous().t(), w2.t().contiguous().t()
    b1, b2 = (torch.from_numpy(rng.randn(n).astype(np.float32) * 0.1).cuda()
              for n in (cr, c))
    launches = ca.fused_channel_attention.launches
    before = _ca_route_counts()
    with torch.inference_mode():
        out = ca.fused_channel_attention(x, w1, b1, w2, b2)
        again = ca.fused_channel_attention(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        ref = ca.reference_channel_attention(x, w1, b1, w2, b2)
    assert ca.fused_channel_attention.launches == launches + 2
    assert _ca_route_took(before) == ROUTE_LAUNCHES[path], 'expected the %s path' % path
    assert torch.equal(out, again)  # no atomics: the same bits every run
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:  # 2 bf16 ULPs: the summation order can flip how att rounds to bf16
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-6, rtol=1.6e-2)


def _meta_gate_inputs(shape, red, dtype, m, with_gate, seed):
    """x, w1 (C + M, Cr) and w2 as conv_du's transposed views (as QCALayer passes
    them), b1, b2, meta (N, M) or None, gate (N, C) or None."""
    rng = np.random.RandomState(seed)
    n, c, cr = shape[0], shape[-1], shape[-1] // red
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dtype).cuda()
    w1 = torch.from_numpy(rng.randn(cr, c + m).astype(np.float32) * 0.1).cuda().t()
    w2 = torch.from_numpy(rng.randn(c, cr).astype(np.float32) * 0.1).cuda().t()
    b1, b2 = (torch.from_numpy(rng.randn(k).astype(np.float32) * 0.1).cuda() for k in (cr, c))
    meta = torch.from_numpy(rng.rand(n, m).astype(np.float32)).cuda() if m else None
    gate = torch.from_numpy(rng.rand(n, c).astype(np.float32)).cuda() if with_gate else None
    return (x, w1, b1, w2, b2), {'meta': meta, 'gate': gate}


@pytest.mark.parametrize('shape,red,dtype,path', [
    ((8, 128, 128, 64), 16, torch.bfloat16, 'onchip'),      # Q-RCAN's main path
    ((8, 128, 128, 64), 16, torch.float32, 'rounds'),       # int8 Q-RCAN's tail map
    ((7, 128, 128, 64), 16, torch.float32, 'rounds'),       # a ragged last round
    ((1, 512, 512, 64), 16, torch.bfloat16, 'stream'),
    ((3, 37, 29, 64), 16, torch.bfloat16, 'onchip'),        # ragged last slab
    ((1, 7, 5, 20), 4, torch.bfloat16, 'three_pass'),       # 40-byte pixels
    ((2, 16, 8, 32), 4, torch.float32, 'onchip'),
])
@pytest.mark.parametrize('m,with_gate', [(10, True), (10, False), (0, True)])
def test_kernel_with_meta_and_gate_matches_plain_version(shape, red, dtype, path, m,
                                                         with_gate):
    args, extra = _meta_gate_inputs(shape, red, dtype, m, with_gate, seed=6)
    before = _ca_route_counts()
    with torch.inference_mode():
        out = ca.fused_channel_attention(*args, **extra)
        again = ca.fused_channel_attention(*args, **extra)
        torch.cuda.synchronize()
        ref = ca.reference_channel_attention(*args, **extra)
    assert _ca_route_took(before) == ROUTE_LAUNCHES[path], 'expected the %s path' % path
    assert torch.equal(out, again)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-6, rtol=1.6e-2)


@pytest.mark.parametrize('shape,valid,dtype,path', [
    ((1, 384, 512, 64), (339, 510), torch.bfloat16, 'onchip'),      # a DIV2K bucket
    ((1, 384, 512, 64), (339, 510), torch.float32, 'stream'),
    ((2, 339, 510, 64), (200, 301), torch.float32, 'stream'),      # 2 rounds, a mid-slab edge
    ((8, 128, 128, 64), (100, 120), torch.float32, 'rounds'),
    ((7, 128, 128, 64), (128, 1), torch.float32, 'rounds'),         # a ragged round
    ((3, 37, 29, 64), (1, 29), torch.bfloat16, 'onchip'),
    ((1, 7, 5, 20), (4, 3), torch.bfloat16, 'three_pass'),          # 40-byte pixels
])
@pytest.mark.parametrize('m,with_gate', [(0, False), (10, True)])
def test_masked_kernel_matches_plain_version(shape, valid, dtype, path, m, with_gate):
    """The valid-extent pool on each route (bucketed eval): the pad holds garbage the
    pool must skip; the kernel against the plain version with the same extent, every
    launch given an extent counted; the full extent bit-equal to no extent."""
    args, extra = _meta_gate_inputs(shape, 16 if shape[-1] == 64 else 4, dtype, m,
                                    with_gate, seed=8)
    x = args[0].clone()
    x[:, valid[0]:] += 3
    x[:, :, valid[1]:] += 3
    args = (x,) + args[1:]
    before, masked = _ca_route_counts(), ca.fused_channel_attention.masked_launches
    with torch.inference_mode():
        out = ca.fused_channel_attention(*args, valid_hw=valid, **extra)
        again = ca.fused_channel_attention(*args, valid_hw=valid, **extra)
        full = ca.fused_channel_attention(*args, valid_hw=shape[1:3], **extra)
        bare = ca.fused_channel_attention(*args, **extra)
        torch.cuda.synchronize()
        ref = ca.reference_channel_attention(*args, valid_hw=valid, **extra)
    assert _ca_route_took(before) == tuple(2 * k for k in ROUTE_LAUNCHES[path])
    assert ca.fused_channel_attention.masked_launches == masked + 3
    assert torch.equal(out, again) and torch.equal(full, bare)
    assert not torch.equal(out, bare)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-6, rtol=1.6e-2)


def test_c_entries_refuse_bad_extents():
    """Each CA entry refuses an extent of 0 or past the map (the wrapper checks first;
    the private launchers reach the C entries directly)."""
    args, _ = _meta_gate_inputs((2, 16, 8, 32), 4, torch.float32, 0, False, seed=9)
    props = torch.cuda.get_device_properties(0)
    plan = ca.onchip_plan(2, 128, 32, 8, 4, True, props.multi_processor_count,
                          props.shared_memory_per_block_optin)
    rounds = ca.res_onchip_plan(2, 128, 32, 8, 4, 0, True, props.multi_processor_count,
                                props.shared_memory_per_block_optin)
    stream = ca.stream_plan(2, 128, 32, 8, 4, 0, True, props.multi_processor_count,
                            props.shared_memory_per_block_optin)
    launchers = (lambda v: ca._onchip(*args, plan, valid_hw=v),
                 lambda v: ca._rounds(args[0], None, *args[1:], torch.empty_like(args[0]),
                                      rounds, valid_hw=v),
                 lambda v: ca._stream(args[0], None, *args[1:], torch.empty_like(args[0]),
                                      stream, valid_hw=v),
                 lambda v: ca._three_pass(*args, valid_hw=v))
    with torch.inference_mode():
        for launch in launchers:
            launch((16, 8))
            for bad in ((0, 8), (16, 0), (17, 8), (16, 9)):
                with pytest.raises(RuntimeError, match='CUDA error'):
                    launch(bad)
        for bad in ((0, 8), (17, 8)):
            with pytest.raises(ValueError, match='valid extent'):
                ca.fused_channel_attention(*args, valid_hw=bad)


def test_onchip_smem_must_equal_the_cu_layout():
    """The C entry lays out the shared memory itself and refuses a plan that
    disagrees: one sized without the 10 meta values, or 16 bytes off."""
    args, extra = _meta_gate_inputs((8, 128, 128, 64), 16, torch.bfloat16, 10, True, seed=7)
    props = torch.cuda.get_device_properties(0)
    n, h, w, c = args[0].shape
    plan_of = lambda m: ca.onchip_plan(n, h * w, c, 4, 2, True, props.multi_processor_count,
                                       props.shared_memory_per_block_optin, m=m)
    plan = plan_of(10)
    with torch.inference_mode():
        out = ca._onchip(*args, plan, **extra)
        torch.testing.assert_close(out.float(), ca.reference_channel_attention(
            *args, **extra).float(), atol=1e-6, rtol=1.6e-2)
        for bad in (plan_of(0), plan[:2] + (plan[2] + 16,)):
            with pytest.raises(RuntimeError, match='CUDA error'):
                ca._onchip(*args, bad, **extra)


def test_qrcan_and_edsr_on_card_match_cpu():
    """Small Q-RCAN (max_concat with q_node: one CA launch per block) and EDSR in f32,
    card against CPU, on the same seeded weights."""
    x = torch.from_numpy(np.random.RandomState(8).rand(2, 16, 16, 3).astype(np.float32))
    meta = torch.from_numpy(np.random.RandomState(9).rand(2, 10).astype(np.float32))
    qrcan = dict(scale=4, n_resgroups=2, n_resblocks=2, n_feats=32, reduction=16, seed=1,
                 style='max_concat', include_q_layer=True, metadata=['blur_kernel'])
    edsr = dict(scale=4, num_features=32, num_blocks=3, seed=1)
    for name, kw, args in (('qrcan', qrcan, (meta,)), ('edsr', edsr, ())):
        card, host = define_model(name, device='cuda', **kw), define_model(name, device='cpu',
                                                                           **kw)
        launches = ca.fused_channel_attention.launches
        with torch.inference_mode():
            out = card.forward(x.cuda(), *(a.cuda() for a in args)).cpu()
            ref = host.forward(x, *args)
        assert ca.fused_channel_attention.launches == launches + (4 if name == 'qrcan' else 0)
        torch.testing.assert_close(out, ref, atol=5e-4, rtol=0)


def test_rcan_on_card_matches_cpu():
    kw = dict(scale=4, n_resgroups=2, n_resblocks=2, n_feats=32, reduction=16, seed=1)
    card, host = define_model('rcan', device='cuda', **kw), define_model('rcan', device='cpu',
                                                                          **kw)
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 16, 16, 3).astype(np.float32))
    launches = ca.fused_channel_attention.launches
    with torch.inference_mode():
        out = card.forward(x.cuda()).cpu()
        ref = host.forward(x)
    assert ca.fused_channel_attention.launches == launches + 4  # one per RCAB
    torch.testing.assert_close(out, ref, atol=5e-4, rtol=0)


def _excite_weights(rng, c, cr):
    """w1 (C, Cr) and w2 (Cr, C) in conv_du's transposed layout, as the int8 tree's
    Dense kernels are passed."""
    w1, w2 = (torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1).cuda()
              for s in ((c, cr), (cr, c)))
    b1, b2 = (torch.from_numpy(rng.randn(n).astype(np.float32) * 0.1).cuda()
              for n in (cr, c))
    return w1, b1, w2, b2


@pytest.mark.parametrize('shape,red,x_dtype,r_dtype,offset,path', [
    ((8, 128, 128, 64), 16, torch.float32, torch.bfloat16, 0, 'onchip'),  # the main path
    ((8, 128, 128, 64), 16, torch.float32, torch.float32, 0, 'onchip'),
    ((7, 128, 128, 64), 16, torch.float32, torch.bfloat16, 0, 'onchip'),  # 4 + 3 images
    ((3, 37, 29, 64), 16, torch.float32, torch.bfloat16, 0, 'onchip'),    # ragged slabs
    ((1, 512, 512, 64), 16, torch.float32, torch.bfloat16, 0, 'stream'),  # 67 MB of x
    ((2, 16, 8, 32), 4, torch.bfloat16, torch.bfloat16, 0, 'onchip'),
    ((2, 16, 8, 32), 4, torch.bfloat16, torch.float32, 0, 'onchip'),
    ((1, 13, 7, 32), 4, torch.float32, torch.bfloat16, 0, 'onchip'),      # odd H x W
    ((1, 7, 5, 20), 4, torch.float32, torch.bfloat16, 0, 'three_pass'),  # r: 40-byte pixels
    ((1, 7, 5, 20), 4, torch.float32, torch.float32, 0, 'onchip'),       # 80-byte pixels
    ((2, 9, 3, 18), 3, torch.float32, torch.float32, 0, 'three_pass'),    # C % 4 != 0
    ((2, 16, 8, 32), 4, torch.float32, torch.bfloat16, 2, 'three_pass'),  # misaligned r
    ((2, 16, 8, 32), 4, torch.float32, torch.bfloat16, 4, 'three_pass'),  # r 8 bytes in
])
def test_residual_kernel_matches_plain_version(shape, red, x_dtype, r_dtype, offset, path):
    rng = np.random.RandomState(1)
    c, cr = shape[-1], shape[-1] // red
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(x_dtype).cuda()
    numel = int(np.prod(shape))
    r = torch.from_numpy(rng.rand(numel + offset).astype(np.float32)).to(r_dtype).cuda()
    r = r[offset:].view(shape)
    weights = _excite_weights(rng, c, cr)
    launches = ca.fused_channel_attention_residual.launches
    before = _res_route_counts()
    with torch.inference_mode():
        out = ca.fused_channel_attention_residual(x, r, *weights)
        again = ca.fused_channel_attention_residual(x, r, *weights)
        torch.cuda.synchronize()
        ref = ca.reference_channel_attention_residual(x, r, *weights)
    assert ca.fused_channel_attention_residual.launches == launches + 2
    took = tuple(a - b for a, b in zip(_res_route_counts(), before))
    assert took == RES_ROUTE_LAUNCHES[path], 'expected the %s path' % path
    assert out.dtype == r_dtype
    assert torch.equal(out, again)  # no atomics: the same bits every run
    if r_dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:  # 2 bf16 ULPs: the summation order of the pool can flip a rounding
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-6, rtol=1.6e-2)


def test_residual_three_pass_matches_onchip():
    """At the main shape both paths run: the same function up to the pool's order."""
    rng = np.random.RandomState(5)
    shape = (8, 128, 128, 64)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
    r = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda()
    weights = _excite_weights(rng, 64, 4)
    with torch.inference_mode():
        onchip = ca.fused_channel_attention_residual(x, r, *weights)
        three_pass = ca._res_three_pass(x, r, *weights)
    torch.testing.assert_close(onchip, three_pass, atol=1e-5, rtol=0)


def assert_tail_close(out, ref, r):
    """f32 out within 1e-5 abs; bf16 out within 2 bf16 ULPs of the output or, for the
    cast-first tail, of the bf16 branch (|branch| <= |out| + |r|), since the pool's
    summation order can flip a rounding."""
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
        return
    err = (out.float() - ref.float()).abs()
    bar = 1.6e-2 * (ref.float().abs() + r.float().abs()) + 1e-6
    assert bool((err <= bar).all()), 'max err %g' % err.max().item()


@pytest.mark.parametrize('shape,red,x_dtype,r_dtype,offset,path', [
    ((8, 128, 128, 64), 16, torch.float32, torch.bfloat16, 0, 'onchip'),  # int8 Q-RCAN
    ((8, 128, 128, 64), 16, torch.float32, torch.float32, 0, 'onchip'),
    ((7, 128, 128, 64), 16, torch.float32, torch.bfloat16, 0, 'onchip'),  # 4 + 3 images
    ((3, 37, 29, 64), 16, torch.float32, torch.bfloat16, 0, 'onchip'),    # ragged slabs
    ((2, 16, 8, 32), 4, torch.bfloat16, torch.bfloat16, 0, 'onchip'),
    ((1, 512, 512, 64), 16, torch.float32, torch.bfloat16, 0, 'stream'),
    ((2, 16, 8, 32), 4, torch.float32, torch.bfloat16, 2, 'three_pass'),  # misaligned r
    ((2, 9, 3, 18), 3, torch.bfloat16, torch.float32, 0, 'three_pass'),   # C % 8 != 0
])
@pytest.mark.parametrize('m,with_gate,cast_first', [(10, True, True), (0, True, True),
                                                    (10, False, False), (0, False, True)])
def test_residual_with_meta_gate_cast_first_matches_plain_version(
        shape, red, x_dtype, r_dtype, offset, path, m, with_gate, cast_first):
    (x, w1, b1, w2, b2), extra = _meta_gate_inputs(shape, red, x_dtype, m, with_gate, seed=14)
    x = (x - 0.5) * 4  # a conv output: signed
    numel = int(np.prod(shape))
    rng = np.random.RandomState(15)
    r = torch.from_numpy(rng.rand(numel + offset).astype(np.float32)).to(r_dtype).cuda()
    r = r[offset:].view(shape)
    args = (x, r, w1, b1, w2, b2)
    launches = ca.fused_channel_attention_residual.launches
    before = _res_route_counts()
    with torch.inference_mode():
        out = ca.fused_channel_attention_residual(*args, cast_first=cast_first, **extra)
        again = ca.fused_channel_attention_residual(*args, cast_first=cast_first, **extra)
        torch.cuda.synchronize()
        ref = ca.reference_channel_attention_residual(*args, cast_first=cast_first, **extra)
    assert ca.fused_channel_attention_residual.launches == launches + 2
    took = tuple(a - b for a, b in zip(_res_route_counts(), before))
    assert took == RES_ROUTE_LAUNCHES[path], 'expected the %s path' % path
    assert out.dtype == r_dtype and torch.equal(out, again)
    assert_tail_close(out, ref, r)


def test_rounds_route_matches_three_passes():
    """At int8 Q-RCAN's f32 map with meta and gate, the CA's rounds route against its
    three passes, and the cast-first tail (f32 carry) in rounds against its three
    passes: the same function up to the pool's order, within 1e-5."""
    args, extra = _meta_gate_inputs((8, 128, 128, 64), 16, torch.float32, 10, True, seed=16)
    r = torch.rand(args[0].shape, device='cuda')
    rounds = ca.fused_channel_attention.rounds_launches
    with torch.inference_mode():
        ours = ca.fused_channel_attention(*args, **extra)
        three_pass = ca._three_pass(*args, **extra)
        tail = ca.fused_channel_attention_residual(args[0], r, *args[1:], cast_first=True,
                                                   **extra)
        tail_three = ca._res_three_pass(args[0], r, *args[1:], cast_first=True, **extra)
    assert ca.fused_channel_attention.rounds_launches == rounds + 1
    torch.testing.assert_close(ours, three_pass, atol=1e-5, rtol=0)
    torch.testing.assert_close(tail, tail_three, atol=1e-5, rtol=0)


def test_rounds_smem_must_equal_the_cu_layout():
    """The rounds entry lays out the shared memory itself and refuses a plan that
    disagrees: one sized without the 10 meta values, or with a slab of r the CA op
    does not have."""
    args, extra = _meta_gate_inputs((8, 128, 128, 64), 16, torch.float32, 10, True, seed=17)
    props = torch.cuda.get_device_properties(0)
    plan_of = lambda r_itemsize, m: ca.res_onchip_plan(
        8, 128 * 128, 64, 4, 4, r_itemsize, True, props.multi_processor_count,
        props.shared_memory_per_block_optin, m=m)
    x = args[0]
    with torch.inference_mode():
        out = ca._rounds(x, None, *args[1:], torch.empty_like(x), plan_of(0, 10), **extra)
        torch.testing.assert_close(out, ca.reference_channel_attention(*args, **extra),
                                   atol=1e-5, rtol=0)
        for bad in (plan_of(0, 0), plan_of(2, 10)):
            with pytest.raises(RuntimeError, match='CUDA error'):
                ca._rounds(x, None, *args[1:], torch.empty_like(x), bad, **extra)


DIV2K_LR = (1, 339, 510, 64)  # the f32 map of a DIV2K validation image's LR


def _stream_inputs(shape, x_dtype, r_dtype, m, with_gate, seed):
    """x (a signed conv output), r (None for the CA op), the weights and meta/gate."""
    args, extra = _meta_gate_inputs(shape, 16, x_dtype, m, with_gate, seed)
    x = ((args[0].float() - 0.5) * 4).to(x_dtype)
    r = None if r_dtype is None else torch.rand(shape, device='cuda').to(r_dtype)
    return (x, r) + args[1:], extra


@pytest.mark.parametrize('shape', [DIV2K_LR, (2, 339, 510, 64), (1, 384, 512, 64)])
@pytest.mark.parametrize('r_dtype,cast_first', [(None, False), (torch.bfloat16, False),
                                                (torch.bfloat16, True), (torch.float32, False),
                                                (torch.float32, True)])
@pytest.mark.parametrize('m,with_gate', [(0, False), (10, True)])
def test_stream_kernel_matches_plain_version(shape, r_dtype, cast_first, m, with_gate):
    """ca_stream in each mode (the CA; the tail with r bf16 or f32, plain or cast first)
    at DIV2K size, f32 x, with and without meta and gate: the route the plan gives,
    within 1e-5 (f32) or 2 bf16 ULPs, the same bits on a rerun."""
    (x, r, *weights), extra = _stream_inputs(shape, torch.float32, r_dtype, m, with_gate,
                                             seed=20)
    with torch.inference_mode():
        if r is None:
            before = _ca_route_counts()
            out = ca.fused_channel_attention(x, *weights, **extra)
            again = ca.fused_channel_attention(x, *weights, **extra)
            torch.cuda.synchronize()
            assert _ca_route_took(before) == ROUTE_LAUNCHES['stream']
            ref = ca.reference_channel_attention(x, *weights, **extra)
            torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
        else:
            before = _res_route_counts()
            op = ca.fused_channel_attention_residual
            out = op(x, r, *weights, cast_first=cast_first, **extra)
            again = op(x, r, *weights, cast_first=cast_first, **extra)
            torch.cuda.synchronize()
            took = tuple(a - b for a, b in zip(_res_route_counts(), before))
            assert took == RES_ROUTE_LAUNCHES['stream']
            ref = ca.reference_channel_attention_residual(x, r, *weights,
                                                          cast_first=cast_first, **extra)
            assert out.dtype == r.dtype
            assert_tail_close(out, ref, r)
    assert torch.equal(out, again)


@pytest.mark.parametrize('r_dtype', [None, torch.bfloat16])
def test_stream_and_three_passes_agree(r_dtype):
    """At DIV2K size the stream route and three passes give the same function within
    1e-5."""
    (x, r, *weights), extra = _stream_inputs(DIV2K_LR, torch.float32, r_dtype, 10, True,
                                             seed=21)
    props = torch.cuda.get_device_properties(0)
    n, h, w, c = x.shape
    plan = ca.stream_plan(n, h * w, c, 4, 4, 0 if r is None else 2, True,
                          props.multi_processor_count, props.shared_memory_per_block_optin,
                          m=10)
    with torch.inference_mode():
        out = ca._stream(x, r, *weights, torch.empty_like(x if r is None else r), plan,
                         **extra)
        three = (ca._three_pass(x, *weights, **extra) if r is None
                 else ca._res_three_pass(x, r, *weights, **extra))
    torch.testing.assert_close(out.float(), three.float(), atol=1e-5, rtol=0)


def test_stream_smem_must_equal_the_cu_layout():
    """The stream entry lays out the shared memory itself and refuses a plan that
    disagrees: one sized without the 10 meta values, with a ring of r the CA op does
    not have, 16 bytes off, or with an empty head."""
    args, extra = _meta_gate_inputs(DIV2K_LR, 16, torch.float32, 10, True, seed=22)
    props = torch.cuda.get_device_properties(0)
    plan_of = lambda r_itemsize, m: ca.stream_plan(
        1, 339 * 510, 64, 4, 4, r_itemsize, True, props.multi_processor_count,
        props.shared_memory_per_block_optin, m=m)
    x = args[0]
    plan = plan_of(0, 10)
    with torch.inference_mode():
        out = ca._stream(x, None, *args[1:], torch.empty_like(x), plan, **extra)
        torch.testing.assert_close(out, ca.reference_channel_attention(*args, **extra),
                                   atol=1e-5, rtol=0)
        for bad in (plan_of(0, 0), plan_of(2, 10), plan[:4] + (plan[4] + 16,),
                    plan[:3] + (0, ca.stream_smem_bytes(0, 64, 4, 4, 0, 10))):
            with pytest.raises(RuntimeError, match='CUDA error'):
                ca._stream(x, None, *args[1:], torch.empty_like(x), bad, **extra)


@pytest.mark.parametrize('n,h,w,cin,cout', [(8, 32, 32, 64, 64), (2, 16, 16, 3, 64),
                                            (1, 2, 3, 64, 3)])
def test_int_mm_conv_on_card_matches_int64(n, h, w, cin, cout):
    rng = np.random.RandomState(2)
    x_q = torch.from_numpy(rng.randint(-127, 128, (n, h, w, cin)).astype(np.int8))
    kernel = torch.from_numpy(rng.randint(-127, 128, (3, 3, cin, cout)).astype(np.int8))
    acc = qz.conv_int8_accumulate(x_q.cuda(), kernel.cuda()).cpu()
    xp = torch.nn.functional.pad(x_q.long(), (0, 0, 1, 1, 1, 1))
    ref = sum(torch.einsum('nhwc,co->nhwo', xp[:, i:i + h, j:j + w], kernel[i, j].long())
              for i in range(3) for j in range(3))
    assert acc.dtype == torch.int32
    assert torch.equal(acc.long(), ref)


def test_int8_rcan_on_card_matches_cpu():
    """The same quantised state and scales (calibrated on the CPU) on both devices;
    every RCAB tail is one launch of the CA + residual kernel on the card."""
    kw = dict(scale=4, n_resgroups=2, n_resblocks=2, n_feats=32, reduction=16, seed=1)
    host, card = define_model('rcan', device='cpu', **kw), define_model('rcan', device='cuda',
                                                                        **kw)
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 16, 16, 3).astype(np.float32))
    for h in (host, card):
        h.set_int8(True)
    host._ensure_int8_ctx(x)
    card.load_int8_state(*host._int8_ctx[1:])
    launches = ca.fused_channel_attention_residual.launches
    with torch.inference_mode():
        ref = host._int8_ctx[0](x)
        out = card._int8_ctx[0](x.cuda()).cpu()
    assert ca.fused_channel_attention_residual.launches == launches + 4
    mse = (out - ref).pow(2).mean().item()
    assert mse == 0 or 10 * np.log10(1.0 / mse) >= 60


def test_int8_calibration_on_card_is_true_f32():
    """With TF32 allowed globally, calibration still runs its convs in f32: the
    scales agree with the CPU's to rtol 1e-5."""
    kw = dict(scale=4, n_resgroups=2, n_resblocks=2, n_feats=32, reduction=16, seed=1)
    host, card = define_model('rcan', device='cpu', **kw), define_model('rcan', device='cuda',
                                                                        **kw)
    x = torch.from_numpy(np.random.RandomState(4).rand(2, 16, 16, 3).astype(np.float32))
    torch.backends.cudnn.allow_tf32 = True  # the fixture restores it
    for h in (host, card):
        h.set_int8(True)
        h._ensure_int8_ctx(x.to(h.device))
    assert torch.backends.cudnn.allow_tf32  # the library set no global flag
    theirs, ours = host._int8_ctx[2], card._int8_ctx[2]
    assert sorted(theirs) == sorted(ours)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=0, err_msg=k)


@pytest.mark.parametrize('shape,with_gate,path', [
    ((8, 64, 64, 64), False, 'onchip'),       # the training shape (RCAN)
    ((8, 64, 64, 64), True, 'onchip'),        # with Q-RCAN's q_node gate
    ((8, 128, 128, 64), False, 'rounds'),      # the f32 eval's map: 2 rounds
])
def test_function_grads_match_plain_autograd(shape, with_gate, path):
    """Under autograd the op runs the kernel forward (launch counted, path as
    planned) and the plain VJP: output within 1e-5, every grad within 1e-5 of plain
    autograd through reference_channel_attention, the same bits on a rerun."""
    args, extra = _meta_gate_inputs(shape, 16, torch.float32, 0, with_gate, seed=10)
    cot = torch.from_numpy(np.random.RandomState(11).randn(*shape).astype(np.float32)).cuda()

    def grads(op):
        leaves = [t.detach().clone().requires_grad_() for t in args]
        gate = extra['gate'].clone().requires_grad_() if with_gate else None
        out = op(*leaves, gate=gate)
        out.backward(cot)
        return out.detach(), [t.grad for t in leaves] + ([gate.grad] if with_gate else [])

    launches = ca.fused_channel_attention.launches
    before = _ca_route_counts()
    out, ours = grads(ca.fused_channel_attention)
    again, ours_again = grads(ca.fused_channel_attention)
    assert ca.fused_channel_attention.launches == launches + 2
    assert _ca_route_took(before) == ROUTE_LAUNCHES[path], 'expected the %s path' % path
    ref, theirs = grads(ca.reference_channel_attention)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    assert torch.equal(out, again)
    for a, b, c in zip(ours, theirs, ours_again):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        assert torch.equal(a, c)


def test_qrcan_train_step_on_card_matches_cpu():
    """One run_train step of a 2 x 2 Q-RCAN (standard + q_node, 64 features), f32 with
    TF32 off: the card (CA kernel forward, 4 launches) against the CPU from the same
    weights and batch: loss within rtol 2e-4, weights within 5e-5."""
    kw = dict(scale=4, n_resgroups=2, n_resblocks=2, n_feats=64, seed=1,
              style='standard', include_q_layer=True, metadata=['blur_kernel'],
              lr=1e-4, scheduler='cosine_annealing_warm_restarts',
              scheduler_params={'restart_period': 125000, 'lr_min': 1e-7})
    card, host = define_model('qrcan', device='cuda', **kw), define_model('qrcan',
                                                                         device='cpu', **kw)
    rng = np.random.RandomState(12)
    batch = {'lr': rng.randint(0, 256, (2, 16, 16, 3)).astype(np.uint8),
             'hr': rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
             'metadata': rng.rand(2, 10).astype(np.float32)}
    launches = ca.fused_channel_attention.launches
    loss_card = float(card.run_train(**batch)[0])
    assert ca.fused_channel_attention.launches == launches + 4
    loss_host = float(host.run_train(**batch)[0])
    assert loss_card == pytest.approx(loss_host, rel=2e-4)
    for a, b in zip(card.module.parameters(), host.module.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), atol=5e-5, rtol=0)
    assert card.step == host.step == 1


def _int8_card_and_host(name, kw, residual_dtype='bfloat16', meta_cols=0):
    """The same seeded model on the card and the CPU, int8 on, each calibrated on the
    same batch (and metadata) with TF32 allowed globally (calibration turns it off for
    itself); then the CPU's quantised state loaded into the card's handler.  Returns
    (card, host, x, meta, the two calibrations' scales)."""
    host = define_model(name, device='cpu', **kw)
    card = define_model(name, device='cuda', **kw)
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.rand(2, 16, 16, 3).astype(np.float32))
    meta = None
    if meta_cols:
        meta = torch.from_numpy(rng.dirichlet(np.ones(meta_cols) * 5, 2).astype(np.float32))
    for h in (host, card):
        h.set_metadata_keys(['blur_kernel'] * meta_cols)
        h.set_int8(True, residual_dtype=residual_dtype)
    host._ensure_int8_ctx(x, meta)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    card._ensure_int8_ctx(x.cuda(), None if meta is None else meta.cuda())
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    scales = (host._int8_ctx[2], card._int8_ctx[2])
    card.load_int8_state(*host._int8_ctx[1:])
    return card, host, x, meta, scales


def _assert_int8_card_matches_cpu(card, host, x, meta, scales):
    theirs, ours = scales
    assert sorted(theirs) == sorted(ours)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=0, err_msg=k)
    with torch.inference_mode():
        ref = host._int8_ctx[0](x, meta)
        out = card._int8_ctx[0](x.cuda(), None if meta is None else meta.cuda()).cpu()
    assert torch.isfinite(out).all() and out.shape == ref.shape
    mse = (out - ref).pow(2).mean().item()
    assert mse == 0 or 10 * np.log10(1.0 / mse) >= 60


@pytest.mark.parametrize('residual_dtype', ['float32', 'bfloat16', 'int16'])
def test_int8_edsr_on_card_matches_cpu(residual_dtype):
    """Int8 EDSR with each residual carry (int16: the fixed-point grid), the same
    quantised state on both devices; no kernel of ours on this path."""
    kw = dict(scale=4, num_features=32, num_blocks=3, seed=1)
    args = _int8_card_and_host('edsr', kw, residual_dtype)
    launches = ca.fused_channel_attention.launches
    _assert_int8_card_matches_cpu(*args)
    assert ca.fused_channel_attention.launches == launches


def test_int8_qrcan_on_card_matches_cpu():
    """Int8 Q-RCAN (max_concat, a q_node in every block): every QRCAB tail is one
    launch of the CA + residual kernel (cast first) on the f32 map and the bfloat16
    carry, with the metadata and the q_node's gate, on the path the plan gives; no CA
    launch."""
    kw = dict(scale=4, n_resgroups=2, n_resblocks=2, n_feats=64, seed=1, style='max_concat',
              include_q_layer=True, metadata=['blur_kernel'])
    args = _int8_card_and_host('qrcan', kw, meta_cols=10)
    launches = ca.fused_channel_attention.launches
    res = (ca.fused_channel_attention_residual.launches,
           ca.fused_channel_attention_residual.onchip_launches)
    _assert_int8_card_matches_cpu(*args)
    props = torch.cuda.get_device_properties(0)
    plan = ca.res_onchip_plan(2, 16 * 16, 64, 4, 4, 2, True, props.multi_processor_count,
                              props.shared_memory_per_block_optin, m=10)
    assert ca.fused_channel_attention.launches == launches
    assert ca.fused_channel_attention_residual.launches == res[0] + 4
    assert ca.fused_channel_attention_residual.onchip_launches == res[1] + (4 if plan else 0)


def test_int8_qedsr_on_card_matches_cpu():
    """Int8 Q-EDSR with the gate's nonlinearity, and its f32 module forward, card
    against CPU."""
    kw = dict(scale=4, num_features=32, num_blocks=2, seed=1, metadata=['blur_kernel'],
              q_layer_nonlinearity=True)
    card, host, x, meta, scales = _int8_card_and_host('qedsr', kw, meta_cols=10)
    _assert_int8_card_matches_cpu(card, host, x, meta, scales)
    with torch.inference_mode():
        out = card.forward(x.cuda(), meta.cuda()).cpu()
        ref = host.forward(x, meta)
    torch.testing.assert_close(out, ref, atol=5e-4, rtol=0)
