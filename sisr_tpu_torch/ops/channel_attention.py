"""Fused channel-attention "squeeze-and-excite": a hand-written CUDA kernel for Hopper.

Computes ``out = x * sigmoid(relu(mean_hw(x) @ w1 + b1) @ w2 + b2)``, the CALayer of
RCAN, with the signature and layout of sisr_tpu's ``fused_channel_attention``: x is
(N, H, W, C), w1 (C, C/r), b1 (C/r), w2 (C/r, C), b2 (C).  A channels_last NCHW
activation permuted to (0, 2, 3, 1) is exactly a contiguous NHWC view, so the model
passes its activations without a copy.  Two optional per-image inputs carry Q-RCAN's
meta-attention (``models/q_layers.py``): ``meta`` (N, M) is concatenated onto the
pooled vector before the first product (w1 then has C + M rows), and ``gate`` (N, C)
multiplies the attention after the sigmoid, ``out = x * (att * gate)``.  ``valid_hw``
(vh, vw), one host pair for the batch, is the valid extent of a bucketed eval's
zero-padded map (``ops/masking.py``): the pool averages only the pixels whose row is
under vh and column under vw (sisr_tpu's ``masked_global_mean``), and the scale still
multiplies every pixel.  The full extent gives the call without one, bit for bit.

:func:`fused_channel_attention_residual` is the int8 RCAB block tail,
``out = (float(x) * att(x) + float(r)).to(r.dtype)``, with the signature of sisr_tpu's
op of the same name; it also takes ``meta``, ``gate`` and ``cast_first``, which makes
it the int8 QRCAB tail of Q-RCAN, ``fused_channel_attention(x, ..., meta,
gate).to(r.dtype) + r``.

On a CUDA tensor each wrapper launches ``ops/cuda/csrc/channel_attention.cu`` (design
and bound in that file) or raises; on a CPU tensor it runs its plain version
(:func:`reference_channel_attention`, :func:`reference_channel_attention_residual`),
which the kernel is held against.  Each wrapper's ``launches`` counts its kernel
launches, and ``fused_channel_attention.masked_launches`` those given a valid extent
(every call of a bucketed eval's forward).  The routes are chosen from the shape and
the card alone.  The CA has four (:func:`ca_plan`): one cooperative launch that holds
the whole batch's map in shared memory (:func:`onchip_plan`, counted also in
``onchip_launches`` and, by shape and dtype, in ``onchip_shapes``), one that streams
the batch through it in rounds of images (:func:`res_onchip_plan` with no r, counted
also in ``rounds_launches``), one that takes one image a round with part of each
slab in shared memory and the rest read again from L2 (:func:`stream_plan`, counted
also in ``stream_launches``), and three launches for pixels that are not whole
16-byte units or a misaligned x.  The CA + residual has the rounds and the stream
routes (:func:`ca_res_plan`, counted also in its ``onchip_launches`` and
``stream_launches``) and three launches.  Each of the rounds and the stream routes is
one kernel for both ops.

Both ops have a backward, as sisr_tpu's ``custom_vjp`` ops do: when autograd records
(grad mode on and an input requires a grad), the wrapper runs as a
``torch.autograd.Function`` whose forward is the one above on detached inputs (the
kernel on the card) and whose backward recomputes the plain version and returns its
vector-Jacobian product.  There is no backward kernel.

Both ops are also registered as ``torch.library`` custom ops, ``sisr::ca`` and
``sisr::ca_res`` (:data:`OP_NAMESPACE`): the CUDA implementation plans and launches the
kernels above, the CPU one is the plain version, and a fake implementation gives the
output's shape and type, so ``torch.export`` traces a forward through them and an
exported program (``tools/export_serving.py``) launches the kernels when it runs on
the card.  A call made while tracing (``torch.compiler.is_compiling()``, or a fake
tensor) goes through the op; an eager call goes straight to the launcher, since the
op's dispatch costs host time on paths that make 200 calls a forward (PERF.md).
"""
import collections
import ctypes
import functools
from typing import List, Optional

import torch
from torch import Tensor

from .cuda import build as cuda_build

_THREADS = 256  # kThreads in channel_attention.cu
_ONCHIP_CHUNKS = 4  # kOnchipChunks in channel_attention.cu
_RES_CHUNKS = 2  # kResChunks in channel_attention.cu
_STREAM_CHUNKS = 4  # kStreamChunks
_STREAM_SLOTS = 2  # kStreamSlots
_STREAM_SLOT_BYTES = 8192  # kStreamSlotBytes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the QCALayer styles that are this op with Q-RCAN's meta or gate (models/q_layers.py)
KERNEL_STYLES = ('standard', 'max_concat', 'modulate')
_SIGNATURES = {
    'sisr_ca_forward': (
        ctypes.c_int, [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
        + [ctypes.c_void_p]),
    'sisr_ca_onchip_forward': (
        ctypes.c_int, [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 5
        + [ctypes.c_void_p]),
    'sisr_ca_rounds_forward': (
        ctypes.c_int, [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 5
        + [ctypes.c_void_p]),
    'sisr_ca_stream_forward': (
        ctypes.c_int, [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6
        + [ctypes.c_void_p]),
    'sisr_ca_res_forward': (
        ctypes.c_int, [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
}
OP_NAMESPACE = 'sisr'  # the custom ops sisr::ca and sisr::ca_res
_NO_R = -1  # r_dtype of the rounds and stream entries for the CA op (no r)
# the three-pass excite keeps 2*C + M + Cr floats in the 48 KB of static shared memory
_MAX_EXCITE_FLOATS = 12288
_DEVICES = {}  # CUDA device index -> (library handle, SM count, opt-in shared memory)


def _masked(x, valid_hw):
    """Whether ``valid_hw`` is an extent smaller than x's (N, H, W, C) map."""
    return valid_hw is not None and tuple(valid_hw) != tuple(x.shape[1:3])


def _attention(x, w1, b1, w2, b2, meta=None, valid_hw=None):
    """att (N, C) in f32: mean over H, W (over the valid extent ``valid_hw``: its f32
    sum over the pixel count, as sisr_tpu's masked_global_mean), then
    sigmoid(relu([pooled | meta] @ w1 + b1) @ w2 + b2).  Autocast is off: the excite
    stays f32 under a bf16 forward, as in the kernel."""
    with torch.autocast(x.device.type, enabled=False):
        if _masked(x, valid_hw):
            vh, vw = valid_hw
            # the count as a device tensor (a true division, and no host copy)
            pooled = x[:, :vh, :vw].float().sum(dim=(1, 2)) / x.new_full(
                (), float(vh * vw), dtype=torch.float32)
        else:
            pooled = x.float().mean(dim=(1, 2))
        if meta is not None:
            pooled = torch.cat([pooled, meta.float()], dim=1)
        hidden = torch.relu(pooled @ w1.float() + b1.float())
        return torch.sigmoid(hidden @ w2.float() + b2.float())


def reference_channel_attention(x, w1, b1, w2, b2, meta=None, gate=None, valid_hw=None):
    """Plain PyTorch version (sisr_tpu's ``_reference_ca``, with ``meta``, ``gate`` and
    ``valid_hw`` as in the module docstring): pool and excite in f32, the gate's
    product in f32, scale in x's dtype."""
    att = _attention(x, w1, b1, w2, b2, meta, valid_hw)
    if gate is not None:
        att = att * gate.float()
    return x * att[:, None, None, :].to(x.dtype)


def reference_channel_attention_residual(x, r, w1, b1, w2, b2, meta=None, gate=None,
                                         cast_first=False):
    """Plain PyTorch version of the CA + residual tail (sisr_tpu's ``_reference_ca_res``
    and Pallas body): ``float(x) * att + float(r)`` in f32, one cast to r's dtype, with
    att taking ``meta`` and ``gate`` as the CA does.  With ``cast_first`` it is the
    int8 QRCAB tail, sisr_tpu's rounding order for Q-RCAN: the CA op's output cast to
    r's dtype, then added in r's dtype."""
    if cast_first:
        return reference_channel_attention(x, w1, b1, w2, b2, meta, gate).to(r.dtype) + r
    att = _attention(x, w1, b1, w2, b2, meta)
    if gate is not None:
        att = att * gate.float()
    return (x.float() * att[:, None, None, :] + r.float()).to(r.dtype)


def launch_plan(n, hw, c, itemsize, aligned, sm_count):
    """(vectorized, slabs) for one launch: 16-byte vectors when a pixel's channels
    fill whole vectors and x is aligned; enough pixel slabs per image for about
    four blocks per SM, each slab at least four rows of the block's threads."""
    vectorized = aligned and (c * itemsize) % 16 == 0
    vec = 16 // itemsize if vectorized else 1
    lanes = c // vec
    chunk_lanes = min(lanes, _THREADS)
    rows = _THREADS // chunk_lanes
    chunks = -(-lanes // chunk_lanes)
    slabs = max(1, min(-(-4 * sm_count // (n * chunks)), -(-hw // (4 * rows))))
    return vectorized, slabs


def _onchip_floats(c, cr, itemsize, m=0):
    """Floats of the on-chip kernels' scratch: the block's row sums, the excite's
    weights (w1 with its M rows for the meta), the partial sums, pooled with the meta,
    hidden and att."""
    rows = _THREADS // (c * itemsize // 16)
    parts = _THREADS // c if c < _THREADS else 1
    return rows * c + (2 * c + m) * cr + cr + c + c * parts + c + m + cr + c


def onchip_smem_bytes(slab_pixels, c, cr, itemsize, m=0):
    """Dynamic shared memory of the on-chip kernel, laid out as ``ca_onchip`` lays it
    out for M meta values: the slab, the float scratch, then one 8-byte mbarrier per
    chunk."""
    floats_end = slab_pixels * c * itemsize + 4 * _onchip_floats(c, cr, itemsize, m)
    return -(-floats_end // 16) * 16 + 8 * _ONCHIP_CHUNKS


def res_onchip_smem_bytes(slab_pixels, c, cr, x_itemsize, r_itemsize, m=0):
    """Dynamic shared memory of ``ca_rounds``, laid out as it lays it out: the slab of
    x; from a 128-byte boundary, the slab of r (``r_itemsize`` 0: no r); the float
    scratch for ``m`` meta values; then one mbarrier for each chunk of x and one for
    each chunk of r."""
    r_offset = -(-slab_pixels * c * x_itemsize // 128) * 128
    floats_end = r_offset + slab_pixels * c * r_itemsize + 4 * _onchip_floats(
        c, cr, x_itemsize, m)
    return -(-floats_end // 16) * 16 + 8 * 2 * _RES_CHUNKS


def onchip_plan(n, hw, c, cr, itemsize, aligned, sm_count, smem_optin, m=0):
    """(blocks_per_image, slab_pixels, smem_bytes) of the one-launch kernel that holds
    the map in shared memory, or None for the three-pass path.  At most one block per
    SM, so every block is resident at once; each block owns ``slab_pixels``
    contiguous pixels of its image (the last block the rest).  Taken only when every
    image gets a block, a pixel is whole 16-byte units and x is 16-byte aligned (bulk
    copies move 16-byte units), and slab plus scratch (with ``m`` meta values) fit
    ``smem_optin``, the opt-in shared memory of one block."""
    lanes, ragged = divmod(c * itemsize, 16)
    if not aligned or ragged or lanes > _THREADS or n > sm_count:
        return None
    slab = -(-hw // (sm_count // n))
    smem = onchip_smem_bytes(slab, c, cr, itemsize, m)
    return (-(-hw // slab), slab, smem) if smem <= smem_optin else None


def res_onchip_plan(n, hw, c, cr, x_itemsize, r_itemsize, aligned, sm_count, smem_optin,
                    m=0):
    """(rounds, images_per_round, blocks_per_image, slab_pixels, smem_bytes) of the
    one-launch kernel that streams the batch through shared memory in rounds of
    images (``ca_rounds``: the CA + residual, or with ``r_itemsize`` 0 the CA alone),
    or None.  The fewest rounds R for which I = ceil(n / R) images of sm_count // I
    blocks each have slabs (ceil(hw / blocks) pixels of x and of r, and scratch with
    ``m`` meta values) within ``smem_optin``; then as many blocks per image as that
    slab needs, so no block is empty.  At most one block per SM, so every block is
    resident at once.  Taken only when the pixels of x and of r are whole 16-byte
    units (bulk copies move 16-byte units) and ``aligned`` (for the CA + residual
    :func:`res_onchip_aligned`)."""
    lanes, ragged = divmod(c * x_itemsize, 16)
    if not aligned or ragged or (c * r_itemsize) % 16 or lanes > _THREADS:
        return None
    rounds = 1
    while rounds <= n:
        images = -(-n // rounds)
        if images <= sm_count:
            slab = -(-hw // (sm_count // images))
            smem = res_onchip_smem_bytes(slab, c, cr, x_itemsize, r_itemsize, m)
            if smem <= smem_optin:
                return rounds, images, -(-hw // slab), slab, smem
        # the fewest rounds that take fewer images each
        rounds = -(-n // (images - 1)) if images > 1 else n + 1
    return None


def _stream_ring_pixels(c, r_itemsize):
    """Pixels of r a slot of ``ca_stream``'s ring holds (none without r)."""
    return max(1, _STREAM_SLOT_BYTES // (c * r_itemsize)) if r_itemsize else 0


def stream_smem_bytes(head_pixels, c, cr, x_itemsize, r_itemsize, m=0):
    """Dynamic shared memory of ``ca_stream``, laid out as it lays it out: the slab's
    head of x; from a 128-byte boundary, the ring of r (``r_itemsize`` 0: none); the
    float scratch for ``m`` meta values; then one mbarrier for each chunk of the head
    and one for each slot of the ring."""
    ring_offset = -(-head_pixels * c * x_itemsize // 128) * 128
    floats_end = (ring_offset + _STREAM_SLOTS * _stream_ring_pixels(c, r_itemsize) * c
                  * r_itemsize + 4 * _onchip_floats(c, cr, x_itemsize, m))
    return -(-floats_end // 16) * 16 + 8 * (_STREAM_CHUNKS + _STREAM_SLOTS)


def stream_plan(n, hw, c, cr, x_itemsize, r_itemsize, aligned, sm_count, smem_optin, m=0):
    """(rounds, blocks_per_image, slab_pixels, head_pixels, smem_bytes) of the
    one-launch kernel that takes one image a round (``ca_stream``: the CA + residual,
    or with ``r_itemsize`` 0 the CA alone), or None.  One block per SM at most, each
    owning ceil(hw / sm_count) contiguous pixels of the image (the last block the
    rest, so none is empty); the first ``head_pixels`` of them, as many as fit
    ``smem_optin`` beside the ring of r and the scratch (with ``m`` meta values), sit
    in shared memory.  Taken only when the pixels of x and of r are whole 16-byte units
    and ``aligned`` (as for :func:`res_onchip_plan`)."""
    lanes, ragged = divmod(c * x_itemsize, 16)
    if not aligned or ragged or (c * r_itemsize) % 16 or lanes > _THREADS:
        return None
    slab = -(-hw // sm_count)
    room = smem_optin - stream_smem_bytes(0, c, cr, x_itemsize, r_itemsize, m)
    head = min(slab, max(0, room // (c * x_itemsize)))
    while head and stream_smem_bytes(head, c, cr, x_itemsize, r_itemsize, m) > smem_optin:
        head -= 1  # the head's 128-byte round-up
    if not head:
        return None
    return (n, -(-hw // slab), slab, head,
            stream_smem_bytes(head, c, cr, x_itemsize, r_itemsize, m))


def ca_plan(n, hw, c, cr, itemsize, aligned, sm_count, smem_optin, m=0):
    """The CA op's route and its plan, from the shape and the card alone, in this
    order: ('onchip', :func:`onchip_plan`) where the whole batch fits on chip at once;
    ('rounds', :func:`res_onchip_plan` with no r) where it streams through in rounds;
    ('stream', :func:`stream_plan` with no r) where not even one image fits; else
    ('three_pass', None).  ``aligned``: x 16-byte aligned."""
    plan = onchip_plan(n, hw, c, cr, itemsize, aligned, sm_count, smem_optin, m)
    if plan is not None:
        return 'onchip', plan
    plan = res_onchip_plan(n, hw, c, cr, itemsize, 0, aligned, sm_count, smem_optin, m)
    if plan is not None:
        return 'rounds', plan
    plan = stream_plan(n, hw, c, cr, itemsize, 0, aligned, sm_count, smem_optin, m)
    if plan is not None:
        return 'stream', plan
    return 'three_pass', None


def ca_res_plan(n, hw, c, cr, x_itemsize, r_itemsize, aligned, sm_count, smem_optin, m=0):
    """The CA + residual op's route and its plan, in this order: ('rounds',
    :func:`res_onchip_plan`), ('stream', :func:`stream_plan`), else ('three_pass',
    None).  ``aligned``: :func:`res_onchip_aligned`."""
    for route, plan_of in (('rounds', res_onchip_plan), ('stream', stream_plan)):
        plan = plan_of(n, hw, c, cr, x_itemsize, r_itemsize, aligned, sm_count, smem_optin,
                       m)
        if plan is not None:
            return route, plan
    return 'three_pass', None


def _check_args(x, w1, b1, w2, b2, op='fused_channel_attention', meta=None, gate=None,
                valid_hw=None):
    if x.dim() != 4:
        raise ValueError('%s: x must be (N, H, W, C), got %s' % (op, tuple(x.shape)))
    if x.dtype not in _DTYPE_CODES:
        raise TypeError('%s: x must be float32 or bfloat16, got %s' % (op, x.dtype))
    if not x.is_contiguous():
        raise ValueError('%s: x must be a contiguous NHWC tensor (a channels_last NCHW '
                         'activation permuted to 0,2,3,1)' % op)
    n, h, w, c = x.shape
    if n == 0 or h * w == 0 or c == 0:
        raise ValueError('%s: empty map %s' % (op, tuple(x.shape)))
    if n > 65535:
        raise ValueError('%s: batch %d exceeds the grid limit 65535' % (op, n))
    if valid_hw is not None:
        vh, vw = (int(v) for v in valid_hw)
        if not (0 < vh <= h and 0 < vw <= w):
            raise ValueError('%s: valid extent %s outside the %dx%d map'
                             % (op, tuple(valid_hw), h, w))
    if meta is not None and (meta.dim() != 2 or meta.shape[0] != n or meta.shape[1] == 0):
        raise ValueError('%s: meta must be (N, M) with N=%d, M > 0, got %s'
                         % (op, n, tuple(meta.shape)))
    m = 0 if meta is None else meta.shape[1]
    if w1.dim() != 2 or w1.shape[0] != c + m or w1.shape[1] == 0:
        raise ValueError('%s: w1 must be (C + M, Cr) with C=%d, M=%d, got %s'
                         % (op, c, m, tuple(w1.shape)))
    cr = w1.shape[1]
    if 2 * c + m + cr > _MAX_EXCITE_FLOATS:
        raise ValueError('%s: C=%d, M=%d, Cr=%d exceed the excite\'s shared memory'
                         % (op, c, m, cr))
    checked = [(b1, (cr,), 'b1'), (w2, (cr, c), 'w2'), (b2, (c,), 'b2')]
    if gate is not None:
        checked.append((gate, (n, c), 'gate'))
    for t, shape, label in checked:
        if tuple(t.shape) != shape:
            raise ValueError('%s: %s must be %s, got %s'
                             % (op, label, shape, tuple(t.shape)))
    extras = [t for t in (meta, gate) if t is not None]
    for t in [w1, b1, w2, b2] + extras:
        if t.device != x.device:
            raise ValueError('%s: weights on %s, x on %s' % (op, t.device, x.device))
        if not t.is_floating_point():
            raise TypeError('%s: weights, meta and gate must be floating point, got %s'
                            % (op, t.dtype))


def _check_residual_args(x, r, w1, b1, w2, b2, meta=None, gate=None):
    op = 'fused_channel_attention_residual'
    _check_args(x, w1, b1, w2, b2, op=op, meta=meta, gate=gate)
    if r.dtype not in _DTYPE_CODES:
        raise TypeError('%s: r must be float32 or bfloat16, got %s' % (op, r.dtype))
    if tuple(r.shape) != tuple(x.shape) or r.device != x.device:
        raise ValueError('%s: r must match x in shape and device: r %s on %s, x %s on %s'
                         % (op, tuple(r.shape), r.device, tuple(x.shape), x.device))
    if not r.is_contiguous():
        raise ValueError('%s: r must be a contiguous NHWC tensor' % op)


def _records_grad(*tensors):
    """Whether autograd records a call on these inputs (None entries allowed)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def _plain_vjp(plain, ctx, grad):
    """The backward of an op whose forward is a kernel: recompute ``plain`` on the
    saved inputs under autograd and return its VJP, a grad for each input that needs
    one (sisr_tpu's ``_bwd`` / ``_res_bwd``).  The VJP runs in f32 with autocast off:
    each saved input and the incoming grad are taken as f32 (a bf16 map of a bf16
    train step too), and each grad is returned in its input's type (bf16 for that
    map, f32 for the weights).  For f32 inputs no cast happens."""
    needs = ctx.needs_input_grad
    inputs = ctx.saved_tensors
    with torch.enable_grad(), torch.autocast(grad.device.type, enabled=False):
        leaves = [None if t is None else t.detach().float().requires_grad_(need)
                  for t, need in zip(inputs, needs)]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(plain(*leaves), wanted, grad.float()))
    return tuple(next(grads).to(t.dtype) if leaf is not None and leaf.requires_grad
                 else None for t, leaf in zip(inputs, leaves))


class _ChannelAttention(torch.autograd.Function):
    """fused_channel_attention under autograd: the kernel forward, the plain VJP.

    Under a bf16 autocast the Function receives mixed types, and casts nothing by
    hand before the launch: ``x`` arrives as the convs left it (bf16) and the kernel
    runs on that map; the weights, ``meta`` and ``gate`` arrive f32 (or bf16 from a
    product) and the launch reads them as f32, as in eval.  The output is in x's
    type.  No ``custom_fwd`` cast: it would cast every input to one type, and the
    map must not become an f32 copy.  The backward is :func:`_plain_vjp` in f32."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, meta, gate, valid_hw):
        ctx.save_for_backward(x, w1, b1, w2, b2, meta, gate)
        ctx.valid_hw = valid_hw
        return _ca_forward(x, w1, b1, w2, b2, meta, gate, valid_hw)

    @staticmethod
    def backward(ctx, grad):
        plain = functools.partial(reference_channel_attention, valid_hw=ctx.valid_hw)
        return _plain_vjp(plain, ctx, grad) + (None,)  # no grad for valid_hw


class _ChannelAttentionResidual(torch.autograd.Function):
    """fused_channel_attention_residual under autograd: the kernel forward, the plain
    VJP."""

    @staticmethod
    def forward(ctx, x, r, w1, b1, w2, b2, meta, gate, cast_first):
        ctx.save_for_backward(x, r, w1, b1, w2, b2, meta, gate)
        ctx.cast_first = cast_first
        return _ca_res_forward(x, r, w1, b1, w2, b2, meta, gate, cast_first)

    @staticmethod
    def backward(ctx, grad):
        plain = functools.partial(reference_channel_attention_residual,
                                  cast_first=ctx.cast_first)
        return _plain_vjp(plain, ctx, grad) + (None,)  # no grad for cast_first


def _library(index):
    """(ctypes library, SM count, opt-in shared memory per block) of CUDA device
    ``index``, built on first use."""
    if index not in _DEVICES:
        with torch.cuda.device(index):
            props = torch.cuda.get_device_properties(index)
            _DEVICES[index] = (cuda_build.load('channel_attention', _SIGNATURES),
                               props.multi_processor_count,
                               props.shared_memory_per_block_optin)
    return _DEVICES[index]


def _excite_args(x, w1, b1, w2, b2, slabs):
    """The excite's weights as the kernel reads them (strided views are fine) and the
    f32 scratch for the partial sums and the attention."""
    n, c = x.shape[0], x.shape[3]
    w1, w2 = w1.detach().float(), w2.detach().float()
    b1, b2 = b1.detach().float().contiguous(), b2.detach().float().contiguous()
    scratch = torch.empty(n * (slabs + 1) * c, dtype=torch.float32, device=x.device)
    partial, att = scratch[:n * slabs * c], scratch[n * slabs * c:]
    return ((w1, b1, w2, b2, partial, att),
            (w1.stride(0), w1.stride(1), w2.stride(0), w2.stride(1)))


def _per_image(t):
    """meta or gate as the kernel reads it: contiguous f32 (a pointer), or None (null)."""
    return None if t is None else t.detach().float().contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_channel_attention(x, w1, b1, w2, b2, meta=None, gate=None, valid_hw=None):
    """CA scale-and-excite, with the optional ``meta`` (N, M) concatenated onto the
    pooled vector, ``gate`` (N, C) multiplying the attention and ``valid_hw`` (vh, vw)
    the extent the pool averages over: the CUDA kernel for a CUDA ``x`` (on the route
    :func:`ca_plan` gives), the plain version for a CPU ``x``; differentiable in every
    tensor input (the plain VJP)."""
    if valid_hw is not None:
        valid_hw = (int(valid_hw[0]), int(valid_hw[1]))
    if _records_grad(x, w1, b1, w2, b2, meta, gate):
        return _ChannelAttention.apply(x, w1, b1, w2, b2, meta, gate, valid_hw)
    if tracing(x):
        return torch.ops.sisr.ca(x, w1, b1, w2, b2, meta, gate,
                                 None if valid_hw is None else list(valid_hw))
    return _ca_forward(x, w1, b1, w2, b2, meta, gate, valid_hw)


def tracing(x):
    """Whether this call is being traced (``torch.export``, ``torch.compile``): the
    custom op then stands in the graph for the launch."""
    return torch.compiler.is_compiling() or \
        isinstance(x, torch._subclasses.fake_tensor.FakeTensor)


def _meta_count(meta):
    return 0 if meta is None else meta.shape[1]


def _ca_forward(x, w1, b1, w2, b2, meta=None, gate=None, valid_hw=None):
    """The forward of :func:`fused_channel_attention`, recording no grad."""
    if x.device.type == 'cpu':
        return reference_channel_attention(x, w1, b1, w2, b2, meta, gate, valid_hw)
    if x.device.type != 'cuda':
        raise ValueError('fused_channel_attention: unsupported device %s' % x.device)
    _check_args(x, w1, b1, w2, b2, meta=meta, gate=gate, valid_hw=valid_hw)
    n, h, w, c = x.shape
    _, sm_count, smem_optin = _library(x.device.index)
    route, plan = ca_plan(n, h * w, c, w1.shape[1], x.element_size(), x.data_ptr() % 16 == 0,
                          sm_count, smem_optin, m=_meta_count(meta))
    if route == 'onchip':
        return _onchip(x, w1, b1, w2, b2, plan, meta, gate, valid_hw)
    if route in ('rounds', 'stream'):
        launch = _rounds if route == 'rounds' else _stream
        return launch(x, None, w1, b1, w2, b2, torch.empty_like(x), plan, meta, gate,
                      valid_hw=valid_hw)
    return _three_pass(x, w1, b1, w2, b2, meta, gate, valid_hw)


def _extent_args(x, valid_hw):
    """(W, vh, vw) as the C entries take them; the full map without an extent."""
    h, w = x.shape[1], x.shape[2]
    vh, vw = (h, w) if valid_hw is None else valid_hw
    return w, vh, vw


def _count_masked(valid_hw):
    if valid_hw is not None:
        fused_channel_attention.masked_launches += 1


def _onchip(x, w1, b1, w2, b2, plan, meta=None, gate=None, valid_hw=None):
    """One cooperative launch of ``ca_onchip`` with ``plan`` from :func:`onchip_plan`
    (arguments already checked)."""
    n, h, w, c = x.shape
    index = x.device.index
    lib = _library(index)[0]
    slabs, slab_pixels, smem_bytes = plan
    out = torch.empty_like(x)
    meta, gate = _per_image(meta), _per_image(gate)
    # the partial sums (N, slabs, C); the att slice is unused on this path
    (w1, b1, w2, b2, partial, _), strides = _excite_args(x, w1, b1, w2, b2, slabs)
    with torch.cuda.device(index):
        code = lib.sisr_ca_onchip_forward(
            x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in (w1, b1, w2, b2)),
            _ptr(meta), _ptr(gate), partial.data_ptr(), n, h * w, c, _meta_count(meta),
            w1.shape[1], *strides, _DTYPE_CODES[x.dtype], slabs, slab_pixels, smem_bytes,
            *_extent_args(x, valid_hw), torch.cuda.current_stream(index).cuda_stream)
    cuda_build.check(lib, code, 'fused_channel_attention on-chip launch')
    fused_channel_attention.launches += 1
    fused_channel_attention.onchip_launches += 1
    fused_channel_attention.onchip_shapes[(tuple(x.shape), x.dtype)] += 1
    _count_masked(valid_hw)
    return out


def _rounds(x, r, w1, b1, w2, b2, out, plan, meta=None, gate=None, cast_first=False,
            valid_hw=None):
    """One cooperative launch of ``ca_rounds`` into ``out`` with ``plan`` from
    :func:`res_onchip_plan` (arguments already checked): the CA op where ``r`` is
    None, counted on :func:`fused_channel_attention` (``rounds_launches``), else the CA
    + residual tail, counted on :func:`fused_channel_attention_residual`
    (``onchip_launches``), whose pool takes no extent."""
    return _cooperative('rounds', x, r, w1, b1, w2, b2, out, plan[2], plan, meta, gate,
                        cast_first, valid_hw)


def _stream(x, r, w1, b1, w2, b2, out, plan, meta=None, gate=None, cast_first=False,
            valid_hw=None):
    """One cooperative launch of ``ca_stream`` into ``out`` with ``plan`` from
    :func:`stream_plan` (arguments already checked), for either op as :func:`_rounds`,
    counted in its ``stream_launches``."""
    return _cooperative('stream', x, r, w1, b1, w2, b2, out, plan[1], plan, meta, gate,
                        cast_first, valid_hw)


def _cooperative(route, x, r, w1, b1, w2, b2, out, slabs, plan_args, meta, gate, cast_first,
                 valid_hw):
    """The launch of :func:`_rounds` or :func:`_stream` (``route``) through its C entry,
    with ``plan_args`` the entry's arguments after ``cast_first``."""
    n, h, w, c = x.shape
    index = x.device.index
    lib = _library(index)[0]
    meta, gate = _per_image(meta), _per_image(gate)
    # the partial sums (N, slabs, C); the att slice is unused on this path
    (w1, b1, w2, b2, partial, _), strides = _excite_args(x, w1, b1, w2, b2, slabs)
    op = fused_channel_attention if r is None else fused_channel_attention_residual
    with torch.cuda.device(index):
        code = getattr(lib, 'sisr_ca_%s_forward' % route)(
            x.data_ptr(), _ptr(r), out.data_ptr(), *(t.data_ptr() for t in (w1, b1, w2, b2)),
            _ptr(meta), _ptr(gate), partial.data_ptr(), n, h * w, c, _meta_count(meta),
            w1.shape[1], *strides, _DTYPE_CODES[x.dtype],
            _NO_R if r is None else _DTYPE_CODES[r.dtype], int(cast_first), *plan_args,
            *_extent_args(x, valid_hw), torch.cuda.current_stream(index).cuda_stream)
    cuda_build.check(lib, code, '%s %s launch' % (op.__name__, route))
    op.launches += 1
    if route == 'stream':
        op.stream_launches += 1
    elif r is None:
        op.rounds_launches += 1
    else:
        op.onchip_launches += 1
    if r is None:
        _count_masked(valid_hw)
    return out


def _three_pass(x, w1, b1, w2, b2, meta=None, gate=None, valid_hw=None):
    """The three launches of ``sisr_ca_forward`` (arguments already checked)."""
    n, h, w, c = x.shape
    index = x.device.index
    lib, sm_count, _ = _library(index)
    vectorized, slabs = launch_plan(n, h * w, c, x.element_size(), x.data_ptr() % 16 == 0,
                                    sm_count)
    out = torch.empty_like(x)
    meta, gate = _per_image(meta), _per_image(gate)
    (w1, b1, w2, b2, partial, att), strides = _excite_args(x, w1, b1, w2, b2, slabs)
    with torch.cuda.device(index):
        code = lib.sisr_ca_forward(
            x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in (w1, b1, w2, b2)),
            _ptr(meta), _ptr(gate), partial.data_ptr(), att.data_ptr(), n, h * w, c,
            _meta_count(meta), w1.shape[1], *strides, _DTYPE_CODES[x.dtype],
            int(vectorized), slabs, sm_count, *_extent_args(x, valid_hw),
            torch.cuda.current_stream(index).cuda_stream)
    cuda_build.check(lib, code, 'fused_channel_attention launch')
    fused_channel_attention.launches += 1
    _count_masked(valid_hw)
    return out


fused_channel_attention.launches = 0
fused_channel_attention.onchip_launches = 0
fused_channel_attention.onchip_shapes = collections.Counter()  # (shape, dtype) -> launches
fused_channel_attention.rounds_launches = 0
fused_channel_attention.stream_launches = 0
fused_channel_attention.masked_launches = 0


def residual_aligned(x, r, out):
    """Whether the vectorised CA + residual path may take these tensors: x 16-byte
    aligned, r and out aligned to one vector (16 / x.itemsize elements) of r's type."""
    r_vec_bytes = 16 // x.element_size() * r.element_size()
    return (x.data_ptr() % 16 == 0 and r.data_ptr() % r_vec_bytes == 0
            and out.data_ptr() % r_vec_bytes == 0)


def res_onchip_aligned(x, r, out):
    """Whether the on-chip CA + residual path may take these tensors: x and r 16-byte
    aligned (bulk copies), out aligned to one vector of r's type."""
    return residual_aligned(x, r, out) and r.data_ptr() % 16 == 0


def fused_channel_attention_residual(x, r, w1, b1, w2, b2, meta=None, gate=None,
                                     cast_first=False):
    """The int8 RCAB block tail ``(float(x) * att(x) + float(r)).to(r.dtype)``, with
    att taking ``meta`` and ``gate`` as :func:`fused_channel_attention` does; with
    ``cast_first`` the int8 QRCAB tail ``fused_channel_attention(x, ..., meta,
    gate).to(r.dtype) + r``.  The CUDA kernel for a CUDA ``x`` (on the route
    :func:`ca_res_plan` gives), the plain version for a CPU ``x``; differentiable in
    every tensor input (the plain VJP)."""
    if _records_grad(x, r, w1, b1, w2, b2, meta, gate):
        return _ChannelAttentionResidual.apply(x, r, w1, b1, w2, b2, meta, gate, cast_first)
    if tracing(x):
        return torch.ops.sisr.ca_res(x, r, w1, b1, w2, b2, meta, gate, bool(cast_first))
    return _ca_res_forward(x, r, w1, b1, w2, b2, meta, gate, cast_first)


def _ca_res_forward(x, r, w1, b1, w2, b2, meta=None, gate=None, cast_first=False):
    """The forward of :func:`fused_channel_attention_residual`, recording no grad."""
    if x.device.type == 'cpu':
        return reference_channel_attention_residual(x, r, w1, b1, w2, b2, meta, gate,
                                                    cast_first)
    if x.device.type != 'cuda':
        raise ValueError('fused_channel_attention_residual: unsupported device %s'
                         % x.device)
    _check_residual_args(x, r, w1, b1, w2, b2, meta, gate)
    n, h, w, c = x.shape
    _, sm_count, smem_optin = _library(x.device.index)
    out = torch.empty_like(r)
    route, plan = ca_res_plan(n, h * w, c, w1.shape[1], x.element_size(), r.element_size(),
                              res_onchip_aligned(x, r, out), sm_count, smem_optin,
                              m=_meta_count(meta))
    if route == 'three_pass':
        return _res_three_pass(x, r, w1, b1, w2, b2, out, meta, gate, cast_first)
    launch = _rounds if route == 'rounds' else _stream
    return launch(x, r, w1, b1, w2, b2, out, plan, meta, gate, cast_first)


def _res_three_pass(x, r, w1, b1, w2, b2, out=None, meta=None, gate=None,
                    cast_first=False):
    """The three launches of ``sisr_ca_res_forward`` into ``out`` (a new tensor when
    None; arguments already checked)."""
    n, h, w, c = x.shape
    index = x.device.index
    lib, sm_count, _ = _library(index)
    out = torch.empty_like(r) if out is None else out
    vectorized, slabs = launch_plan(n, h * w, c, x.element_size(),
                                    residual_aligned(x, r, out), sm_count)
    meta, gate = _per_image(meta), _per_image(gate)
    (w1, b1, w2, b2, partial, att), strides = _excite_args(x, w1, b1, w2, b2, slabs)
    with torch.cuda.device(index):
        code = lib.sisr_ca_res_forward(
            x.data_ptr(), r.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in (w1, b1, w2, b2)), _ptr(meta), _ptr(gate),
            partial.data_ptr(), att.data_ptr(), n, h * w, c, _meta_count(meta), w1.shape[1],
            *strides, _DTYPE_CODES[x.dtype], _DTYPE_CODES[r.dtype], int(cast_first),
            int(vectorized), slabs, sm_count, torch.cuda.current_stream(index).cuda_stream)
    cuda_build.check(lib, code, 'fused_channel_attention_residual launch')
    fused_channel_attention_residual.launches += 1
    return out


fused_channel_attention_residual.launches = 0
fused_channel_attention_residual.onchip_launches = 0
fused_channel_attention_residual.stream_launches = 0


# --- the custom ops (torch.library): what torch.export records for the two wrappers ----
@torch.library.custom_op('sisr::ca', mutates_args=(), device_types='cuda')
def _ca_op(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, meta: Optional[Tensor],
           gate: Optional[Tensor], valid_hw: Optional[List[int]]) -> Tensor:
    """sisr::ca on CUDA: plan and launch the CA kernel (:func:`_ca_forward`)."""
    return _ca_forward(x, w1, b1, w2, b2, meta, gate,
                       None if valid_hw is None else tuple(valid_hw))


@_ca_op.register_kernel('cpu')
def _ca_op_cpu(x, w1, b1, w2, b2, meta, gate, valid_hw):
    """sisr::ca on the CPU: the plain version."""
    return reference_channel_attention(x, w1, b1, w2, b2, meta, gate,
                                       None if valid_hw is None else tuple(valid_hw))


@_ca_op.register_fake
def _ca_op_fake(x, w1, b1, w2, b2, meta, gate, valid_hw):
    return torch.empty_like(x)


@torch.library.custom_op('sisr::ca_res', mutates_args=(), device_types='cuda')
def _ca_res_op(x: Tensor, r: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
               meta: Optional[Tensor], gate: Optional[Tensor], cast_first: bool) -> Tensor:
    """sisr::ca_res on CUDA: plan and launch the CA + residual kernel
    (:func:`_ca_res_forward`)."""
    return _ca_res_forward(x, r, w1, b1, w2, b2, meta, gate, cast_first)


@_ca_res_op.register_kernel('cpu')
def _ca_res_op_cpu(x, r, w1, b1, w2, b2, meta, gate, cast_first):
    """sisr::ca_res on the CPU: the plain version."""
    return reference_channel_attention_residual(x, r, w1, b1, w2, b2, meta, gate,
                                                cast_first)


@_ca_res_op.register_fake
def _ca_res_op_fake(x, r, w1, b1, w2, b2, meta, gate, cast_first):
    return torch.empty_like(r)
