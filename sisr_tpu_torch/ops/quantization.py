"""Int8 serving of RCAN, EDSR, Q-RCAN, Q-EDSR, HAN, Q-HAN, SAN, Q-SAN, SRMD, SFTMD and
VDSR: those families' part of sisr_tpu's ``ops/quantization.py``.

The recipe is sisr_tpu's, with its names, NHWC activations, HWIO kernels and
parameter-tree and scale-key names (``head``, ``group_<g>.rcab_<b>.conv_0``,
``group_<g>.qrcab_<b>.conv_0``, ``block_<i>.conv_0``, ``rg_<g>.rb_<b>.conv_0``,
``body_tail`` or ``final_body``, ``upsampler.conv_<i>``, ``tail``):

* weights: symmetric per-output-channel int8 (scale = max|w| / 127 over H, W, I);
* activations: one static scale per conv input, from the absmax of a float32
  calibration pass (``calibrate_<family>_scales``), or for :func:`edsr_int8_forward`
  one dynamic scale per conv input, its own absmax (:func:`quantize_activations`);
* every 3x3 conv in int8 with an exact int32 sum; dequantisation, bias, ReLU and the
  residual carry (bfloat16 or float32; for EDSR also an int16 grid) in float32 or the
  carry's type;
* the attention stages (RCAN's CA, Q-RCAN's QCALayer, PALayer and q_node, Q-EDSR's
  ParaCALayer gates, SAN's and Q-SAN's non-local block and SOCA, Q-SAN's ParaCALayer
  gates, SFTMD's q-injection gates) stay float32; HAN's and Q-HAN's LAM and CSAM and
  SFTMD's SFT branches run in bfloat16 (the gram, the softmax and every sum in
  float32), as in sisr_tpu's serving forwards; SRMD's whole chain is int8, on the
  input with its metadata maps concatenated, and VDSR's on the Y channel of the
  pre-upscaled LR;
* each RCAB tail (channel attention scale + residual add) runs as
  :func:`~sisr_tpu_torch.ops.channel_attention.fused_channel_attention_residual`, the
  CUDA kernel on the card: the numerics of sisr_tpu's ``ca_epilogue='pallas'``;
* each QRCAB tail of the ``standard``, ``max_concat`` and ``modulate`` styles without
  a pa_node (attention with the metadata and the q_node's gate, one cast to the carry,
  the add in the carry's type: sisr_tpu's rounding order) is one
  :func:`~sisr_tpu_torch.ops.channel_attention.fused_channel_attention_residual` call
  with ``cast_first``; with a pa_node, the attention is one
  :func:`~sisr_tpu_torch.ops.channel_attention.fused_channel_attention` call.

The int8 convolution is an im2col product: the padded int8 input's kh x kw windows
are gathered into an (N*H*W, kh*kw*Cin) int8 matrix and multiplied by the HWIO kernel
reshaped to (kh*kw*Cin, Cout) with ``torch._int_mm``, which sums in int32 exactly.
The weight matrix is packed once, at quantisation (``entry['matrix']``), zero-padded
to the multiples of 8 that ``_int_mm`` takes.  Where the matrix would pass
``IM2COL_BAND_BYTES`` (SFTMD's 9x9 ``conv_output`` at HR size: 5184 bytes a row), it
is gathered and multiplied in bands of output rows, each band's sums complete in
itself: the same int32 sums, at a bounded peak.

The programs are plain functions over dicts of tensors, as in sisr_tpu; they do not
run the ``nn.Module``.  Activation scales are ``np.float32`` numbers; the forward
also takes them as 0-dim tensors on its device (:func:`scales_on`), which is how the
handler passes them, so no host-to-device copy runs per conv.

A static int8 conv traced by ``torch.export`` (``tools/export_serving.py``) is one
node, the custom op ``sisr::conv_int8_static`` (its implementation is
:func:`conv_int8_static`'s eager code on every device): traced op by op, the im2col
gather alone makes some 20 nodes of a conv, and an int8 RCAN program some 20000,
whose export, save and load each take minutes.  Eager calls do not go through it.
"""
import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from ..models.advanced import csam_weight, layer_attention
from ..models.san import embedded_gaussian, max_pool2, quadrants, second_order_pool
from .channel_attention import (KERNEL_STYLES, fused_channel_attention,
                                fused_channel_attention_residual,
                                reference_channel_attention_residual, tracing)

_INT_MM_MULTIPLE = 8    # _int_mm on CUDA takes K and N divisible by 8 ...
_INT_MM_MIN_ROWS = 17   # ... and more than 16 rows
# the largest im2col matrix gathered at once; a larger one is cut into bands of rows
IM2COL_BAND_BYTES = 1 << 30
# EDSR's Upsampler: conv + pixel-shuffle stages per scale, x3 in one stage
_UPSAMPLE_STAGES = {2: 1, 4: 2, 8: 3, 3: 1}


def pixel_shuffle(x, factor):
    """Depth-to-space on NHWC: (N, H, W, C*r^2) -> (N, H*r, W*r, C), torch
    PixelShuffle's ordering (sisr_tpu's ``models/blocks.py`` ``pixel_shuffle``)."""
    n, h, w, c = x.shape
    r = factor
    x = x.reshape(n, h, w, c // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, c // (r * r))


def quantize_kernel_int8(kernel):
    """HWIO conv kernel -> (int8 kernel, per-out-channel f32 scales)."""
    kernel = kernel.float()
    scale = torch.clamp(kernel.abs().amax(dim=(0, 1, 2)) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(kernel / scale), -127, 127).to(torch.int8)
    return q, scale


def pack_kernel_matrix(q_kernel):
    """HWIO int8 kernel (kh, kw, Cin, Cout) -> the (K, Nc) int8 operand of
    ``torch._int_mm``: rows in (kh, kw, Cin) order, as :func:`_im2col` lays out the
    windows, zero-padded to multiples of 8 in both dimensions (the head's K = 27 to
    32, the tail's Cout = 3 to 8).  Stored column-major (the transposed view of an
    (Nc, K) contiguous matrix), the layout in which ``_int_mm`` runs fastest on an
    H100 (``chip_smoke.py``'s int8_reference phase times both layouts; PERF.md)."""
    kh, kw, cin, cout = q_kernel.shape
    mat = q_kernel.reshape(kh * kw * cin, cout)
    k_pad = -mat.shape[0] % _INT_MM_MULTIPLE
    n_pad = -cout % _INT_MM_MULTIPLE
    return F.pad(mat, (0, n_pad, 0, k_pad)).t().contiguous().t()


def _q_entry(entry):
    """Quantize one conv param entry: int8 HWIO kernel, per-out-channel scales, f32
    bias, and the packed ``_int_mm`` matrix."""
    qk, sc = quantize_kernel_int8(entry['kernel'])
    return {'kernel': qk, 'scale': sc, 'bias': entry['bias'].float(),
            'matrix': pack_kernel_matrix(qk)}


def _f32_tree(tree):
    """A nested dict of tensors with every tensor in f32 (the attention stages the
    int8 programs keep in float)."""
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    return tree.float()


def _fconv(entry, h, compute_dtype=None):
    """SAME conv + bias (sisr_tpu's ``_fconv``).  NHWC in and out, HWIO kernel.  In f32
    by default (the calibration mirrors' conv primitive); with ``compute_dtype``
    (bfloat16: SFTMD's SFT branches in its int8 forward) the conv takes operands of
    that type and gives that type, and the bias is added in it."""
    k, bias = entry['kernel'], entry['bias']
    if compute_dtype is not None:
        h, k, bias = h.to(compute_dtype), k.to(compute_dtype), bias.to(compute_dtype)
    out = F.conv2d(h.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                   padding=(k.shape[0] // 2, k.shape[1] // 2))
    return out.permute(0, 2, 3, 1) + bias


def _absmax_tracker():
    """(track, maxes): record per-name activation absmax during a mirror pass."""
    maxes = {}

    def track(name, h):
        maxes[name] = max(maxes.get(name, 0.0), float(h.abs().max()))
        return h

    return track, maxes


def _finalize_scales(maxes, margin):
    # in Python floats, then np.float32: the same bits as sisr_tpu's scales
    return {k: np.float32(max(v * margin, 1e-12) / 127.0) for k, v in maxes.items()}


def quantize_activations_static(x, x_scale):
    """``clip(round(float(x) / x_scale), -127, 127)`` as int8.  A true division, not a
    product with the reciprocal (``x_scale`` as a tensor on x's device: a CPU scalar
    would let CUDA multiply by its reciprocal); round half to even, as jnp.round."""
    x_scale = _scale_tensor(x_scale, x.device)
    return torch.clamp(torch.round(x.float() / x_scale), -127, 127).to(torch.int8)


def _scale_tensor(x_scale, device):
    if isinstance(x_scale, torch.Tensor) and x_scale.device == device:
        return x_scale
    return torch.as_tensor(np.float32(x_scale), device=device)


def _im2col(xp, kh, kw, k_cols, r0=0, r1=None):
    """The SAME-padded int8 map ``xp`` (N, H + kh - 1, W + kw - 1, Cin) -> the
    (N * (r1 - r0) * W, k_cols) int8 matrix of the kh x kw windows of output rows r0 to
    r1 (all by default), in (kh, kw, Cin) order, then zero columns up to ``k_cols``."""
    n, hp, wp, cin = xp.shape
    h, w = hp - kh + 1, wp - kw + 1
    r1 = h if r1 is None else r1
    cols = [xp[:, r0 + i:r1 + i, j:j + w, :] for i in range(kh) for j in range(kw)]
    if k_cols > kh * kw * cin:
        cols.append(xp.new_zeros((n, r1 - r0, w, k_cols - kh * kw * cin)))
    return torch.cat(cols, dim=-1).reshape(n * (r1 - r0) * w, k_cols)


def _int_mm_rows(a, matrix, cout):
    """``torch._int_mm`` of an im2col matrix (padded to the rows it takes) and the
    packed kernel: the (rows, cout) int32 sums."""
    rows = a.shape[0]
    if rows < _INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - rows))
    return torch._int_mm(a, matrix)[:rows, :cout]


def band_rows(n, h, w, k_cols):
    """Output rows per band of the im2col gather of an (n, h, w) map with ``k_cols``
    bytes a row: every row (one band) when the matrix fits ``IM2COL_BAND_BYTES``, else
    as many as fit, at least one."""
    return max(1, min(h, IM2COL_BAND_BYTES // max(1, n * w * k_cols)))


def conv_int8_accumulate(x_q, q_kernel, matrix=None):
    """SAME conv of an int8 NHWC map with an int8 HWIO kernel: the exact int32 sums
    (N, H, W, Cout), by ``torch._int_mm`` on the im2col matrix, gathered whole or,
    past ``IM2COL_BAND_BYTES``, in bands of output rows (each output sum within one
    band: the same sums)."""
    kh, kw, _, cout = q_kernel.shape
    if matrix is None:
        matrix = pack_kernel_matrix(q_kernel)
    n, h, w, _ = x_q.shape
    k_cols = matrix.shape[0]
    xp = F.pad(x_q, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    step = band_rows(n, h, w, k_cols)
    if step >= h:
        return _int_mm_rows(_im2col(xp, kh, kw, k_cols), matrix, cout).reshape(n, h, w, cout)
    acc = torch.empty((n, h, w, cout), dtype=torch.int32, device=x_q.device)
    for r0 in range(0, h, step):
        r1 = min(h, r0 + step)
        acc[:, r0:r1] = _int_mm_rows(_im2col(xp, kh, kw, k_cols, r0, r1), matrix,
                                     cout).reshape(n, r1 - r0, w, cout)
    return acc


def quantize_activations(x):
    """Dynamic per-tensor symmetric int8 quantisation (sisr_tpu's
    ``quantize_activations``): (int8 map, its scale ``max(max|x| / 127, 1e-12)`` as a
    0-dim f32 tensor on x's device)."""
    x = x.float()
    scale = torch.clamp(x.abs().amax() / 127.0, min=1e-12)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def conv_int8(x, q_kernel, w_scale, x_scale=None, bias=None, matrix=None):
    """int8 SAME conv (sisr_tpu's ``conv_int8``): ``x`` an int8 map already on the grid
    ``x_scale``, or, with ``x_scale`` None, a float map quantised here with its own
    dynamic scale (:func:`quantize_activations`).  Sum in int32, dequantise
    ``acc * (x_scale * w_scale) + bias`` in f32, in that order."""
    if x_scale is None:
        x, x_scale = quantize_activations(x)
    x_scale = _scale_tensor(x_scale, x.device)
    out = conv_int8_accumulate(x, q_kernel, matrix).float() * (x_scale * w_scale)
    if bias is not None:
        out = out + bias
    return out


def conv_int8_static(x, q_kernel, w_scale, x_scale, bias=None, matrix=None):
    """int8 conv with a precomputed (static) activation scale: quantise x, then
    :func:`conv_int8`.  Traced, one ``sisr::conv_int8_static`` node."""
    x_scale = _scale_tensor(x_scale, x.device)
    if tracing(x):
        return torch.ops.sisr.conv_int8_static(x, q_kernel, w_scale, x_scale, bias, matrix)
    return _conv_int8_static(x, q_kernel, w_scale, x_scale, bias, matrix)


def _conv_int8_static(x, q_kernel, w_scale, x_scale, bias, matrix):
    return conv_int8(quantize_activations_static(x, x_scale), q_kernel, w_scale, x_scale,
                     bias, matrix)


@torch.library.custom_op('sisr::conv_int8_static', mutates_args=())
def _conv_int8_static_op(x: Tensor, q_kernel: Tensor, w_scale: Tensor, x_scale: Tensor,
                         bias: Optional[Tensor], matrix: Optional[Tensor]) -> Tensor:
    """sisr::conv_int8_static on any device: :func:`conv_int8_static`'s eager code."""
    return _conv_int8_static(x, q_kernel, w_scale, x_scale, bias, matrix)


@_conv_int8_static_op.register_fake
def _conv_int8_static_fake(x, q_kernel, w_scale, x_scale, bias, matrix):
    return x.new_empty(x.shape[:3] + (q_kernel.shape[3],), dtype=torch.float32)


def quantize_rcan_params(params, n_resgroups=10, n_resblocks=20):
    """Quantize an RCAN parameter tree (sisr_tpu's naming, HWIO kernels) to int8.
    Only the 3x3 convs are quantized; each RCAB's channel-attention Dense pair stays
    f32."""
    q = _q_entry
    out = {'head': q(params['head']), 'body_tail': q(params['body_tail']),
           'tail': q(params['tail']),
           'upsampler': {k: q(v) for k, v in params['upsampler'].items()}}
    for g in range(n_resgroups):
        grp = params['group_%d' % g]
        qg = {'conv_tail': q(grp['conv_tail'])}
        for b in range(n_resblocks):
            blk = grp['rcab_%d' % b]
            qg['rcab_%d' % b] = {'conv_0': q(blk['conv_0']), 'conv_1': q(blk['conv_1']),
                                 'ca': _f32_tree(blk['ca'])}
        out['group_%d' % g] = qg
    return out


def _rcan_float_forward(params, x, n_resgroups, n_resblocks, track=None):
    """f32 RCAN forward over the parameter tree (the calibration mirror of
    sisr_tpu's ``_rcan_float_forward``)."""
    tr = track or (lambda name, h: h)
    fconv = _tracked_fconv(tr)
    h = fconv('head', params['head'], x)
    res = _rcan_groups_float(params, fconv, tr, h, n_resgroups, n_resblocks)[-1]
    res = fconv('body_tail', params['body_tail'], res) + h
    res = _pow2_upsample(fconv, params['upsampler'], res)
    return fconv('tail', params['tail'], res)


def _rcan_groups_float(params, fconv, tr, h, n_resgroups, n_resblocks):
    """RCAN's (and HAN's) residual groups in f32 on the head's output ``h``: each
    group's output, in order."""
    def ca(entry, y):
        a = y.mean(dim=(1, 2))
        a = torch.relu(a @ entry['du_0']['kernel'] + entry['du_0']['bias'])
        a = torch.sigmoid(a @ entry['du_1']['kernel'] + entry['du_1']['bias'])
        return y * a[:, None, None, :]

    res, outs = tr('_residual', h), []
    for g in range(n_resgroups):
        grp = params['group_%d' % g]
        r = res
        for b in range(n_resblocks):
            blk = grp['rcab_%d' % b]
            pre = 'group_%d.rcab_%d' % (g, b)
            y = torch.relu(fconv(pre + '.conv_0', blk['conv_0'], r))
            y = fconv(pre + '.conv_1', blk['conv_1'], y)
            r = tr('_residual', ca(blk['ca'], y) + r)
        res = tr('_residual', fconv('group_%d.conv_tail' % g, grp['conv_tail'], r) + res)
        outs.append(res)
    return outs


def _tracked_fconv(tr):
    """The f32 conv as ``conv(name, entry, h)``, recording h under ``name``."""
    return lambda name, entry, h: _fconv(entry, tr(name, h))


def _check_rcan_upsampler_pow2(upsampler):
    """One conv + x2 shuffle per stage only covers power-of-2 scales; fail early for
    the x3 Upsampler (9*n_feat conv)."""
    k = upsampler['conv_0']['kernel']
    if k.shape[-1] != 4 * k.shape[-2]:
        raise NotImplementedError('int8 RCAN path supports power-of-2 scales only '
                                  '(x3 upsampler detected: conv_0 %s)'
                                  % str(tuple(k.shape)))


def _pow2_upsample(conv, upsampler, res):
    """RCAN's and Q-RCAN's upsampler: one ``conv(name, entry, h)`` and a x2 shuffle
    per stage."""
    _check_rcan_upsampler_pow2(upsampler)
    for i in range(sum(1 for k in upsampler if k.startswith('conv_'))):
        res = pixel_shuffle(conv('upsampler.conv_%d' % i, upsampler['conv_%d' % i], res), 2)
    return res


def _edsr_upsample(conv, upsampler, res, scale):
    """EDSR's and Q-EDSR's upsampler: ``conv(name, entry, h)`` and a shuffle per stage,
    x3 in one stage for scale 3."""
    for i in range(_UPSAMPLE_STAGES[scale]):
        res = conv('upsampler.conv_%d' % i, upsampler['conv_%d' % i], res)
        res = pixel_shuffle(res, 3 if scale == 3 else 2)
    return res


@contextlib.contextmanager
def _true_f32():
    """cuDNN runs f32 convs in TF32 by default on Hopper, and a caller may allow TF32
    matmuls; either would shift every absmax.  Calibration turns TF32 off for its own
    convs and products, and restores both flags after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = saved


def _calibration_maxes(forward, params, sample_batches, metadata_batches=None, name=None):
    """Absmax of every tracked activation of ``forward(params, x, meta, track)`` over
    the calibration batches (each with its metadata batch, for a metadata model), in
    true f32."""
    prefix = '' if name is None else name + ': '
    sample_batches = list(sample_batches)
    if not sample_batches:
        raise ValueError(prefix + 'no calibration batches provided.')
    if metadata_batches is None:
        metadata_batches = [None] * len(sample_batches)
    metadata_batches = list(metadata_batches)
    if len(sample_batches) != len(metadata_batches):
        raise ValueError('%s%d sample batches but %d metadata batches — zip would '
                         'silently truncate the calibration set.'
                         % (prefix, len(sample_batches), len(metadata_batches)))
    device = _first_tensor(params).device
    track, maxes = _absmax_tracker()
    with torch.inference_mode(), _true_f32():
        for x, meta in zip(sample_batches, metadata_batches):
            x = torch.as_tensor(x).float().to(device)
            meta = None if meta is None else torch.as_tensor(meta).float().to(device)
            forward(params, x, meta, track)
    return maxes


def _first_tensor(tree):
    """The first tensor of a nested dict of tensors."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def calibrate_rcan_scales(params, sample_batches, n_resgroups=10, n_resblocks=20,
                          margin=1.0):
    """Static activation scales for the int8 RCAN forward (absmax calibration, true
    f32): {scale key: np.float32}."""
    maxes = _calibration_maxes(
        lambda p, x, _, track: _rcan_float_forward(p, x, n_resgroups, n_resblocks, track),
        params, sample_batches)
    maxes.pop('_residual')  # RCAN supports only f32/bf16 residual carries (no int16)
    return _finalize_scales(maxes, margin)


def scales_on(act_scales, device):
    """The scales as 0-dim f32 tensors on ``device``, from one host-to-device copy."""
    names = sorted(act_scales)
    values = torch.tensor([float(act_scales[k]) for k in names], dtype=torch.float32)
    values = values.to(device)
    return {k: values[i] for i, k in enumerate(names)}


def rcan_int8_forward_static(qparams, act_scales, x, n_resgroups=10, n_resblocks=20,
                             residual_dtype='bfloat16', ca_epilogue='kernel'):
    """Quantized RCAN forward: int8 convs, f32 channel attention, narrow residual
    carry; each RCAB tail is one :func:`fused_channel_attention_residual` call, or with
    ``ca_epilogue='plain'`` its plain version (:func:`_ca_tail`).

    ``x`` is the f32 NHWC LR batch; returns the f32 NHWC SR batch."""
    carry_t = _carry_type(residual_dtype)
    qconv = _qconv_with(act_scales)
    h = qconv('head', qparams['head'], x).to(carry_t)
    res = _rcan_groups_int8(qparams, qconv, h, n_resgroups, n_resblocks, ca_epilogue)[-1]
    res = qconv('body_tail', qparams['body_tail'], res) + h.float()
    res = _pow2_upsample(qconv, qparams['upsampler'], res)
    return qconv('tail', qparams['tail'], res)


def _ca_tail(ca_epilogue):
    """The RCAB tail of the int8 programs: ``'kernel'`` (the default, the main path)
    :func:`fused_channel_attention_residual`, ``'plain'`` its plain version
    :func:`reference_channel_attention_residual`, the unfused PyTorch ops on every
    device (sisr_tpu's ``ca_epilogue`` 'pallas' and 'xla'; ``tools/bench_ca_epilogue``
    times the two)."""
    if ca_epilogue == 'kernel':
        return fused_channel_attention_residual
    if ca_epilogue == 'plain':
        return reference_channel_attention_residual
    raise ValueError("ca_epilogue must be 'kernel' or 'plain', got %r" % (ca_epilogue,))


def _rcan_groups_int8(qparams, qconv, h, n_resgroups, n_resblocks, ca_epilogue='kernel'):
    """RCAN's (and HAN's) int8 residual groups on the head's output ``h`` in the
    carry's type, each RCAB tail one ``ca_epilogue`` call (:func:`_ca_tail`): each
    group's output, in order."""
    tail = _ca_tail(ca_epilogue)
    res, outs = h, []
    for g in range(n_resgroups):
        grp = qparams['group_%d' % g]
        r = res
        for b in range(n_resblocks):
            blk = grp['rcab_%d' % b]
            pre = 'group_%d.rcab_%d' % (g, b)
            y = torch.relu(qconv(pre + '.conv_0', blk['conv_0'], r))
            y = qconv(pre + '.conv_1', blk['conv_1'], y)
            ca = blk['ca']
            r = tail(y, r, ca['du_0']['kernel'], ca['du_0']['bias'], ca['du_1']['kernel'],
                     ca['du_1']['bias'])
        res = qconv('group_%d.conv_tail' % g, grp['conv_tail'], r).to(h.dtype) + res
        outs.append(res)
    return outs


def _qconv_with(act_scales):
    """The int8 conv as ``qconv(name, entry, h)``, with the static scale
    ``act_scales[name]``."""
    def qconv(name, tree, h):
        return conv_int8_static(h, tree['kernel'], tree['scale'], act_scales[name],
                                tree['bias'], tree.get('matrix'))
    return qconv


def _carry_type(residual_dtype):
    if residual_dtype not in ('float32', 'bfloat16'):
        raise ValueError('residual_dtype must be float32 | bfloat16')
    return torch.float32 if residual_dtype == 'float32' else torch.bfloat16


# --- EDSR and Q-EDSR -------------------------------------------------------------------------
def quantize_edsr_params(params):
    """Quantize an EDSR parameter tree (sisr_tpu's ``models/advanced.py`` naming) to
    int8."""
    q = _q_entry
    out = {'head': q(params['head']), 'body_tail': q(params['body_tail']),
           'tail': q(params['tail']),
           'upsampler': {k: q(v) for k, v in params['upsampler'].items()}}
    for name, block in params.items():
        if name.startswith('block_'):
            out[name] = {'conv_0': q(block['conv_0']), 'conv_1': q(block['conv_1'])}
    return out


def _edsr_spine_float(params, x, num_blocks, scale, res_scale, body_tail, track=None,
                      gate=None):
    """f32 forward of the EDSR spine over the parameter tree (the calibration mirror
    of sisr_tpu's ``calibrate_edsr_scales`` and ``_qedsr_float_forward``).  ``gate``,
    for Q-EDSR, maps a block's entry to the (N, C) gate its branch is multiplied by
    after the res_scale multiply; ``body_tail`` names the conv after the blocks."""
    tr = track or (lambda name, h: h)
    fconv = _tracked_fconv(tr)
    h = fconv('head', params['head'], x)
    res = tr('_residual', h)
    for i in range(num_blocks):
        name = 'block_%d' % i
        blk = params[name]
        y = torch.relu(fconv(name + '.conv_0', blk['conv_0'], res))
        y = fconv(name + '.conv_1', blk['conv_1'], y) * res_scale
        if gate is not None:
            y = y * gate(blk)[:, None, None, :]
        res = tr('_residual', y + res)
    res = fconv(body_tail, params[body_tail], res) + h
    res = _edsr_upsample(fconv, params['upsampler'], res, scale)
    return fconv('tail', params['tail'], res)


def _edsr_spine_int8(qparams, act_scales, x, num_blocks, scale, res_scale, carry_t,
                     body_tail, gate=None):
    """The int8 EDSR spine with a float carry: each block's branch in f32 (times its
    ``gate`` for Q-EDSR), cast once to ``carry_t``, then added in the carry's type."""
    qconv = _qconv_with(act_scales)
    h = qconv('head', qparams['head'], x).to(carry_t)
    res = h
    for i in range(num_blocks):
        name = 'block_%d' % i
        blk = qparams[name]
        y = torch.relu(qconv(name + '.conv_0', blk['conv_0'], res))
        y = qconv(name + '.conv_1', blk['conv_1'], y) * res_scale
        if gate is not None:
            y = y * gate(blk)[:, None, None, :]
        res = y.to(carry_t) + res
    res = qconv(body_tail, qparams[body_tail], res) + h.float()
    res = _edsr_upsample(qconv, qparams['upsampler'], res, scale)
    return qconv('tail', qparams['tail'], res)


def calibrate_edsr_scales(params, sample_batches, num_blocks=16, scale=4, res_scale=0.1,
                          margin=1.0):
    """Static activation scales for the int8 EDSR forward (absmax calibration, true
    f32), and ``residual16``, the int16 grid of the residual carry."""
    maxes = _calibration_maxes(
        lambda p, x, _, track: _edsr_spine_float(p, x, num_blocks, scale, res_scale,
                                                 'body_tail', track),
        params, sample_batches)
    res_absmax = maxes.pop('_residual')
    scales = _finalize_scales(maxes, margin)
    scales['residual16'] = np.float32(max(res_absmax * margin, 1e-12) / 32767.0)
    return scales


def edsr_int8_forward_static(qparams, act_scales, x, num_blocks=16, scale=4,
                             res_scale=0.1, residual_dtype='float32'):
    """Quantized EDSR forward with static activation scales.  ``residual_dtype``
    carries the residual stream in float32, bfloat16, or as int16 fixed point on the
    calibrated grid ``act_scales['residual16']``."""
    if residual_dtype not in ('float32', 'bfloat16', 'int16'):
        raise ValueError('residual_dtype must be float32 | bfloat16 | int16')
    if residual_dtype == 'int16':
        return _edsr_int8_forward_res16(qparams, act_scales, x, num_blocks, scale,
                                        res_scale)
    return _edsr_spine_int8(qparams, act_scales, x, num_blocks, scale, res_scale,
                            _carry_type(residual_dtype), 'body_tail')


def edsr_int8_forward(qparams, x, num_blocks=16, scale=4, res_scale=0.1):
    """Quantized EDSR forward with dynamic activation scales (sisr_tpu's
    ``edsr_int8_forward``): every conv quantises its input with the input's own
    absmax (:func:`conv_int8` without ``x_scale``); the residual carry is f32."""
    def qconv(name, tree, h):
        return conv_int8(h, tree['kernel'], tree['scale'], bias=tree['bias'],
                         matrix=tree.get('matrix'))

    h = qconv('head', qparams['head'], x)
    res = h
    for i in range(num_blocks):
        blk = qparams['block_%d' % i]
        y = torch.relu(qconv('conv_0', blk['conv_0'], res))
        res = res + qconv('conv_1', blk['conv_1'], y) * res_scale
    res = qconv('body_tail', qparams['body_tail'], res) + h
    res = _edsr_upsample(qconv, qparams['upsampler'], res, scale)
    return qconv('tail', qparams['tail'], res)


def _edsr_int8_forward_res16(qparams, act_scales, x, num_blocks, scale, res_scale):
    """The int16 fixed-point residual datapath: the carry is requantised straight to
    each conv's int8 grid, and each block's branch is rounded onto the int16 grid and
    added in int32."""
    if 'residual16' not in act_scales:
        raise KeyError("act_scales has no 'residual16' entry — re-run "
                       "calibrate_edsr_scales (older calibration dicts predate the "
                       "int16 residual datapath).")
    s_res = _scale_tensor(act_scales['residual16'], x.device)
    qconv = _qconv_with(act_scales)

    def to_i8(h_i16, name):
        ratio = s_res / _scale_tensor(act_scales[name], x.device)
        return torch.clamp(torch.round(h_i16.float() * ratio), -127, 127).to(torch.int8)

    def qconv_i8(name, tree, x_q):
        return conv_int8(x_q, tree['kernel'], tree['scale'], act_scales[name],
                         tree['bias'], tree.get('matrix'))

    h16 = torch.clamp(torch.round(qconv('head', qparams['head'], x) / s_res),
                      -32767, 32767).to(torch.int16)
    res16 = h16
    step = torch.tensor(res_scale, dtype=torch.float32, device=x.device) / s_res
    for i in range(num_blocks):
        name = 'block_%d' % i
        blk = qparams[name]
        y = torch.relu(qconv_i8(name + '.conv_0', blk['conv_0'],
                                to_i8(res16, name + '.conv_0')))
        y = qconv(name + '.conv_1', blk['conv_1'], y)
        delta = torch.round(y * step).to(torch.int32)
        res16 = torch.clamp(res16.to(torch.int32) + delta, -32767, 32767).to(torch.int16)
    res = qconv_i8('body_tail', qparams['body_tail'], to_i8(res16, 'body_tail')) \
        + h16.float() * s_res
    res = _edsr_upsample(qconv, qparams['upsampler'], res, scale)
    return qconv('tail', qparams['tail'], res)


def quantize_qedsr_params(params, num_blocks=16):
    """Quantize a QEDSR parameter tree (sisr_tpu's ``models/qmodels.py`` naming) to
    int8: the EDSR conv spine goes int8, each block's ParaCALayer stays f32."""
    q = _q_entry
    out = {'head': q(params['head']), 'final_body': q(params['final_body']),
           'tail': q(params['tail']),
           'upsampler': {k: q(v) for k, v in params['upsampler'].items()}}
    for i in range(num_blocks):
        blk = params['block_%d' % i]
        out['block_%d' % i] = {'conv_0': q(blk['conv_0']), 'conv_1': q(blk['conv_1']),
                               'attention': _f32_tree(blk['attention'])}
    return out


def _qedsr_gate(metadata, nonlinearity):
    """A Q-EDSR block's entry -> its ParaCALayer gate on ``metadata``, in f32."""
    meta = metadata.float()
    return lambda blk: _para_ca_apply(blk['attention'], meta, nonlinearity)


def _qedsr_float_forward(params, x, metadata, num_blocks, scale, res_scale,
                         nonlinearity=False, track=None):
    """f32 QEDSR forward (the calibration mirror): the EDSR spine with each block's
    ParaCALayer gate applied after the res_scale multiply."""
    return _edsr_spine_float(params, x, num_blocks, scale, res_scale, 'final_body', track,
                             gate=_qedsr_gate(metadata, nonlinearity))


def calibrate_qedsr_scales(params, sample_batches, metadata_batches, num_blocks=16,
                           scale=4, res_scale=0.1, nonlinearity=False, margin=1.0):
    """Static activation scales for the int8 QEDSR forward (absmax calibration, true
    f32).  ``metadata_batches`` are the handler-prepared (key-masked) metadata of each
    sample batch."""
    maxes = _calibration_maxes(
        lambda p, x, meta, track: _qedsr_float_forward(p, x, meta, num_blocks, scale,
                                                       res_scale, nonlinearity, track),
        params, sample_batches, metadata_batches, name='calibrate_qedsr_scales')
    maxes.pop('_residual')
    return _finalize_scales(maxes, margin)


def qedsr_int8_forward_static(qparams, act_scales, x, metadata, num_blocks=16, scale=4,
                              res_scale=0.1, nonlinearity=False,
                              residual_dtype='bfloat16'):
    """Quantized QEDSR forward: the int8 EDSR spine with f32 ParaCALayer gates on the
    (N, M) handler-prepared ``metadata``."""
    return _edsr_spine_int8(qparams, act_scales, x, num_blocks, scale, res_scale,
                            _carry_type(residual_dtype), 'final_body',
                            gate=_qedsr_gate(metadata, nonlinearity))


# --- Q-RCAN ----------------------------------------------------------------------------------
def _dense_apply(entry, y):
    return y @ entry['kernel'] + entry['bias']


def _qca_apply(entry, pooled, meta, style):
    """QCALayer math in f32 on the pooled (N, C) vector, every style (sisr_tpu's
    ``_qca_apply``)."""
    y = pooled
    if style in ('modulate', 'standard'):
        y = torch.relu(_dense_apply(entry['du_0'], y))
        y = torch.sigmoid(_dense_apply(entry['du_1'], y))
        if style == 'modulate':
            y = y * meta
    elif style in ('max_concat', 'softmax'):
        y = torch.cat([y, meta], dim=-1)
        y = torch.relu(_dense_apply(entry['du_0'], y))
        y = torch.sigmoid(_dense_apply(entry['du_1'], y))
        if style == 'softmax':
            y = torch.softmax(y, dim=-1)
    elif style == 'mini_concat':
        y = _dense_apply(entry['pre_concat'], y)
        y = torch.relu(torch.cat([y, meta], dim=-1))
        y = torch.sigmoid(_dense_apply(entry['du_1'], y))
    elif style == 'extended_attention':
        for i in range(3):
            y = torch.cat([y, meta], dim=-1)
            y = torch.relu(_dense_apply(entry['feature_%d' % i], y))
        y = torch.sigmoid(_dense_apply(entry['final'], y))
    else:
        raise NotImplementedError('Unknown QCALayer style %s' % style)
    return y


def _para_ca_apply(entry, meta, nonlinearity=True):
    """ParaCALayer math in f32: the ``fc_<i>`` chain on the metadata, with a ReLU
    between layers when ``nonlinearity`` (QRCAB's q_node; Q-EDSR's blocks take the
    config's ``q_layer_nonlinearity``), then a sigmoid."""
    n_fc = sum(1 for k in entry if k.startswith('fc_'))
    y = meta
    for i in range(n_fc):
        y = _dense_apply(entry['fc_%d' % i], y)
        if nonlinearity and i < n_fc - 1:
            y = torch.relu(y)
    return torch.sigmoid(y)


def _pa_apply(entry, h):
    """PALayer: two 1x1 convs (products over the channels) and a sigmoid gate, in
    f32."""
    def c1x1(e, z):
        return z @ e['kernel'][0, 0] + e['bias']
    y = torch.relu(c1x1(entry['pa_0'], h.float()))
    y = torch.sigmoid(c1x1(entry['pa_1'], y))
    return h * y.to(h.dtype)


def quantize_qrcan_params(params, n_resgroups=10, n_resblocks=20, body_tail='final_body'):
    """Quantize a QRCAN parameter tree (sisr_tpu's ``models/qmodels.py`` naming) to
    int8: the 3x3 convs go int8, every attention stage (qca, pa_node, q_node) stays
    f32.  ``body_tail`` names the conv after the groups (Q-HAN's is ``body_tail``)."""
    q = _q_entry
    out = {'head': q(params['head']), body_tail: q(params[body_tail]),
           'tail': q(params['tail']),
           'upsampler': {k: q(v) for k, v in params['upsampler'].items()}}
    for g in range(n_resgroups):
        grp = params['group_%d' % g]
        qg = {'final_body': q(grp['final_body'])}
        for b in range(n_resblocks):
            blk = grp['qrcab_%d' % b]
            qb = {'conv_0': q(blk['conv_0']), 'conv_1': q(blk['conv_1']),
                  'qca': _f32_tree(blk['qca'])}
            for extra in ('pa_node', 'q_node'):  # presence mirrors the module config
                if extra in blk:
                    qb[extra] = _f32_tree(blk[extra])
            qg['qrcab_%d' % b] = qb
        out['group_%d' % g] = qg
    return out


def _qrcan_float_forward(params, x, metadata, style, n_resgroups, n_resblocks,
                         track=None):
    """f32 QRCAN forward over the parameter tree (the calibration mirror; pa_node and
    q_node presence is read off the tree)."""
    tr = track or (lambda name, h: h)
    fconv = _tracked_fconv(tr)
    h = fconv('head', params['head'], x)
    res = _qrcan_groups_float(params, fconv, tr, h, metadata.float(), style, n_resgroups,
                              n_resblocks)[-1]
    res = fconv('final_body', params['final_body'], res) + h
    res = _pow2_upsample(fconv, params['upsampler'], res)
    return fconv('tail', params['tail'], res)


def _qrcan_groups_float(params, fconv, tr, h, meta, style, n_resgroups, n_resblocks):
    """Q-RCAN's (and Q-HAN's) residual groups in f32 on the head's output ``h``: each
    group's output, in order."""
    res, outs = tr('_residual', h), []
    for g in range(n_resgroups):
        grp = params['group_%d' % g]
        r = res
        for b in range(n_resblocks):
            blk = grp['qrcab_%d' % b]
            pre = 'group_%d.qrcab_%d' % (g, b)
            y = torch.relu(fconv(pre + '.conv_0', blk['conv_0'], r))
            y = fconv(pre + '.conv_1', blk['conv_1'], y)
            y = y * _qca_apply(blk['qca'], y.mean(dim=(1, 2)), meta, style)[:, None, None, :]
            if 'pa_node' in blk:
                y = _pa_apply(blk['pa_node'], y)
            if 'q_node' in blk:
                y = y * _para_ca_apply(blk['q_node'], meta)[:, None, None, :]
            r = tr('_residual', y + r)
        res = tr('_residual', fconv('group_%d.final_body' % g, grp['final_body'], r) + res)
        outs.append(res)
    return outs


def calibrate_qrcan_scales(params, sample_batches, metadata_batches, style='modulate',
                           n_resgroups=10, n_resblocks=20, margin=1.0):
    """Static activation scales for the int8 QRCAN forward (absmax calibration, true
    f32).  ``metadata_batches`` are the handler-prepared metadata of each sample batch
    (key-masked, and scale_qpi-expanded for style='modulate')."""
    maxes = _calibration_maxes(
        lambda p, x, meta, track: _qrcan_float_forward(p, x, meta, style, n_resgroups,
                                                       n_resblocks, track),
        params, sample_batches, metadata_batches, name='calibrate_qrcan_scales')
    maxes.pop('_residual')
    return _finalize_scales(maxes, margin)


def _qrcab_tail(blk, y, r, meta, style):
    """One int8 QRCAB's tail after its convs: the f32 branch y times its attention,
    then the pixel attention and the q_node's gate where the block has them, cast once
    to the carry r's type and added to r in that type (sisr_tpu's rounding order).
    Without a pa_node, the kernel styles' whole tail is one
    :func:`fused_channel_attention_residual` call with ``cast_first``, taking the
    metadata (max_concat), the expanded metadata (modulate) and the q_node's gate;
    with one, they scale in one :func:`fused_channel_attention` call.  The other
    styles compute :func:`_qca_apply` in plain f32."""
    q_gate = _para_ca_apply(blk['q_node'], meta) if 'q_node' in blk else None
    if style in KERNEL_STYLES:
        gate = None
        if 'pa_node' not in blk:
            gate, q_gate = q_gate, None
        if style == 'modulate':
            gate = meta if gate is None else meta * gate
        qca = blk['qca']
        weights = (qca['du_0']['kernel'], qca['du_0']['bias'], qca['du_1']['kernel'],
                   qca['du_1']['bias'])
        ca_meta = meta if style == 'max_concat' else None
        if 'pa_node' not in blk:
            return fused_channel_attention_residual(y, r, *weights, meta=ca_meta, gate=gate,
                                                    cast_first=True)
        y = fused_channel_attention(y, *weights, meta=ca_meta, gate=gate)
    else:
        y = y * _qca_apply(blk['qca'], y.mean(dim=(1, 2)), meta, style)[:, None, None, :]
    if 'pa_node' in blk:
        y = _pa_apply(blk['pa_node'], y)
    if q_gate is not None:
        y = y * q_gate[:, None, None, :]
    return y.to(r.dtype) + r


def qrcan_int8_forward_static(qparams, act_scales, x, metadata, style='modulate',
                              n_resgroups=10, n_resblocks=20, residual_dtype='bfloat16'):
    """Quantized QRCAN forward: int8 convs, f32 meta-attention (:func:`_qrcab_tail`)
    on the handler-prepared ``metadata``, and a narrow residual carry: each block's
    branch is cast once to the carry and added in the carry's type."""
    qconv = _qconv_with(act_scales)
    h = qconv('head', qparams['head'], x).to(_carry_type(residual_dtype))
    res = _qrcan_groups_int8(qparams, qconv, h, metadata.float(), style, n_resgroups,
                             n_resblocks)[-1]
    res = qconv('final_body', qparams['final_body'], res) + h.float()
    res = _pow2_upsample(qconv, qparams['upsampler'], res)
    return qconv('tail', qparams['tail'], res)


def _qrcan_groups_int8(qparams, qconv, h, meta, style, n_resgroups, n_resblocks):
    """Q-RCAN's (and Q-HAN's) int8 residual groups on the head's output ``h`` in the
    carry's type, each QRCAB tail :func:`_qrcab_tail`: each group's output, in
    order."""
    res, outs = h, []
    for g in range(n_resgroups):
        grp = qparams['group_%d' % g]
        r = res
        for b in range(n_resblocks):
            blk = grp['qrcab_%d' % b]
            pre = 'group_%d.qrcab_%d' % (g, b)
            y = torch.relu(qconv(pre + '.conv_0', blk['conv_0'], r))
            y = qconv(pre + '.conv_1', blk['conv_1'], y)
            r = _qrcab_tail(blk, y, r, meta, style)
        res = qconv('group_%d.final_body' % g, grp['final_body'], r).to(h.dtype) + res
        outs.append(res)
    return outs


# --- HAN and Q-HAN ---------------------------------------------------------------------------
def _quantize_han_fusion(params, out):
    """Add HAN's fusion layers to a quantised tree: the two fusion convs (``last_conv``,
    (N+1)*C -> C, the widest conv of the net) int8, LAM and CSAM f32."""
    out['last_conv'] = _q_entry(params['last_conv'])
    out['last'] = _q_entry(params['last'])
    out['la'] = _f32_tree(params['la'])
    out['csa'] = _f32_tree(params['csa'])
    return out


def quantize_han_params(params, n_resgroups=10, n_resblocks=20):
    """Quantize a HAN parameter tree (sisr_tpu's ``models/advanced.py`` naming) to
    int8: RCAN's tree and HAN's fusion layers."""
    return _quantize_han_fusion(params, quantize_rcan_params(params, n_resgroups,
                                                             n_resblocks))


def _lam_apply(entry, stack, compute_dtype=None):
    """LAM on the (B, N, H, W, C) stack (sisr_tpu's ``_lam_apply``): f32 by default
    (calibration); the int8 forwards pass ``compute_dtype=torch.bfloat16``, so the
    stack, the largest tensor of the model, moves at bf16 (the gram, the softmax
    and the sums stay f32: :func:`~sisr_tpu_torch.models.advanced.layer_attention`,
    which takes the maps as image rows)."""
    rows = stack.transpose(1, 2).to(compute_dtype or stack.dtype).contiguous()
    return layer_attention(rows, entry['gamma'])


def _csam_apply(entry, h_in, compute_dtype=None):
    """CSAM on the NHWC map (sisr_tpu's ``_csam_apply``): the 3-D conv summed in f32
    (on the ``compute_dtype`` values when given), plus the bias and the sigmoid in
    f32, then ``h * (gamma * att) + h`` in the map's type."""
    kernel = entry['conv3d_kernel']  # DHWIO over (C, H, W)
    if compute_dtype is not None:
        h_in, kernel = h_in.to(compute_dtype), kernel.to(compute_dtype)
    weight = csam_weight(kernel.permute(4, 3, 0, 1, 2).float(), h_in.shape[-1])
    att = F.conv2d(h_in.float().permute(0, 3, 1, 2), weight, padding=1).permute(0, 2, 3, 1)
    att = torch.sigmoid(att + entry['conv3d_bias']).to(h_in.dtype)
    return h_in * (entry['gamma'].to(h_in.dtype) * att) + h_in


def _han_fusion_float(params, fconv, h, outs):
    """HAN's and Q-HAN's end in f32 after the groups' outputs ``outs`` (sisr_tpu's
    ``_han_float_forward`` from the body tail on)."""
    res = fconv('body_tail', params['body_tail'], outs[-1])
    la = _lam_apply(params['la'], torch.stack([res] + outs[::-1], dim=1))
    out2 = fconv('last_conv', params['last_conv'], la)
    out = torch.cat([_csam_apply(params['csa'], res), out2], dim=-1)
    res = fconv('last', params['last'], out) + h
    res = _pow2_upsample(fconv, params['upsampler'], res)
    return fconv('tail', params['tail'], res)


def _han_fusion_int8(qparams, qconv, h, outs):
    """HAN's and Q-HAN's int8 end (sisr_tpu's ``han_int8_forward_static`` from the body
    tail on): the body tail int8, LAM over the stack (newest first, the body tail's
    output cast to the carry) and CSAM on the body tail's f32 output, both in bf16,
    the fusion convs int8."""
    res = qconv('body_tail', qparams['body_tail'], outs[-1])
    stack = torch.stack([res.to(h.dtype)] + outs[::-1], dim=1)
    out2 = qconv('last_conv', qparams['last_conv'],
                 _lam_apply(qparams['la'], stack, compute_dtype=torch.bfloat16))
    out1 = _csam_apply(qparams['csa'], res, compute_dtype=torch.bfloat16)
    res = qconv('last', qparams['last'], torch.cat([out1.float(), out2], dim=-1)) + h.float()
    res = _pow2_upsample(qconv, qparams['upsampler'], res)
    return qconv('tail', qparams['tail'], res)


def _han_float_forward(params, x, n_resgroups, n_resblocks, track=None):
    """f32 HAN forward over the parameter tree (the calibration mirror)."""
    tr = track or (lambda name, h: h)
    fconv = _tracked_fconv(tr)
    h = fconv('head', params['head'], x)
    return _han_fusion_float(params, fconv, h, _rcan_groups_float(
        params, fconv, tr, h, n_resgroups, n_resblocks))


def calibrate_han_scales(params, sample_batches, n_resgroups=10, n_resblocks=20,
                         margin=1.0):
    """Static activation scales for the int8 HAN forward (absmax calibration, true
    f32)."""
    maxes = _calibration_maxes(
        lambda p, x, _, track: _han_float_forward(p, x, n_resgroups, n_resblocks, track),
        params, sample_batches)
    maxes.pop('_residual')
    return _finalize_scales(maxes, margin)


def han_int8_forward_static(qparams, act_scales, x, n_resgroups=10, n_resblocks=20,
                            residual_dtype='bfloat16', ca_epilogue='kernel'):
    """Quantized HAN forward: RCAN's int8 body (each RCAB tail one
    :func:`fused_channel_attention_residual` call: sisr_tpu's
    ``ca_epilogue='pallas'``; ``'plain'`` its plain version), LAM and CSAM in bf16,
    the fusion convs int8."""
    qconv = _qconv_with(act_scales)
    h = qconv('head', qparams['head'], x).to(_carry_type(residual_dtype))
    return _han_fusion_int8(qparams, qconv, h, _rcan_groups_int8(
        qparams, qconv, h, n_resgroups, n_resblocks, ca_epilogue))


def quantize_qhan_params(params, n_resgroups=10, n_resblocks=20):
    """Quantize a QHAN parameter tree (sisr_tpu's ``models/qmodels.py`` naming) to int8:
    Q-RCAN's groups (the convs int8, every attention stage f32), the body tail, and
    HAN's fusion layers."""
    return _quantize_han_fusion(params, quantize_qrcan_params(
        params, n_resgroups, n_resblocks, body_tail='body_tail'))


def _qhan_float_forward(params, x, metadata, n_resgroups, n_resblocks, track=None):
    """f32 QHAN forward (the calibration mirror): Q-RCAN's groups in the ``standard``
    style, then HAN's fusion."""
    tr = track or (lambda name, h: h)
    fconv = _tracked_fconv(tr)
    h = fconv('head', params['head'], x)
    return _han_fusion_float(params, fconv, h, _qrcan_groups_float(
        params, fconv, tr, h, metadata.float(), 'standard', n_resgroups, n_resblocks))


def calibrate_qhan_scales(params, sample_batches, metadata_batches, n_resgroups=10,
                          n_resblocks=20, margin=1.0):
    """Static activation scales for the int8 QHAN forward (absmax calibration, true
    f32); ``metadata_batches`` are the handler-prepared metadata of each sample
    batch."""
    maxes = _calibration_maxes(
        lambda p, x, meta, track: _qhan_float_forward(p, x, meta, n_resgroups,
                                                      n_resblocks, track),
        params, sample_batches, metadata_batches, name='calibrate_qhan_scales')
    maxes.pop('_residual')
    return _finalize_scales(maxes, margin)


def qhan_int8_forward_static(qparams, act_scales, x, metadata, n_resgroups=10,
                             n_resblocks=20, residual_dtype='bfloat16'):
    """Quantized QHAN forward: Q-RCAN's int8 groups, each QRCAB tail
    :func:`_qrcab_tail` in the ``standard`` style (one
    :func:`fused_channel_attention_residual` call with the q_node's gate, cast first;
    sisr_tpu multiplies by the attention and then by the gate, which differs from
    one product by f32 rounding), then HAN's int8 fusion."""
    qconv = _qconv_with(act_scales)
    h = qconv('head', qparams['head'], x).to(_carry_type(residual_dtype))
    return _han_fusion_int8(qparams, qconv, h, _qrcan_groups_int8(
        qparams, qconv, h, metadata.float(), 'standard', n_resgroups, n_resblocks))


# --- SAN and Q-SAN ---------------------------------------------------------------------------
def quantize_san_params(params, n_resgroups=20, n_resblocks=10, block='rb_%d'):
    """Quantize a SAN parameter tree (sisr_tpu's ``models/san.py`` naming) to int8: the
    3x3 convs (the blocks, each group's ``conv_last``, head, upsampler, tail) go int8;
    the shared non-local block, each SOCA, ``gamma`` and (Q-SAN, ``block='qrb_%d'``)
    each block's ParaCALayer ``q_layer`` stay f32."""
    q = _q_entry
    out = {'head': q(params['head']), 'tail': q(params['tail']),
           'upsampler': {k: q(v) for k, v in params['upsampler'].items()},
           'non_local': _f32_tree(params['non_local']), 'gamma': params['gamma'].float()}
    for g in range(n_resgroups):
        grp = params['rg_%d' % g]
        qg = {'conv_last': q(grp['conv_last']), 'soca': _f32_tree(grp['soca'])}
        for b in range(n_resblocks):
            blk = grp[block % b]
            qg[block % b] = {'conv_0': q(blk['conv_0']), 'conv_1': q(blk['conv_1'])}
            if 'q_layer' in blk:
                qg[block % b]['q_layer'] = _f32_tree(blk['q_layer'])
        out['rg_%d' % g] = qg
    return out


def _nonlocal_block_apply(entry, x_f32):
    """The embedded-gaussian non-local block in f32 on an NHWC map (sisr_tpu's
    ``_nonlocal_block_apply``: g and phi always 2 x 2 max-pooled)."""
    def c1x1(e, z):
        return z @ e['kernel'][0, 0] + e['bias']
    g = max_pool2(c1x1(entry['g'], x_f32))
    phi = max_pool2(c1x1(entry['phi'], x_f32))
    y = embedded_gaussian(c1x1(entry['theta'], x_f32), phi, g)
    return c1x1(entry['w'], y) + x_f32


def _nonlocal_ca_apply(entry, x_f32):
    """The shared block on each quadrant of an NHWC map (sisr_tpu's
    ``_nonlocal_ca_apply``)."""
    return quadrants(lambda part: _nonlocal_block_apply(entry['non_local'], part), x_f32,
                     1, 2)


def _soca_apply(entry, h_f32):
    """SOCA in f32 on an NHWC map (sisr_tpu's ``_soca_apply``, the 1000^2 crop
    included)."""
    y = torch.relu(_dense_apply(entry['du_0'], second_order_pool(h_f32)))
    y = torch.sigmoid(_dense_apply(entry['du_1'], y))
    return h_f32 * y[:, None, None, :]


def _san_float_forward(params, x, n_resgroups, n_resblocks, track=None, meta=None):
    """f32 SAN forward over the parameter tree (the calibration mirror), or with
    ``meta`` (handler-prepared metadata) the QSAN forward: each block's branch times its
    ``q_layer`` gate."""
    tr = track or (lambda name, h: h)
    fconv = _tracked_fconv(tr)
    block = 'rb_%d' if meta is None else 'qrb_%d'
    h = fconv('head', params['head'], x)
    xx = _nonlocal_ca_apply(params['non_local'], h)
    residual = tr('_residual', xx)
    for g in range(n_resgroups):
        grp = params['rg_%d' % g]
        r = xx
        for b in range(n_resblocks):
            blk = grp[block % b]
            pre = 'rg_%d.%s' % (g, block % b)
            y = torch.relu(fconv(pre + '.conv_0', blk['conv_0'], r))
            y = fconv(pre + '.conv_1', blk['conv_1'], y)
            if meta is not None:
                y = y * _para_ca_apply(blk['q_layer'], meta)[:, None, None, :]
            r = tr('_residual', y + r)
        r = _soca_apply(grp['soca'], r)
        xx = tr('_residual', fconv('rg_%d.conv_last' % g, grp['conv_last'], r) + xx
                + params['gamma'] * residual)
    res = _nonlocal_ca_apply(params['non_local'], xx) + h
    res = _pow2_upsample(fconv, params['upsampler'], res)
    return fconv('tail', params['tail'], res)


def calibrate_san_scales(params, sample_batches, n_resgroups=20, n_resblocks=10,
                         margin=1.0):
    """Static activation scales for the int8 SAN forward (absmax calibration, true
    f32)."""
    maxes = _calibration_maxes(
        lambda p, x, _, track: _san_float_forward(p, x, n_resgroups, n_resblocks, track),
        params, sample_batches)
    maxes.pop('_residual')
    return _finalize_scales(maxes, margin)


def _san_int8(qparams, act_scales, x, n_resgroups, n_resblocks, residual_dtype, meta=None):
    """SAN's (with ``meta``, Q-SAN's) int8 forward: the int8 convs, the non-local block
    and SOCA in f32 (the carry cast up for them), each block's branch (Q-SAN: times its
    f32 gate) cast to the carry and added in its type, each group's output
    ``conv_last + xx + gamma * residual`` in the carry's type, in that order."""
    carry_t = _carry_type(residual_dtype)
    qconv = _qconv_with(act_scales)
    block = 'rb_%d' if meta is None else 'qrb_%d'
    gamma = qparams['gamma'].to(carry_t)
    h = qconv('head', qparams['head'], x)
    xx = _nonlocal_ca_apply(qparams['non_local'], h).to(carry_t)
    residual = xx
    for g in range(n_resgroups):
        grp = qparams['rg_%d' % g]
        r = xx
        for b in range(n_resblocks):
            blk = grp[block % b]
            pre = 'rg_%d.%s' % (g, block % b)
            y = torch.relu(qconv(pre + '.conv_0', blk['conv_0'], r))
            y = qconv(pre + '.conv_1', blk['conv_1'], y)
            if meta is not None:
                y = y * _para_ca_apply(blk['q_layer'], meta)[:, None, None, :]
            r = y.to(carry_t) + r
        r = _soca_apply(grp['soca'], r.float())
        xx = qconv('rg_%d.conv_last' % g, grp['conv_last'], r).to(carry_t) + xx \
            + gamma * residual
    res = _nonlocal_ca_apply(qparams['non_local'], xx.float()) + h
    res = _pow2_upsample(qconv, qparams['upsampler'], res)
    return qconv('tail', qparams['tail'], res)


def san_int8_forward_static(qparams, act_scales, x, n_resgroups=20, n_resblocks=10,
                            residual_dtype='bfloat16'):
    """Quantized SAN forward: the int8 conv body, the non-local block and SOCA in f32, a
    narrow residual carry (:func:`_san_int8`)."""
    return _san_int8(qparams, act_scales, x, n_resgroups, n_resblocks, residual_dtype)


def quantize_qsan_params(params, n_resgroups=20, n_resblocks=10):
    """Quantize a QSAN parameter tree to int8: SAN's split, each block's ParaCALayer
    gate f32."""
    return quantize_san_params(params, n_resgroups, n_resblocks, block='qrb_%d')


def calibrate_qsan_scales(params, sample_batches, metadata_batches, n_resgroups=20,
                          n_resblocks=10, margin=1.0):
    """Static activation scales for the int8 QSAN forward (absmax calibration, true
    f32); ``metadata_batches`` are the handler-prepared metadata of each sample
    batch."""
    maxes = _calibration_maxes(
        lambda p, x, meta, track: _san_float_forward(p, x, n_resgroups, n_resblocks, track,
                                                     meta=meta),
        params, sample_batches, metadata_batches, name='calibrate_qsan_scales')
    maxes.pop('_residual')
    return _finalize_scales(maxes, margin)


def qsan_int8_forward_static(qparams, act_scales, x, metadata, n_resgroups=20,
                             n_resblocks=10, residual_dtype='bfloat16'):
    """Quantized QSAN forward: SAN's int8 program with each block's f32 ParaCALayer gate
    on the handler-prepared ``metadata``."""
    return _san_int8(qparams, act_scales, x, n_resgroups, n_resblocks, residual_dtype,
                     meta=metadata.float())


# --- SRMD and SFTMD --------------------------------------------------------------------------
def quantize_srmd_params(params):
    """Quantize an SRMD parameter tree (sisr_tpu's ``models/advanced.py`` naming:
    ``conv_0`` .. ``conv_<nb - 2>`` and ``conv_tail``) to int8: the whole chain."""
    return {k: _q_entry(v) for k, v in params.items() if k.startswith('conv_')}


def _srmd_convs(params):
    return sum(1 for k in params if k.startswith('conv_') and k != 'conv_tail')


def _srmd_float_forward(params, x, scale, track=None):
    """f32 SRMD forward over the parameter tree (the calibration mirror); ``x`` is the
    input with its metadata maps concatenated."""
    fconv = _tracked_fconv(track or (lambda name, h: h))
    out = x.float()
    for i in range(_srmd_convs(params)):
        out = torch.relu(fconv('conv_%d' % i, params['conv_%d' % i], out))
    return pixel_shuffle(fconv('conv_tail', params['conv_tail'], out), scale)


def calibrate_srmd_scales(params, sample_batches, scale, margin=1.0):
    """Static activation scales for the int8 SRMD forward (absmax calibration, true
    f32) on the concatenated inputs."""
    maxes = _calibration_maxes(
        lambda p, x, _, track: _srmd_float_forward(p, x, scale, track), params,
        sample_batches)
    return _finalize_scales(maxes, margin)


def srmd_int8_forward_static(qparams, act_scales, x, scale):
    """Quantized SRMD forward: every conv int8, the ReLUs in f32, on the input with
    its metadata maps concatenated."""
    qconv = _qconv_with(act_scales)
    out = x.float()
    for i in range(_srmd_convs(qparams)):
        out = torch.relu(qconv('conv_%d' % i, qparams['conv_%d' % i], out))
    return pixel_shuffle(qconv('conv_tail', qparams['conv_tail'], out), scale)


_SFTMD_SPINE = ('conv1', 'conv2', 'conv3', 'conv_mid', 'up_conv1', 'up_conv2', 'conv_output')


def quantize_sftmd_params(params, num_blocks=16, scale=4):
    """Quantize an SFTMD parameter tree (sisr_tpu's ``models/sftmd.py`` naming) to
    int8: the conv spine (conv1-3, each block's conv1 and conv2, conv_mid, the
    upscale's convs, the 9x9 conv_output) int8; the SFT layers (none for the
    parameterless ``weak`` and ``none``) and the q-injection ParaCALayers f32."""
    out = {k: _q_entry(params[k]) for k in _SFTMD_SPINE if k in params}
    for k in ('sft', 'final_injection'):
        if k in params:
            out[k] = _f32_tree(params[k])
    for i in range(1, num_blocks + 1):
        blk = params['sft_residual_%d' % i]
        qb = {'conv1': _q_entry(blk['conv1']), 'conv2': _q_entry(blk['conv2'])}
        qb.update({k: _f32_tree(blk[k]) for k in ('sft1', 'sft2', 'q_1', 'q_2') if k in blk})
        out['sft_residual_%d' % i] = qb
    return out


def _sft_apply(entry, sft_type, fea, para_maps, repeats=None, mask_para=False,
               compute_dtype=None):
    """SFTLayer math on NHWC maps (sisr_tpu's ``_sft_apply``): f32 by default (the
    calibration mirror); ``compute_dtype`` bfloat16 casts the features and the maps and
    runs the branches' convs in it (the int8 forward)."""
    if compute_dtype is not None:
        fea, para_maps = fea.to(compute_dtype), para_maps.to(compute_dtype)
    if sft_type == 'none':
        return fea
    if sft_type == 'weak':
        return fea * para_maps
    if sft_type == 'concat':
        return _fconv(entry['sft_module']['conv'], torch.cat([fea, para_maps], dim=-1),
                      compute_dtype)
    mod = entry['sft_module']
    if repeats is not None:
        para_maps = para_maps.repeat(1, 1, 1, repeats)
    cat = fea if mask_para else torch.cat([fea, para_maps], dim=-1)
    mul = F.leaky_relu(_fconv(mod['mul_conv1'], cat, compute_dtype), 0.2)
    mul = torch.sigmoid(_fconv(mod['mul_conv2'], mul, compute_dtype))
    add = F.leaky_relu(_fconv(mod['add_conv1'], cat, compute_dtype), 0.2)
    return fea * mul + _fconv(mod['add_conv2'], add, compute_dtype)


def _sftmd_upscale(conv, params, fea, scale):
    """SFTMD's upscale: at 4x two conv + x2 shuffle + LeakyReLU stages, else one."""
    stages = (('up_conv1', 2), ('up_conv2', 2)) if scale == 4 else (('up_conv1', scale),)
    for name, factor in stages:
        fea = F.leaky_relu(pixel_shuffle(conv(name, params[name], fea), factor), 0.2)
    return fea


def _sftmd_body(params, conv, x, meta, num_blocks, scale, sft_type, mask_para, repeats,
                sft_dtype=None):
    """SFTMD's forward over a parameter tree with the spine's ``conv(name, entry, h)``
    (f32 or int8): the SFT layers in ``sft_dtype`` (f32 when None), each q-injection
    gate in f32 on the (N, M) ``meta``, cast to its map's type in the blocks (the final
    gate's product promotes to f32), as sisr_tpu's forwards do."""
    n, h, w, _ = x.shape
    para_maps = meta[:, None, None, :].expand(n, h, w, meta.shape[-1])
    if sft_dtype is not None:  # cast once: the same values as a cast at each layer
        para_maps = para_maps.to(sft_dtype)

    def sft(entry, fea):
        return _sft_apply(entry, sft_type, fea, para_maps, repeats, mask_para, sft_dtype)

    def gate(entry):
        return _para_ca_apply(entry, meta)[:, None, None, :]

    fea = F.leaky_relu(conv('conv1', params['conv1'], x), 0.2)
    fea = F.leaky_relu(conv('conv2', params['conv2'], fea), 0.2)
    fea_bef = conv('conv3', params['conv3'], fea)
    fea_in = fea_bef
    for i in range(1, num_blocks + 1):
        blk, pre = params['sft_residual_%d' % i], 'sft_residual_%d' % i
        f1 = torch.relu(sft(blk.get('sft1'), fea_in))
        if 'q_1' in blk:
            f1 = f1 * gate(blk['q_1']).to(f1.dtype)
        f1 = conv(pre + '.conv1', blk['conv1'], f1)
        f2 = torch.relu(sft(blk.get('sft2'), f1))
        if 'q_2' in blk:
            f2 = f2 * gate(blk['q_2']).to(f2.dtype)
        fea_in = fea_in + conv(pre + '.conv2', blk['conv2'], f2)
    fea_fin = sft(params.get('sft'), fea_in + fea_bef)
    if 'final_injection' in params:
        fea_fin = fea_fin * gate(params['final_injection'])
    fea = _sftmd_upscale(conv, params, conv('conv_mid', params['conv_mid'], fea_fin), scale)
    return torch.clamp(conv('conv_output', params['conv_output'], fea), 0.0, 1.0)


def _sftmd_float_forward(params, x, metadata, num_blocks=16, scale=4, sft_type='standard',
                         mask_para=False, repeats=None, track=None):
    """f32 SFTMD forward (the calibration mirror); ``metadata`` the (N, M) vector."""
    fconv = _tracked_fconv(track or (lambda name, h: h))
    return _sftmd_body(params, fconv, x.float(), metadata.float(), num_blocks, scale,
                       sft_type, mask_para, repeats)


def calibrate_sftmd_scales(params, sample_batches, metadata_batches, num_blocks=16, scale=4,
                           sft_type='standard', mask_para=False, repeats=None, margin=1.0):
    """Static activation scales for the int8 SFTMD forward (absmax calibration, true
    f32) on the batches and their handler-prepared (N, M) metadata."""
    maxes = _calibration_maxes(
        lambda p, x, meta, track: _sftmd_float_forward(p, x, meta, num_blocks, scale,
                                                       sft_type, mask_para, repeats, track),
        params, sample_batches, metadata_batches, name='calibrate_sftmd_scales')
    return _finalize_scales(maxes, margin)


def sftmd_int8_forward_static(qparams, act_scales, x, metadata, num_blocks=16, scale=4,
                              sft_type='standard', mask_para=False, repeats=None):
    """Quantized SFTMD forward: the int8 conv spine (the 9x9 conv_output's gather in
    bands at HR size), the SFT branches in bf16, the q-injection gates in f32."""
    return _sftmd_body(qparams, _qconv_with(act_scales), x.float(), metadata.float(),
                       num_blocks, scale, sft_type, mask_para, repeats,
                       sft_dtype=torch.bfloat16)


# --- VDSR ------------------------------------------------------------------------------------
def quantize_vdsr_params(params):
    """Quantize a VDSR parameter tree (sisr_tpu's ``models/basic.py`` naming:
    ``conv_0`` .. ``conv_<n - 1>``) to int8: the whole chain."""
    return {k: _q_entry(v) for k, v in params.items() if k.startswith('conv_')}


def _vdsr_convs(params):
    return sum(1 for k in params if k.startswith('conv_'))


def _vdsr_float_forward(params, x, track=None):
    """f32 VDSR forward over the parameter tree, ``padding='same'`` (the calibration
    mirror); ``x`` the (N, H, W, 1) Y channel of the pre-upscaled LR."""
    fconv = _tracked_fconv(track or (lambda name, h: h))
    n = _vdsr_convs(params)
    out = residual = x.float()
    for i in range(n):
        out = fconv('conv_%d' % i, params['conv_%d' % i], out)
        if i != n - 1:
            out = torch.relu(out)
    return out + residual


def calibrate_vdsr_scales(params, sample_batches, margin=1.0):
    """Static activation scales for the int8 VDSR forward (absmax calibration, true
    f32) on the Y channels of the pre-upscaled LR batches."""
    maxes = _calibration_maxes(lambda p, x, _, track: _vdsr_float_forward(p, x, track),
                               params, sample_batches)
    return _finalize_scales(maxes, margin)


def vdsr_int8_forward_static(qparams, act_scales, x):
    """Quantized VDSR forward: the whole conv chain int8 at HR size (the first conv's
    9 input values a pixel padded to 16 in the im2col matrix, the last conv's one
    output to 8), the ReLUs and the global residual in f32."""
    qconv = _qconv_with(act_scales)
    n = _vdsr_convs(qparams)
    out = residual = x.float()
    for i in range(n):
        out = qconv('conv_%d' % i, qparams['conv_%d' % i], out)
        if i != n - 1:
            out = torch.relu(out)
    return out + residual
