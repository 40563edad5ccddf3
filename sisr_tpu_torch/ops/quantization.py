"""Int8 serving of RCAN: the RCAN subset of sisr_tpu's ``ops/quantization.py``.

The recipe is sisr_tpu's, with its names, NHWC activations, HWIO kernels and
parameter-tree and scale-key names (``head``, ``group_<g>.rcab_<b>.conv_0``,
``group_<g>.conv_tail``, ``body_tail``, ``upsampler.conv_<i>``, ``tail``):

* weights: symmetric per-output-channel int8 (scale = max|w| / 127 over H, W, I);
* activations: one static scale per conv input, from the absmax of a float32
  calibration pass (:func:`calibrate_rcan_scales`);
* every 3x3 conv in int8 with an exact int32 sum; dequantisation, bias, ReLU and the
  residual carry (bfloat16 or float32) in float32 or the carry's type;
* each RCAB tail (channel attention scale + residual add) runs as
  :func:`~sisr_tpu_torch.ops.channel_attention.fused_channel_attention_residual`, the
  CUDA kernel on the card: the numerics of sisr_tpu's ``ca_epilogue='pallas'``.

The int8 convolution is an im2col product: the padded int8 input's 3x3 windows are
gathered into an (N*H*W, 9*Cin) int8 matrix and multiplied by the HWIO kernel
reshaped to (9*Cin, Cout) with ``torch._int_mm``, which sums in int32 exactly.  The
weight matrix is packed once, at quantisation (``entry['matrix']``), zero-padded to
the multiples of 8 that ``_int_mm`` takes.

The programs are plain functions over dicts of tensors, as in sisr_tpu; they do not
run the ``nn.Module``.  Activation scales are ``np.float32`` numbers; the forward
also takes them as 0-dim tensors on its device (:func:`scales_on`), which is how the
handler passes them, so no host-to-device copy runs per conv.
"""
import numpy as np
import torch
import torch.nn.functional as F

from .channel_attention import fused_channel_attention_residual

_INT_MM_MULTIPLE = 8    # _int_mm on CUDA takes K and N divisible by 8 ...
_INT_MM_MIN_ROWS = 17   # ... and more than 16 rows


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


def _fconv(entry, h):
    """SAME conv + bias in f32 (the calibration mirror's conv primitive; sisr_tpu's
    ``_fconv`` f32 branch).  NHWC in and out, HWIO kernel."""
    k = entry['kernel']
    out = F.conv2d(h.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                   padding=(k.shape[0] // 2, k.shape[1] // 2))
    return out.permute(0, 2, 3, 1) + entry['bias']


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


def _im2col(x_q, kh, kw, k_cols):
    """(N, H, W, Cin) int8 -> (N*H*W, k_cols) int8: the SAME-padded kh x kw windows in
    (kh, kw, Cin) order, then zero columns up to ``k_cols``."""
    n, h, w, cin = x_q.shape
    xp = F.pad(x_q, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    cols = [xp[:, i:i + h, j:j + w, :] for i in range(kh) for j in range(kw)]
    if k_cols > kh * kw * cin:
        cols.append(x_q.new_zeros((n, h, w, k_cols - kh * kw * cin)))
    return torch.cat(cols, dim=-1).reshape(n * h * w, k_cols)


def conv_int8_accumulate(x_q, q_kernel, matrix=None):
    """SAME conv of an int8 NHWC map with an int8 HWIO kernel: the exact int32 sums
    (N, H, W, Cout), by ``torch._int_mm`` on the im2col matrix."""
    kh, kw, _, cout = q_kernel.shape
    if matrix is None:
        matrix = pack_kernel_matrix(q_kernel)
    n, h, w, _ = x_q.shape
    a = _im2col(x_q, kh, kw, matrix.shape[0])
    rows = a.shape[0]
    if rows < _INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - rows))
    acc = torch._int_mm(a, matrix)
    return acc[:rows, :cout].reshape(n, h, w, cout)


def conv_int8_static(x, q_kernel, w_scale, x_scale, bias=None, matrix=None):
    """int8 conv with a precomputed (static) activation scale: quantise x, sum in
    int32, dequantise ``acc * (x_scale * w_scale) + bias`` in f32, in that order."""
    x_scale = _scale_tensor(x_scale, x.device)
    acc = conv_int8_accumulate(quantize_activations_static(x, x_scale), q_kernel, matrix)
    out = acc.float() * (x_scale * w_scale)
    if bias is not None:
        out = out + bias
    return out


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
            qg['rcab_%d' % b] = {
                'conv_0': q(blk['conv_0']), 'conv_1': q(blk['conv_1']),
                'ca': {k: {kk: vv.float() for kk, vv in v.items()}
                       for k, v in blk['ca'].items()}}
        out['group_%d' % g] = qg
    return out


def _rcan_float_forward(params, x, n_resgroups, n_resblocks, track=None):
    """f32 RCAN forward over the parameter tree (the calibration mirror of
    sisr_tpu's ``_rcan_float_forward``)."""
    tr = track or (lambda name, h: h)
    fconv = _fconv

    def ca(entry, h):
        a = h.mean(dim=(1, 2))
        a = torch.relu(a @ entry['du_0']['kernel'] + entry['du_0']['bias'])
        a = torch.sigmoid(a @ entry['du_1']['kernel'] + entry['du_1']['bias'])
        return h * a[:, None, None, :]

    h = fconv(params['head'], tr('head', x))
    res = tr('_residual', h)
    for g in range(n_resgroups):
        grp = params['group_%d' % g]
        r = res
        for b in range(n_resblocks):
            blk = grp['rcab_%d' % b]
            pre = 'group_%d.rcab_%d' % (g, b)
            y = torch.relu(fconv(blk['conv_0'], tr(pre + '.conv_0', r)))
            y = fconv(blk['conv_1'], tr(pre + '.conv_1', y))
            r = tr('_residual', ca(blk['ca'], y) + r)
        res = tr('_residual',
                 fconv(grp['conv_tail'], tr('group_%d.conv_tail' % g, r)) + res)
    res = fconv(params['body_tail'], tr('body_tail', res)) + h
    _check_rcan_upsampler_pow2(params['upsampler'])
    for i in range(sum(1 for k in params['upsampler'] if k.startswith('conv_'))):
        res = fconv(params['upsampler']['conv_%d' % i], tr('upsampler.conv_%d' % i, res))
        res = pixel_shuffle(res, 2)
    return fconv(params['tail'], tr('tail', res))


def _check_rcan_upsampler_pow2(upsampler):
    """One conv + x2 shuffle per stage only covers power-of-2 scales; fail early for
    the x3 Upsampler (9*n_feat conv)."""
    k = upsampler['conv_0']['kernel']
    if k.shape[-1] != 4 * k.shape[-2]:
        raise NotImplementedError('int8 RCAN path supports power-of-2 scales only '
                                  '(x3 upsampler detected: conv_0 %s)'
                                  % str(tuple(k.shape)))


def _true_f32_convs():
    """cuDNN runs f32 convs in TF32 by default on Hopper, which would shift every
    absmax: calibration turns TF32 off for its own convs only, no global flag."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def calibrate_rcan_scales(params, sample_batches, n_resgroups=10, n_resblocks=20,
                          margin=1.0):
    """Static activation scales for the int8 RCAN forward (absmax calibration, true
    f32): {scale key: np.float32}."""
    track, maxes = _absmax_tracker()
    if not len(sample_batches):
        raise ValueError('no calibration batches provided.')
    with torch.inference_mode(), _true_f32_convs():
        for x in sample_batches:
            x = torch.as_tensor(x).float()
            _rcan_float_forward(params, x.to(params['head']['kernel'].device),
                                n_resgroups, n_resblocks, track=track)
    maxes.pop('_residual')  # RCAN supports only f32/bf16 residual carries (no int16)
    return _finalize_scales(maxes, margin)


def scales_on(act_scales, device):
    """The scales as 0-dim f32 tensors on ``device``, from one host-to-device copy."""
    names = sorted(act_scales)
    values = torch.tensor([float(act_scales[k]) for k in names], dtype=torch.float32)
    values = values.to(device)
    return {k: values[i] for i, k in enumerate(names)}


def rcan_int8_forward_static(qparams, act_scales, x, n_resgroups=10, n_resblocks=20,
                             residual_dtype='bfloat16'):
    """Quantized RCAN forward: int8 convs, f32 channel attention, narrow residual
    carry; each RCAB tail is one :func:`fused_channel_attention_residual` call.

    ``x`` is the f32 NHWC LR batch; returns the f32 NHWC SR batch."""
    if residual_dtype not in ('float32', 'bfloat16'):
        raise ValueError('residual_dtype must be float32 | bfloat16')
    carry_t = torch.float32 if residual_dtype == 'float32' else torch.bfloat16

    def qconv(name, tree, h):
        return conv_int8_static(h, tree['kernel'], tree['scale'], act_scales[name],
                                tree['bias'], tree.get('matrix'))

    def ca_res(entry, h, r):
        return fused_channel_attention_residual(
            h, r, entry['du_0']['kernel'], entry['du_0']['bias'],
            entry['du_1']['kernel'], entry['du_1']['bias'])

    h = qconv('head', qparams['head'], x).to(carry_t)
    res = h
    for g in range(n_resgroups):
        grp = qparams['group_%d' % g]
        r = res
        for b in range(n_resblocks):
            blk = grp['rcab_%d' % b]
            pre = 'group_%d.rcab_%d' % (g, b)
            y = torch.relu(qconv(pre + '.conv_0', blk['conv_0'], r))
            y = qconv(pre + '.conv_1', blk['conv_1'], y)
            r = ca_res(blk['ca'], y, r)
        res = qconv('group_%d.conv_tail' % g, grp['conv_tail'], r).to(carry_t) + res
    res = qconv('body_tail', qparams['body_tail'], res) + h.float()
    _check_rcan_upsampler_pow2(qparams['upsampler'])
    for i in range(sum(1 for k in qparams['upsampler'] if k.startswith('conv_'))):
        res = qconv('upsampler.conv_%d' % i, qparams['upsampler']['conv_%d' % i], res)
        res = pixel_shuffle(res, 2)
    return qconv('tail', qparams['tail'], res)
