"""Fused channel-attention "squeeze-and-excite": a hand-written CUDA kernel for Hopper.

Computes ``out = x * sigmoid(relu(mean_hw(x) @ w1 + b1) @ w2 + b2)``, the CALayer of
RCAN, with the signature and layout of sisr_tpu's ``fused_channel_attention``: x is
(N, H, W, C), w1 (C, C/r), b1 (C/r), w2 (C/r, C), b2 (C).  A channels_last NCHW
activation permuted to (0, 2, 3, 1) is exactly a contiguous NHWC view, so the model
passes its activations without a copy.

On a CUDA tensor the wrapper launches ``ops/cuda/csrc/channel_attention.cu`` (design
and bound in that file) or raises; on a CPU tensor it runs
:func:`reference_channel_attention`, the plain version the kernel is held against.
``fused_channel_attention.launches`` counts kernel launches.
"""
import ctypes

import torch

from .cuda import build as cuda_build

_THREADS = 256  # kThreads in channel_attention.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {'sisr_ca_forward': (
    ctypes.c_int, [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])}
# the excite keeps 2*C + Cr floats in the 48 KB of static shared memory
_MAX_EXCITE_FLOATS = 12288
_DEVICES = {}  # CUDA device index -> (library handle, SM count)


def reference_channel_attention(x, w1, b1, w2, b2):
    """Plain PyTorch version (sisr_tpu's ``_reference_ca``): pool and excite in f32,
    scale in x's dtype."""
    pooled = x.float().mean(dim=(1, 2))
    hidden = torch.relu(pooled @ w1.float() + b1.float())
    att = torch.sigmoid(hidden @ w2.float() + b2.float())
    return x * att[:, None, None, :].to(x.dtype)


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


def _check_args(x, w1, b1, w2, b2):
    if x.dim() != 4:
        raise ValueError('fused_channel_attention: x must be (N, H, W, C), got %s'
                         % (tuple(x.shape),))
    if x.dtype not in _DTYPE_CODES:
        raise TypeError('fused_channel_attention: x must be float32 or bfloat16, got %s'
                        % x.dtype)
    if not x.is_contiguous():
        raise ValueError('fused_channel_attention: x must be a contiguous NHWC tensor '
                         '(a channels_last NCHW activation permuted to 0,2,3,1)')
    n, h, w, c = x.shape
    if n == 0 or h * w == 0 or c == 0:
        raise ValueError('fused_channel_attention: empty map %s' % (tuple(x.shape),))
    if n > 65535:
        raise ValueError('fused_channel_attention: batch %d exceeds the grid limit '
                         '65535' % n)
    if w1.dim() != 2 or w1.shape[0] != c or w1.shape[1] == 0:
        raise ValueError('fused_channel_attention: w1 must be (C, Cr) with C=%d, got %s'
                         % (c, tuple(w1.shape)))
    cr = w1.shape[1]
    if 2 * c + cr > _MAX_EXCITE_FLOATS:
        raise ValueError('fused_channel_attention: C=%d, Cr=%d exceed the excite\'s shared '
                         'memory' % (c, cr))
    for t, shape, label in ((b1, (cr,), 'b1'), (w2, (cr, c), 'w2'), (b2, (c,), 'b2')):
        if tuple(t.shape) != shape:
            raise ValueError('fused_channel_attention: %s must be %s, got %s'
                             % (label, shape, tuple(t.shape)))
    for t in (w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError('fused_channel_attention: weights on %s, x on %s'
                             % (t.device, x.device))
    if any(t.requires_grad for t in (x, w1, b1, w2, b2)) and torch.is_grad_enabled():
        raise NotImplementedError('fused_channel_attention has no backward on CUDA yet '
                                  '(it comes with the training slice): call it under '
                                  'torch.no_grad() or inference_mode().')


def fused_channel_attention(x, w1, b1, w2, b2):
    """CA scale-and-excite: the CUDA kernel for a CUDA ``x``, the plain version for
    a CPU ``x``."""
    if x.device.type == 'cpu':
        return reference_channel_attention(x, w1, b1, w2, b2)
    if x.device.type != 'cuda':
        raise ValueError('fused_channel_attention: unsupported device %s' % x.device)
    _check_args(x, w1, b1, w2, b2)
    n, h, w, c = x.shape
    cr = w1.shape[1]
    w1, w2 = w1.detach().float(), w2.detach().float()  # strided views are fine
    b1, b2 = b1.detach().float().contiguous(), b2.detach().float().contiguous()
    index = x.device.index
    if index not in _DEVICES:
        with torch.cuda.device(index):
            _DEVICES[index] = (cuda_build.load('channel_attention', _SIGNATURES),
                               torch.cuda.get_device_properties(index).multi_processor_count)
    lib, sm_count = _DEVICES[index]
    vectorized, slabs = launch_plan(n, h * w, c, x.element_size(), x.data_ptr() % 16 == 0,
                                    sm_count)
    out = torch.empty_like(x)
    scratch = torch.empty(n * (slabs + 1) * c, dtype=torch.float32, device=x.device)
    partial, att = scratch[:n * slabs * c], scratch[n * slabs * c:]
    with torch.cuda.device(index):
        code = lib.sisr_ca_forward(
            x.data_ptr(), out.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), partial.data_ptr(), att.data_ptr(), n, h * w, c, cr,
            w1.stride(0), w1.stride(1), w2.stride(0), w2.stride(1),
            _DTYPE_CODES[x.dtype], int(vectorized), slabs, sm_count,
            torch.cuda.current_stream(index).cuda_stream)
    cuda_build.check(lib, code, 'fused_channel_attention launch')
    fused_channel_attention.launches += 1
    return out


fused_channel_attention.launches = 0
