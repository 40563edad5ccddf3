"""PIL-parity bicubic resampling (PyTorch port of sisr_tpu's ``ops/resize.py``).

The reference framework resizes exclusively through ``PIL.Image.resize(..., BICUBIC)``
(ref: Code/sr_tools/image_manipulation.py:32-53).  PIL's resample is a separable
convolution with a Catmull-Rom (a=-0.5) kernel whose support is widened by the scale
factor when downscaling; for uint8 images the two passes run in fixed-point arithmetic
with rounding+clipping after each pass.

1. :func:`resize_uint8` — bit-exact reimplementation of Pillow's 8-bit fixed-point path
   (numpy), for host-side data prep.
2. :func:`resize_bicubic` — batched NHWC torch version as two dense float32 matrix
   products (``W_h @ img @ W_w^T``), the device path of the fused eval.
"""
import functools

import numpy as np
import torch

_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed-point coefficient precision for 8bpc


def _bicubic_filter(x, a=-0.5):
    """Pillow's bicubic kernel (Catmull-Rom for a=-0.5), support = 2."""
    x = np.abs(x)
    out = np.zeros_like(x)
    m1 = x < 1
    m2 = (x >= 1) & (x < 2)
    out[m1] = ((a + 2) * x[m1] - (a + 3)) * x[m1] * x[m1] + 1
    out[m2] = (((x[m2] - 5) * x[m2] + 8) * x[m2] - 4) * a
    return out


@functools.lru_cache(maxsize=256)
def precompute_coeffs(in_size, out_size, support=2.0):
    """Per-output-pixel filter windows, as Pillow computes them.

    Returns (bounds, ksize, kk) where ``bounds[i] = (xmin, xmax-xmin)`` and
    ``kk[i, :n]`` holds the normalized float64 weights for output pixel i.
    """
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    eff_support = support * filterscale
    ksize = int(np.ceil(eff_support)) * 2 + 1

    bounds = np.zeros((out_size, 2), dtype=np.int64)
    kk = np.zeros((out_size, ksize), dtype=np.float64)
    ss = 1.0 / filterscale

    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = int(center - eff_support + 0.5)
        if xmin < 0:
            xmin = 0
        xmax = int(center + eff_support + 0.5)
        if xmax > in_size:
            xmax = in_size
        n = xmax - xmin
        x = (np.arange(n) + xmin - center + 0.5) * ss
        w = _bicubic_filter(x)
        total = w.sum()
        if total != 0:
            w = w / total
        bounds[i] = (xmin, n)
        kk[i, :n] = w
    return bounds, ksize, kk


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size, out_size):
    """Dense (out_size, in_size) float64 resampling matrix for one axis."""
    bounds, _, kk = precompute_coeffs(in_size, out_size)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        xmin, n = bounds[i]
        mat[i, xmin:xmin + n] = kk[i, :n]
    return mat


def _quantize_coeffs(kk):
    """Pillow's ROUND_UP fixed-point quantization of filter weights."""
    scaled = kk * (1 << _PRECISION_BITS)
    return np.where(scaled >= 0, scaled + 0.5, scaled - 0.5).astype(np.int64)


def _resample_axis_uint8(img, out_size, axis):
    """One fixed-point resample pass over ``axis`` of an (..., C)-last uint8 array."""
    in_size = img.shape[axis]
    bounds, _, kk = precompute_coeffs(in_size, out_size)
    kk_int = _quantize_coeffs(kk)

    img = np.moveaxis(img, axis, 0).astype(np.int64)
    out = np.empty((out_size,) + img.shape[1:], dtype=np.uint8)
    half = 1 << (_PRECISION_BITS - 1)
    for i in range(out_size):
        xmin, n = bounds[i]
        acc = half + np.tensordot(kk_int[i, :n], img[xmin:xmin + n], axes=(0, 0))
        out[i] = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_uint8(img, size):
    """Bit-exact Pillow BICUBIC resize of an H,W[,C] uint8 numpy image.

    :param img: uint8 array, H,W or H,W,C.
    :param size: (width, height) target, PIL convention.
    """
    out_w, out_h = size
    if img.dtype != np.uint8:
        raise TypeError('resize_uint8 expects a uint8 image')
    # Pillow resamples horizontally first, then vertically, with rounding after each pass.
    out = img
    if out.shape[1] != out_w:
        out = _resample_axis_uint8(out, out_w, axis=1)
    if out.shape[0] != out_h:
        out = _resample_axis_uint8(out, out_h, axis=0)
    if out is img:
        out = img.copy()  # identity resize: PIL returns a fresh buffer
    return out


@functools.lru_cache(maxsize=32)
def _device_resize_matrix(in_size, out_size, device):
    return torch.as_tensor(resize_matrix(in_size, out_size), dtype=torch.float32,
                           device=device)


def resize_bicubic(img, out_h, out_w):
    """Batched NHWC bicubic resize on device, as two float32 matrix products.

    Matches PIL's filter weights exactly; differs from PIL's uint8 output only by
    fixed-point rounding (|err| <= 1 LSB of uint8).  Resampling weights are small and
    parity-critical, so the products run in full float32: a caller on CUDA keeps
    ``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default).

    :param img: (N, H, W, C) float tensor.
    :param out_h/out_w: output spatial dims.
    """
    n, h, w, c = img.shape
    img = img.float()
    if h != out_h:
        mat_h = _device_resize_matrix(h, out_h, img.device)
        img = torch.einsum('oh,nhwc->nowc', mat_h, img)
    if w != out_w:
        mat_w = _device_resize_matrix(w, out_w, img.device)
        img = torch.einsum('ow,nhwc->nhoc', mat_w, img)
    return img
