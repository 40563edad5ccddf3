"""Plain float32 building blocks of the benchmark's reference, written from the
published descriptions and importing nothing of the program under test.

Every tensor is NCHW float32 on whatever device the caller chose; the caller turns
TF32 off (:func:`no_tf32`), so convolutions and products run in full float32.

* bicubic resize: Pillow's ``Image.BICUBIC`` (``ImagingResample``: the Keys cubic with
  a = -0.5, support 2 scaled by the down-scale factor, weights renormalised where the
  window meets the border), as one matrix per axis;
* Y of full-range (JFIF) YCbCr: 0.299 R + 0.587 G + 0.114 B;
* PSNR on [0, 1] images; SSIM of Wang et al. 2004 with an 11-tap Gaussian window
  (sigma 1.5, truncated at 3.5 sigma), k1 0.01, k2 0.03, population variances, over the
  pixels whose window lies inside the image (the mean over the valid region);
* channel attention of Zhang et al. 2018 (RCAN): global average pool, 1x1 reduce,
  ReLU, 1x1 expand, sigmoid, scale;
* the L1 loss and Adam (Kingma and Ba 2015, with bias correction).
"""
import contextlib
import math

import numpy as np
import torch
from torch.nn import functional as F


@contextlib.contextmanager
def no_tf32():
    """Full float32 convolutions and matrix products for the block."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def conv2d(x, weight, bias, name=None):
    """A 'same' convolution (odd kernel, zero padding k // 2), as the models use.
    ``name`` is the layer's key, for the lower-precision reference of ``quant.py``."""
    return F.conv2d(x, weight, bias, padding=weight.shape[-1] // 2)


def exact(x):
    """The float32 residual stream as it is (the lower-precision controls round it)."""
    return x


def dense(v, weight, bias):
    """A 1x1 convolution's weight (O, I, 1, 1) applied to (N, I) vectors."""
    return v @ weight.reshape(weight.shape[0], -1).t() + bias


def channel_attention(x, w1, b1, w2, b2, gate=None):
    """x times sigmoid(W2 relu(W1 mean(x) + b1) + b2), optionally times ``gate``
    (N, C)."""
    att = torch.sigmoid(dense(torch.relu(dense(x.mean(dim=(2, 3)), w1, b1)), w2, b2))
    if gate is not None:
        att = att * gate
    return x * att[:, :, None, None]


def upsample_x4(p, prefix, x, conv=conv2d):
    """Two stages of conv (C -> 4C) and pixel shuffle by 2 (Shi et al. 2016)."""
    for stage in ('0', '2'):
        name = '%s.%s' % (prefix, stage)
        x = F.pixel_shuffle(conv(x, p[name + '.weight'], p[name + '.bias'], name), 2)
    return x


def _cubic(x, a=-0.5):
    x = np.abs(x)
    return np.where(x < 1, ((a + 2) * x - (a + 3)) * x * x + 1,
                    np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def bicubic_matrix(n_in, n_out):
    """The (n_out, n_in) float64 matrix of Pillow's bicubic resampling along one axis."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    mat = np.zeros((n_out, n_in))
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        taps = np.arange(lo, hi)
        w = _cubic((taps - center + 0.5) / filterscale)
        mat[i, lo:hi] = w / w.sum()
    return mat


def bicubic(x, out_h, out_w):
    """NCHW float32 bicubic resize (no rounding to uint8)."""
    mh = torch.as_tensor(bicubic_matrix(x.shape[2], out_h), dtype=x.dtype, device=x.device)
    mw = torch.as_tensor(bicubic_matrix(x.shape[3], out_w), dtype=x.dtype, device=x.device)
    return torch.einsum('oh,nchw,pw->ncop', mh, x, mw)


def luma(x):
    """The Y channel of full-range YCbCr, (N, H, W), of an NCHW RGB batch in [0, 1]."""
    return 0.299 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2]


def psnr(a, b):
    """Per-image PSNR in dB of (N, H, W) images with peak 1, in float64."""
    mse = ((a.double() - b.double()) ** 2).mean(dim=(1, 2))
    return 10.0 * torch.log10(1.0 / mse)


def _gaussian_window():
    r = int(3.5 * 1.5 + 0.5)
    t = np.arange(-r, r + 1)
    g = np.exp(-0.5 * (t / 1.5) ** 2)
    return g / g.sum()


def ssim(a, b):
    """Per-image SSIM of (N, H, W) images with data range 1, in float64."""
    g = torch.as_tensor(_gaussian_window(), dtype=torch.float64, device=a.device)
    k = len(g)

    def filt(x):
        x = F.conv2d(x[:, None], g.view(1, 1, k, 1))
        return F.conv2d(x, g.view(1, 1, 1, k))[:, 0]

    a, b = a.double(), b.double()
    ua, ub = filt(a), filt(b)
    va = filt(a * a) - ua * ua
    vb = filt(b * b) - ub * ub
    cov = filt(a * b) - ua * ub
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * ua * ub + c1) * (2 * cov + c2)) / ((ua * ua + ub * ub + c1) * (va + vb + c2))
    return s.mean(dim=(1, 2))


def quality_rows(sr, lr, hr):
    """(PSNR, SSIM) rows of the model and of the bicubic baseline against HR, on the Y
    channel, each (2, N) float64 ordered (LR, model): ``sr`` NCHW float32 (clipped to
    [0, 1] here), ``lr`` and ``hr`` NCHW float32 in [0, 1]."""
    hr_y = luma(hr)
    base_y = luma(bicubic(lr, hr.shape[2], hr.shape[3]).clamp(0.0, 1.0))
    sr_y = luma(sr.clamp(0.0, 1.0))
    return (torch.stack([psnr(base_y, hr_y), psnr(sr_y, hr_y)]),
            torch.stack([ssim(base_y, hr_y), ssim(sr_y, hr_y)]))


def l1(pred, target):
    return (pred - target).abs().mean()


def cosine_warm_restarts(step, lr, restart_period, lr_min=0.0, t_mult=1):
    """The learning rate of update ``step`` (0 for the first) under SGDR (Loshchilov and
    Hutter 2017) stepped once a batch, with restarts every ``restart_period`` updates
    (t_mult 1)."""
    if t_mult != 1:
        raise ValueError('only t_mult 1 is written here')
    t = math.fmod(float(step), float(restart_period))
    return lr_min + (lr - lr_min) * 0.5 * (1.0 + math.cos(math.pi * t / restart_period))


class Adam:
    """Adam over a dict of float32 tensors, updated in place from their ``.grad``."""

    def __init__(self, params, betas=(0.9, 0.999), eps=1e-8):
        self.params = params
        self.betas = betas
        self.eps = eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, lr):
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = p.grad
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(lr * m_hat / (v_hat.sqrt() + self.eps))
