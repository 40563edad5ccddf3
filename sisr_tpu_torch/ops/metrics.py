"""Image quality metrics: PSNR and SSIM, host (numpy) and device (torch) variants
(PyTorch port of sisr_tpu's ``ops/metrics.py``).

PSNR follows the reference exactly (ref: Code/sr_tools/metrics.py:6-17): mean over the full
array, ``20*log10(max/sqrt(mse))``, 100 when mse == 0.

SSIM reimplements ``skimage.metrics.structural_similarity`` with the reference's settings
(ref: metrics.py:74-90): ``gaussian_weights=True, sigma=1.5, use_sample_covariance=False``,
i.e. 11-tap gaussian windows (truncate=3.5), cov_norm = 1, and the result averaged over the
map cropped by ``(win-1)//2`` on every side.  The gaussian filter with scipy's 'reflect'
boundary is one banded matrix per axis, on the host in float64 and on the device in
float32, so filtering is two matrix products.
"""
from collections import defaultdict
import functools

import numpy as np
import torch


def psnr(img1, img2, max_value=255.0):
    """PSNR between two arrays (any shape) — ref: metrics.py:6-17."""
    mse = np.mean((np.array(img1, dtype=np.float32) - np.array(img2, dtype=np.float32)) ** 2)
    if mse == 0:
        return 100
    return 20 * np.log10(max_value / (np.sqrt(mse)))


def _gaussian_kernel1d(sigma=1.5, truncate=3.5, dtype=np.float32):
    r = int(truncate * sigma + 0.5)
    x = np.arange(-r, r + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return (phi / phi.sum()).astype(dtype), r


def _reflect_filter_matrix(n, kern, dtype=np.float32):
    """(n, n) matrix M with M[i, j] = summed gaussian taps mapping source j to output i
    under scipy 'reflect' (symmetric) boundary handling: filtering along an axis of
    length n becomes ONE dense matrix product."""
    r = (len(kern) - 1) // 2
    m = np.zeros((n, n), dtype)
    idx = np.arange(n)
    for t, kv in enumerate(kern):
        j = idx + (t - r)
        j = np.where(j < 0, -j - 1, j)
        j = np.where(j >= n, 2 * n - j - 1, j)
        np.add.at(m, (idx, j), kv)
    return m


def _ssim_map_mean(filt, im1, im2, data_range, pad, k1=0.01, k2=0.03):
    ux, uy = filt(im1), filt(im2)
    uxx, uyy, uxy = filt(im1 * im1), filt(im2 * im2), filt(im1 * im2)
    vx = uxx - ux * ux
    vy = uyy - uy * uy
    vxy = uxy - ux * uy
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return s[..., pad:-pad, pad:-pad]


def _check_ssim_size(h, w, win_size):
    if h <= win_size - 1 or w <= win_size - 1:
        raise ValueError('Image (%dx%d) is too small for the %d-tap SSIM window.'
                         % (h, w, win_size))


def structural_similarity(im1, im2, data_range=1.0):
    """skimage-compatible gaussian-weighted SSIM of two 2-D images, in float64."""
    im1 = np.asarray(im1, dtype=np.float64)
    im2 = np.asarray(im2, dtype=np.float64)
    kern, r = _gaussian_kernel1d(dtype=np.float64)
    _check_ssim_size(im1.shape[0], im1.shape[1], 2 * r + 1)
    mh = _reflect_filter_matrix(im1.shape[0], kern, np.float64)
    mw = _reflect_filter_matrix(im1.shape[1], kern, np.float64)
    return float(_ssim_map_mean(lambda x: mh @ x @ mw.T, im1, im2, data_range, r).mean())


# --- device-side (torch, batched) --------------------------------------------------------
@functools.lru_cache(maxsize=16)
def _device_filter_matrix(n, device):
    kern, _ = _gaussian_kernel1d()
    return torch.as_tensor(_reflect_filter_matrix(n, kern), device=device)


def ssim_nhw(im1, im2, data_range=1.0):
    """Batched single-channel SSIM on device: (N, H, W) float32 -> (N,).

    The filter products run in full float32 (keep TF32 off for matmuls on CUDA)."""
    _, r = _gaussian_kernel1d()
    _check_ssim_size(im1.shape[1], im1.shape[2], 2 * r + 1)
    mh = _device_filter_matrix(im1.shape[1], im1.device)
    mw = _device_filter_matrix(im1.shape[2], im1.device)
    s = _ssim_map_mean(lambda x: mh @ x @ mw.T, im1, im2, data_range, r)
    return s.mean(dim=(1, 2))


def psnr_nhw(im1, im2, max_value=1.0):
    """Batched PSNR on device: (N, ...) -> (N,)."""
    dims = tuple(range(1, im1.dim()))
    mse = ((im1.float() - im2.float()) ** 2).mean(dim=dims)
    return torch.where(mse == 0, torch.full_like(mse, 100.0),
                       20 * torch.log10(max_value / torch.sqrt(mse)))


class Metrics:
    """Metric hub mirroring the reference class (ref: metrics.py:20-121): PSNR and
    SSIM on channel 0 (the Y channel) of N,H,W,C numpy batches, per image, keyed
    ``'{key}{delim}{metric}'``."""

    def __init__(self, metrics, delimeter='-'):
        self.metrics = metrics
        self.delimeter = delimeter

    def run_image_metric(self, metric, im_a, im_ref, max_value=1):
        """Per-image values of ``metric`` over a batch."""
        if im_a.ndim == 3:
            im_a, im_ref = im_a[None], im_ref[None]
        if metric == 'PSNR':
            return [psnr(im_a[i, :, :, 0], im_ref[i, :, :, 0], max_value=max_value)
                    for i in range(im_a.shape[0])]
        if metric == 'SSIM':
            return [structural_similarity(im_a[i, :, :, 0], im_ref[i, :, :, 0],
                                          data_range=max_value)
                    for i in range(im_a.shape[0])]
        raise ValueError('Unknown metric %s' % metric)

    def run_metrics(self, images, references, key='', max_value=1):
        """Run every metric over a batch (ref: metrics.py:92-121)."""
        diag_string = ''
        output = defaultdict(list)
        for metric in self.metrics:
            value = self.run_image_metric(metric, images, references, max_value=max_value)
            output['%s%s%s' % (key, self.delimeter, metric)] = value
            if metric.upper() == 'PSNR':
                diag_string = '{} {}: {:.4f}, '.format(key, metric, np.average(value))
        return output, diag_string
