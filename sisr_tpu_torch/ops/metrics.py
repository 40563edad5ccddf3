"""Image quality metrics: PSNR and SSIM, host (numpy) and device (torch) variants
(PyTorch port of sisr_tpu's ``ops/metrics.py``).

PSNR follows the reference exactly (ref: Code/sr_tools/metrics.py:6-17): mean over the full
array, ``20*log10(max/sqrt(mse))``, 100 when mse == 0.

SSIM reimplements ``skimage.metrics.structural_similarity`` with the reference's settings
(ref: metrics.py:74-90): ``gaussian_weights=True, sigma=1.5, use_sample_covariance=False``,
i.e. 11-tap gaussian windows (truncate=3.5), cov_norm = 1, and the result averaged over the
map cropped by ``(win-1)//2`` on every side.  On the host the filter is scipy's
``gaussian_filter`` ('reflect' boundary) in float64, as sisr_tpu's; on the device the
same filter is one banded matrix per axis in float32, so filtering is two matrix
products.

:class:`Metrics` is the host metric hub of the standard eval protocol and the
standard validation epoch.
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


def structural_similarity(im1, im2, data_range=1.0, multichannel=False):
    """skimage-compatible gaussian-weighted SSIM of two 2-D images, in float64; with
    ``multichannel`` the last axis is channels and their SSIMs are averaged."""
    if multichannel:
        return float(np.mean([structural_similarity(im1[..., ch], im2[..., ch], data_range)
                              for ch in range(np.shape(im1)[-1])]))
    from scipy.ndimage import gaussian_filter
    im1 = np.asarray(im1, dtype=np.float64)
    im2 = np.asarray(im2, dtype=np.float64)
    _, r = _gaussian_kernel1d()
    _check_ssim_size(im1.shape[0], im1.shape[1], 2 * r + 1)

    def filt(x):
        return gaussian_filter(x, sigma=1.5, truncate=3.5)  # mode 'reflect'
    return float(_ssim_map_mean(filt, im1, im2, data_range, r).mean())


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
    """Host metric hub (ref: metrics.py:20-121, sisr_tpu's ops/metrics.py:171-276):
    PSNR and SSIM on channel 0 (the Y channel) of N,H,W,C numpy batches, keyed
    ``'{key}{delimeter}{metric}'``.  ``device`` (a torch device, or True for
    ``cuda``) computes the per-image PSNR/SSIM of a single-channel comparison as one
    batched pass on that device (:func:`psnr_nhw`, :func:`ssim_nhw`; eval's
    ``--device_metrics``) instead of per image on the host."""

    def __init__(self, metrics, delimeter='-', device=None):
        self.metrics = metrics
        self.delimeter = delimeter
        self.device = torch.device('cuda') if device is True \
            else torch.device(device) if device else None

    def _device_metric(self, metric, im_a, im_ref, max_value):
        a = torch.as_tensor(np.ascontiguousarray(im_a[..., 0]), dtype=torch.float32,
                            device=self.device)
        b = torch.as_tensor(np.ascontiguousarray(im_ref[..., 0]), dtype=torch.float32,
                            device=self.device)
        fn = psnr_nhw if metric == 'PSNR' else ssim_nhw
        return [float(v) for v in fn(a, b, float(max_value)).cpu()]

    def run_image_metric(self, metric, im_a, im_ref=None, single_values=False, max_value=1,
                         multichannel=False):
        """``metric`` of a batch against its references: per image with
        ``single_values``; else one value for the batch (``multichannel``: over all
        channels)."""
        if len(im_a.shape) == 3:
            im_a = np.expand_dims(im_a, axis=0)
        if im_ref is not None and len(im_ref.shape) == 3:
            im_ref = np.expand_dims(im_ref, axis=0)
        if metric == 'FACE_SIM':
            raise NotImplementedError('The FACE_SIM metric is not ported to sisr_tpu_torch '
                                      'yet (ROADMAP.md, Queue 1 item 10).')
        if metric not in ('PSNR', 'SSIM'):
            raise ValueError('Unknown metric %s' % metric)
        if im_ref is None:
            raise ValueError('Need a reference to calculate %s.' % metric)
        if self.device is not None and single_values and not multichannel:
            return self._device_metric(metric, im_a, im_ref, max_value)
        if metric == 'PSNR':
            if single_values:
                return [psnr(im_a[i, :, :, 0], im_ref[i, :, :, 0], max_value=max_value)
                        for i in range(im_a.shape[0])]
            if multichannel:
                return psnr(im_a, im_ref, max_value=max_value)
            return psnr(im_a[:, :, :, 0], im_ref[:, :, :, 0], max_value=max_value)
        if multichannel:
            vals = [structural_similarity(im_a[i], im_ref[i], data_range=max_value,
                                          multichannel=True) for i in range(im_a.shape[0])]
            return sum(vals) / len(vals)
        if single_values:
            return [structural_similarity(im_a[i, :, :, 0], im_ref[i, :, :, 0],
                                          data_range=max_value)
                    for i in range(im_a.shape[0])]
        # the batch as the channel axis, as the reference's (H, W, N) call
        return structural_similarity(np.moveaxis(im_a[:, :, :, 0], 0, -1),
                                     np.moveaxis(im_ref[:, :, :, 0], 0, -1),
                                     data_range=max_value, multichannel=True)

    def run_metrics(self, images, references=None, key='', metrics=None, probe_names=None,
                    max_value=1):
        """Every metric of ``metrics`` (default: the hub's) per image of a batch (ref:
        metrics.py:92-121): ({'key<delim>metric': values}, a 'key PSNR: mean, '
        diagnostic string).  ``probe_names`` name the images, as the reference's
        signature has them."""
        if metrics is None:
            metrics = self.metrics
        diag_string = ''
        output = defaultdict(list)
        for metric in metrics:
            value = self.run_image_metric(metric, images, references, max_value=max_value,
                                          single_values=True)
            output['%s%s%s' % (key, self.delimeter, metric)] = value
            if metric.upper() == 'PSNR':
                diag_string = '{} {}: {:.4f}, '.format(key, metric, np.average(value))
        return output, diag_string
