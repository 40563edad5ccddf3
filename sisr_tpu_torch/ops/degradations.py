"""Gaussian-blur degradations: kernel generation, PCA codes, blur, noise, and the batched
blur and downscale on the device (PyTorch port of sisr_tpu's ``ops/degradations.py``,
ref: Code/sr_tools/gaussian_utils.py:181-424).

* Kernels are drawn from the global numpy RNG in sisr_tpu's (the reference's) draw
  order, so runs seeded alike draw the same kernel sequences in both packages.
* The PCA is a numpy SVD (its components' signs are arbitrary, as in any SVD).
* The host blur is a reflection pad and a per-image 2-D correlation
  (:func:`blur_image`); the batched one (:func:`batch_blur_nhwc`) is one grouped
  ``F.conv2d`` over the batch's N*C channels, on the device of its input.
* :func:`degrade_batch_on_device` is the train step's online degradation: blur, the
  ToPILImage uint8 truncation, then :func:`~sisr_tpu_torch.ops.resize.resize_bicubic`
  down, within one uint8 step of the host chain (PIL's fixed-point rounding).

Gaussian kernels of odd size are centro-symmetric, so correlation and convolution
coincide; :func:`blur_image` flips the kernel for scipy's convolution all the same.
"""
import contextlib

import numpy as np
import torch
import torch.nn.functional as F


# --- kernel generation (numpy RNG, the reference's draw order) ----------------------------
def cal_sigma(sig_x, sig_y, radians):
    """Covariance matrix from axis sigmas and a rotation (ref: gaussian_utils.py:203-207)."""
    d = np.array([[sig_x ** 2, 0], [0, sig_y ** 2]])
    u = np.array([[np.cos(radians), -np.sin(radians)], [np.sin(radians), np.cos(radians)]])
    return np.dot(u, np.dot(d, u.T))


def anisotropic_gaussian_kernel(l, sigma_matrix):
    """(ref: gaussian_utils.py:210-216)"""
    ax = np.arange(-l // 2 + 1., l // 2 + 1.)
    xx, yy = np.meshgrid(ax, ax)
    xy = np.hstack((xx.reshape((l * l, 1)), yy.reshape(l * l, 1))).reshape(l, l, 2)
    inverse_sigma = np.linalg.inv(sigma_matrix)
    kernel = np.exp(-0.5 * np.sum(np.dot(xy, inverse_sigma) * xy, 2))
    return kernel / np.sum(kernel)


def isotropic_gaussian_kernel(l, sigma):
    """(ref: gaussian_utils.py:219-223)"""
    ax = np.arange(-l // 2 + 1., l // 2 + 1.)
    xx, yy = np.meshgrid(ax, ax)
    kernel = np.exp(-(xx ** 2 + yy ** 2) / (2. * sigma ** 2))
    return kernel / np.sum(kernel)


def random_anisotropic_gaussian_kernel(sig_min=0.2, sig_max=4.0, scaling=3, l=21):
    """(ref: gaussian_utils.py:226-232)"""
    pi = np.random.random() * np.pi * 2 - np.pi
    x = np.random.random() * (sig_max - sig_min) + sig_min
    y = np.clip(np.random.random() * scaling * x, sig_min, sig_max)
    return anisotropic_gaussian_kernel(l, cal_sigma(x, y, pi))


def random_isotropic_gaussian_kernel(sig_min=0.2, sig_max=4.0, l=21):
    """(ref: gaussian_utils.py:235-238)"""
    x = np.random.random() * (sig_max - sig_min) + sig_min
    return isotropic_gaussian_kernel(l, x)


def stable_gaussian_kernel(l=21, sig=2.6):
    """(ref: gaussian_utils.py:241-255)"""
    return isotropic_gaussian_kernel(l, sig)


def random_gaussian_kernel(l=21, sig_min=0.2, sig_max=4.0, rate_iso=1.0, scaling=3):
    """(ref: gaussian_utils.py:247-251)"""
    if np.random.random() < rate_iso:
        return random_isotropic_gaussian_kernel(l=l, sig_min=sig_min, sig_max=sig_max)
    return random_anisotropic_gaussian_kernel(l=l, sig_min=sig_min, sig_max=sig_max,
                                              scaling=scaling)


def random_batch_kernel(batch, l=21, sig_min=0.2, sig_max=4.0, rate_iso=1.0, scaling=3):
    """(batch, l, l) float64 kernels (ref: gaussian_utils.py:258-262)."""
    batch_kernel = np.zeros((batch, l, l))
    for i in range(batch):
        batch_kernel[i] = random_gaussian_kernel(l=l, sig_min=sig_min, sig_max=sig_max,
                                                 rate_iso=rate_iso, scaling=scaling)
    return batch_kernel


def stable_batch_kernel(batch, l=21, sig=2.6):
    """(ref: gaussian_utils.py:265-269)"""
    batch_kernel = np.zeros((batch, l, l))
    for i in range(batch):
        batch_kernel[i] = stable_gaussian_kernel(l=l, sig=sig)
    return batch_kernel


# --- PCA codes ----------------------------------------------------------------------------
def pca_matrix(data, k=2):
    """(D, k) float32 projection onto the first ``k`` principal components of the (N, D)
    samples ``data`` (ref: gaussian_utils.py:196-201)."""
    x = np.asarray(data, dtype=np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    u, _, _ = np.linalg.svd(x.T, full_matrices=False)
    return u[:, :k].astype(np.float32)


class PCAEncoder:
    """(B, l, l) kernels -> (B, k) float32 codes (ref: gaussian_utils.py:332-343)."""

    def __init__(self, weight):
        self.weight = np.asarray(weight, dtype=np.float32)  # (l*l, k)
        self.size = self.weight.shape

    def __call__(self, batch_kernel):
        flat = np.asarray(batch_kernel, dtype=np.float32).reshape(len(batch_kernel), -1)
        return flat @ self.weight


# --- blur ---------------------------------------------------------------------------------
def _reflect_pads(l):
    """(before, after) reflection pad of an l-wide kernel: torch ReflectionPad2d's."""
    return (l // 2, l // 2) if l % 2 == 1 else (l // 2, l // 2 - 1)


def blur_image(img_hwc, kernel):
    """One H,W,C float image blurred with one (l, l) kernel on the host: reflection pad,
    then the correlation of torch's ``F.conv2d`` (ref: gaussian_utils.py:346-368, batch
    size 1), as float32."""
    from scipy.signal import fftconvolve
    pads = _reflect_pads(kernel.shape[-1])
    img = np.asarray(img_hwc, dtype=np.float32)
    padded = np.pad(img, (pads, pads) + ((0, 0),) * (img.ndim - 2), mode='reflect')
    # a correlation is a convolution with the flipped kernel
    kernel = np.ascontiguousarray(kernel[::-1, ::-1])
    out = np.stack([fftconvolve(padded[..., c], kernel, mode='valid')
                    for c in range(padded.shape[-1])], axis=-1)
    return out.astype(np.float32)


@contextlib.contextmanager
def _no_tf32():
    """cuDNN runs f32 convs in TF32 by default on Hopper; the blur feeds a uint8
    truncation, so it runs in true f32 (the flags come back after)."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def _reflect_index(size, before, after, device):
    """Indices of a reflection pad of one axis: numpy's ``mode='reflect'``, which
    reflects again where a pad is wider than the axis (``F.pad`` refuses those)."""
    idx = torch.arange(-before, size + after, device=device)
    if size == 1:
        return torch.zeros_like(idx)
    period = 2 * (size - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= size, period - idx, idx)


def batch_blur_nhwc(images, kernels):
    """An (N, H, W, C) float batch blurred with per-image (N, l, l) kernels, as one
    grouped correlation over its N*C channels after a reflection pad (numpy's, also
    where the kernel is wider than the image), in f32 on the batch's device
    (autocast off)."""
    n, h, w, c = images.shape
    l = kernels.shape[-1]
    pad_a, pad_b = _reflect_pads(l)
    x = images.float().permute(0, 3, 1, 2).reshape(1, n * c, h, w)
    x = x.index_select(2, _reflect_index(h, pad_a, pad_b, x.device))
    x = x.index_select(3, _reflect_index(w, pad_a, pad_b, x.device))
    weight = kernels.to(device=x.device, dtype=torch.float32)
    weight = weight[:, None].expand(n, c, l, l).reshape(n * c, 1, l, l)
    with torch.autocast(x.device.type, enabled=False), _no_tf32():
        out = F.conv2d(x, weight, groups=n * c)
    return out.reshape(n, c, h, w).permute(0, 2, 3, 1)


# --- noise --------------------------------------------------------------------------------
def random_batch_noise(batch, high, rate_cln=1.0):
    """(ref: gaussian_utils.py:299-304)"""
    noise_level = np.random.uniform(size=(batch, 1)) * high
    noise_mask = np.random.uniform(size=(batch, 1))
    noise_mask[noise_mask < rate_cln] = 0
    noise_mask[noise_mask >= rate_cln] = 1
    return noise_level * noise_mask


def gaussian_noising(arr, sigma, mean=0.0, min_val=0.0, max_val=1.0):
    """Additive gaussian noise, clipped (ref: gaussian_utils.py:307-313).  The field is
    drawn in H,W,C order, as sisr_tpu draws it."""
    noise = np.random.normal(loc=mean, scale=1.0, size=arr.shape) * np.reshape(
        sigma, np.shape(sigma) + (1,) * (arr.ndim - np.ndim(sigma)))
    return np.clip(arr + noise, min_val, max_val).astype(np.float32)


class BatchSRKernel:
    """(ref: gaussian_utils.py:315-329)"""

    def __init__(self, l=21, sig=2.6, sig_min=0.2, sig_max=4.0, rate_iso=1.0, scaling=3):
        self.l = l
        self.sig = sig
        self.sig_min = sig_min
        self.sig_max = sig_max
        self.rate = rate_iso
        self.scaling = scaling

    def __call__(self, random, batch):
        if random:
            return random_batch_kernel(batch, l=self.l, sig_min=self.sig_min,
                                       sig_max=self.sig_max, rate_iso=self.rate,
                                       scaling=self.scaling)
        return stable_batch_kernel(batch, l=self.l, sig=self.sig)


class OnlineDegrader:
    """Blur, PCA-encode and optionally noise one HR image (the reference's
    SRMDPreprocessing, gaussian_utils.py:371-424).  H,W,C float32 in [0, 1] in; out
    (blurred image, code of ``para_input`` values (+1, the noise level x 10, with
    noise), the (l, l) kernel)."""

    def __init__(self, pca, random, para_input=10, kernel=21, noise=True, sig=2.6,
                 sig_min=0.2, sig_max=4.0, rate_iso=1.0, scaling=3, rate_cln=0.2,
                 noise_high=0.08, **kwargs):
        self.encoder = PCAEncoder(pca)
        self.kernel_gen = BatchSRKernel(l=kernel, sig=2.6 if sig is None else sig,
                                        sig_min=sig_min, sig_max=sig_max,
                                        rate_iso=rate_iso, scaling=scaling)
        self.para_in = para_input
        self.l = kernel
        self.noise = noise
        self.rate_cln = rate_cln
        self.noise_high = noise_high
        self.random = random

    def __call__(self, hr_image):
        kernels = self.kernel_gen(self.random, 1)  # (1, l, l)
        blurred = blur_image(np.asarray(hr_image, dtype=np.float32), kernels[0])
        code = self.encoder(kernels)  # (1, k)
        if self.noise:
            noise_level = random_batch_noise(1, self.noise_high, self.rate_cln)
            blurred = gaussian_noising(blurred, noise_level[0])
            code = np.concatenate([code, noise_level.astype(np.float32) * 10], axis=1)
        return blurred, code[0], kernels[0].astype(np.float32)


def degrade_batch_on_device(hr_batch, kernels, pca, scale, quantize=True):
    """The host chain blur -> ToPILImage -> PIL bicubic down (ref: data_handler.py:
    446-455) for a batch on its device: :func:`batch_blur_nhwc`, the uint8
    truncation (``floor(x * 255)`` clipped to [0, 255], over 255) unless ``quantize``
    is False, then :func:`~sisr_tpu_torch.ops.resize.resize_bicubic` to 1/``scale``.

    :param hr_batch: (N, H, W, C) float in [0, 1], H and W multiples of ``scale``.
    :param kernels: (N, l, l) blur kernels.
    :param pca: (l*l, k) projection matrix, or None for no codes.
    :returns: (LR (N, H/s, W/s, C) f32, codes (N, k) f32 or None, blurred HR).
    """
    from .resize import resize_bicubic

    blurred = batch_blur_nhwc(hr_batch, kernels)
    blurred_q = torch.clamp(torch.floor(blurred * 255.0), 0, 255) / 255.0 if quantize \
        else blurred
    _, h, w, _ = hr_batch.shape
    lr = resize_bicubic(blurred_q, h // scale, w // scale)
    codes = None
    if pca is not None:
        flat = kernels.reshape(kernels.shape[0], -1).to(device=blurred.device,
                                                         dtype=torch.float32)
        codes = flat @ torch.as_tensor(pca, dtype=torch.float32, device=blurred.device)
    return lr, codes, blurred
