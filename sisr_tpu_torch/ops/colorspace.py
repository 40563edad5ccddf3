"""RGB <-> YCbCr conversions with the reference's two matrix conventions
(PyTorch port of sisr_tpu's ``ops/colorspace.py``).

Two conversion flavours, matching the reference exactly
(ref: Code/sr_tools/image_manipulation.py:56-116):

* ``'jpg'``  — full-range JFIF matrix (bias 128*max_val/255 on chroma only).
* ``'png'``  — ITU-R BT.601 studio-range matrix (bias 16*max_val/255 on luma).

Host-side entry point :func:`ycbcr_convert` keeps the reference's C,H,W numpy contract.
Device-side code uses the batched NHWC :func:`rgb_to_ycbcr_nhwc`, one small matmul.
"""
import functools

import numpy as np
import torch

# --- matrix/bias constants -------------------------------------------------------------
# forward 'jpg' (rows: Y, Cb, Cr; cols: R, G, B)  (ref: image_manipulation.py:65-75)
_JPG_FWD = np.array([[0.299, 0.587, 0.114],
                     [-0.168736, -0.331264, 0.5],
                     [0.5, -0.418688, -0.081312]], dtype=np.float64)
_JPG_FWD_BIAS = np.array([0., 128., 128.], dtype=np.float64)  # * max_val/255

# forward 'png' (ref: image_manipulation.py:77-87)
_PNG_FWD = np.array([[65.481, 128.553, 24.966],
                     [-37.797, -74.203, 112.0],
                     [112.0, -93.786, -18.214]], dtype=np.float64) / 255.
_PNG_FWD_BIAS = np.array([16., 128., 128.], dtype=np.float64)

# inverse 'jpg' (ref: image_manipulation.py:100-105)
_JPG_INV = np.array([[1., 0., 1.402],
                     [1., -0.344136, -0.714136],
                     [1., 1.772, 0.]], dtype=np.float64)
_JPG_INV_BIAS = np.array([-1.402 * 128., (0.714136 + 0.344136) * 128., -1.772 * 128.],
                         dtype=np.float64)

# inverse 'png' (ref: image_manipulation.py:107-114)
_PNG_INV = np.array([[298.082, 0., 408.583],
                     [298.082, -100.291, -208.120],
                     [298.082, 516.412, 0.]], dtype=np.float64) / 256.
_PNG_INV_BIAS = np.array([-222.921, 135.576, -276.836], dtype=np.float64)


def _matrices(im_type, inverse):
    if im_type == 'jpg':
        return (_JPG_INV, _JPG_INV_BIAS) if inverse else (_JPG_FWD, _JPG_FWD_BIAS)
    return (_PNG_INV, _PNG_INV_BIAS) if inverse else (_PNG_FWD, _PNG_FWD_BIAS)


# --- host-side (numpy, C,H,W reference contract) ----------------------------------------
def rgb_to_ycbcr(img, y_only=True, max_val=1, im_type='png'):
    """Convert a C,H,W RGB image to YCbCr (ref: image_manipulation.py:56-89)."""
    mat, bias = _matrices(im_type, inverse=False)
    bias = bias * (max_val / 255.)
    y = mat[0, 0] * img[0] + mat[0, 1] * img[1] + mat[0, 2] * img[2] + bias[0]
    if y_only:
        return y, None, None
    cb = mat[1, 0] * img[0] + mat[1, 1] * img[1] + mat[1, 2] * img[2] + bias[1]
    cr = mat[2, 0] * img[0] + mat[2, 1] * img[1] + mat[2, 2] * img[2] + bias[2]
    return y, cb, cr


def ycbcr_to_rgb(img, max_val=1, im_type='png'):
    """Convert a C,H,W YCbCr image to RGB (ref: image_manipulation.py:92-116)."""
    mat, bias = _matrices(im_type, inverse=True)
    bias = bias * (max_val / 255.)
    r = mat[0, 0] * img[0] + mat[0, 1] * img[1] + mat[0, 2] * img[2] + bias[0]
    g = mat[1, 0] * img[0] + mat[1, 1] * img[1] + mat[1, 2] * img[2] + bias[1]
    b = mat[2, 0] * img[0] + mat[2, 1] * img[1] + mat[2, 2] * img[2] + bias[2]
    return r, g, b


def ycbcr_convert(img, y_only=True, max_val=1, im_type='png', input='rgb'):
    """Forward/inverse YCbCr conversion dispatcher on C,H,W numpy arrays.

    Keeps the signature and stacking semantics of the reference
    (ref: image_manipulation.py:121-157), numpy-only (torch branch dropped).
    """
    img = np.asarray(img)
    if len(img.shape) == 4:
        img = np.squeeze(img, axis=0)

    if input == 'ycbcr':
        a, b, c = ycbcr_to_rgb(img, max_val=max_val, im_type=im_type)
    elif input == 'rgb':
        a, b, c = rgb_to_ycbcr(img, max_val=max_val, y_only=y_only, im_type=im_type)
    else:
        raise ValueError('input must be rgb or ycbcr')

    # like the reference, always return floats (integer dtypes would truncate and
    # wrap out-of-range values; callers clip explicitly)
    if y_only and input == 'rgb':
        return np.expand_dims(np.asarray(a, np.float32), axis=0)
    return np.stack([a, b, c], axis=0).astype(np.float32)


class RGBtoYCbCrConverter:
    """The Y-channel datasets' transform (sisr_tpu's ``RGBtoYCbCrConverter``; ref:
    image_manipulation.py:177-194): an H,W,3 float RGB array to YCbCr, H,W,1 with
    ``y_only``, H,W,3 without."""

    def __init__(self, im_type='jpg', y_only=True, max_val=1):
        self.im_type = im_type
        self.y_only = y_only
        self.max_val = max_val

    def __call__(self, image):
        out = ycbcr_convert(np.transpose(image, (2, 0, 1)), y_only=self.y_only,
                            max_val=self.max_val, im_type=self.im_type, input='rgb')
        return np.transpose(out, (1, 2, 0))


# --- device-side (torch, NHWC batched) ---------------------------------------------------
def rgb_to_ycbcr_nhwc(img, y_only=False, max_val=1.0, im_type=None):
    """Batched NHWC RGB->YCbCr; identical math to :func:`rgb_to_ycbcr`.

    ``im_type`` is REQUIRED: the host converters default to 'png' (BT.601
    studio-range) — a silently different default here would shift Y by up to
    ~0.07 and move PSNR by whole dB with no error."""
    if im_type is None:
        raise ValueError("im_type required: 'jpg' (full-range JFIF) or 'png' "
                         '(BT.601 studio-range) — the two matrices differ.')
    mat, bias = _device_matrices(im_type, float(max_val), img.dtype, img.device)
    out = img @ mat + bias
    if y_only:
        return out[..., :1]
    return out


def ycbcr_to_rgb_nhwc(img, max_val=1.0, im_type=None):
    """Batched NHWC YCbCr->RGB; identical math to :func:`ycbcr_to_rgb`.  ``im_type``
    is required, as for :func:`rgb_to_ycbcr_nhwc`."""
    if im_type is None:
        raise ValueError("im_type required: 'jpg' or 'png' — the matrices differ.")
    mat, bias = _device_matrices(im_type, float(max_val), img.dtype, img.device, True)
    return img @ mat + bias


@functools.lru_cache(maxsize=16)
def _device_matrices(im_type, max_val, dtype, device, inverse=False):
    """The forward (or inverse) matrix, transposed for ``img @ mat``, and bias on
    ``device``, made once: a fresh host-to-device copy per call would make the host
    wait for the device's queue to drain."""
    mat, bias = _matrices(im_type, inverse=inverse)
    return (torch.as_tensor(mat.T, dtype=dtype, device=device),
            torch.as_tensor(bias * (max_val / 255.), dtype=dtype, device=device))
