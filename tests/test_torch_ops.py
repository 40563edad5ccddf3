"""sisr_tpu_torch's eval ops against sisr_tpu's on the same numpy inputs: the host
bicubic bit-exact with Pillow, the device bicubic, YCbCr, PSNR and SSIM at 1e-5."""
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from sisr_tpu.ops import colorspace as jax_colorspace
from sisr_tpu.ops import metrics as jax_metrics
from sisr_tpu.ops import resize as jax_resize
from sisr_tpu_torch.ops import colorspace, metrics, resize


@pytest.mark.parametrize('src,dst,channels', [
    ((13, 17), (52, 68), 3),   # 4x up
    ((40, 33), (10, 8), 3),    # down (widened filter support)
    ((21, 9), (30, 14), None),  # grayscale H,W
])
def test_resize_uint8_bit_exact(src, dst, channels):
    rng = np.random.RandomState(0)
    shape = src + ((channels,) if channels else ())
    img = rng.randint(0, 256, shape).astype(np.uint8)
    ours = resize.resize_uint8(img, (dst[1], dst[0]))
    pil = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), Image.BICUBIC))
    np.testing.assert_array_equal(ours, pil)
    np.testing.assert_array_equal(ours, jax_resize.resize_uint8(img, (dst[1], dst[0])))


def test_resize_bicubic_matches_sisr_tpu():
    img = np.random.RandomState(1).rand(2, 9, 11, 3).astype(np.float32)
    ours = resize.resize_bicubic(torch.from_numpy(img), 36, 44).numpy()
    theirs = np.asarray(jax_resize.resize_bicubic(jnp.asarray(img), 36, 44,
                                                  dtype=jnp.float32))
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)


@pytest.mark.parametrize('im_type', ['jpg', 'png'])
@pytest.mark.parametrize('y_only', [True, False])
def test_ycbcr_matches_sisr_tpu(im_type, y_only):
    img = np.random.RandomState(2).rand(2, 5, 6, 3).astype(np.float32)
    ours = colorspace.rgb_to_ycbcr_nhwc(torch.from_numpy(img), y_only=y_only,
                                        im_type=im_type).numpy()
    theirs = np.asarray(jax_colorspace.rgb_to_ycbcr_nhwc(jnp.asarray(img), y_only=y_only,
                                                         im_type=im_type))
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)
    chw = img[0].transpose(2, 0, 1)
    for direction in ('rgb', 'ycbcr'):
        np.testing.assert_allclose(
            colorspace.ycbcr_convert(chw, y_only=y_only, im_type=im_type, input=direction),
            jax_colorspace.ycbcr_convert(chw, y_only=y_only, im_type=im_type,
                                         input=direction), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match='im_type required'):
        colorspace.rgb_to_ycbcr_nhwc(torch.from_numpy(img))


def _image_pair(seed, shape=(3, 24, 29)):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape).astype(np.float32)
    return a, np.clip(a + rng.randn(*shape).astype(np.float32) * 0.05, 0, 1)


def test_device_psnr_ssim_match_sisr_tpu():
    a, b = _image_pair(3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(metrics.psnr_nhw(ta, tb).numpy(),
                               np.asarray(jax_metrics.psnr_nhw(ja, jb)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(metrics.ssim_nhw(ta, tb).numpy(),
                               np.asarray(jax_metrics.ssim_nhw(ja, jb)), atol=1e-5, rtol=0)
    assert metrics.psnr_nhw(ta, ta).tolist() == [100.0] * 3
    with pytest.raises(ValueError, match='too small'):
        metrics.ssim_nhw(ta[:, :10], tb[:, :10])


def test_host_metrics_hub_matches_sisr_tpu():
    a, b = _image_pair(4)
    ours, diag = metrics.Metrics(['PSNR', 'SSIM'], delimeter='>').run_metrics(
        a[..., None], b[..., None], key='LR')
    theirs, their_diag = jax_metrics.Metrics(['PSNR', 'SSIM'], delimeter='>').run_metrics(
        a[..., None], b[..., None], key='LR')
    assert sorted(ours) == sorted(theirs) == ['LR>PSNR', 'LR>SSIM']
    for key in ours:
        np.testing.assert_allclose(ours[key], theirs[key], atol=1e-5, rtol=0)
    assert diag == their_diag
