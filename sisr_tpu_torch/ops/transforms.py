"""Host image transforms (copy of sisr_tpu's ``ops/transforms.py``, ref:
Code/sr_tools/image_manipulation.py): PIL <-> H,W,C float32 conversion with torchvision's
semantics, the centre crop and bicubic ``downsample`` of the online degradation's host
chain (Pillow-exact through :func:`~sisr_tpu_torch.ops.resize.resize_uint8`), and the
random training crops and augments on H,W,C numpy arrays.

Randomness uses the global ``random`` module in the reference's draw order, so runs
seeded alike crop and flip alike in both packages.
"""
import random

import numpy as np
import PIL.Image

from .resize import resize_uint8


def pil_to_float(img):
    """PIL image or uint8 array -> H,W,C float32 in [0,1] (torchvision ToTensor,
    channel-last)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def float_to_pil(arr):
    """H,W,C float in [0,1] -> PIL uint8 (torchvision ToPILImage: times 255, then the
    byte cast truncates)."""
    arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[:, :, 0]
    return PIL.Image.fromarray(arr)


def center_crop(image, height, width):
    """Centre crop of a PIL image (ref: image_manipulation.py:197-208)."""
    l_crop, top_crop = (image.width - width) // 2, (image.height - height) // 2
    return image.crop((l_crop, top_crop, width + l_crop, top_crop + height))


def downsample(image, scale, jm=False):
    """Centre crop of a PIL image to a multiple of ``scale``, then the bicubic
    downscale, bit-exact with PIL's BICUBIC (ref: image_manipulation.py:32-53): (the
    cropped image, the LR image).  ``jm`` makes the LR sides even."""
    if jm:
        corrected_width = ((image.width // scale) // 2) * 2
        corrected_height = ((image.height // scale) // 2) * 2
    else:
        corrected_width = image.width // scale
        corrected_height = image.height // scale
    r_width, r_height = corrected_width * scale, corrected_height * scale
    r_image = center_crop(image, height=r_height, width=r_width)
    if r_image.mode in ('RGB', 'L'):
        lr = resize_uint8(np.asarray(r_image), (r_width // scale, r_height // scale))
        return r_image, PIL.Image.fromarray(lr)
    # other modes (P, 1, RGBA, ...) resize in PIL itself, in their own mode
    return r_image, r_image.resize((r_width // scale, r_height // scale),
                                   resample=PIL.Image.BICUBIC)


def random_matched_crop(image_lr, image_hr, crop_size, scale):
    """Matched random LR/HR patch crop (ref: image_manipulation.py:233-239, same
    random draw order)."""
    rnd_h = random.randint(0, max(0, image_lr.shape[0] - crop_size))
    rnd_w = random.randint(0, max(0, image_lr.shape[1] - crop_size))
    cropped_lr = image_lr[rnd_h:rnd_h + crop_size, rnd_w:rnd_w + crop_size, :]
    rnd_h_gt, rnd_w_gt = int(rnd_h * scale), int(rnd_w * scale)
    hs = int(crop_size * scale)
    cropped_hr = image_hr[rnd_h_gt:rnd_h_gt + hs, rnd_w_gt:rnd_w_gt + hs, :]
    return cropped_lr, cropped_hr


def random_flip_rotate(*img, hflip=True, rot=True):
    """Random h/v flips and a 90-degree transpose, the same for every array
    (ref: image_manipulation.py:242-257, same draw order; 'hflip' flips the width
    axis)."""
    hflip = hflip and random.random() < 0.5
    vflip = rot and random.random() < 0.5
    rot90 = rot and random.random() < 0.5

    def _augment(arr):
        if hflip:
            arr = arr[:, ::-1, :]
        if vflip:
            arr = arr[::-1, :, :]
        if rot90:
            arr = arr.transpose(1, 0, 2)
        return np.ascontiguousarray(arr)

    return [_augment(i) for i in img]
