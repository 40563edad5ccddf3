"""Random training crops and augments on H,W,C numpy arrays (copy of the training
transforms of sisr_tpu's ``ops/transforms.py``, ref: Code/sr_tools/image_manipulation.py).

Randomness uses the global ``random`` module in the reference's draw order, so runs
seeded alike crop and flip alike in both packages.
"""
import random

import numpy as np


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
