"""Where a training crop came from: the reference finds each LR crop the program
trained on in the benchmark's own LR image under one of the eight flips and
transposes of the square, checks that the HR crop is the matching window of the HR
image, and hands back its own copies of both."""
import numpy as np


def dihedral(img, t):
    """The ``t``-th (0-7) of the eight flips and transposes of an H, W, C array."""
    if t & 1:
        img = img[:, ::-1]
    if t & 2:
        img = img[::-1]
    if t & 4:
        img = img.transpose(1, 0, 2)
    return img


def locate(lr_img, hr_img, lr_crop, hr_crop, scale):
    """(LR window, HR window) of the images equal to the crops, or None."""
    c = lr_crop.shape[0]
    for t in range(8):
        lr_t, hr_t = dihedral(lr_img, t), dihedral(hr_img, t)
        h, w = lr_t.shape[:2]
        first = (lr_t[:h - c + 1, :w - c + 1] == lr_crop[0, 0]).all(-1)
        for i, j in np.argwhere(first):
            lr_win = lr_t[i:i + c, j:j + c]
            if not np.array_equal(lr_win, lr_crop):
                continue
            hr_win = hr_t[i * scale:(i + c) * scale, j * scale:(j + c) * scale]
            if np.array_equal(hr_win, hr_crop):
                return np.ascontiguousarray(lr_win), np.ascontiguousarray(hr_win)
    return None
