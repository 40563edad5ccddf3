"""Image saving (the ``safe_image_save`` of sisr_tpu's ``tools/visualization.py``, ref:
Code/sr_tools/visualization.py:31-54), for the training epoch's sample images."""
import os

import numpy as np
from PIL import Image


def safe_image_save(images, out_loc, names, config='rgb', max_val=1):
    """Save an N,H,W,C float batch in [0, max_val] as image files named ``names``.
    Only RGB batches: Y-channel images come with the families that make them."""
    if config != 'rgb':
        raise NotImplementedError('safe_image_save: only RGB batches are ported to '
                                  'sisr_tpu_torch yet (ROADMAP.md, Queue 1 item 10).')
    for index in range(images.shape[0]):
        im = np.clip(np.asarray(images[index]) * 255 / max_val, 0, 255).astype(np.uint8)
        if im.shape[-1] == 1:
            im = im[..., 0]
        Image.fromarray(im).save(os.path.join(out_loc, names[index]))
