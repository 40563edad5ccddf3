"""SuperResImages dataset for LR/HR folder pairs (PyTorch port of the eval subset of
sisr_tpu's ``data/datasets.py``, ref: Code/sr_tools/data_handler.py:147-528).

Index building (``_qN`` group tags, recursive search, dataset splits, shortlists),
PIL decode to H,W,3 uint8, the HR alignment crop and a capped in-memory
cache of decoded images.  Degradation metadata, online degradations, CelebA
attributes, crops and augments come with later slices.
"""
from collections import OrderedDict
import os
import re
import threading

import numpy as np
import PIL.Image

from ..configuration.constants import data_splits
from ..utils.helpers import extract_image_names_from_folder


def center_crop_np(arr, height, width):
    """Center crop an H,W,C numpy array with PIL's arithmetic — including its
    behavior when the target EXCEEDS the image: out-of-bounds regions pad with zeros."""
    res_h = arr.shape[0] - height
    res_w = arr.shape[1] - width
    top, left = res_h // 2, res_w // 2
    if res_h >= 0 and res_w >= 0:
        return arr[top:top + height, left:left + width]
    out = np.zeros((height, width) + arr.shape[2:], arr.dtype)
    src_t, src_l = max(top, 0), max(left, 0)
    dst_t, dst_l = max(-top, 0), max(-left, 0)
    h = min(arr.shape[0] - src_t, height - dst_t)
    w = min(arr.shape[1] - src_l, width - dst_l)
    out[dst_t:dst_t + h, dst_l:dst_l + w] = arr[src_t:src_t + h, src_l:src_l + w]
    return out


class SuperResImages:
    """(ref: data_handler.py:147-528).  Indexable dataset of LR images with their
    HR references, yielding per-image dicts of H,W,3 arrays: float32 in [0,1], or
    the decoded uint8 when ``keep_uint8`` is set (the fused eval divides on the
    device)."""

    def __init__(self, lr_dir, hr_dir=None, dataset=None, split=None, custom_split=None,
                 recursive_search=False, image_shortlist=None, scale=4, cache_decoded=None):
        if split not in ['train', 'eval', 'test', 'all', None]:
            raise RuntimeError('"Split" must be one of: train | eval | test | all | None')
        self.scale = scale
        self.lr_base = lr_dir
        self.hr_base = hr_dir

        main_filenames = self.filter_names(lr_dir, recursive_search)
        main_filenames = self.dataset_split(main_filenames, custom_split, image_shortlist,
                                            split, dataset, lr_dir)
        if len(main_filenames) == 0:
            raise RuntimeError('No images were supplied or all images were filtered out!')
        self.lr_filenames, self.base_filenames = [], []
        for key, val in main_filenames.items():
            for file_name in val:
                self.lr_filenames.append(file_name)
                self.base_filenames.append(key)
        self.image_count = len(self.lr_filenames)

        # serve decoded uint8 instead of float (the fused eval's transport)
        self.keep_uint8 = False
        # decoded-image cache: eval protocols re-iterate the same images (warm-up
        # and timed passes, repeated hub calls), and PNG decode is the host's
        # throughput ceiling.  True => 4 GiB cap; an int > 1 is the cap in bytes.
        self._decode_cache = {} if cache_decoded else None
        self._decode_cache_bytes = 0
        self._decode_cache_lock = threading.Lock()
        self._decode_cache_cap = (cache_decoded if isinstance(cache_decoded, int)
                                  and cache_decoded > 1 else 4 << 30)
        print('Initialized %s data with %d image%s.' % (
            dataset if dataset is not None else 'image', self.image_count,
            's' if self.image_count > 1 else ''))

    # --- index building (ref: data_handler.py:307-390) ------------------------------------
    @staticmethod
    def filter_names(directory, recursive):
        """LR files grouped by the HR name they pair with: an LR file ``x_q<tag>.png``
        pairs with HR ``x.png``."""
        final_files = OrderedDict()
        for file in extract_image_names_from_folder(directory, recursive=recursive):
            real_file = os.path.relpath(file, directory)
            # the _qN group tag lives in the FILENAME: match on the basename only
            subdir, fname = os.path.split(real_file)
            split_key = re.split(r"_q(.*)(?=\.)", fname)
            if len(split_key) > 1:
                base_name = os.path.join(subdir, split_key[0] + split_key[2])
            else:
                base_name = os.path.join(subdir, split_key[0])
            final_files.setdefault(base_name, []).append(real_file)
        return final_files

    @staticmethod
    def dataset_split(current_files, custom_split, image_shortlist, split, dataset,
                      main_dir):
        if custom_split is not None or (image_shortlist is None
                                        and split not in ('all', None)
                                        and len(current_files) != 1):
            if custom_split is None:
                start, end = data_splits[dataset][split]
            else:
                start, end = custom_split[0], custom_split[1]
            return OrderedDict(list(current_files.items())[start:end])
        elif image_shortlist is not None:
            with open(image_shortlist, 'r') as shortlist:
                cleanup = lambda pth: os.path.relpath(pth.rstrip('\n'), main_dir) \
                    if main_dir in pth else pth.rstrip('\n')
                accepted = [cleanup(line) for line in shortlist]
            return OrderedDict((k, v) for k, v in current_files.items() if k in accepted)
        return current_files

    # --- loading --------------------------------------------------------------------------
    @staticmethod
    def read_image(filename):
        """Decode to an H,W,3 uint8 RGB numpy array."""
        with PIL.Image.open(filename) as im:
            if im.mode != 'RGB':
                im = im.convert('RGB')
            return np.asarray(im, np.uint8)

    def _read_cached(self, filename):
        """read_image through the decoded-uint8 cache.  Returned arrays are treated
        as read-only (crops are views; float conversions copy)."""
        cache = self._decode_cache
        if cache is None:
            return self.read_image(filename)
        arr = cache.get(filename)
        if arr is None:
            arr = self.read_image(filename)
            with self._decode_cache_lock:  # loader threads race on the byte budget
                if self._decode_cache_bytes + arr.nbytes <= self._decode_cache_cap:
                    cache[filename] = arr
                    self._decode_cache_bytes += arr.nbytes
        return arr

    def _to_image(self, arr):
        if self.keep_uint8:
            return arr
        return arr.astype(np.float32) / 255.0

    def __getitem__(self, index):
        """(ref: data_handler.py:433-525)"""
        base_name = self.base_filenames[index]
        image_name = self.lr_filenames[index]
        lr_arr = self._read_cached(os.path.join(self.lr_base, image_name))
        hr_im = np.array(0)
        if self.hr_base is not None:
            # HR alignment crop (ref: data_handler.py:471-489)
            hr_arr = self._read_cached(os.path.join(self.hr_base, base_name))
            h, w = lr_arr.shape[0] * self.scale, lr_arr.shape[1] * self.scale
            if hr_arr.shape[1] != w or hr_arr.shape[0] != h:
                hr_arr = center_crop_np(hr_arr, height=h, width=w)
            hr_im = self._to_image(hr_arr)
        return {'lr': self._to_image(lr_arr), 'hr': hr_im, 'tag': image_name,
                'hr_tag': base_name}

    def __len__(self):
        return self.image_count
