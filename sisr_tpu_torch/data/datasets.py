"""SuperResImages dataset for LR/HR folder pairs (PyTorch port of sisr_tpu's
``data/datasets.py``, ref: Code/sr_tools/data_handler.py:20-528).

Index building (``_qN`` group tags, recursive search, dataset splits, shortlists,
blacklists), PIL decode to H,W,3 uint8, the HR alignment crop, a capped in-memory
cache of decoded images with optional decoded ``.npy`` sidecars on disk, the
degradation-metadata CSV (:func:`read_augmentation_list`) with a float32 ``metadata``
vector per item, CelebA attributes (:func:`read_celeba_attributes`) and legacy
blur-kernel ``.npy`` files merged in front of it, and the training options: random
flips and transposes (``random_augments``), matched random crops (``random_crop``) and
several crops per image (``request_crops``).  ``input='interp'`` reads LR images that
are already at the HR size (the eval's ``--lr_dir_interp``, a pre-upscaled family's
data); ``colorspace='ycbcr'`` serves both images in YCbCr ('jpg' matrices), the Y
channel alone with ``y_only`` (SRCNN's and VDSR's training split).

Online degradation (``online_degradations``) makes the LR images from the HR folder:
a random Gaussian kernel per item (``ops/degradations.py``), whose 10-value PCA code
(30000 kernels' components, drawn at construction) joins the metadata as
``blur_kernel`` (and the noise level, x 10, as ``noise``).  In host mode the item's LR
is the blurred (and noised) HR, truncated to uint8 and PIL-bicubic downscaled; in
device mode (``online_degradation_params.device``) the item carries the HR, a zero
placeholder LR and its kernel as ``blur_kernels``, and the train step makes the LR on
the device (``BaseHandler.set_device_degrade``).  ``mask_data`` adds each image's
segmentation pattern as ``mask``.
"""
from collections import OrderedDict, deque
import hashlib
import json
import os
import re
import threading
import time

import numpy as np
import pandas as pd
import PIL.Image

from .. import native
from ..configuration.constants import data_splits
from ..ops import degradations
from ..ops.colorspace import RGBtoYCbCrConverter
from ..ops.transforms import (downsample, float_to_pil, pil_to_float, random_flip_rotate,
                              random_matched_crop)
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


def read_celeba_attributes(attributes_loc, image_dict, selected_metadata='all',
                           attribute_amplification=None):
    """CelebA attributes (ref: data_handler.py:20-58) put in front of each image's
    metadata vector: (the extended dict, the attribute keys in vector order).

    ``attributes_loc`` is a CelebA ``list_attr_celeba.txt`` (a count line, a header of
    attribute names, then ``<stem>.jpg`` rows of -1 / 1).  Negative values become 0, or
    with ``attribute_amplification`` -2 and positive ones 2.  ``selected_metadata``
    names the columns ('all' for every one; ``age`` and ``gender`` are CelebA's
    ``Young`` and ``Male``).  An image ``x_q<tag>.png`` reads the row of ``x.jpg``; the
    columns go in reversed order."""
    full_dict = image_dict.copy()
    celeb_data = pd.read_csv(attributes_loc, skiprows=1, sep=r'\s+')
    if attribute_amplification is not None:
        celeb_data[celeb_data < 0] = -2
        celeb_data[celeb_data > 0] = 2
    else:
        celeb_data[celeb_data < 0] = 0
    if selected_metadata != 'all':
        if 'age' in selected_metadata:
            celeb_data.rename(columns={'Young': 'age'}, inplace=True)
        if 'gender' in selected_metadata:
            celeb_data.rename(columns={'Male': 'gender'}, inplace=True)
        celeb_data = celeb_data[selected_metadata]
    final_keys = list(celeb_data.columns)
    final_keys.reverse()
    for key in sorted(full_dict):
        row = celeb_data.loc[key.split('_')[0].split('.')[0] + '.jpg']
        full_dict[key] = np.concatenate(([row[k] for k in final_keys], full_dict[key]))
    return full_dict, final_keys


def read_augmentation_list(metadata_file, filenames=None, legacy_blur_kernels=None,
                           data_attributes=None, attributes_loc=None, qpi_selection=None,
                           attribute_amplification=None):
    """Degradation-metadata CSV parser (ref: data_handler.py:62-144): {image name:
    metadata vector} for ``filenames`` and the key of every entry.

    JSON-list columns (e.g. a 10-value ``blur_kernel``) give one key per value;
    integer and float columns are normalised to [0, 1] by their range (QPI by the
    fixed range 20-40), a constant column to 0.  CelebA attributes
    (``attributes_loc``, the columns ``data_attributes`` names) go in front
    (:func:`read_celeba_attributes`), and a legacy ``.npy`` of blur-kernel codes (one
    row per image, in sorted name order) in front of those; ``qpi_selection`` (low,
    high) keeps the images whose QPI lies in that range."""
    keys = deque()
    qpi_cutoffs = bool(qpi_selection) and None not in qpi_selection

    if metadata_file is not None:
        aug_data = pd.read_csv(metadata_file, header=0, index_col=0)
        for col in aug_data:
            if pd.api.types.is_object_dtype(aug_data[col]) \
                    or pd.api.types.is_string_dtype(aug_data[col]):
                aug_data[col] = aug_data[col].apply(json.loads)
                keys.extend([col.lower()] * len(aug_data[col].iloc[0]))
            elif pd.api.types.is_integer_dtype(aug_data[col]) \
                    or pd.api.types.is_float_dtype(aug_data[col]):
                # floats take the integers' normalisation, QPI's fixed range included
                aug_data[col] = aug_data[col].astype(float)
                keys.append(col.lower())
                is_qpi = col.upper() == 'QPI'
                minimum = 20 if is_qpi else aug_data[col].min()
                maximum = 40 if is_qpi else aug_data[col].max()
                if maximum != minimum:
                    aug_data[col] = (aug_data[col] - minimum) / (maximum - minimum)
                    if is_qpi and qpi_cutoffs:
                        qpi_selection = [(q - minimum) / (maximum - minimum)
                                         for q in qpi_selection]
                else:
                    # a constant column carries nothing: 0, not the 0/0 NaN
                    aug_data[col] = 0.0
                    if is_qpi and qpi_cutoffs:
                        qpi_selection = [q - minimum for q in qpi_selection]
            else:
                raise RuntimeError('Unidentified datatype in metadata file.')

        all_image_dict = aug_data.T.to_dict('list')
        augmentation_dict = {}
        for key in filenames:
            data = []
            for v in all_image_dict[key]:
                if isinstance(v, list):
                    data.extend(v)
                else:
                    data.append(v)
            augmentation_dict[key] = np.array(data)
    else:
        augmentation_dict = {image: np.array([]) for image in filenames}

    if attributes_loc is not None and data_attributes is not None:
        augmentation_dict, attribute_keys = read_celeba_attributes(
            attributes_loc, augmentation_dict, selected_metadata=data_attributes,
            attribute_amplification=attribute_amplification)
        keys.extendleft(reversed(attribute_keys))

    if legacy_blur_kernels is not None:
        kernels = np.load(legacy_blur_kernels)
        keys.extendleft(['blur_kernel'] * len(kernels[0]))
        for index, key in enumerate(sorted(augmentation_dict)):
            augmentation_dict[key] = np.concatenate((kernels[index], augmentation_dict[key]))

    if qpi_cutoffs:
        qpi_pos = list(keys).index('qpi')
        augmentation_dict = {im: md for im, md in augmentation_dict.items()
                             if qpi_selection[0] <= md[qpi_pos] <= qpi_selection[-1]}
    return augmentation_dict, list(keys)


# the PCA of the online degradation's kernel codes: this many random kernels, this many
# components (ref: data_handler.py:221-238)
PCA_KERNELS = 30000
PCA_COMPONENTS = 10


class SuperResImages:
    """(ref: data_handler.py:147-528).  Indexable dataset of LR images with their
    HR references, yielding per-image dicts of H,W,3 arrays: float32 in [0,1], or
    the decoded uint8 when ``keep_uint8`` is set (the fused eval and the train step
    divide on the device).  With ``random_crop`` the images are matched LR/HR patches
    (``request_crops`` of them per image, stacked).  With ``colorspace='ycbcr'`` the
    float images are converted to YCbCr (``conv_type``'s matrices), H,W,1 with
    ``y_only``, and travel as float32 whatever ``keep_uint8`` says (sisr_tpu's rule:
    the conversion needs the float image); keys of the reference's data tables that no
    option here reads pass through ``kwargs``.

    ``cache_decoded``: True (a 4 GiB cap) or an int > 1 (the cap in bytes) keeps
    decoded images in memory; a string also persists them as decoded uint8 ``.npy``
    sidecars, so a new process skips the decode: 'sidecar' puts them in a
    ``.decoded_u8/`` folder beside each image, any other string is a cache folder
    (hashed names).  A sidecar's name holds its source's mtime and size, so an edited
    source is decoded again; stale sidecars are removed.

    ``online_degradations`` makes the LR images from ``hr_dir`` (the module docstring;
    ``online_degradation_params`` are :class:`~sisr_tpu_torch.ops.degradations.
    OnlineDegrader`'s, with ``device`` for device mode; ``usage`` 'eval' or 'test'
    refuses device mode).  ``data_attributes`` is a CelebA attribute file,
    ``metadata`` then also naming its columns (``attribute_amplification`` for +/-2),
    and ``legacy_blur_kernels`` a ``.npy`` of kernel codes (:func:`read_augmentation_list`).
    ``mask_data`` is a folder of segmentation patterns named as the HR images: each
    item's ``mask``, centre-cropped as its HR image."""

    def __init__(self, lr_dir, hr_dir=None, dataset=None, split=None, custom_split=None,
                 recursive_search=False, image_shortlist=None, scale=4, cache_decoded=None,
                 degradation_metadata_file=None, metadata=None, qpi_selection=None,
                 data_attributes=None, input='unmodified', colorspace='rgb', y_only=True,
                 conv_type='jpg', blacklist=None, random_augments=None, random_crop=None,
                 request_crops=None, online_degradations=None,
                 online_degradation_params=None, mask_data=None, legacy_blur_kernels=None,
                 attribute_amplification=None, usage=None, **kwargs):
        if split not in ['train', 'eval', 'test', 'all', None]:
            raise RuntimeError('"Split" must be one of: train | eval | test | all | None')
        if input not in ('interp', 'unmodified'):
            raise RuntimeError('"lr_type" must be one of: interp | unmodified')
        if colorspace not in ('rgb', 'augmented_rgb', 'ycbcr'):
            raise ValueError('colorspace must be rgb | augmented_rgb | ycbcr, got %r'
                             % (colorspace,))
        self.scale = scale
        self.lr_type = input
        self.hr_base = hr_dir
        self.mask_base = mask_data
        self._ycbcr = RGBtoYCbCrConverter(y_only=y_only, im_type=conv_type) \
            if colorspace == 'ycbcr' else None
        self.patch_crop = random_crop
        self.random_augment = random_augments
        self.request_crops = request_crops

        self.online_degradations = bool(online_degradations)
        params = dict(online_degradation_params or {})
        self.device_degradations = self.online_degradations and bool(params.pop('device',
                                                                                False))
        if self.device_degradations and (usage or split) in ('eval', 'test'):
            raise RuntimeError('device-mode online degradation emits placeholder LR '
                               'images (LR is synthesized inside the train step) — '
                               'use host-mode online degradation or file-based LR for '
                               'eval sets.')
        if self.online_degradations:
            if hr_dir is None:
                raise RuntimeError('Cannot synthesize LR images without HR images.')
            main_dir, self.lr_base = hr_dir, None
            kernels = degradations.random_batch_kernel(batch=PCA_KERNELS)
            pca = degradations.pca_matrix(kernels.reshape(PCA_KERNELS, -1),
                                          k=PCA_COMPONENTS)
            if not params:
                params = dict(kernel=21, rate_iso=1.0, sig_min=0.2, sig_max=4.0,
                              noise=False, noise_high=0.0)
            self.degrader = degradations.OnlineDegrader(pca, random=True, **params)
        else:
            main_dir, self.lr_base = lr_dir, lr_dir

        main_filenames = self.filter_names(main_dir, recursive_search)
        main_filenames = self.dataset_split(main_filenames, custom_split, image_shortlist,
                                            split, dataset, main_dir)
        main_filenames = self.blacklist_removal(main_filenames, blacklist)
        if len(main_filenames) == 0:
            raise RuntimeError('No images were supplied or all images were filtered out!')
        if self.online_degradations:
            # one item per HR image, named after it
            self.base_filenames = list(main_filenames)
            self.lr_filenames = list(self.base_filenames)
        else:
            self.lr_filenames, self.base_filenames = [], []
            for key, val in main_filenames.items():
                for file_name in val:
                    self.lr_filenames.append(file_name)
                    self.base_filenames.append(key)

        # degradation metadata (ref: datasets.py:226-266): one vector per item;
        # ``metadata`` names the requested columns ('all' for the file's)
        self.metadata_keys = []
        self.metadata = None
        if degradation_metadata_file is not None or metadata is not None:
            att_dict, self.metadata_keys = read_augmentation_list(
                degradation_metadata_file, filenames=self.lr_filenames,
                attributes_loc=data_attributes, data_attributes=metadata,
                qpi_selection=qpi_selection, legacy_blur_kernels=legacy_blur_kernels,
                attribute_amplification=attribute_amplification)
            if qpi_selection is not None:
                pairs = [(lr, base) for lr, base in zip(self.lr_filenames,
                                                        self.base_filenames)
                         if lr in att_dict]
                if not pairs:
                    raise RuntimeError('qpi_selection %s filtered out every image.'
                                       % (qpi_selection,))
                self.lr_filenames, self.base_filenames = map(list, zip(*pairs))
            self.metadata = [att_dict[image] for image in self.lr_filenames]
        self.image_count = len(self.lr_filenames)

        if self.online_degradations:
            # the item's kernel code follows the file's metadata (ref:
            # datasets.py:291-305); with noise its level is one more entry
            self.metadata_keys = self.metadata_keys + ['blur_kernel'] * self.degrader.para_in
            if self.degrader.noise:
                if self.device_degradations:
                    raise ValueError(
                        'device-mode online degradation does not apply gaussian '
                        "noise (the train step's pipeline is blur + downscale only) — "
                        'set noise = false in online_degradation_params, or use '
                        'host-mode degradation.')
                self.metadata_keys.append('noise')

        # serve decoded uint8 instead of float (the fused eval's and train step's
        # transport); a YCbCr dataset serves floats whatever it says
        self.keep_uint8 = False
        # decoded-image cache: eval protocols re-iterate the same images (warm-up
        # and timed passes, repeated hub calls), and PNG decode is the host's
        # throughput ceiling.  True => 4 GiB cap; an int > 1 is the cap in bytes.
        self._decode_cache = {} if cache_decoded else None
        self._decode_cache_bytes = 0
        self._decode_cache_lock = threading.Lock()
        self._decode_cache_cap = (cache_decoded if isinstance(cache_decoded, int)
                                  and cache_decoded > 1 else 4 << 30)
        self._disk_cache_dir = None
        # per folder, the sidecar names in it (one listdir, then kept up to date under
        # the lock), for the stale-sidecar clean-up
        self._sidecar_listing = {}
        if isinstance(cache_decoded, str):
            self._disk_cache_dir = 'sidecar' if cache_decoded == 'sidecar' \
                else os.path.abspath(os.path.expanduser(cache_decoded))
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

    @staticmethod
    def blacklist_removal(current_files, blacklist):
        """Drop the images a blacklist CSV names in its ``Images`` column."""
        if blacklist is None:
            return current_files
        print('Removing blacklisted images.')
        banned = set(pd.read_csv(blacklist, header=[0])['Images'].tolist())
        return OrderedDict((k, v) for k, v in current_files.items() if k not in banned)

    # --- loading --------------------------------------------------------------------------
    @staticmethod
    def read_image(filename):
        """Decode to an H,W,3 uint8 RGB numpy array: a PNG through the native libpng
        decoder (``sisr_tpu_torch.native``; lossless, PIL's pixels) where it loads and
        takes the file, else through PIL."""
        if filename.lower().endswith('.png'):
            arr = native.decode_png_rgb8(filename)
            if arr is not None:
                return arr
        with PIL.Image.open(filename) as im:
            if im.mode != 'RGB':
                im = im.convert('RGB')
            return np.asarray(im, np.uint8)

    def _sidecar_path(self, filename):
        """Where ``filename``'s decoded sidecar lives; its name holds the source's
        (mtime_ns, size), so an edited source does not read a stale one."""
        st = os.stat(filename)
        stem = '%s.%d.%d.npy' % (os.path.basename(filename), st.st_mtime_ns, st.st_size)
        if self._disk_cache_dir == 'sidecar':
            return os.path.join(os.path.dirname(os.path.abspath(filename)), '.decoded_u8',
                                stem)
        digest = hashlib.sha1(os.path.abspath(filename).encode()).hexdigest()[:16]
        return os.path.join(self._disk_cache_dir, '%s_%s' % (digest, stem))

    def _disk_cache_load(self, filename):
        """The decoded sidecar of ``filename``, or None (none, or unreadable)."""
        try:
            path = self._sidecar_path(filename)
            if os.path.isfile(path):
                arr = np.load(path)
                if arr.dtype == np.uint8 and arr.ndim == 3:
                    return arr
        except (OSError, ValueError):
            pass
        return None

    def _disk_cache_store(self, filename, arr):
        """Write ``filename``'s sidecar atomically (a temporary file, then a rename),
        first removing its stale sidecars and temporary files left by a crash more
        than 10 minutes ago.  A folder that cannot be written turns the disk layer off
        for this dataset (one notice); decoding goes on."""
        try:
            path = self._sidecar_path(filename)
            folder, base = os.path.split(path)
            os.makedirs(folder, exist_ok=True)
            with self._decode_cache_lock:
                names = self._sidecar_listing.get(folder)
                if names is None:
                    names = self._sidecar_listing[folder] = set(os.listdir(folder))
                listing = list(names)
            prefix = base.rsplit('.', 3)[0] + '.'
            for old in listing:
                if old == base or not old.startswith(prefix):
                    continue
                full = os.path.join(folder, old)
                if '.tmp' in old:
                    try:
                        if time.time() - os.stat(full).st_mtime < 600:
                            continue  # perhaps a live writer's
                    except OSError:
                        pass
                elif not old.endswith('.npy'):
                    continue
                try:
                    os.remove(full)
                except OSError:
                    pass
                with self._decode_cache_lock:
                    names.discard(old)
            tmp = '%s.tmp%d.npy' % (path, os.getpid())
            with open(tmp, 'wb') as f:
                np.save(f, arr)
            os.replace(tmp, path)
            with self._decode_cache_lock:
                names.add(base)
        except OSError as exc:
            print('decoded-image disk cache disabled (%s): %s' % (self._disk_cache_dir, exc))
            self._disk_cache_dir = None

    def _read_cached(self, filename):
        """read_image through the decoded-uint8 cache (and its sidecars on disk).
        Returned arrays are treated as read-only (crops are views; float conversions
        copy)."""
        cache = self._decode_cache
        if cache is None:
            return self.read_image(filename)
        arr = cache.get(filename)
        if arr is None:
            if self._disk_cache_dir is not None:
                arr = self._disk_cache_load(filename)
            if arr is None:
                arr = self.read_image(filename)
                if self._disk_cache_dir is not None:
                    self._disk_cache_store(filename, arr)
            with self._decode_cache_lock:  # loader threads race on the byte budget
                if self._decode_cache_bytes + arr.nbytes <= self._decode_cache_cap:
                    cache[filename] = arr
                    self._decode_cache_bytes += arr.nbytes
        return arr

    def _to_image(self, arr, uint8_ok=True):
        """The decoded uint8 array as the dataset serves it: as it is under
        ``keep_uint8`` (RGB datasets, unless ``uint8_ok`` is False: the host-mode
        degradation's float HR), else :meth:`_model_space` of its float32 in [0, 1]."""
        if self._ycbcr is None and self.keep_uint8 and uint8_ok:
            return arr
        return self._model_space(arr.astype(np.float32) / 255.0)

    def _model_space(self, img):
        """A float32 RGB image in the dataset's colorspace (YCbCr for ``ycbcr``)."""
        return self._ycbcr(img) if self._ycbcr is not None else img

    def _degraded_lr(self, hr_arr):
        """The online degradation of one decoded HR image: (LR, its kernel's code, the
        (l, l) kernel).  Host mode: blurred (and noised) HR through ToPILImage's uint8
        and PIL's bicubic downscale (ref: data_handler.py:446-455).  Device mode: a
        zero placeholder of the LR's size; the train step makes the LR."""
        degrader = self.degrader
        if self.device_degradations:
            kernels = degrader.kernel_gen(degrader.random, 1)
            s = self.scale
            lr = np.zeros((hr_arr.shape[0] // s, hr_arr.shape[1] // s, 3), np.float32)
            return lr, degrader.encoder(kernels)[0], kernels[0].astype(np.float32)
        blurred, code, kernel = degrader(pil_to_float(hr_arr))
        _, lr_pil = downsample(float_to_pil(blurred), scale=self.scale, jm=False)
        return pil_to_float(lr_pil), code, kernel

    def __getitem__(self, index):
        """(ref: data_handler.py:433-525)"""
        base_name = self.base_filenames[index]
        image_name = self.lr_filenames[index]
        metadata = self.metadata[index] if self.metadata is not None else np.array(0)
        hr_arr = None
        if self.hr_base is not None:
            hr_arr = self._read_cached(os.path.join(self.hr_base, base_name))
        extras = {}
        if self.online_degradations:
            lr_im, code, kernel = self._degraded_lr(hr_arr)
            lr_im = self._model_space(lr_im)
            metadata = code if self.metadata is None else np.concatenate((metadata, code))
            extras['blur_kernels'] = kernel
            # the host chain blurs floats: its HR travels as float too
            hr_u8 = self.device_degradations
            lr_hw = lr_im.shape[:2]
        else:
            lr_arr = self._read_cached(os.path.join(self.lr_base, image_name))
            lr_im, hr_u8, lr_hw = self._to_image(lr_arr), True, lr_arr.shape[:2]
        hr_im = np.array(0)
        if hr_arr is not None:
            # HR alignment crop (ref: data_handler.py:471-489); an interpolated LR image
            # is already at the HR size
            factor = 1 if self.lr_type == 'interp' else self.scale
            h, w = lr_hw[0] * factor, lr_hw[1] * factor
            if hr_arr.shape[1] != w or hr_arr.shape[0] != h:
                hr_arr = center_crop_np(hr_arr, height=h, width=w)
            hr_im = self._to_image(hr_arr, uint8_ok=hr_u8)
            if self.mask_base is not None:
                mask_arr = self._read_cached(os.path.join(self.mask_base, base_name))
                if mask_arr.shape[1] != w or mask_arr.shape[0] != h:
                    mask_arr = center_crop_np(mask_arr, height=h, width=w)
                extras['mask'] = np.asarray(mask_arr)
        # the reference's order: flips and transpose, then the crop
        if self.random_augment is not None:
            lr_im, hr_im = random_flip_rotate(lr_im, hr_im)
        if self.patch_crop is not None:
            # interpolated LR images align with HR 1:1
            crop_scale = 1 if self.lr_type == 'interp' else self.scale
            if self.request_crops is not None:
                lr_im, hr_im = (np.stack(ims, 0) for ims in zip(*(
                    random_matched_crop(lr_im, hr_im, self.patch_crop, crop_scale)
                    for _ in range(self.request_crops))))
            else:
                lr_im, hr_im = random_matched_crop(lr_im, hr_im, self.patch_crop,
                                                   crop_scale)
        return {'lr': lr_im, 'hr': hr_im, 'tag': image_name,
                'hr_tag': base_name, 'metadata': np.asarray(metadata, dtype=np.float32),
                'metadata_keys': self.metadata_keys, **extras}

    def __len__(self):
        return self.image_count
