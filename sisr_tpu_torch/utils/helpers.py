"""Small filesystem and device helpers (a subset of sisr_tpu's ``utils/helpers.py``,
plus device selection)."""
import glob
import os
import re

import torch


def atoi(text):
    return int(text) if text.isdigit() else text


def natural_keys(text):
    """Human-order sort key (ref: helper_functions.py:67-72)."""
    return [atoi(c) for c in re.split(r'(\d+)', text)]


def generate_range(limits, subdivisions):
    """Split a numeric range into ``subdivisions`` intervals' boundaries, linearly
    spaced and strictly increasing (sisr_tpu's repair of helper_functions.py:94-101,
    whose truncated step repeats boundaries on narrow ranges)."""
    if subdivisions < 1:
        raise ValueError('subdivisions must be >= 1 (got %d)' % subdivisions)
    span = limits[1] - limits[0]
    if span < subdivisions:
        raise ValueError('Range %s is too narrow for %d subdivisions — each '
                         'interval needs at least one integer.'
                         % (list(limits), subdivisions))
    steps = [limits[0] + round(i * span / subdivisions) for i in range(subdivisions + 1)]
    steps[-1] += 1
    return steps


def create_dir_if_empty(*directories):
    for directory in directories:
        os.makedirs(directory, exist_ok=True)


def extract_image_names_from_folder(folder, sorted=True, recursive=False):
    """Find all images in a folder (ref: helper_functions.py:167-177)."""
    filenames = []
    # superset of the reference's lowercase list (helper_functions.py:169):
    # camera-default .JPG/.jpeg files silently vanished on case-sensitive FSes
    for extension in ['*.jpg', '*.png', '*.bmp', '*.tif', '*.jpeg',
                      '*.JPG', '*.PNG', '*.BMP', '*.TIF', '*.JPEG']:
        if recursive:
            glob_path = os.path.join(folder, '**', extension)
        else:
            glob_path = os.path.join(folder, extension)
        filenames.extend(glob.glob(glob_path, recursive=recursive))
    if sorted:
        filenames.sort()
    return filenames


def read_metadata_list(metadata_file):
    """Read a text file of metadata key names, one per line (ref: net_train.py:10-13)."""
    with open(metadata_file, 'r') as f:
        return [label.rstrip() for label in f.readlines()]


def resolve_device(device=None):
    """The device a component runs on: ``cuda`` unless the caller names another.
    Asking for CUDA where there is none raises; there is no quiet CPU fallback."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA was requested (the default) but torch.cuda.is_available() '
                           'is False: pass device="cpu" (CLI: --no-gpu) to run on the CPU.')
    return device


def training_device(gpu=None, sp_gpu=0):
    """The device of a training run from the reference's ``gpu`` option: 'off' (or
    False) is the CPU; unset, 'single' (or True) is ``cuda:<sp_gpu>`` (device 0 when
    out of range), and raises without CUDA; 'multi' is not ported."""
    if gpu in ('off', False):
        return torch.device('cpu')
    if gpu == 'multi':
        raise NotImplementedError('gpu = "multi" (data parallelism over several cards) is '
                                  'not ported to sisr_tpu_torch yet: it comes with the '
                                  'multi-GPU slice (ROADMAP.md, Queue 1 item 9).')
    if gpu not in (None, 'single', True):
        raise ValueError("gpu must be 'off', 'single' or 'multi', got %r" % (gpu,))
    resolve_device('cuda')  # raises without CUDA
    index = int(sp_gpu or 0)
    if index >= torch.cuda.device_count():
        print('sp_gpu=%s requested but only %d device(s) visible — using device 0.'
              % (sp_gpu, torch.cuda.device_count()))
        index = 0
    return torch.device('cuda', index)
