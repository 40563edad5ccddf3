"""Small filesystem and device helpers (the eval subset of sisr_tpu's
``utils/helpers.py``, plus device selection)."""
import glob
import os

import torch


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


def resolve_device(device=None):
    """The device a component runs on: ``cuda`` unless the caller names another.
    Asking for CUDA where there is none raises; there is no quiet CPU fallback."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA was requested (the default) but torch.cuda.is_available() '
                           'is False: pass device="cpu" (CLI: --no-gpu) to run on the CPU.')
    return device
