"""Native (C++) host helpers, loaded with ctypes (the port's copy of sisr_tpu's
``native`` package).

The image resampler (``fastresize.cpp``, bit-exact with Pillow's BICUBIC) and the PNG
decoder (``fastimage.cpp``, libpng) are host-side hot paths of the data pipeline and
the standard eval protocol.  Each is built with g++ on its first use in a process,
from the sources beside this file, into ``build/`` (``_<name>-<digest>.so``: the
digest covers the source and the flags, so a changed source never loads a stale
library), and each has a Python fallback: :func:`resize_bicubic_u8` and
:func:`decode_png_rgb8` return None when their library is unavailable (no compiler,
no libpng, or ``SISR_TPU_TORCH_NO_NATIVE=1``), and the caller takes its own path.  A
failed build says why, once, on stderr.
"""
import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, 'build')
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')
_LOCK = threading.Lock()
_LIBS = {}  # source name -> ctypes.CDLL, or None (tried and unavailable)
_REASONS = {}  # source name -> why it is unavailable


def library_path(src_name, extra_flags=()):
    """Where the build of ``src_name`` with ``extra_flags`` lives."""
    with open(os.path.join(_HERE, src_name), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(CXX_FLAGS + tuple(extra_flags))
                                .encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, '_%s-%s.so' % (os.path.splitext(src_name)[0], digest))


def _load_native(src_name, extra_flags, configure):
    """Build (when missing) and load a native helper, once a process.

    :param src_name: C++ source name in this directory.
    :param extra_flags: g++ arguments after the source (``['-lpng']``).
    :param configure: callable(lib) setting the restype and argtypes.
    :return: the configured CDLL, or None when it is unavailable.
    """
    if src_name in _LIBS:
        return _LIBS[src_name]
    with _LOCK:
        if src_name in _LIBS:
            return _LIBS[src_name]
        if os.environ.get('SISR_TPU_TORCH_NO_NATIVE') == '1':
            _REASONS[src_name] = 'SISR_TPU_TORCH_NO_NATIVE=1'
            _LIBS[src_name] = None
            return None
        try:
            lib_path = library_path(src_name, extra_flags)
            if not os.path.isfile(lib_path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                # a process-unique name, renamed into place: another process never
                # loads a half-written library
                tmp_path = '%s.%d.tmp' % (lib_path, os.getpid())
                cmd = ['g++', *CXX_FLAGS, os.path.join(_HERE, src_name),
                       *extra_flags, '-o', tmp_path]
                subprocess.run(cmd, check=True, capture_output=True)
                os.replace(tmp_path, lib_path)
            lib = ctypes.CDLL(lib_path)
            configure(lib)
            _LIBS[src_name] = lib
        except Exception as exc:
            # the fallback is ~10x slower: say why, once
            lines = str(exc).strip().splitlines()
            if isinstance(exc, subprocess.CalledProcessError):
                lines = (exc.stderr or b'').decode(errors='replace').strip().splitlines()
            # the compiler's first error names the cause; its last line does not
            errors = [line for line in lines if 'error' in line]
            detail = ': %s' % (errors[0] if errors else lines[-1]) if lines else ''
            _REASONS[src_name] = '%s%s' % (type(exc).__name__, detail)
            print('sisr_tpu_torch.native: %s unavailable (%s) — using the Python '
                  'fallback' % (src_name, _REASONS[src_name]), file=sys.stderr)
            _LIBS[src_name] = None
        return _LIBS[src_name]


def status():
    """{source name: 'loaded' or why not} of both helpers, loading each once."""
    out = {}
    for src_name, get in (('fastresize.cpp', get_library),
                          ('fastimage.cpp', get_image_library)):
        out[src_name] = 'loaded' if get() is not None else _REASONS.get(src_name, 'unknown')
    return out


def _configure_resize(lib):
    lib.resize_bicubic_u8.restype = ctypes.c_int
    lib.resize_bicubic_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]


def get_library():
    """The bit-exact resampler library; None if unavailable."""
    return _load_native('fastresize.cpp', [], _configure_resize)


def resize_bicubic_u8(img, out_h, out_w):
    """Native bit-exact Pillow BICUBIC resize; None if the library is unavailable.

    :param img: (H, W, C) or (H, W) uint8 array.
    """
    lib = get_library()
    if lib is None:
        return None
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    out = np.empty((out_h, out_w, c), np.uint8)
    rc = lib.resize_bicubic_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_h, out_w)
    if rc != 0:
        return None
    return out[:, :, 0] if squeeze else out


def _configure_image(lib):
    lib.fastimage_decode_png_rgb8.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.fastimage_decode_png_rgb8.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.fastimage_free.restype = None
    lib.fastimage_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]


def get_image_library():
    """The PNG decoder library; None if unavailable (no compiler or no libpng)."""
    return _load_native('fastimage.cpp', ['-lpng'], _configure_image)


def decode_png_rgb8(path):
    """Decode an 8-bit PNG to an (H, W, 3) uint8 array with libpng.

    PNG is lossless, so the pixels are those of ``PIL.Image.open(path).convert('RGB')``:
    palette, grey and alpha images are converted in the C++ transform chain.  A 16-bit
    file returns None (PIL's lossy ``I;16 -> RGB`` conversion is not what libpng's
    transforms give), as does anything it cannot decode: the caller falls back to
    PIL.
    """
    lib = get_image_library()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    buf = lib.fastimage_decode_png_rgb8(os.fsencode(path), ctypes.byref(w), ctypes.byref(h))
    if not buf:
        return None
    try:
        arr = np.ctypeslib.as_array(buf, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.fastimage_free(buf)
    return arr
