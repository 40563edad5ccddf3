"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/lib<name>-<digest>.so``, where the digest covers the source and the flags, so
a changed source never loads a stale library.  Nothing is built at import: the first
call of a kernel builds its library (``load``); ``build`` starts one nvcc per missing
library, all at once (``chip_smoke.py`` calls it up front and times it).  ``defines``
are preprocessor macros for a diagnostic build (``tools/ca_res_timeline.py``), which
gets a library of its own.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build')
SOURCES = ('channel_attention',)
DEFAULT_NVCC = '/usr/local/cuda/bin/nvcc'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LOCK = threading.Lock()
_LIBS = {}


def nvcc_path():
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then /usr/local/cuda."""
    candidates = [os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc')
                  if os.environ.get('CUDA_HOME') else None,
                  shutil.which('nvcc'), DEFAULT_NVCC]
    for cand in candidates:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, PATH and '
                       '/usr/local/cuda/bin): the CUDA kernels cannot be built.')


def source_path(name):
    return os.path.join(CSRC_DIR, name + '.cu')


def _flags(defines):
    return [*NVCC_FLAGS, *('-D' + d for d in defines)]


def library_path(name, defines=()):
    with open(source_path(name), 'rb') as f:
        digest = hashlib.sha1(f.read() + ' '.join(_flags(defines)).encode()).hexdigest()
    return os.path.join(BUILD_DIR, 'lib%s-%s.so' % (name, digest[:12]))


def nvcc_command(name, output, defines=()):
    return [nvcc_path(), *_flags(defines), '-o', output, source_path(name)]


def build(names=SOURCES, defines=()):
    """Compile every library in ``names`` that is not built yet, one nvcc process per
    source, all started together.  Returns {name: {'path', 'seconds', 'log'}}; raises
    with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    results = {}
    for name in names:
        path = library_path(name, defines)
        if os.path.isfile(path):
            results[name] = {'path': path, 'seconds': 0.0, 'log': 'cached'}
            continue
        tmp = '%s.%d.tmp' % (path, os.getpid())
        proc = subprocess.Popen(nvcc_command(name, tmp, defines), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, path, tmp, time.perf_counter())
    failures = []
    for name, (proc, path, tmp, tic) in started.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - tic
        if proc.returncode != 0:
            failures.append('%s (exit %d):\n%s' % (name, proc.returncode, log))
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
        results[name] = {'path': path, 'seconds': seconds, 'log': log}
    if failures:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failures))
    return results


def load(name, signatures, defines=()):
    """The ctypes handle of library ``name`` (built with ``defines``), built on first
    use, once per process.  ``signatures`` maps each C entry point to (restype,
    argtypes)."""
    key = (name, tuple(defines))
    with _LOCK:
        if key not in _LIBS:
            lib = ctypes.CDLL(build([name], defines)[name]['path'])
            lib.sisr_cuda_error_string.restype = ctypes.c_char_p
            lib.sisr_cuda_error_string.argtypes = [ctypes.c_int]
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[key] = lib
        return _LIBS[key]


def check(lib, code, what):
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError('%s: CUDA error %d (%s)' % (
            what, code, lib.sisr_cuda_error_string(code).decode()))
