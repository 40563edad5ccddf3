"""The benchmark of sisr_tpu_torch: one run of one cell of BENCHMARK.json, from the
root of a checkout.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs the CUDA card(s) the cell asks for (exits 2 without them).  Build and kernel
caches stay inside the checkout; the generated inputs go to ``benchmark/.work`` and
are removed at the end.  See ``harness.py`` for what a run does.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def prepare():
    """The process's paths and caches, before anything heavy is imported: the
    benchmark's modules as ``benchmark.*``, and Python's compiled bytecode of every
    module the run imports (PyTorch's thousands among them) cached inside the
    checkout at a fixed path, so that only the first run of a checkout compiles it."""
    if sys.path and os.path.abspath(sys.path[0] or '.') == HERE:
        sys.path.pop(0)
    sys.path.insert(0, os.path.dirname(HERE))
    sys.pycache_prefix = os.path.join(HERE, '.cache', 'pycache')
    sys.dont_write_bytecode = False
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(HERE, '.cache', 'triton'))
    os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                          os.path.join(HERE, '.cache', 'torch_extensions'))
    os.environ['USE_FLAX'] = '0'
    os.environ.setdefault('TQDM_DISABLE', '1')  # the program's progress bars, per pass


if __name__ == '__main__':
    T0 = time.perf_counter()
    prepare()
    from benchmark import harness
    sys.exit(harness.main(sys.argv[1:], T0))
