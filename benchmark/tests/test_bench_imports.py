"""Nothing the benchmark runs imports JAX, its libraries or the JAX package
(``sisr_tpu``; top-level names compared whole, so ``sisr_tpu_torch`` passes), and the
reference imports nothing of the program."""
import ast
import glob
import os
import subprocess
import sys

import pytest

from benchmark.harness import FORBIDDEN
from benchmark.tests.tiny import BENCH, ROOT

SOURCES = sorted(glob.glob(os.path.join(BENCH, '**', '*.py'), recursive=True))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    tops = {name.split('.')[0] for name in _imports(path)}
    assert not tops & set(FORBIDDEN)
    if os.sep + 'reference' + os.sep in path:
        assert 'sisr_tpu_torch' not in tops


def test_forbidden_names_are_compared_whole():
    from benchmark.harness import forbidden_modules
    assert forbidden_modules(['sisr_tpu_torch.models', 'jaxtyping', 'flaxen', 'os']) == []
    assert forbidden_modules(['sisr_tpu.ops', 'jax.numpy', 'optax']) == \
        ['jax', 'optax', 'sisr_tpu']


def test_harness_and_program_load_no_jax():
    """In a fresh process: the harness, every job, the reference and the program's
    modules that the jobs drive leave no forbidden module loaded."""
    code = ('import sys; sys.path.insert(0, %r)\n'
            'import benchmark.harness, benchmark.readings, benchmark.jobs.eval, '
            'benchmark.jobs.train\n'
            'import benchmark.reference.qrcan, benchmark.reference.edsr\n'
            'import sisr_tpu_torch.evaluation.standard_eval, '
            'sisr_tpu_torch.training.handler\n'
            'from benchmark.harness import forbidden_modules\n'
            'print(forbidden_modules())' % ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS='cpu'), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'
