"""The controls of every cell, on the card at the cell's own size, on three seeds:
each has to come out not correct under the cell's limits (and the float8 rounding they
use, on the CPU).  Run on the card with

    python -m pytest --noconftest -m cuda benchmark/tests/test_bench_controls.py -s

(``--noconftest``: the repo's tests/conftest.py imports JAX).  Skips without a card."""
import json
import os

import pytest
import torch

from benchmark.reference.quant import E4M3_MAX, round_e4m3
from benchmark.spec import Spec
from benchmark.tests.tiny import ROOT

with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
    CELLS = [w['name'] for w in json.load(f)['workloads']]
SEEDS = (2 ** 31 + 501, 2 ** 31 + 502, 2 ** 31 + 503)


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the controls run at the cells\' own sizes')
    from benchmark.readings import readings
    rows = readings(Spec(ROOT), cell, SEEDS, control=True, seconds=0.1)
    print(json.dumps({'workload': cell, 'control': rows}))
    assert not any(row['correct'] for row in rows)


def test_e4m3_rounding():
    x = torch.linspace(-3.0, 5.0, 1001) ** 3
    y = round_e4m3(x)
    scale = x.abs().max() / E4M3_MAX
    q = y / scale
    # the largest magnitude meets 448; every value lies on the e4m3 grid, 3 bits of
    # mantissa, within half a step of where it was
    assert float(q.abs().max()) == pytest.approx(E4M3_MAX)
    assert torch.equal(q.to(torch.float8_e4m3fn).float(), q)
    normal = x.abs() >= 2.0 ** -6 * scale
    assert float(((y - x).abs() / x.abs())[normal].max()) <= 2.0 ** -4
    w = torch.stack([torch.ones(4), 1e-3 * torch.arange(1.0, 5.0)])
    assert float(round_e4m3(w, dim=0)[1].max()) == pytest.approx(4e-3)
