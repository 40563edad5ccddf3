"""Whole runs on the CPU at a tiny size (the harness's look for a card skipped): a
sound run comes out correct, and each fault a cell can have, planted in the program
underneath the harness, comes out not correct; so does the float8 control of a
bfloat16 eval cell, the plain reference in float8 e4m3 in the program's place."""
import pytest
import torch

from benchmark.harness import run_cell
from benchmark.spec import Spec
from benchmark.tests import tiny


@pytest.fixture(scope='module')
def spec(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp('bench'))
    return Spec(root, root + '/benchmark')


def _alter(out):
    """One image of the batch altered where it is produced."""
    out = out.clone()
    out[0] += 0.25
    return out


def plant(monkeypatch, fault):
    from sisr_tpu_torch.models import advanced, handlers, qmodels
    from sisr_tpu_torch.ops import quantization
    if fault == 'answer':
        for cls in (qmodels.QRCAN, advanced.EDSR):
            inner = cls.forward
            monkeypatch.setattr(cls, 'forward', lambda self, *a, f=inner: _alter(f(self, *a)))
        inner = quantization.qrcan_int8_forward_static
        monkeypatch.setattr(quantization, 'qrcan_int8_forward_static',
                            lambda *a, **k: _alter(inner(*a, **k)))
    elif fault == 'unchanged':  # every step leaves the parameters as they are
        monkeypatch.setattr(handlers.BaseHandler, 'update', lambda self: None)
    elif fault == 'half_batch':  # the loss is the mean over half of the batch
        inner = handlers.BaseHandler.forward_loss

        def half(self, batch):
            n = batch['lr'].shape[0] // 2
            return inner(self, {k: (v[:n] if torch.is_tensor(v) else v)
                                for k, v in batch.items()})
        monkeypatch.setattr(handlers.BaseHandler, 'forward_loss', half)


CASES = [('qrcan_tiny.eval_bf16', None), ('qrcan_tiny.eval_bf16', 'answer'),
         ('qrcan_tiny.eval_int8', None), ('qrcan_tiny.eval_int8', 'answer'),
         ('edsr_tiny.eval_bf16', None), ('edsr_tiny.eval_bf16', 'answer'),
         ('edsr_tiny.train_f32', None), ('edsr_tiny.train_f32', 'unchanged'),
         ('edsr_tiny.train_f32', 'half_batch'),
         ('qrcan_tiny.eval_bf16', 'control'), ('edsr_tiny.eval_bf16', 'control')]


@pytest.mark.parametrize('cell,fault', CASES, ids=lambda v: v or 'sound')
def test_fault_reads_not_correct(spec, tmp_path, monkeypatch, cell, fault):
    plant(monkeypatch, fault)
    control = spec.checks(cell)['control'] if fault == 'control' else None
    result = run_cell(spec, cell, 2 ** 31 + 99, 0.05, 0, 'cpu', work=str(tmp_path / 'w'),
                      control=control)
    assert result['correct'] is (fault is None), result['checks']
    if fault == 'unchanged':  # a state left unchanged reads 1 by the step measure
        assert result['checks']['step_gap']['value'] == pytest.approx(1.0)
