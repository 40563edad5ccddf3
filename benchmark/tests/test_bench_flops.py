"""The frozen FLOP formulas against the program's own (``tools/flops.py``) at the
cells' shapes, and the training count against the conv list."""
import json
import os

import pytest

from benchmark import flops
from benchmark.tests.tiny import BENCH


def _config(name):
    with open(os.path.join(BENCH, 'configs', name + '.json')) as f:
        return json.load(f)


@pytest.mark.parametrize('lr', [128, 64])
def test_formulas_equal_the_programs(lr):
    from sisr_tpu_torch.tools import flops as program
    q, e = _config('qrcan')['sizes'], _config('edsr')['sizes']
    assert flops.forward_flops('qrcan', q, lr) == program.qrcan_flops_per_image(
        lr, 64, 10, 20, 4, 16, num_metadata=10)
    assert flops.forward_flops('edsr', e, lr) == program.edsr_flops_per_image(lr, 256, 32, 4)
    assert flops.rcan_flops_per_image(lr) == program.rcan_flops_per_image(lr)


@pytest.mark.parametrize('family', ['qrcan', 'edsr'])
def test_conv_list_sums_to_the_forward(family):
    sizes = _config(family)['sizes']
    convs = sum(flops._conv(*c) for c in flops.convs(family, sizes, 128))
    total = flops.forward_flops(family, sizes, 128)
    # what the conv list leaves out is the attention's vector products only
    assert 0 <= total - convs < 1e-4 * total
    if family == 'edsr':
        assert convs == total


def test_train_flops_counts_no_first_input_gradient():
    sizes = _config('edsr')['sizes']
    fwd = flops.forward_flops('edsr', sizes, 64)
    head = flops._conv(64, 3, 256)
    assert flops.train_flops('edsr', sizes, 64) == 3 * fwd - head
    # a crop of 64^2 through EDSR 256f/32b: about 1.24 TFLOP
    assert 1.2e12 < flops.train_flops('edsr', sizes, 64) < 1.3e12


def test_bounds_take_the_larger_of_operations_and_bytes():
    layers = [(128, 64, 64, 3)]
    ops = 2.0 * 128 * 128 * 64 * 64 * 9
    moved = 128 * 128 * (64 + 64 * 2) + 64 * 64 * 9
    assert flops.conv_bound_s(layers, 1, 1, 2, 1e15, 1e12) == max(ops / 1e15, moved / 1e12)
    assert flops.ca_bytes(2, 4, 4, 64, 2, 16, gate=True) == \
        2 * 2 * 16 * 64 * 2 + 4 * (64 * 4 + 4 + 4 * 64 + 64) + 4 * 2 * 64
