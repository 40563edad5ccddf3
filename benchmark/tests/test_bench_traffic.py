"""The generator: each mix's inputs and weights are the same for a seed and differ
between seeds (at a tiny size, on the CPU)."""
import glob
import json
import os

import numpy as np
import pytest
import torch

from benchmark import workload
from benchmark.reference import edsr, qrcan
from benchmark.tests.tiny import BENCH

MIXES = sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(BENCH, 'traffic',
                                                                         '*.json')))


def _tiny(mix):
    with open(os.path.join(BENCH, 'traffic', mix + '.json')) as f:
        traffic = json.load(f)
    traffic.update(images=3, lr_size=12, content={'grid': 4, 'rectangles': 3, 'noise': 3.0})
    return traffic


def _pairs(tmp_path, mix, seed, tag):
    return workload.write_pairs(str(tmp_path / ('%s_%d_%s' % (mix, seed, tag))), _tiny(mix),
                                10, seed, 'cpu')


@pytest.mark.parametrize('mix', MIXES)
def test_mix_is_deterministic_per_seed(tmp_path, mix):
    seed = 2 ** 31 + 12345  # seeds may pass 32 signed bits
    a, b = _pairs(tmp_path, mix, seed, 'a'), _pairs(tmp_path, mix, seed, 'b')
    c = _pairs(tmp_path, mix, seed + 1, 'c')
    for key in ('lr', 'hr', 'metadata'):
        assert np.array_equal(a[key], b[key])
        assert not np.array_equal(a[key], c[key])
    with open(os.path.join(a['lr_dir'], 'degradation_metadata.csv')) as f:
        assert f.readline().strip() == 'image,blur_kernel'
    assert sorted(os.listdir(a['hr_dir'])) == a['names']
    # structured content, not noise: neighbouring pixels mostly agree
    hr = a['hr'].astype(int)
    assert np.median(np.abs(np.diff(hr, axis=2))) < 8


@pytest.mark.parametrize('module,sizes', [
    (qrcan, {'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 16,
             'num_metadata': 10}),
    (edsr, {'num_blocks': 2, 'num_features': 16})])
def test_weights_are_deterministic_per_seed(module, sizes):
    shapes = module.param_shapes(sizes)
    a, b = workload.weights(shapes, 7, 'cpu'), workload.weights(shapes, 7, 'cpu')
    c = workload.weights(shapes, 8, 'cpu')
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not any(torch.equal(a[k], c[k]) for k in a)
    for key, shape, fan_in in shapes:
        assert tuple(a[key].shape) == shape
        assert a[key].abs().max() <= 1 / np.sqrt(fan_in)
