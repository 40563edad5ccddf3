"""sisr_tpu_torch's image_manipulate (tools/data_converter.py) against sisr_tpu's on the
CPU, the same source images and seed through both CLIs: blur-downscale (PNGs within
one uint8 LSB, degradation_metadata.csv within 1e-6, the PCA matrix), downscale-
jpeg_compress and upscale (PNGs byte-equal), and jm_compress through a fake JM encoder
(as tests/test_jm_yuv.py drives sisr_tpu's); the YUV 4:2:0 conversion's golden values
and sisr_tpu's bytes; create_h5 where h5py is installed."""
import json
import os
import stat

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from sisr_tpu.configuration import constants as jax_constants
from sisr_tpu.ops import degradations as jax_degradations
from sisr_tpu.tools import data_converter as jax_converter
from sisr_tpu_torch.configuration import constants
from sisr_tpu_torch.ops import degradations
from sisr_tpu_torch.tools import data_converter

FAKE_LENCOD = r"""#!/usr/bin/env python3
# a fake JM lencod: reads the -p key=value arguments the real binary takes
import sys
params = {}
args = sys.argv[1:]
for i, a in enumerate(args):
    if a == '-p':
        k, v = args[i + 1].split('=', 1)
        params[k] = v
h, w = int(params['SourceHeight']), int(params['SourceWidth'])
step = max(1, int(params['QPISlice']) // 4)
with open(params['InputFile'], 'rb') as f:
    data = bytearray(f.read(h * w * 3 // 2))
for i in range(h * w):  # 'compress': quantise the Y plane by the QPI
    data[i] = (data[i] // step) * step
with open(params['ReconFile'], 'wb') as f:
    f.write(bytes(data))
for key in ('OutputFile', 'StatsFile'):
    with open(params[key], 'w') as f:
        f.write(key)
"""


def _fewer_draws(draw):
    """``draw`` making at most 2000 kernels, repeated to the batch asked for."""
    def few(batch, **kwargs):
        kernels = draw(min(batch, 2000), **kwargs)
        return np.concatenate([kernels] * -(-batch // len(kernels)))[:batch]
    return few


@pytest.fixture
def sources(tmp_path, monkeypatch):
    """Three source images (one of odd size) and, for both packages, a fake JM tree and
    2000 kernel draws repeated for the PCA's 30000 (both sides alike: the draw order is
    kept)."""
    src = tmp_path / 'src'
    src.mkdir()
    rng = np.random.RandomState(5)
    for name, (h, w) in (('alpha', (48, 40)), ('beta', (40, 56)), ('gamma', (45, 37))):
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            src / (name + '.png'))
    jm_bin = tmp_path / 'fake_repo' / 'JM' / 'bin'
    jm_bin.mkdir(parents=True)
    lencod = jm_bin / 'lencod.exe'
    lencod.write_text(FAKE_LENCOD)
    lencod.chmod(lencod.stat().st_mode | stat.S_IXUSR)
    (jm_bin / 'encoder_baseline.cfg').write_text('# fake cfg\n')
    for module, kernels in ((constants, degradations), (jax_constants, jax_degradations)):
        monkeypatch.setattr(module, 'base_directory', str(tmp_path / 'fake_repo' / 'pkg'))
        monkeypatch.setattr(kernels, 'random_batch_kernel',
                            _fewer_draws(kernels.random_batch_kernel))
    return str(src)


def _run(tmp_path, sources, *args):
    outs = {}
    for package, module in (('port', data_converter), ('ref', jax_converter)):
        out = str(tmp_path / package)
        module.manipulation_hub.main(args=['--source_dir', sources, '--output_dir', out,
                                           *args], standalone_mode=False)
        outs[package] = out
    return outs


def _images(folder):
    return {f: np.asarray(Image.open(os.path.join(folder, f)), np.int16)
            for f in sorted(os.listdir(folder)) if f.endswith('.png')}


def _csv(folder):
    return pd.read_csv(os.path.join(folder, 'degradation_metadata.csv'), index_col=0)


def test_blur_downscale_matches_sisr_tpu(tmp_path, sources):
    outs = _run(tmp_path, sources, '--pipeline', 'blur-downscale', '--seed', '3',
                '--scale', '2', '--save_original_kernel')
    ours, theirs = _images(outs['port']), _images(outs['ref'])
    assert sorted(ours) == sorted(theirs) == ['alpha.png', 'beta.png', 'gamma.png']
    for name in ours:
        assert ours[name].shape == theirs[name].shape
        assert np.abs(ours[name] - theirs[name]).max() <= 1, name
    a, b = _csv(outs['port']), _csv(outs['ref'])
    assert list(a.columns) == list(b.columns) == ['blur_kernel', 'unmodified_blur_kernel']
    assert list(a.index) == list(b.index)
    for column in a.columns:
        np.testing.assert_allclose(np.stack(a[column].map(json.loads)),
                                   np.stack(b[column].map(json.loads)), atol=1e-6, rtol=0)
    pca = [torch.load(os.path.join(o, 'pca_matrix.pth'), weights_only=True)
           for o in outs.values()]
    torch.testing.assert_close(pca[0], pca[1], atol=1e-6, rtol=0)


@pytest.mark.parametrize('pipeline', ['downscale-jpeg_compress', 'upscale'])
def test_lossless_pipelines_are_byte_equal(tmp_path, sources, pipeline):
    outs = _run(tmp_path, sources, '--pipeline', pipeline, '--scale', '3',
                '--jpeg_quality', '45')
    ours, theirs = _images(outs['port']), _images(outs['ref'])
    assert sorted(ours) == sorted(theirs) and len(ours) == 3
    for name in ours:
        np.testing.assert_array_equal(ours[name], theirs[name])
    if 'jpeg' in pipeline:
        pd.testing.assert_frame_equal(_csv(outs['port']), _csv(outs['ref']))
        assert set(_csv(outs['port'])['jpeg_quality']) == {45}
    else:
        assert not os.path.exists(os.path.join(outs['port'], 'degradation_metadata.csv'))


def test_jm_compress_through_a_fake_encoder(tmp_path, sources):
    outs = _run(tmp_path, sources, '--pipeline', 'downscale-jm_compress', '--scale', '2',
                '--random_compression', '--compression_range', '10', '40',
                '--qpi_divisions', '2', '--seed', '4')
    ours, theirs = _images(outs['port']), _images(outs['ref'])
    assert sorted(ours) == sorted(theirs) and len(ours) == 6 and 'alpha_q1.png' in ours
    for name in ours:
        np.testing.assert_array_equal(ours[name], theirs[name])
    pd.testing.assert_frame_equal(_csv(outs['port']), _csv(outs['ref']))
    assert not [f for f in os.listdir(outs['port']) if f.startswith('vid_')]
    with pytest.raises(RuntimeError, match='QPI cannot be larger than 51'):
        _run(tmp_path / 'bad', sources, '--pipeline', 'jm_compress', '--jm_qpi', '52')


def test_yuv420p_matches_sisr_tpu():
    def one(rgb):
        data = data_converter.rgb_to_yuv420p(np.tile(np.array(rgb, np.uint8), (2, 2, 1)))
        return data[0], data[4], data[5]
    assert one((255, 255, 255)) == (235, 128, 128)
    assert one((0, 0, 0)) == (16, 128, 128)
    assert one((255, 0, 0)) == (81, 90, 240)
    assert one((0, 255, 0)) == (145, 54, 34)
    assert one((0, 0, 255)) == (41, 240, 110)
    img = np.random.RandomState(6).randint(0, 256, (17, 22, 3)).astype(np.uint8)
    data = data_converter.rgb_to_yuv420p(img)
    assert data == jax_converter.rgb_to_yuv420p(img) and len(data) == 16 * 22 * 3 // 2
    np.testing.assert_array_equal(data_converter.yuv420p_to_rgb(data, 16, 22),
                                  jax_converter.yuv420p_to_rgb(data, 16, 22))


def test_create_h5(tmp_path, sources):
    h5py = pytest.importorskip('h5py')
    folder = tmp_path / 'same'
    folder.mkdir()
    rng = np.random.RandomState(7)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (8, 6, 3)).astype(np.uint8)).save(
            folder / ('%d.png' % i))
    path = data_converter.create_h5(str(folder), str(tmp_path / 'set.h5'))
    with h5py.File(path, 'r') as f:
        assert f['images'].shape == (2, 8, 6, 3) and f['images'].dtype == np.uint8
