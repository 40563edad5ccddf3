"""sisr_tpu_torch's native host helpers (``sisr_tpu_torch/native``: the Pillow-exact
bicubic resampler and the libpng decoder, built with g++ from the package's own
sources) against PIL and against sisr_tpu's ``native`` package, on the CPU: the resize
at the sizes of the standard protocol (a DIV2K validation image's 510 x 339 LR map to
2040 x 1356 and back, 128^2 -> 512^2), for 1 and 3 channels, bit-equal; PNG decoding of
8-bit RGB, palette, grey and alpha images bit-equal to PIL's ``convert('RGB')``, 16-bit
PNGs left to PIL; the ``SISR_TPU_TORCH_NO_NATIVE=1`` switch and a failed build, each
falling back to the Python path with the same pixels."""
import os

import numpy as np
import pytest
from PIL import Image

from sisr_tpu import native as jax_native
from sisr_tpu_torch import native
from sisr_tpu_torch.data.datasets import SuperResImages
from sisr_tpu_torch.ops import resize

# (in (h, w), out (h, w)): the re-anchor's three cases
CASES = [((339, 510), (1356, 2040)), ((128, 128), (512, 512)), ((1356, 2040), (339, 510))]


def _image(hw, channels, seed=0):
    shape = hw if channels == 1 else hw + (channels,)
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def test_both_helpers_load_from_the_package_sources():
    assert native.status() == {'fastresize.cpp': 'loaded', 'fastimage.cpp': 'loaded'}
    for src, flags in (('fastresize.cpp', ()), ('fastimage.cpp', ('-lpng',))):
        path = native.library_path(src, flags)
        assert path.startswith(native.BUILD_DIR) and path.endswith('.so')
        assert native._LIBS[src]._name == path


@pytest.mark.parametrize('channels', [1, 3])
@pytest.mark.parametrize('case', CASES, ids=['510x339_up', '128_up', '2040x1356_down'])
def test_resize_uint8_bit_equal_to_pil_and_sisr_tpu(case, channels):
    (h, w), (out_h, out_w) = case
    img = _image((h, w), channels)
    ours = resize.resize_uint8(img, (out_w, out_h))
    direct = native.resize_bicubic_u8(img, out_h, out_w)
    pil = np.asarray(Image.fromarray(img).resize((out_w, out_h), Image.BICUBIC))
    theirs = jax_native.resize_bicubic_u8(img, out_h, out_w)
    assert theirs is not None, 'sisr_tpu.native did not load'
    assert ours.dtype == np.uint8 and ours.shape == pil.shape
    for other in (direct, pil, theirs):
        np.testing.assert_array_equal(ours, other)


def test_no_native_switch_takes_the_numpy_loop(monkeypatch):
    """With SISR_TPU_TORCH_NO_NATIVE=1 neither library loads (the reason is kept for
    status()), and resize_uint8 and read_image give the same pixels through numpy and
    PIL."""
    monkeypatch.setattr(native, '_LIBS', {})
    monkeypatch.setattr(native, '_REASONS', {})
    monkeypatch.setenv('SISR_TPU_TORCH_NO_NATIVE', '1')
    assert native.resize_bicubic_u8(_image((8, 8), 3), 4, 4) is None
    assert native.status() == dict.fromkeys(('fastresize.cpp', 'fastimage.cpp'),
                                            'SISR_TPU_TORCH_NO_NATIVE=1')
    img = _image((64, 48), 3, seed=1)
    pil = np.asarray(Image.fromarray(img).resize((192, 256), Image.BICUBIC))
    np.testing.assert_array_equal(resize.resize_uint8(img, (192, 256)), pil)


def test_a_failed_build_says_why_once_and_falls_back(monkeypatch, capsys):
    monkeypatch.setattr(native, '_LIBS', {})
    monkeypatch.setattr(native, '_REASONS', {})
    monkeypatch.delenv('SISR_TPU_TORCH_NO_NATIVE', raising=False)
    assert native._load_native('no_such_source.cpp', [], lambda lib: None) is None
    assert native._load_native('no_such_source.cpp', [], lambda lib: None) is None
    err = capsys.readouterr().err
    assert err.count('no_such_source.cpp unavailable (FileNotFoundError') == 1
    assert 'using the Python fallback' in err


def test_a_failed_compile_names_the_compilers_first_error(tmp_path, monkeypatch, capsys):
    """A source g++ cannot compile (a header the host lacks, as libpng's on a host
    without it) is reported by the compiler's first error line, not its last."""
    (tmp_path / 'needs_header.cpp').write_text('#include <no_such_header_here.h>\n')
    monkeypatch.setattr(native, '_HERE', str(tmp_path))
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(native, '_LIBS', {})
    monkeypatch.setattr(native, '_REASONS', {})
    monkeypatch.delenv('SISR_TPU_TORCH_NO_NATIVE', raising=False)
    assert native._load_native('needs_header.cpp', [], lambda lib: None) is None
    reason = native._REASONS['needs_header.cpp']
    assert reason.startswith('CalledProcessError: ') and 'no_such_header_here.h' in reason
    assert 'fatal error' in reason and reason in capsys.readouterr().err
    assert not os.listdir(str(tmp_path / 'build'))  # nothing half-built left in place


def _png(tmp_path, name, mode, seed=2, size=(23, 17)):
    """A PNG of ``mode`` (PIL's names; 'I;16' a 16-bit grey image) with seeded
    pixels."""
    rng = np.random.RandomState(seed)
    w, h = size
    if mode == 'P':
        im = Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).convert(
            'P', palette=Image.ADAPTIVE, colors=37)
    elif mode == 'I;16':
        im = Image.fromarray(rng.randint(0, 65536, (h, w)).astype(np.uint16))
    else:
        channels = {'RGB': 3, 'RGBA': 4, 'L': 1, 'LA': 2}[mode]
        arr = rng.randint(0, 256, (h, w, channels)).astype(np.uint8)
        im = Image.fromarray(arr[..., 0] if channels == 1 else arr, mode)
    path = str(tmp_path / name)
    im.save(path)
    return path


def _pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'), np.uint8)


@pytest.mark.parametrize('mode', ['RGB', 'P', 'L', 'RGBA', 'LA'])
def test_read_image_decodes_8bit_pngs_natively_bit_equal_to_pil(tmp_path, mode,
                                                                monkeypatch):
    path = _png(tmp_path, 'im_%s.png' % mode, mode)
    with Image.open(path) as im:
        assert im.mode == mode
    calls = []
    decode = native.decode_png_rgb8
    monkeypatch.setattr(native, 'decode_png_rgb8',
                        lambda p: calls.append(decode(p) is not None) or decode(p))
    ours = SuperResImages.read_image(path)
    assert calls == [True]  # the native decoder took the file
    assert ours.dtype == np.uint8 and ours.shape == (17, 23, 3)
    np.testing.assert_array_equal(ours, _pil_rgb(path))
    np.testing.assert_array_equal(ours, jax_native.decode_png_rgb8(path))


def test_16bit_png_goes_to_pil(tmp_path):
    path = _png(tmp_path, 'deep.png', 'I;16')
    assert native.decode_png_rgb8(path) is None
    np.testing.assert_array_equal(SuperResImages.read_image(path), _pil_rgb(path))


def test_read_image_without_native_is_pil(tmp_path, monkeypatch):
    path = _png(tmp_path, 'im.png', 'P')
    monkeypatch.setattr(native, '_LIBS', {})
    monkeypatch.setenv('SISR_TPU_TORCH_NO_NATIVE', '1')
    assert native.decode_png_rgb8(path) is None
    np.testing.assert_array_equal(SuperResImages.read_image(path), _pil_rgb(path))
