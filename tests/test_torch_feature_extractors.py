"""sisr_tpu_torch's feature extractors against sisr_tpu's on the CPU, on seeded weights
written to a temporary file in the torch checkpoint layouts both packages load: the
VGG19 trunk to conv5_4 (torchvision's ``features.N.*``; 2e-3 abs at 32², the bar of
tests/test_perceptual_loss.py), LightCNN-29 (``{'state_dict': {'module.…'}}``, 10
classes, with its bicubic and luma preprocess; 1e-4 abs) and VggFace (``vgg_face_dag``
names, full width at 224², one image; 1e-4 abs).  Every loader fails loudly without a
weights file, and the extractors are frozen."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sisr_tpu.models import feature_extractors as jax_fx
from sisr_tpu_torch.models import feature_extractors as fx


def _seeded(module, seed, gain=2.0):
    """``module`` with weights N(0, gain / fan_in) (He's for a ReLU net) and N(0, 0.01^2)
    biases from numpy ``seed``, so activations stay of order one through every layer."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            std = np.sqrt(gain / np.prod(p.shape[1:])) if p.dim() > 1 else 0.01
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape, dtype=np.float32) * std))
    return module


@pytest.fixture(scope='module')
def vgg_file(tmp_path_factory):
    path = tmp_path_factory.mktemp('vgg') / 'vgg19.pth'
    torch.save(_seeded(fx.VGG19Features(), 0).state_dict(), path)
    return str(path)


@pytest.fixture(scope='module')
def lightcnn_file(tmp_path_factory):
    path = tmp_path_factory.mktemp('lightcnn') / 'LightCNN_29Layers_checkpoint.pth.tar'
    # gain 0.25: the max-feature-map halves and the residual sums keep the scale bounded
    module = _seeded(fx.LightCNN29(10), 1, gain=0.25)
    state = {'module.' + k: v for k, v in module.state_dict().items()}
    torch.save({'epoch': 3, 'arch': 'LightCNN-29', 'state_dict': state}, path)
    return str(path)


@pytest.fixture(scope='module')
def vggface_file(tmp_path_factory):
    path = tmp_path_factory.mktemp('vggface') / 'vgg_face_dag.pth'
    module = _seeded(fx.VggFace(), 2)
    with torch.no_grad():  # the input is on the 0-255 scale: features of order one
        module.conv1_1.weight.mul_(0.01)
    torch.save(module.state_dict(), path)
    return str(path)


def test_vgg19_features_match_sisr_tpu(vgg_file):
    x = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32)
    ours = fx.load_vgg_extractor(vgg_file, device='cpu')
    theirs = jax_fx.load_vgg_extractor(vgg_file)
    with torch.no_grad():
        out = ours(torch.from_numpy(x)).numpy()
    ref = np.asarray(theirs(jnp.asarray(x)))
    assert out.shape == ref.shape == (2, 2, 2, 512)
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=0)
    # the trunk ends at conv5_4, before its ReLU: torchvision's features[:35]
    assert len(ours.module.features) == 35
    assert isinstance(ours.module.features[-1], torch.nn.Conv2d)
    assert not any(p.requires_grad for p in ours.module.parameters())
    assert not ours.module.training


@pytest.mark.parametrize('hw', [(128, 128), (96, 112)])
def test_lightcnn_embeddings_match_sisr_tpu(lightcnn_file, hw):
    """128² goes in as it is; another size through torch's bicubic (which sisr_tpu
    emulates), then the BT.601 luma; fc2 is not loaded."""
    x = np.random.RandomState(4).rand(2, *hw, 3).astype(np.float32)
    ours = fx.load_face_extractor('lightcnn', lightcnn_file, device='cpu')
    theirs = jax_fx.load_face_extractor('lightcnn', lightcnn_file)
    with torch.no_grad():
        out = ours(torch.from_numpy(x)).numpy()
    ref = np.asarray(theirs(jnp.asarray(x)))
    assert out.shape == ref.shape == (2, 256)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    assert ours.module.fc2 is None


def test_vggface_embeddings_match_sisr_tpu(vggface_file):
    x = np.random.RandomState(5).rand(1, 224, 224, 3).astype(np.float32)
    ours = fx.load_face_extractor('vggface', vggface_file, device='cpu')
    theirs = jax_fx.load_face_extractor('vggface', vggface_file)
    with torch.no_grad():
        out = ours(torch.from_numpy(x)).numpy()
    ref = np.asarray(theirs(jnp.asarray(x)))
    assert out.shape == ref.shape == (1, 4096) and np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_vggface_other_modes(vggface_file):
    """'p_loss' (conv5_3 before its ReLU) against sisr_tpu's module on the converted
    weights, at 32²; the class softmax is fc8's softmax of the 'recognition' features."""
    sd = torch.load(vggface_file, weights_only=True)
    params = jax_fx.convert_torch_vggface({k: v.numpy() for k, v in sd.items()})
    x = np.random.RandomState(7).rand(1, 32, 32, 3).astype(np.float32) * 255 - 128
    p_loss = fx.VggFace(mode='p_loss').eval()
    p_loss.load_state_dict(sd)
    with torch.no_grad():
        out = p_loss(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    ref = np.asarray(jax_fx.VggFace(mode='p_loss').apply({'params': params},
                                                         jnp.asarray(x)))
    assert out.shape == ref.shape == (1, 2, 2, 512)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
    module = fx.VggFace(mode='recognition').eval()
    module.load_state_dict(sd)
    x = torch.rand(1, 3, 224, 224, generator=torch.Generator().manual_seed(8)) * 255 - 128
    with torch.no_grad():
        want = torch.softmax(module.fc8(module(x)), -1)
        module.mode = 'softmax'
        probs = module(x)
    assert probs.shape == (1, 2622)
    torch.testing.assert_close(probs, want, atol=0, rtol=0)


def test_loaders_fail_without_weights(tmp_path):
    missing = str(tmp_path / 'none.pth')
    assert fx.load_vgg_extractor(missing, device='cpu') is None
    with pytest.raises(RuntimeError, match='VGG19 weights unavailable'):
        fx.perceptual_loss_mechanism('vgg', 'p_loss', missing, device='cpu')
    for name in ('lightcnn', 'vggface'):
        with pytest.raises(RuntimeError, match='No %s weights' % name):
            fx.load_face_extractor(name, missing, device='cpu')
    with pytest.raises(NotImplementedError, match='recognition'):
        fx.perceptual_loss_mechanism('vggface', 'p_loss', missing)
    with pytest.raises(NotImplementedError):
        fx.perceptual_loss_mechanism('resnet', 'p_loss', missing)


def test_perceptual_loss_mechanism_dispatches(vgg_file, lightcnn_file):
    vgg = fx.perceptual_loss_mechanism('vgg', 'p_loss', vgg_file, device='cpu')
    face = fx.perceptual_loss_mechanism('lightcnn', 'recognition', lightcnn_file,
                                        device='cpu')
    assert isinstance(vgg.module, fx.VGG19Features)
    assert isinstance(face.module, fx.LightCNN29)
