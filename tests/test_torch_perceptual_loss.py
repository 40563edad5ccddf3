"""sisr_tpu_torch's perceptual (VGG54) loss against sisr_tpu's on the CPU, on one seeded
torchvision-layout VGG19 file: the loss's value, its L1-override warning and its
refusal without an extractor; 3 train steps of a 2 x 2, 16-feature RCAN with the term
in both packages (within rtol 2e-4, PR 6's bar); the term only in training, on frozen
VGG weights; in bf16 training the term runs in float32, as sisr_tpu's does."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sisr_tpu.models.feature_extractors import load_vgg_extractor as jax_load_vgg
from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu.training.losses import build_loss as jax_build_loss
from sisr_tpu_torch.models.feature_extractors import VGG19Features, load_vgg_extractor
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.training.losses import build_loss

RCAN = {'scale': 2, 'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 4,
        'lr': 1e-3}


@pytest.fixture(scope='module')
def vgg_file(tmp_path_factory):
    """VGG19 to conv5_4 with He-scaled weights from numpy seed 0 (features of order
    one), in torchvision's layout."""
    module = VGG19Features()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in module.parameters():
            std = np.sqrt(2.0 / np.prod(p.shape[1:])) if p.dim() > 1 else 0.01
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape, dtype=np.float32) * std))
    path = tmp_path_factory.mktemp('vgg') / 'vgg19.pth'
    torch.save(module.state_dict(), path)
    return str(path)


@pytest.mark.parametrize('lam', [0.01, 1.0])
def test_perceptual_loss_value_matches_sisr_tpu(vgg_file, lam):
    rng = np.random.RandomState(1)
    pred, target = (rng.rand(2, 32, 32, 3).astype(np.float32) for _ in range(2))
    ours = build_loss('l1', perceptual=lam, vgg_apply=load_vgg_extractor(vgg_file,
                                                                          device='cpu'))
    theirs = jax_build_loss('l1', perceptual=lam, vgg_apply=jax_load_vgg(vgg_file))
    got = float(ours(torch.from_numpy(pred), torch.from_numpy(target)))
    want = float(np.asarray(theirs(jnp.asarray(pred), jnp.asarray(target))))
    assert got == pytest.approx(want, rel=2e-4)


def test_l1_override_warning_and_missing_extractor(vgg_file, capsys):
    vgg = load_vgg_extractor(vgg_file, device='cpu')
    build_loss('mse', perceptual=0.1, vgg_apply=vgg)
    ours = capsys.readouterr().out
    jax_build_loss('mse', perceptual=0.1, vgg_apply=jax_load_vgg(vgg_file))
    assert ours == capsys.readouterr().out and 'overrides the configured' in ours
    with pytest.raises(RuntimeError, match='no VGG feature extractor'):
        build_loss('l1', perceptual=0.1)
    with pytest.raises(RuntimeError, match='no VGG feature extractor'):
        define_model('rcan', device='cpu', perceptual=0.1, vgg_weights='/nonexistent.pth',
                     **RCAN)


def test_train_steps_match_sisr_tpu(vgg_file):
    """3 steps with the term (lambda 1.0), the same batches and initial weights (the
    port's, through sisr_tpu's converter): the losses within rtol 2e-4."""
    port = define_model('rcan', device='cpu', seed=3, perceptual=1.0, vgg_weights=vgg_file,
                        **RCAN)
    sd = {k: v.detach().numpy().copy() for k, v in port.module.state_dict().items()}
    theirs = jax_define_model('rcan', eval_mode=False, perceptual=1.0, vgg_weights=vgg_file,
                              **RCAN)
    theirs.init_state(spatial=(16, 16), batch=2)
    theirs.state = theirs.state.replace(params=convert_torch_state_dict(
        'rcan', sd, scale=2, n_resgroups=2, n_resblocks=2))
    rng = np.random.RandomState(2)
    ours, ref = [], []
    for _ in range(3):
        batch = {'lr': rng.rand(2, 16, 16, 3).astype(np.float32),
                 'hr': rng.rand(2, 32, 32, 3).astype(np.float32)}
        ours.append(float(port.run_train(**batch)[0]))
        ref.append(float(np.asarray(theirs.run_train(**batch)[0])))
    np.testing.assert_allclose(ours, ref, rtol=2e-4)
    assert ours[-1] != ours[0]


def test_term_in_training_only_on_frozen_weights(vgg_file):
    """An eval handler takes no term and needs no weights; a training handler's VGG is
    frozen (no grad, eval mode, outside the optimizer) and stays as loaded."""
    evaluator = define_model('rcan', device='cpu', eval_mode=True, perceptual=0.1,
                             vgg_weights='/nonexistent.pth', **RCAN)
    assert evaluator.loss_fn is build_loss('l1')
    handler = define_model('rcan', device='cpu', perceptual=0.1, vgg_weights=vgg_file,
                           **RCAN)
    vgg = handler.loss_fn.vgg_apply.module
    assert isinstance(vgg, VGG19Features) and not vgg.training
    assert not any(p.requires_grad for p in vgg.parameters())
    before = {k: v.clone() for k, v in vgg.state_dict().items()}
    optimized = {id(p) for g in handler.optimizer.param_groups for p in g['params']}
    assert not optimized & {id(p) for p in vgg.parameters()}
    rng = np.random.RandomState(3)
    handler.run_train(lr=rng.rand(2, 16, 16, 3).astype(np.float32),
                      hr=rng.rand(2, 32, 32, 3).astype(np.float32))
    for k, v in vgg.state_dict().items():
        assert torch.equal(v, before[k])


def test_bf16_training_runs_the_term_in_float32(vgg_file):
    """Under the bf16 autocast of the train step (sisr_tpu's f32 extractor), every VGG
    conv takes float32; the step is finite."""
    handler = define_model('rcan', device='cpu', dtype='bf16', perceptual=1.0,
                           vgg_weights=vgg_file, **RCAN)
    vgg = handler.loss_fn.vgg_apply.module
    seen = set()
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.add(args[0].dtype))
             for m in vgg.modules() if isinstance(m, torch.nn.Conv2d)]
    rng = np.random.RandomState(4)
    loss = handler.run_train(lr=rng.rand(2, 16, 16, 3).astype(np.float32),
                             hr=rng.rand(2, 32, 32, 3).astype(np.float32))[0]
    for hook in hooks:
        hook.remove()
    assert seen == {torch.float32} and torch.isfinite(loss)
