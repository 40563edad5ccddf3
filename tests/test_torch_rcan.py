"""sisr_tpu_torch's RCAN against sisr_tpu's on the same weights (carried over by the
weights bridge) in f32, the bridge's round trip through sisr_tpu's own converter, and
the port's checkpoint contract."""
import os

import numpy as np
import pytest
import torch

import jax

from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.tools.convert_weights import state_dict_from_jax

RCAN = {'scale': 4, 'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 32, 'reduction': 16}


@pytest.fixture(scope='module')
def jax_params():
    handler = jax_define_model('rcan', eval_mode=True, **RCAN)
    handler.init_state(spatial=(16, 16))
    return handler, jax.tree.map(np.asarray, handler.state.params)


def _port(params, **kwargs):
    handler = define_model('rcan', device='cpu', **{**RCAN, **kwargs})
    handler.module.load_state_dict(state_dict_from_jax('rcan', params))
    return handler


def test_forward_matches_sisr_tpu_f32(jax_params):
    jax_handler, params = jax_params
    x = np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32)
    theirs = np.asarray(jax_handler.state.apply_fn({'params': jax_handler.state.params}, x))
    with torch.inference_mode():
        ours = _port(params).forward(torch.from_numpy(x)).numpy()
    assert ours.shape == theirs.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(ours, theirs, atol=5e-4, rtol=0)


def test_bf16_autocast_forward_tracks_f32(jax_params):
    _, params = jax_params
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 16, 16, 3).astype(np.float32))
    with torch.inference_mode():
        f32 = _port(params).forward(x)
        bf16 = _port(params, dtype='bf16').forward(x)
    assert bf16.dtype == torch.bfloat16
    assert torch.isfinite(bf16.float()).all()
    assert (bf16.float() - f32).abs().max().item() < 5e-2


def test_bridge_round_trips_through_sisr_tpu_converter(jax_params):
    _, params = jax_params
    state = {k: v.numpy() for k, v in _port(params).module.state_dict().items()}
    back = convert_torch_state_dict('rcan', state, n_resgroups=2, n_resblocks=2, scale=4)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_bridge_rejects_mismatched_trees(jax_params):
    _, params = jax_params
    extra = {**params, 'stray': {'kernel': np.zeros(1)}}
    with pytest.raises(RuntimeError, match='unconsumed'):
        state_dict_from_jax('rcan', extra)
    missing = {k: v for k, v in params.items() if k != 'tail'}
    with pytest.raises(KeyError, match='tail'):
        state_dict_from_jax('rcan', missing)
    with pytest.raises(NotImplementedError):
        state_dict_from_jax('edsr', params)


def test_seeded_init_checkpoint_round_trip(tmp_path):
    a = define_model('rcan', device='cpu', seed=3, **RCAN)
    b = define_model('rcan', device='cpu', seed=3, **RCAN)
    c = define_model('rcan', device='cpu', seed=4, **RCAN)
    sa, sb, sc = (h.module.state_dict() for h in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa['head.0.weight'], sc['head.0.weight'])
    bound = 1 / np.sqrt(3 * 9)  # torch's Conv2d default: U(-1/sqrt(fan_in), ...)
    assert sa['head.0.weight'].abs().max() <= bound

    a.set_epoch(7)
    a.save_model('train_model', 7, str(tmp_path))
    saved = torch.load(os.path.join(tmp_path, 'train_model_7'), weights_only=True)
    assert {'network', 'model_name', 'model_epoch', 'step'} <= set(saved)
    assert saved['model_name'] == 'rcan' and saved['model_epoch'] == 7
    assert 'body.1.body.0.body.3.conv_du.2.weight' in saved['network']
    c.load_model('train_model', 7, str(tmp_path))
    assert c.curr_epoch == 7
    assert all(torch.equal(sa[k], c.module.state_dict()[k]) for k in sa)
