"""sisr_tpu_torch's SFTMD against sisr_tpu's on the same weights, on the CPU.  Models: 2
SFT residual blocks of 16 features, 4x (one case 2x), on 10 blur-kernel values (the
``weak`` SFT type, which multiplies the features by the maps, on one qpi value), in
every SFT variant: ``standard`` (with ``mask_para``, with ``repeats``), ``concat``,
``weak``, ``none``, with ``q_injection`` (2 and 3 gate layers) and with
``concat_strategy`` (the maps also concatenated onto the LR image; with q-injection
too).

Each case holds: the SFT layers and a residual block against sisr_tpu's modules; the
f32 forward; the bf16 autocast (the maps in the features' type); the fused eval (f32
and bf16); eval_sisr --fused_eval and the standard protocol end to end;
--eval_buckets against the unbucketed run (the maps are non-zero in the pad); the
weights bridge through sisr_tpu's converter; an aged checkpoint's keys (before the
``sft_module`` nesting, with dead ``sft_branch`` entries) loading strictly; the
full-size models' keys and shapes; training against sisr_tpu's and train_sisr on the
shipped recipe's model.  int8 is in test_torch_int8_sftmd.py.

Bars: the layers and the forward 5e-4 abs in f32 (the layers 1e-5); PSNR within 0.01
dB and SSIM within 1e-3 per image; bucketed against unbucketed 2e-6; training losses
rtol 2e-4, parameters 5e-5 after the steps."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sisr_tpu.models import sftmd as jax_sftmd
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch.models import sftmd
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.tools.convert_weights import (params_from_state_dict,
                                                  repair_reference_keys, state_dict_from_jax)
from test_torch_srmd import (MIXED_HR, assert_metric_rows, bucketed_against_unbucketed,
                             cli_against_sisr_tpu, forward_both, inputs, jax_handler,
                             mixed, params_of, port_handler, recipe_internal,
                             train_sisr_on_recipe, trajectory_against_sisr_tpu, uint8_batch)

BASE = {'scale': 4, 'num_features': 16, 'num_blocks': 2, 'metadata': ['blur_kernel']}
CASES = {
    'standard': ('sftmd', BASE),
    'mask_para': ('sftmd', {**BASE, 'mask_para': True}),
    'repeats': ('sftmd', {**BASE, 'repeats': 2}),
    'concat': ('sftmd', {**BASE, 'sft_type': 'concat'}),
    'weak': ('sftmd', {**BASE, 'SFT_type': 'weak', 'metadata': ['qpi'], 'scale': 2}),
    'none': ('sftmd', {**BASE, 'sft_type': 'none'}),
    'q_injection': ('sftmd', {**BASE, 'q_injection': True}),
    'q_layers_3': ('sftmd', {**BASE, 'q_injection': True, 'q_layers': 3}),
    'concat_strategy': ('sftmd', {**BASE, 'concat_strategy': True}),
    'concat_strategy_q': ('sftmd', {**BASE, 'concat_strategy': True, 'q_injection': True}),
}
TO_FILES = ('standard', 'q_injection', 'concat_strategy')  # the CLI cases


def n_meta(case):
    return 1 if CASES[case][1]['metadata'] == ['qpi'] else 10


def sft_type(case):
    cfg = CASES[case][1]
    return cfg.get('sft_type') or cfg.get('SFT_type') or 'standard'


@pytest.fixture(scope='module')
def jax_model():
    cache = {}

    def get(case, dtype=None):
        if (case, dtype) not in cache:
            params = params_of(get(case)) if dtype is not None else None
            cache[case, dtype] = jax_handler(case, dtype, params, families=CASES)
        return cache[case, dtype]
    return get


def port_of(case, jax_h, **kwargs):
    return port_handler(case, params_of(jax_h), families=CASES, **kwargs)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize('case', ['standard', 'mask_para', 'repeats', 'concat', 'weak',
                                  'none', 'q_injection'])
def test_sft_layer_and_block_match_sisr_tpu(jax_model, case):
    """The last SFT layer and the first residual block (its gates on the vector with
    q_injection) against sisr_tpu's modules on the bridged parameters, f32."""
    jax_h = jax_model(case)
    params, cfg = params_of(jax_h), CASES[case][1]
    port = port_of(case, jax_h).module
    m = n_meta(case)
    rng = np.random.RandomState(0)
    fea = (0.5 * rng.randn(2, 9, 11, 16)).astype(np.float32)
    meta = rng.rand(2, m).astype(np.float32)
    maps = np.broadcast_to(meta[:, None, None, :], (2, 9, 11, m)).copy()
    kw = dict(sft_type=sft_type(case), nf=16, para=m, mask_para=cfg.get('mask_para', False),
              repeats=cfg.get('repeats'))
    layer = {'params': params['sft']} if 'sft' in params else {}
    theirs = jax_sftmd.SFTLayer(**kw).apply(layer, jnp.asarray(fea), jnp.asarray(maps))
    block = jax_sftmd.SFTResidualBlock(
        16, m, kw['sft_type'], kw['mask_para'], kw['repeats'], cfg.get('q_injection', False),
        cfg.get('q_layers', 2)).apply({'params': params['sft_residual_1']},
                                      jnp.asarray(fea), jnp.asarray(maps), jnp.asarray(meta))
    with torch.inference_mode():
        ours = port.sft(_nchw(fea), _nchw(maps)).permute(0, 2, 3, 1)
        ours_block = port.blocks()[0](_nchw(fea), _nchw(maps), torch.from_numpy(meta))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours_block.permute(0, 2, 3, 1).numpy(), np.asarray(block),
                               atol=1e-5, rtol=0)
    if case != 'none':
        assert np.abs(np.asarray(theirs) - fea).max() > 0.05  # the layer acts


@pytest.mark.parametrize('case', sorted(CASES))
def test_forward_matches_sisr_tpu_f32(jax_model, case):
    jax_h = jax_model(case)
    port = port_of(case, jax_h)
    ours, theirs = forward_both(jax_h, port, *inputs(1, n_meta(case)))
    scale = CASES[case][1]['scale']
    assert ours.shape == theirs.shape == (2, 13 * scale, 15 * scale, 3)
    np.testing.assert_allclose(ours, theirs, atol=5e-4, rtol=0)
    assert 0.05 < (theirs > 0).mean() and (theirs < 1).mean() > 0.05  # not all clamped
    assert port.module_takes_metadata
    assert port.module_input_channels == (13 if 'concat_strategy' in case else 3)


@pytest.mark.parametrize('case', ['standard', 'weak', 'concat_strategy_q'])
def test_bf16_autocast_casts_the_maps(jax_model, case, monkeypatch):
    """Under the bf16 forward the maps are materialised once, in bf16, channels_last;
    every SFT layer takes them so, and the output is bf16 and finite."""
    port = port_of(case, jax_model(case), dtype='bf16')
    made, seen = [], []
    para_maps_like = sftmd.para_maps_like
    monkeypatch.setattr(sftmd, 'para_maps_like',
                        lambda m, f: made.append(para_maps_like(m, f)) or made[-1])
    for layer in [port.module.sft] + [b for blk in port.module.blocks()
                                      for b in (blk.sft1, blk.sft2)]:
        layer.register_forward_pre_hook(lambda mod, args: seen.append(args[1]))
    x, meta = inputs(2, n_meta(case))
    with torch.inference_mode():
        xt, _, mt = port._prep_batch({'lr': torch.from_numpy(x),
                                      'metadata': torch.from_numpy(meta)})
        out = port.forward(xt, mt)
    (maps,) = made
    assert maps.dtype == torch.bfloat16 and maps.is_contiguous(memory_format=torch.channels_last)
    assert len(seen) == 5 and all(s is maps for s in seen)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


@pytest.mark.parametrize('dtype', [None, 'bf16'])
@pytest.mark.parametrize('case', ['standard', 'q_injection', 'concat_strategy', 'weak'])
def test_run_eval_fused_matches_sisr_tpu(jax_model, case, dtype):
    jax_h = jax_model(case, dtype)
    port = port_of(case, jax_h, dtype=dtype)
    batch = uint8_batch(5, n_meta=n_meta(case), scale=CASES[case][1]['scale'])
    (keys, theirs), _ = jax_h.run_eval_fused(batch)
    (our_keys, ours), _ = port.run_eval_fused(batch)
    assert our_keys == keys and ours.shape == (len(keys), 3)
    assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize('protocol', ['fused', 'standard'])
@pytest.mark.parametrize('case', TO_FILES)
def test_cli_protocols_match_sisr_tpu(tmp_path, jax_model, mixed, case, protocol):
    jax_h = jax_model(case)
    if protocol == 'fused':
        lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 4, lr_size=16,
                                        metadata_cols=10)
    else:
        lr_dir, hr_dir = mixed
    cli_against_sisr_tpu(tmp_path, jax_h, port_of(case, jax_h), 'sftmd', CASES[case][1],
                         lr_dir, hr_dir, protocol == 'fused',
                         4 if protocol == 'fused' else len(MIXED_HR))


@pytest.mark.parametrize('case', sorted(CASES))
def test_eval_buckets_match_unbucketed(jax_model, case):
    bucketed_against_unbucketed(port_of(case, jax_model(case)), n_meta(case))


def _converter_kwargs(case):
    cfg = CASES[case][1]
    return dict(num_blocks=2, scale=cfg['scale'], sft_type=sft_type(case),
                q_injection=cfg.get('q_injection', False), q_layers=cfg.get('q_layers', 2))


@pytest.mark.parametrize('case', sorted(CASES))
def test_bridge_round_trips_through_sisr_tpu_converter(jax_model, case):
    """sisr_tpu tree -> port state_dict -> sisr_tpu's convert_torch_state_dict and the
    port's reader give the tree back; the weak and none layers have no entries."""
    params = params_of(jax_model(case))
    state = state_dict_from_jax('sftmd', params)
    assert 'SFT-residual2.conv2.weight' in state and 'conv_output.weight' in state
    assert any('sft_module' in k for k in state) == (sft_type(case) in ('standard', 'concat'))
    back = convert_torch_state_dict('sftmd', {k: v.numpy() for k, v in state.items()},
                                    **_converter_kwargs(case))
    ours = params_from_state_dict('sftmd', state)
    expected = _leaves(params)
    for tree in (back, ours):  # sisr_tpu's converter gives weak/none layers as {}
        got = _leaves(tree)
        assert sorted(got) == sorted(expected)
        for path, value in expected.items():
            np.testing.assert_array_equal(np.asarray(got[path]), value, err_msg=str(path))
    with pytest.raises(RuntimeError, match='unconsumed'):
        state_dict_from_jax('sftmd', {**params, 'stray': {'kernel': np.zeros(1)}})
    with pytest.raises(KeyError, match='conv_mid'):
        state_dict_from_jax('sftmd', {k: v for k, v in params.items() if k != 'conv_mid'})


def _leaves(tree, path=()):
    """{path: leaf} of a nested dict (empty dicts have none)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def aged(state, seed=3):
    """The port's SFTMD keys as an aged reference checkpoint names them: the SFT
    layers' parameters without the ``sft_module`` level, and dead ``sft_branch``
    entries."""
    rng = np.random.RandomState(seed)
    old = {k.replace('.sft_module.', '.'): v for k, v in state.items()}
    old['sft_branch.0.weight'] = torch.from_numpy(rng.randn(4, 10, 1, 1).astype(np.float32))
    old['SFT-residual1.sft_branch.bias'] = torch.zeros(4)
    return old


@pytest.mark.parametrize('case', ['standard', 'concat', 'q_injection'])
def test_aged_checkpoint_loads_strictly(jax_model, case, tmp_path):
    """An aged checkpoint's keys renamed as sisr_tpu's sftmd_legacy_switch does: the
    port's reader and load_model (strict) take it, and sisr_tpu's converter reads it to
    the same tree."""
    jax_h = jax_model(case)
    state = port_of(case, jax_h).module.state_dict()
    old = aged(state)
    assert old.keys() != state.keys() and not any('sft_module' in k for k in old)
    assert sorted(repair_reference_keys('sftmd', old)) == sorted(state)
    ours = _leaves(params_from_state_dict('sftmd', old))
    theirs = _leaves(convert_torch_state_dict('sftmd', {k: v.numpy() for k, v in old.items()},
                                              **_converter_kwargs(case)))
    assert sorted(ours) == sorted(theirs) == sorted(_leaves(params_of(jax_h)))
    for path, value in theirs.items():
        np.testing.assert_array_equal(ours[path].numpy(), value, err_msg=str(path))
    base = tmp_path / 'saved_models'
    base.mkdir()
    torch.save({'network': old, 'model_name': 'sftmd', 'model_epoch': 1},
               str(base / 'train_model_1'))
    fresh = define_model('sftmd', device='cpu', eval_mode=True, seed=9, **CASES[case][1])
    fresh.load_model('train_model', 1, str(base))
    for k, v in fresh.module.state_dict().items():
        torch.testing.assert_close(v, state[k], atol=0, rtol=0)


@pytest.mark.parametrize('q_injection', [False, True])
def test_full_size_model_has_the_reference_keys(q_injection):
    """configs/div2k/sftmd.toml builds 16 SFT residual blocks of 64 features, standard
    SFT on 10 blur-kernel values, 4x: the converter's keys with their shapes (the SFT
    branches' first convs over 64 + 10 channels, the 9 x 9 conv_output), the count of
    each kind; sisr_tpu's converter reads every key."""
    internal = recipe_internal('sftmd', ('scale', 'num_blocks', 'num_features', 'in_nc',
                                         'metadata'))
    handler = define_model('sftmd', device='cpu', q_injection=q_injection, **internal)
    state = handler.module.state_dict()
    expected = {'conv1.weight': (64, 3, 3, 3), 'conv3.weight': (64, 64, 3, 3),
                'SFT-residual16.conv2.weight': (64, 64, 3, 3),
                'SFT-residual16.sft2.sft_module.mul_conv1.weight': (32, 74, 3, 3),
                'SFT-residual16.sft2.sft_module.add_conv2.weight': (64, 32, 3, 3),
                'sft.sft_module.add_conv1.weight': (32, 74, 3, 3),
                'conv_mid.weight': (64, 64, 3, 3), 'upscale.0.weight': (256, 64, 3, 3),
                'upscale.3.weight': (256, 64, 3, 3), 'conv_output.weight': (3, 64, 9, 9)}
    if q_injection:
        expected.update({'SFT-residual16.q_2.attribute_integrator.0.weight': (32, 10, 1, 1),
                         'SFT-residual16.q_2.attribute_integrator.2.weight': (64, 32, 1, 1),
                         'final_injection.attribute_integrator.2.weight': (64, 32, 1, 1)})
    for key, shape in expected.items():
        assert tuple(state[key].shape) == shape, key
    kinds = {}
    for key in state:
        kind = '.'.join('#' if p.isdigit() else p for p in key.split('.'))
        kind = kind.replace('residual' + key.split('.')[0][12:], 'residual#')
        kinds[kind] = kinds.get(kind, 0) + 1
    assert kinds['SFT-residual#.sft1.sft_module.mul_conv1.weight'] == 16
    assert kinds['SFT-residual#.conv1.weight'] == 16
    assert kinds.get('SFT-residual#.q_1.attribute_integrator.#.weight', 0) == 32 * q_injection
    assert len(state) == 2 * (3 + 16 * (2 + 8) + 4 + 1 + 2 + 1 + q_injection * (16 * 4 + 2))
    convert_torch_state_dict('sftmd', {k: v.numpy() for k, v in state.items()}, num_blocks=16,
                             scale=4, q_injection=q_injection)


@pytest.mark.parametrize('case', ['standard', 'q_injection', 'concat_strategy'])
def test_training_trajectory_matches_sisr_tpu(case):
    trajectory_against_sisr_tpu('sftmd', CASES[case][1], steps=4)


def test_train_sisr_runs_the_shipped_recipe(tmp_path):
    train_sisr_on_recipe(tmp_path, 'sftmd', {'num_blocks': 1, 'num_features': 16})
