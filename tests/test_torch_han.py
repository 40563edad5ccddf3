"""sisr_tpu_torch's HAN and Q-HAN against sisr_tpu's on the same weights, on the CPU.
LAM's and CSAM's gammas are set non-zero (0.5 and -0.7) in sisr_tpu's params before
they are bridged: at their initial 0 both blocks are the identity and a comparison
would prove nothing about them.  Each case runs HAN and Q-HAN (2 groups x 2 blocks,
32 features, reduction 16; Q-HAN with 10 blur-kernel values): LAM and CSAM alone
against sisr_tpu's modules (f32 and bf16); the f32 forward, with its channel
attention calls; the weights bridge both ways and through sisr_tpu's own converter,
and mismatched trees raising; the full-size models' reference keys; the fused eval in
f32 and bf16 and eval_sisr --fused_eval end to end; the bucketed forward exact against
the unpadded one (sisr_tpu's tests/test_bucketed_eval.py HAN case, CSAM's Conv3d
unhooked); and set_int8's warning.  The standard protocol is in
test_torch_standard_eval.py, the bucketed eval against sisr_tpu's in
test_torch_masking.py, training in test_torch_training.py and int8 in
test_torch_int8_han.py.

Bars: forward 5e-4 abs in f32; LAM and CSAM 5e-5 in f32 (LAM's softmax takes
differences of energies near D/3, which the gram's f32 summation order moves by about
1e-5) and 2 bf16 ULPs of their magnitude in bf16; PSNR within 0.01 dB and SSIM
within 1e-3 per image; the bucketed forward within 2e-6 of the unpadded one."""
import os
import re
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from sisr_tpu.models.advanced import CSAM as JaxCSAM, LAM as JaxLAM
from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch import net_eval
from sisr_tpu_torch.models import blocks, handlers, q_layers
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import channel_attention as ca
from sisr_tpu_torch.ops.masking import conv_mask_hooks, spatial_masks
from sisr_tpu_torch.tools.convert_weights import params_from_state_dict, state_dict_from_jax
from sisr_tpu_torch.utils import toml_io

SMALL = {'scale': 4, 'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 32, 'reduction': 16}
FAMILIES = {'han': SMALL, 'qhan': {**SMALL, 'metadata': ['blur_kernel']}}
KEYS = ['blur_kernel'] * 10
GAMMAS = {'la': 0.5, 'csa': -0.7}
BARS = {'PSNR': 0.01, 'SSIM': 1e-3}


def with_gammas(params):
    """sisr_tpu params (numpy) with LAM's and CSAM's gammas non-zero."""
    return {**params, 'la': {'gamma': np.array([GAMMAS['la']], np.float32)},
            'csa': {**params['csa'], 'gamma': np.array([GAMMAS['csa']], np.float32)}}


@pytest.fixture(scope='module')
def jax_model():
    """(name, dtype) -> sisr_tpu's handler, its gammas non-zero."""
    cache = {}

    def get(name, dtype=None):
        if (name, dtype) not in cache:
            handler = jax_define_model(name, eval_mode=True, dtype=dtype, **FAMILIES[name])
            if name == 'qhan':
                handler.set_metadata_keys(KEYS)
            handler.init_state(spatial=(16, 16))
            params = with_gammas(jax.tree.map(np.asarray, handler.state.params))
            handler.state = handler.state.replace(params=jax.tree.map(jnp.asarray, params))
            cache[name, dtype] = handler
        return cache[name, dtype]
    return get


def _params(jax_handler):
    return jax.tree.map(np.asarray, jax_handler.state.params)


def _port(name, jax_handler, **kwargs):
    handler = define_model(name, device='cpu', **{**FAMILIES[name], **kwargs})
    if name == 'qhan':
        handler.set_metadata_keys(KEYS)
    handler.module.load_state_dict(state_dict_from_jax(name, _params(jax_handler)))
    return handler


def _batch(seed, n=3, lr=16):
    rng = np.random.RandomState(seed)
    return {'lr': rng.randint(0, 256, (n, lr, lr, 3)).astype(np.uint8),
            'hr': rng.randint(0, 256, (n, 4 * lr, 4 * lr, 3)).astype(np.uint8),
            'metadata': rng.rand(n, 10).astype(np.float32)}


def _assert_metric_rows(keys, ours, theirs):
    for i, key in enumerate(keys):
        bar = BARS[key.split('>')[1]]
        np.testing.assert_allclose(ours[i], theirs[i], atol=bar, rtol=0, err_msg=key)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_lam_and_csam_match_sisr_tpu(jax_model, name, dtype):
    """The port's LAM and CSAM modules, with the family's bridged parameters, against
    sisr_tpu's flax modules on the same NHWC inputs: LAM on a stack of 11 maps, in
    layer-major channel order; CSAM on one map."""
    params = _params(jax_model(name))
    port = _port(name, jax_model(name)).module
    rng = np.random.RandomState(0)
    stack = rng.rand(2, 11, 5, 6, 8).astype(np.float32)
    vol = rng.randn(2, 5, 6, 8).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    theirs_lam = np.asarray(JaxLAM().apply({'params': params['la']},
                                           jnp.asarray(stack, jdt)), np.float32)
    theirs_csam = np.asarray(JaxCSAM(dtype=jdt).apply({'params': params['csa']},
                                                      jnp.asarray(vol, jdt)), np.float32)
    with torch.inference_mode():
        maps = [torch.from_numpy(stack[:, i]).to(tdt).permute(0, 3, 1, 2) for i in range(11)]
        ours_lam = port.la(maps).permute(0, 2, 3, 1)
        ours_csam = port.csa(torch.from_numpy(vol).to(tdt).permute(0, 3, 1, 2))
        ours_csam = ours_csam.permute(0, 2, 3, 1)
    assert ours_lam.dtype == ours_csam.dtype == tdt
    assert ours_lam.shape == (2, 5, 6, 88) and ours_lam.is_contiguous()
    for ours, theirs in ((ours_lam, theirs_lam), (ours_csam, theirs_csam)):
        bar = 5e-5 if dtype == 'float32' else 2 * 2.0 ** -8 * np.abs(theirs).max()
        np.testing.assert_allclose(ours.float().numpy(), theirs, atol=bar, rtol=0)
    # the gammas act: at 0 both would return their input
    assert np.abs(theirs_lam - stack.transpose(0, 2, 3, 1, 4).reshape(2, 5, 6, 88)).max() > 0.1
    assert np.abs(theirs_csam - vol).max() > 0.1


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_forward_matches_sisr_tpu_f32(jax_model, name, monkeypatch):
    """The f32 forward on the same weights (and, for Q-HAN, the same metadata, prepared
    by each handler): one CA call a block, Q-HAN's with its q_node's gate and no
    metadata (the 'standard' style)."""
    jax_handler = jax_model(name)
    rng = np.random.RandomState(1)
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    meta = rng.rand(2, 10).astype(np.float32)
    kwargs = {}
    if name == 'qhan':
        kwargs['metadata'] = jax_handler.prepare_metadata(jnp.asarray(x), jnp.asarray(meta))
    theirs = np.asarray(jax_handler.state.apply_fn({'params': jax_handler.state.params}, x,
                                                   **kwargs))
    port = _port(name, jax_handler)
    calls = []

    def spy(*args, **kw):
        calls.append((kw.get('meta') is not None, kw.get('gate') is not None))
        return ca.fused_channel_attention(*args, **kw)

    monkeypatch.setattr(blocks, 'fused_channel_attention', spy)
    monkeypatch.setattr(q_layers, 'fused_channel_attention', spy)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        args = (port.prepare_metadata(xt, torch.from_numpy(meta)),) if name == 'qhan' else ()
        ours = port.forward(xt, *args).numpy()
    assert ours.shape == theirs.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(ours, theirs, atol=5e-4, rtol=0)
    assert calls == [(False, name == 'qhan')] * 4


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_bridge_round_trips_through_sisr_tpu_converter(jax_model, name):
    """sisr_tpu tree -> port state_dict -> sisr_tpu's convert_torch_state_dict (no
    leftover keys) gives the tree back, gammas and CSAM's kernel included; the port's
    own reader gives it too."""
    params = _params(jax_model(name))
    port = _port(name, jax_model(name))
    state = port.module.state_dict()
    assert state['la.gamma'].item() == GAMMAS['la']
    assert state['csa.gamma'].item() == pytest.approx(GAMMAS['csa'])
    assert state['csa.conv.weight'].shape == (1, 1, 3, 3, 3)
    back = convert_torch_state_dict(name, {k: v.numpy() for k, v in state.items()},
                                    n_resgroups=2, n_resblocks=2, scale=4)
    ours = jax.tree.map(np.asarray, params_from_state_dict(name, state))
    for tree in (back, ours):
        assert jax.tree.structure(tree) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_bridge_rejects_mismatched_trees(jax_model, name):
    params = _params(jax_model(name))
    with pytest.raises(RuntimeError, match='unconsumed'):
        state_dict_from_jax(name, {**params, 'stray': {'kernel': np.zeros(1)}})
    for part in ('la', 'csa', 'last_conv', 'body_tail'):
        with pytest.raises(KeyError, match=part):
            state_dict_from_jax(name, {k: v for k, v in params.items() if k != part})
    other = 'qhan' if name == 'han' else 'han'  # the other family's layout
    with pytest.raises((KeyError, RuntimeError)):
        state_dict_from_jax(other, params)
    with pytest.raises(RuntimeError, match='unread'):
        params_from_state_dict(name, {**_port(name, jax_model(name)).module.state_dict(),
                                      'stray.weight': torch.zeros(1)})


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_full_size_models_have_the_reference_keys(name):
    """define_model with the shipped recipes' parameters builds 10 x 20, 64 features,
    4x: the reference's keys and shapes (sisr_tpu's converter reads every one), both
    gammas 0 and CSAM's Conv3d drawn as torch's default."""
    internal = {'scale': 4, 'metadata': ['blur_kernel']} if name == 'qhan' else {'scale': 4}
    handler = define_model(name, device='cpu', **internal)
    state = handler.module.state_dict()
    assert state['last_conv.weight'].shape == (64, 64 * 11, 3, 3)
    assert state['last.weight'].shape == (64, 128, 3, 3)
    assert state['body.10.weight'].shape == (64, 64, 3, 3)  # the body tail
    assert state['la.gamma'].item() == state['csa.gamma'].item() == 0.0
    assert 0 < state['csa.conv.weight'].abs().max() <= 1 / np.sqrt(27)
    if name == 'qhan':
        assert handler.num_metadata == 10
        assert state['body.9.body.19.q_node.attribute_integrator.0.weight'].shape \
            == (32, 10, 1, 1)
        assert 'body.9.final_body.weight' in state
    else:
        assert 'body.9.body.20.weight' in state  # the group's tail conv
    convert_torch_state_dict(name, {k: v.numpy() for k, v in state.items()}, scale=4)


@pytest.mark.parametrize('dtype', [None, 'bf16'])
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_run_eval_fused_matches_sisr_tpu(jax_model, name, dtype):
    """The fused step (with the metadata batch for Q-HAN), f32 and bf16."""
    jax_handler = jax_model(name, dtype)
    batch = _batch(seed=3)
    (keys, theirs), _ = jax_handler.run_eval_fused(batch)
    port = _port(name, jax_handler, dtype=dtype)
    (our_keys, ours), _ = port.run_eval_fused(batch)
    assert our_keys == keys and ours.shape == (len(keys), 3)
    _assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))


def _read_metrics(out_loc, results):
    return pd.read_csv(os.path.join(out_loc, results, 'standard_metrics',
                                    'individual_metrics.csv'), header=[0, 1], index_col=0)


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_cli_fused_eval_matches_sisr_tpu(tmp_path, jax_model, name):
    """eval_sisr --fused_eval --no-gpu on a folder with a blur-kernel
    degradation_metadata.csv beside the LR images, against sisr_tpu's EvalHub on the
    same weights."""
    from sisr_tpu.evaluation.standard_eval import EvalHub as JaxEvalHub
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 5, lr_size=16, metadata_cols=10)
    model_loc, out_loc = str(tmp_path / 'Results'), str(tmp_path / 'out')
    for exp in ('jax_exp', 'torch_exp'):
        os.makedirs(os.path.join(model_loc, exp, 'saved_models'))
        toml_io.dump({'model': {'name': name, 'internal_params': FAMILIES[name]}},
                     os.path.join(model_loc, exp, 'config.toml'))
    jax_model(name).save_model('train_model', 0, os.path.join(model_loc, 'jax_exp',
                                                              'saved_models'))
    jax_model(name).wait_pending_checkpoints()
    _port(name, jax_model(name)).save_model('train_model', 0, os.path.join(
        model_loc, 'torch_exp', 'saved_models'))
    net_eval.eval_run.main(
        args=['--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'torch_exp', '0',
              '--model_loc', model_loc, '--out_loc', out_loc, '--results_name', 'port',
              '-m', 'PSNR', '-m', 'SSIM', '--batch_size', '2', '--full_directory',
              '--fused_eval', '--no_image_comparison', '--no-time_models', '--no-gpu'],
        standalone_mode=False)
    JaxEvalHub(hr_dir=hr_dir, lr_dir=lr_dir, model_and_epoch=[('jax_exp', '0')],
               results_name='ref', gpu=False, metrics=['PSNR', 'SSIM'], data_split=None,
               save_im=False, batch_size=2, full_directory=True, lr_dir_interp=None,
               model_only=False, scale=4, model_loc=model_loc, out_loc=out_loc,
               use_test_group=False, no_image_comparison=True, num_image_save=0,
               qpi_selection=(None, None), data_attributes=None, dataset_name=None,
               image_shortlist=None, metadata_file=None, sp_gpu=0, time_models=False,
               recursive=False, fused_eval=True).full_image_protocol()
    ours, theirs = _read_metrics(out_loc, 'port'), _read_metrics(out_loc, 'ref')
    assert list(ours.index) == list(theirs.index) and len(ours) == 5
    for side_ours, side_theirs in (('LR', 'LR'), ('torch_exp', 'jax_exp')):
        for met, bar in BARS.items():
            np.testing.assert_allclose(ours[(side_ours, met)], theirs[(side_theirs, met)],
                                       atol=bar, rtol=0, err_msg='%s %s' % (side_ours, met))


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_bucketed_module_exact(name):
    """LAM (a gram over every pixel of every layer) and CSAM (a 3-D conv that multiplies
    x) are exact under zero-masked pads: a 2 x 1, 16-feature, 2x model on an 11 x 14
    image, zero-padded to 16 x 16 and run inside the mask context with the conv hooks,
    equals its unpadded forward on the valid region.  CSAM's Conv3d gets no hook: its
    input, the body tail's masked output, is zero in the pad, and so is its output."""
    internal = {'scale': 2, 'n_resgroups': 2, 'n_resblocks': 1, 'n_feats': 16}
    if name == 'qhan':
        internal['metadata'] = ['blur_kernel']
    handler = define_model(name, device='cpu', seed=5, **internal)
    with torch.no_grad():
        handler.module.la.gamma.fill_(GAMMAS['la'])
        handler.module.csa.gamma.fill_(GAMMAS['csa'])
    meta = (torch.from_numpy(np.random.RandomState(2).rand(1, 10).astype(np.float32)),) \
        if name == 'qhan' else ()
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 3, 11, 14).astype(np.float32))
    seen = []
    handler.module.csa.register_forward_hook(lambda mod, args, out: seen.append(out))
    with torch.inference_mode():
        ref = handler.module(x.contiguous(memory_format=torch.channels_last), *meta)
        padded = torch.nn.functional.pad(x, (0, 2, 0, 5))
        with spatial_masks((16, 16), (11, 14)), conv_mask_hooks(handler.module):
            assert not handler.module.csa.conv._forward_hooks
            out = handler.module(padded.contiguous(memory_format=torch.channels_last), *meta)
    assert ref.shape == (1, 3, 22, 28) and out.shape == (1, 3, 32, 32)
    torch.testing.assert_close(out[:, :, :22, :28], ref, atol=2e-6, rtol=0)
    csa_padded = seen[1]
    assert csa_padded[:, :, 11:].abs().max() == 0 and csa_padded[:, :, :, 14:].abs().max() == 0
    torch.testing.assert_close(csa_padded[:, :, :11, :14], seen[0], atol=2e-6, rtol=0)


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_set_int8_warns_with_the_cards_ratio(name):
    """set_int8 warns for a family measured slower in int8 than in bf16, with the
    ratio measured on the card and the card's name and power limit, and no TPU
    figure; every family of the table has an int8 program."""
    assert set(handlers.INT8_MEASURED_SLOWER) <= set(handlers._INT8_PROGRAMS)
    assert all(re.fullmatch(r'\d\.\d\dx', ratio)
               for ratio in handlers.INT8_MEASURED_SLOWER.values())
    handler = define_model(name, device='cpu', **{**FAMILIES[name], 'n_resgroups': 1,
                                                  'n_resblocks': 1})
    with pytest.warns(UserWarning) as record:
        handler.set_int8(True)
    message = str(record[0].message)
    assert message.startswith('int8 measured slower than bf16 for the %s family on an '
                              'NVIDIA H100 80GB HBM3, 700.00 W (%s bf16 img/s'
                              % (name, handlers.INT8_MEASURED_SLOWER[name]))
    assert not re.search(r'v5e|v4|TPU|0\.73x', message)
    assert handler.int8_mode
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        handler.set_int8(False)  # turning it off warns nothing
