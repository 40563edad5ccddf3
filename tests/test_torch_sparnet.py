"""sisr_tpu_torch's SPARNet and Q-SPARNet against sisr_tpu's on the same weights and
running statistics, on the CPU.  Model: 1 stride-2 step (in_size 32, min_feat_size 16),
8-16 channels, 3 body blocks, hourglasses of depth 2 (encoder, body) and 3 (decoder)
with 64 middle channels (sisr_tpu's fixed width), BatchNorm, LeakyReLU; Q-SPARNet on 10
blur-kernel values.

Each case holds: every NormLayer and ReluLayer type (BatchNorm in both modes, with its
running statistics); ConvLayer in none, down and up; HourGlassBlock at depths 0-3 on a
37 x 29 map (odd sides: the nearest-exact resize, shown to differ from torch's
'nearest') and at depth 3 on an 11 x 5 map (a one-pixel map inside); the reflect pad of
one- and two-pixel sides against jnp.pad; SPARNet, Q-SPARNet and metadata_encoder_only
in eval and train mode; the running statistics after 3 train steps; the checkpoint
round trip with them; the weights bridge both ways through sisr_tpu's
convert_torch_variables (the ``in`` norm, which that converter walks to a layout sisr_tpu's
model does not have, in the sisr_tpu -> port direction only); the fused eval; both eval
protocols end to end and the standard protocol against the fused one; --eval_buckets and
--int8 ignored; training and train_sisr on configs/celebahq/qsparnet.toml.

Bars: the layers 1e-5 abs; the model forwards in f32 within 1e-5 of the output's
largest magnitude (train mode normalises by the statistics of maps of a few pixels,
which magnify the two backends' last-bit differences); the running statistics rtol
1e-5 (atol 1e-6) after one forward and after 3 train steps at learning rate 0 (Adam's
first steps move a weight by the whole learning rate on the sign of its gradient, and
gradient entries of 1e-7 take either sign in the two backends); the losses of 3 steps
at learning rate 1e-3 rtol 2e-4; PSNR within 0.01 dB and SSIM within 1e-3 per
image against sisr_tpu; the fused protocol against the standard one within sisr_tpu's
own 0.3 dB for this family (tests/test_fused_families.py: the module's input is the
device bicubic there, the host Pillow bicubic here)."""
import os

import numpy as np
import pandas as pd
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

import jax
import jax.numpy as jnp

from sisr_tpu.models import sparnet as jax_sparnet
from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.tools.convert_weights import convert_torch_variables
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch import net_eval, net_train
from sisr_tpu_torch.models import sparnet
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.tools.convert_weights import (_sparnet_torch_key, params_from_state_dict,
                                                  state_dict_from_jax,
                                                  variables_from_state_dict)
from sisr_tpu_torch.utils import toml_io
from test_torch_srmd import (HERE, KEYS, assert_metric_rows, cli_against_sisr_tpu, mixed,
                             read_metrics, uint8_batch)

SPAR = {'scale': 4, 'min_ch': 8, 'max_ch': 16, 'in_size': 32, 'out_size': 32,
        'min_feat_size': 16, 'res_depth': 1, 'bottleneck_size': 16}
CASES = {'sparnet': ('sparnet', SPAR),
         'qsparnet': ('qsparnet', {**SPAR, 'metadata': ['blur_kernel']}),
         'encoder_only': ('qsparnet', {**SPAR, 'metadata': ['blur_kernel'],
                                       'metadata_encoder_only': True})}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def perturbed(variables, seed):
    """sisr_tpu variables with every norm scale, bias and running statistic moved off
    its initial value (and every PReLU slope), so each one matters."""
    rng = np.random.RandomState(seed)

    def move(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name in ('scale', 'var'):
            return (0.5 + rng.rand(*leaf.shape)).astype(np.float32)
        if name in ('bias', 'mean', 'prelu') and path[-2].key != 'conv2d':
            return (rng.rand(*leaf.shape) - 0.5).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(move, jax.tree.map(np.asarray, variables))


def flax_to_port(module, variables):
    """sisr_tpu variables of a submodule (ConvLayer, HourGlassBlock) into the port's
    module of the same structure: the bridge's walk with the submodule as a block."""
    sd = {}
    for collection, tree in variables.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key, kind = _sparnet_torch_key(('out_conv',) + tuple(p.key for p in path))
            a = np.asarray(leaf)
            a = a.transpose(3, 2, 0, 1) if kind == 'conv' else a
            sd[key[len('out_conv.'):]] = torch.from_numpy(np.ascontiguousarray(a))
    for key, value in module.state_dict().items():
        if key.endswith('num_batches_tracked'):
            sd[key] = value
    module.load_state_dict(sd)
    return module


def norm_to_port(layer, variables, norm_type):
    """A NormLayer's sisr_tpu variables into the port's (weight / bias / running
    statistics of its ``norm``)."""
    params = variables.get('params', {})
    inner = params if norm_type == 'in' else params.get('norm', {})
    stats = variables.get('batch_stats', {}).get('norm', {})
    with torch.no_grad():
        for src, dst in (('scale', 'weight'), ('bias', 'bias')):
            if src in inner:
                getattr(layer.norm, dst).copy_(torch.from_numpy(np.asarray(inner[src])))
        for src, dst in (('mean', 'running_mean'), ('var', 'running_var')):
            if src in stats:
                getattr(layer.norm, dst).copy_(torch.from_numpy(np.asarray(stats[src])))
    return layer


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('norm_type', sparnet.NORM_TYPES)
def test_norm_layer_matches_sisr_tpu(norm_type, train):
    """Every norm type, BatchNorm's train mode with the running statistics it leaves
    (the biased variance, weight 0.1 on the batch's)."""
    x = np.random.RandomState(0).randn(2, 7, 5, 32).astype(np.float32) * 2 + 0.7
    mod = jax_sparnet.NormLayer(32, norm_type)
    variables = perturbed(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    theirs, mutated = mod.apply(variables, jnp.asarray(x), train=train,
                                mutable=['batch_stats'])
    layer = norm_to_port(sparnet.NormLayer(32, norm_type), variables, norm_type)
    layer.train(train)
    ours = layer(nchw(x))
    np.testing.assert_allclose(nhwc(ours), np.asarray(theirs), atol=1e-5, rtol=0)
    if norm_type == 'bn':
        stats = mutated['batch_stats']['norm']
        np.testing.assert_allclose(layer.norm.running_mean.numpy(), stats['mean'],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(layer.norm.running_var.numpy(), stats['var'],
                                   rtol=1e-5, atol=1e-7)
        assert int(layer.norm.num_batches_tracked) == int(train)
        if train:  # torch's stock module moves the variance by the unbiased estimate
            stock = torch.nn.BatchNorm2d(32)
            stock.running_var.copy_(torch.from_numpy(
                np.asarray(variables['batch_stats']['norm']['var'])))
            stock(nchw(x))
            assert not np.allclose(stock.running_var.numpy(), stats['var'], rtol=1e-5)


@pytest.mark.parametrize('relu_type', sparnet.RELU_TYPES)
def test_relu_layer_matches_sisr_tpu(relu_type):
    x = np.random.RandomState(1).randn(2, 4, 3, 6).astype(np.float32)
    mod = jax_sparnet.ReluLayer(6, relu_type)
    variables = perturbed(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    layer = sparnet.ReluLayer(6, relu_type)
    if relu_type == 'prelu':
        assert torch.equal(layer.func.weight, torch.full((6,), 0.25))
        with torch.no_grad():
            layer.func.weight.copy_(torch.from_numpy(variables['params']['prelu']))
    theirs = np.asarray(mod.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(nhwc(layer(nchw(x))), theirs, atol=1e-6, rtol=0)


@pytest.mark.parametrize('scale', ['none', 'down', 'up'])
def test_conv_layer_matches_sisr_tpu(scale):
    """Reflect pad, stride-2 down or nearest x2 up, BatchNorm (no conv bias) and PReLU;
    the output sizes of an odd 9 x 7 map."""
    x = np.random.RandomState(2).rand(2, 9, 7, 5).astype(np.float32)
    mod = jax_sparnet.ConvLayer(5, 6, 3, scale, norm_type='bn', relu_type='prelu')
    variables = perturbed(mod.init(jax.random.PRNGKey(1), jnp.asarray(x)), 3)
    layer = flax_to_port(sparnet.ConvLayer(5, 6, 3, scale, 'bn', 'prelu'), variables)
    assert layer.conv2d.bias is None
    layer.eval()
    theirs = np.asarray(mod.apply(variables, jnp.asarray(x)))
    ours = nhwc(layer(nchw(x)))
    assert ours.shape == theirs.shape == {'none': (2, 9, 7, 6), 'down': (2, 5, 4, 6),
                                          'up': (2, 18, 14, 6)}[scale]
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)


@pytest.mark.parametrize('depth,size', [(0, (37, 29)), (1, (37, 29)), (2, (37, 29)),
                                        (3, (37, 29)), (3, (11, 5))])
def test_hourglass_matches_sisr_tpu_on_odd_sides(depth, size, monkeypatch):
    """Odd sides make the up branch one pixel longer: the nearest-exact resize brings
    it back as jax.image.resize does (torch's 'nearest' picks other pixels); the 11 x
    5 map reaches one pixel wide, where the reflect pad repeats the value."""
    x = np.random.RandomState(3).rand(2, *size, 8).astype(np.float32)
    mod = jax_sparnet.HourGlassBlock(depth, 8, 1, c_mid=16)
    variables = perturbed(mod.init(jax.random.PRNGKey(2), jnp.asarray(x)), 4)
    block = flax_to_port(sparnet.HourGlassBlock(depth, 8, 1, c_mid=16), variables)
    for train in (False, True):
        theirs, _ = mod.apply(variables, jnp.asarray(x), train=train,
                              mutable=['batch_stats'])
        block.train(train)
        np.testing.assert_allclose(nhwc(block(nchw(x))), np.asarray(theirs), atol=1e-5,
                                   rtol=0)
    if depth:  # the running statistics again, then torch's 'nearest' in its place
        flax_to_port(block, variables).eval()
        monkeypatch.setattr(sparnet, 'nearest_resize', lambda t, hw: torch.nn.functional
                            .interpolate(t, size=tuple(hw), mode='nearest'))
        theirs = np.asarray(mod.apply(variables, jnp.asarray(x)))
        assert np.abs(nhwc(block(nchw(x))) - theirs).max() > 1e-3


@pytest.mark.parametrize('shape,pad', [((1, 5), 1), ((4, 1), 1), ((1, 1), 1), ((2, 3), 2),
                                       ((6, 7), 1)])
def test_reflect_pad_matches_jnp_pad(shape, pad):
    x = np.random.RandomState(4).rand(2, *shape, 3).astype(np.float32)
    theirs = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode='reflect')
    np.testing.assert_array_equal(np.asarray(jnp.pad(jnp.asarray(x), (
        (0, 0), (pad, pad), (pad, pad), (0, 0)), mode='reflect')), theirs)
    np.testing.assert_array_equal(nhwc(sparnet.reflect_pad(nchw(x), pad)), theirs)


def jax_handler(case, dtype=None, variables=None, **kwargs):
    """sisr_tpu's handler of CASES[case], on ``variables`` when given."""
    name, cfg = CASES[case]
    handler = jax_define_model(name, dtype=dtype, **{**cfg, **kwargs})
    handler.set_metadata_keys(KEYS)
    handler.init_state(spatial=(16, 16))
    if variables is not None:
        handler.state = handler.state.replace(
            params=jax.tree.map(jnp.asarray, variables['params']),
            batch_stats=jax.tree.map(jnp.asarray, variables['batch_stats']))
    return handler


def variables_of(handler):
    return jax.tree.map(np.asarray, {'params': handler.state.params,
                                     'batch_stats': handler.state.batch_stats})


def port_handler(case, variables, **kwargs):
    name, cfg = CASES[case]
    handler = define_model(name, device='cpu', **{**cfg, **kwargs})
    handler.set_metadata_keys(KEYS)
    handler.module.load_state_dict(state_dict_from_jax(name, variables))
    return handler


@pytest.fixture(scope='module')
def jax_model():
    """case -> sisr_tpu's eval handler on perturbed variables (every BatchNorm's scale,
    bias and running statistics moved)."""
    cache = {}

    def get(case, dtype=None):
        if (case, dtype) not in cache:
            variables = perturbed(variables_of(jax_handler(case)), 5) \
                if (case, None) not in cache else variables_of(cache[case, None])
            cache[case, dtype] = jax_handler(case, dtype, variables, eval_mode=True)
        return cache[case, dtype]
    return get


def model_inputs(seed, size=(36, 28), n=2):
    rng = np.random.RandomState(seed)
    return rng.rand(n, *size, 3).astype(np.float32), rng.rand(n, 10).astype(np.float32)


def assert_close_to_scale(ours, theirs, bar=1e-5):
    np.testing.assert_allclose(ours, theirs, atol=bar * float(np.abs(theirs).max()), rtol=0)


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('case', sorted(CASES))
def test_forward_matches_sisr_tpu_f32(jax_model, case, train):
    """The model on a 36 x 28 map (each hourglass takes an odd side: 9 and 7 at depth
    2), eval mode on the running statistics, train mode on the batch's with the running
    statistics it leaves."""
    jax_h = jax_model(case)
    port = port_handler(case, variables_of(jax_h))
    x, meta = model_inputs(6)
    kwargs = {} if case == 'sparnet' else {'metadata': jnp.asarray(meta)}
    variables = {'params': jax_h.state.params, 'batch_stats': jax_h.state.batch_stats}
    theirs, mutated = jax_h.state.apply_fn(variables, jnp.asarray(x), train=train,
                                           mutable=['batch_stats'], **kwargs)
    port._set_training(train)
    with torch.no_grad():
        ours = port.forward(torch.from_numpy(x), None if case == 'sparnet'
                            else torch.from_numpy(meta)).numpy()
    assert ours.shape == (2, 36, 28, 3)
    assert_close_to_scale(ours, np.asarray(theirs))
    stats = variables_from_state_dict(CASES[case][0], port.module.state_dict())
    for a, b in zip(jax.tree.leaves(stats['batch_stats']),
                    jax.tree.leaves(mutated['batch_stats'])):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)
    if case == 'encoder_only':
        assert not any('metadata_attention' in k for k in port.module.state_dict()
                       if not k.startswith('encoder'))


TRAIN = {'lr': 1e-3, 'scheduler': 'cosine_annealing_warm_restarts',
         'scheduler_params': {'t_mult': 1, 'restart_period': 4, 'lr_min': 1e-6}}


def trained_pair(case, steps=3, seed=7, lr=1e-3):
    """``steps`` train steps of the port and of sisr_tpu from the same variables and
    batches (HR-size LR: a pre-upscaled family's data) at learning rate ``lr``: (port,
    sisr_tpu's, batches, the two loss lists)."""
    theirs = jax_handler(case, **{**TRAIN, 'lr': lr})
    port = port_handler(case, variables_of(theirs), **{**TRAIN, 'lr': lr})
    rng = np.random.RandomState(seed)
    batches, ours_losses, their_losses = [], [], []
    for _ in range(steps):
        batch = {'lr': rng.rand(2, 24, 20, 3).astype(np.float32),
                 'hr': rng.rand(2, 24, 20, 3).astype(np.float32),
                 'metadata': rng.rand(2, 10).astype(np.float32)}
        batches.append(batch)
        ours_losses.append(float(port.run_train(**batch)[0]))
        their_losses.append(float(theirs.run_train(**batch)[0]))
    return port, theirs, batches, ours_losses, their_losses


@pytest.mark.parametrize('case', ['sparnet', 'qsparnet'])
def test_running_statistics_after_train_steps_match_sisr_tpu(case):
    """3 train steps: the losses at learning rate 1e-3; the running statistics, which
    each step's BatchNorms move from the batch's biased statistics, at learning rate
    0."""
    _, _, _, ours_losses, their_losses = trained_pair(case)
    np.testing.assert_allclose(ours_losses, their_losses, rtol=2e-4, atol=2e-6)
    port, theirs, _, ours_losses, their_losses = trained_pair(case, lr=0.0)
    np.testing.assert_allclose(ours_losses, their_losses, rtol=2e-5)
    stats = variables_from_state_dict(CASES[case][0], port.module.state_dict())['batch_stats']
    assert jax.tree.structure(jax.tree.map(np.asarray, stats)) == \
        jax.tree.structure(theirs.state.batch_stats)
    for a, b in zip(jax.tree.leaves(stats), jax.tree.leaves(theirs.state.batch_stats)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    assert all(int(v) == 3 for k, v in port.module.state_dict().items()
               if k.endswith('num_batches_tracked'))


def test_checkpoint_round_trip_keeps_running_statistics(tmp_path):
    """After train steps the running statistics are saved with the network and a fresh
    eval handler gives the same eval output from them (sisr_tpu's
    tests/test_multi_step.py:79-105)."""
    port, _, batches, _, _ = trained_pair('sparnet', steps=2)
    x = batches[0]['lr']
    before = port.run_eval(x)[0]
    port.set_epoch(2)
    port.save_model('train_model', 2, str(tmp_path))
    saved = torch.load(str(tmp_path / 'train_model_2'), weights_only=True)['network']
    assert float(saved['encoder.1.conv1.norm.norm.running_var'].sub(1).abs().max()) > 1e-3
    fresh = define_model('sparnet', device='cpu', eval_mode=True, seed=11, **SPAR)
    fresh.load_model('train_model', 2, str(tmp_path))
    for k, v in fresh.module.state_dict().items():
        assert torch.equal(v, saved[k]), k
    np.testing.assert_array_equal(fresh.run_eval(x)[0], before)


BRIDGE = {'bn_prelu': {'relu_type': 'prelu'}, 'layer': {'norm_type': 'layer'},
          'none_selu': {'norm_type': 'none', 'relu_type': 'selu'},
          'pixel': {'norm_type': 'pixel'}}


@pytest.mark.parametrize('variant', sorted(BRIDGE))
@pytest.mark.parametrize('case', ['sparnet', 'qsparnet'])
def test_bridge_round_trips_through_sisr_tpu_converter(case, variant):
    """sisr_tpu variables -> the port's state_dict -> sisr_tpu's convert_torch_variables
    and the port's variables_from_state_dict: both give the variables back, bit for bit
    (num_batches_tracked, which flax does not keep, is 0); the port's forward on them
    equals sisr_tpu's."""
    name = CASES[case][0]
    jax_h = jax_handler(case, eval_mode=True, **BRIDGE[variant])
    variables = perturbed(variables_of(jax_h), 8)
    if not variables['batch_stats']:
        variables = {'params': variables['params']}
    state = state_dict_from_jax(name, variables)
    port = define_model(name, device='cpu', **{**CASES[case][1], **BRIDGE[variant]})
    port.module.load_state_dict(state)
    assert all(int(v) == 0 for k, v in state.items() if k.endswith('num_batches_tracked'))
    back = convert_torch_variables(name, {k: v.numpy() for k, v in state.items()})
    ours = jax.tree.map(lambda t: t.numpy(), variables_from_state_dict(name, state))
    for tree in (back, ours):
        tree = {k: v for k, v in tree.items() if v}
        assert jax.tree.structure(tree) == jax.tree.structure(variables)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(variables)):
            np.testing.assert_array_equal(a, b)
    if 'batch_stats' in variables:
        jax_h.state = jax_h.state.replace(
            params=jax.tree.map(jnp.asarray, variables['params']),
            batch_stats=jax.tree.map(jnp.asarray, variables['batch_stats']))
    else:
        jax_h.state = jax_h.state.replace(params=jax.tree.map(jnp.asarray,
                                                              variables['params']))
    x, meta = model_inputs(9)
    port.set_metadata_keys(KEYS)
    ours_out = port.run_eval(x, metadata=meta)[0]
    theirs_out = jax_h.run_eval(x, metadata=meta)[0]
    assert_close_to_scale(ours_out, theirs_out)


def test_bridge_takes_the_in_norm_from_sisr_tpu_and_fails_loudly():
    """The ``in`` norm keeps its scale and bias on the NormLayer in sisr_tpu (not under
    ``norm/norm``, where sisr_tpu's converter puts them): sisr_tpu -> port only, the
    forwards equal.  A stray leaf or collection raises; the params alone do not read
    a state_dict with running statistics."""
    jax_h = jax_handler('qsparnet', eval_mode=True, norm_type='in')
    variables = perturbed(variables_of(jax_h), 10)
    assert 'scale' in variables['params']['encoder_1']['conv1']['norm']
    port = define_model('qsparnet', device='cpu', norm_type='in', **CASES['qsparnet'][1])
    port.module.load_state_dict(state_dict_from_jax('qsparnet', {'params': variables['params']}))
    jax_h.state = jax_h.state.replace(params=jax.tree.map(jnp.asarray, variables['params']))
    port.set_metadata_keys(KEYS)
    x, meta = model_inputs(11)
    assert_close_to_scale(port.run_eval(x, metadata=meta)[0],
                          jax_h.run_eval(x, metadata=meta)[0])
    bn = variables_of(jax_handler('sparnet', eval_mode=True))
    for stray in ({**bn, 'params': {**bn['params'], 'stray': {'kernel': np.zeros(1)}}},
                  {**bn, 'intermediates': {}},
                  {**bn, 'params': {**bn['params'], 'out_conv': {
                      **bn['params']['out_conv'], 'conv2d': {'kernel': np.zeros((3, 3, 8, 3)),
                                                             'scale': np.zeros(3)}}}}):
        with pytest.raises(RuntimeError):
            port_model = define_model('sparnet', device='cpu', **SPAR)
            port_model.module.load_state_dict(state_dict_from_jax('sparnet', stray))
    state = state_dict_from_jax('sparnet', bn)
    with pytest.raises(RuntimeError, match='variables_from_state_dict'):
        params_from_state_dict('sparnet', state)
    with pytest.raises(RuntimeError):
        variables_from_state_dict('sparnet', {**state, 'encoder.1.conv1.norm.norm.stray':
                                              torch.zeros(1)})


@pytest.mark.parametrize('dtype', [None, 'bf16'])
@pytest.mark.parametrize('case', ['sparnet', 'qsparnet'])
def test_run_eval_fused_matches_sisr_tpu(jax_model, case, dtype):
    """The fused step on a uint8 batch of 8^2 -> 32^2: the module on the LR's device
    bicubic at HR size, f32 and bf16."""
    jax_h = jax_model(case, dtype)
    port = port_handler(case, variables_of(jax_h), dtype=dtype)
    batch = uint8_batch(12, lr=8)
    (keys, theirs), _ = jax_h.run_eval_fused(batch)
    (our_keys, ours), _ = port.run_eval_fused(batch)
    assert our_keys == keys and ours.shape == (len(keys), 3)
    assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))
    (loss_keys, with_loss), _ = port.run_eval_fused(batch, request_loss=True,
                                                    include_lr=False)
    (_, their_loss), _ = jax_h.run_eval_fused(batch, request_loss=True, include_lr=False)
    np.testing.assert_allclose(with_loss[-1].numpy(), np.asarray(their_loss)[-1], rtol=1e-3)


def test_the_module_takes_the_upscaled_lr_once(jax_model, monkeypatch):
    """The fused step upscales the RGB LR once, and that tensor is both the LR
    baseline's and the module's input (HR size, 3 channels); the module runs in eval
    mode, on the running statistics."""
    from sisr_tpu_torch.models import handlers as port_handlers
    port = port_handler('qsparnet', variables_of(jax_model('qsparnet')))
    resized, seen = [], []
    resize = port_handlers.resize_bicubic
    monkeypatch.setattr(port_handlers, 'resize_bicubic',
                        lambda x, h, w: resized.append(tuple(x.shape)) or resize(x, h, w))
    port.module.encoder[0].register_forward_pre_hook(
        lambda mod, args: seen.append((tuple(args[0].shape), mod.training)))
    port.run_eval_fused(uint8_batch(13, n=2, lr=8))
    assert resized == [(2, 8, 8, 3)]
    assert seen == [((2, 3, 32, 32), False)]


def hub_workload(root, n=4, lr_size=16):
    return build_workload(root, n, lr_size=lr_size, metadata_cols=10)


@pytest.mark.parametrize('protocol', ['fused', 'standard'])
def test_cli_protocols_match_sisr_tpu(tmp_path, jax_model, mixed, protocol):
    """eval_sisr --no-gpu on Q-SPARNet against sisr_tpu's EvalHub: the fused protocol
    on 16^2 -> 64^2 pairs, the standard one on the mixed-size set (60 x 44 takes the
    odd-side resize in every hourglass)."""
    jax_h = jax_model('qsparnet')
    if protocol == 'fused':
        lr_dir, hr_dir = hub_workload(str(tmp_path / 'data'))
    else:
        lr_dir, hr_dir = mixed
    cli_against_sisr_tpu(tmp_path, jax_h, port_handler('qsparnet', variables_of(jax_h)),
                         'qsparnet', CASES['qsparnet'][1], lr_dir, hr_dir,
                         protocol == 'fused', 4 if protocol == 'fused' else 3)


def eval_cli(tmp_path, lr_dir, hr_dir, results, extra):
    net_eval.eval_run.main(
        args=['--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'torch_exp', '0',
              '--model_loc', str(tmp_path / 'Results'), '--out_loc', str(tmp_path / 'out'),
              '--results_name', results, '-m', 'PSNR', '-m', 'SSIM', '--full_directory',
              '--no_image_comparison', '--no-gpu', *extra], standalone_mode=False)
    return read_metrics(str(tmp_path / 'out'), results)


def test_standard_protocol_within_fused_bar(tmp_path, jax_model, capsys):
    """The port's standard protocol (host Pillow bicubic input) against its fused one
    (device bicubic input): model PSNR within 0.3 dB per image; --eval_buckets 128 is
    ignored with sisr_tpu's notice and changes nothing; --int8 prints sisr_tpu's notice
    and stays float."""
    port = port_handler('sparnet', variables_of(jax_model('sparnet')))
    base = tmp_path / 'Results' / 'torch_exp'
    os.makedirs(base / 'saved_models')
    toml_io.dump({'model': {'name': 'sparnet', 'internal_params': SPAR}},
                 str(base / 'config.toml'))
    port.save_model('train_model', 0, str(base / 'saved_models'))
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 4, lr_size=16)
    fused = eval_cli(tmp_path, lr_dir, hr_dir, 'fused', ['--fused_eval', '--batch_size', '2'])
    standard = eval_cli(tmp_path, lr_dir, hr_dir, 'standard', [])
    buckets = eval_cli(tmp_path, lr_dir, hr_dir, 'buckets', ['--eval_buckets', '128'])
    int8 = eval_cli(tmp_path, lr_dir, hr_dir, 'int8', ['--int8', '--fused_eval',
                                                       '--batch_size', '2'])
    out = capsys.readouterr().out
    assert 'bucketed eval is not exact for this architecture' in out
    assert 'no int8 serving path for this architecture' in out
    diff = np.abs(fused[('torch_exp', 'PSNR')] - standard[('torch_exp', 'PSNR')])
    assert 0 < diff.max() <= 0.3
    np.testing.assert_array_equal(buckets[('torch_exp', 'PSNR')],
                                  standard[('torch_exp', 'PSNR')])
    np.testing.assert_array_equal(int8[('torch_exp', 'PSNR')], fused[('torch_exp', 'PSNR')])
    handler = define_model('sparnet', device='cpu', **SPAR)
    handler.set_eval_buckets(128)
    handler.set_int8(True)
    assert handler.eval_buckets is None and not handler.int8_mode


def interp_workload(root, n=4, lr_size=8):
    """Pairs whose LR folder holds the LR upscaled to HR size on the host (Pillow
    bicubic), with the blur-kernel CSV: a pre-upscaled family's training data."""
    lr_dir, hr_dir = build_workload(root, n, lr_size=lr_size, metadata_cols=10)
    interp_dir = os.path.join(root, 'lr_interp')
    os.makedirs(interp_dir)
    for name in sorted(os.listdir(lr_dir)):
        if name.endswith('.png'):
            with Image.open(os.path.join(lr_dir, name)) as im:
                im.resize((lr_size * 4, lr_size * 4), Image.BICUBIC).save(
                    os.path.join(interp_dir, name))
        else:
            with open(os.path.join(lr_dir, name)) as src, \
                    open(os.path.join(interp_dir, name), 'w') as dst:
                dst.write(src.read())
    return interp_dir, hr_dir


@pytest.mark.parametrize('recipe', ['qsparnet', 'sparnet'])
def test_train_sisr_runs_the_shipped_recipe(tmp_path, recipe):
    """train_sisr on configs/celebahq/<recipe>.toml as shipped (its model cut to SPAR's
    sizes, its data a seeded pre-upscaled folder, cutoffs in place of sparnet.toml's
    shortlists): two epochs of the standard validation, finite losses and metrics, the
    running statistics in the checkpoint; then fused_val on the same recipe gives the
    same val-PSNR within 0.3 dB."""
    config = toml_io.load(os.path.join(HERE, 'configs', 'celebahq', recipe + '.toml'))
    lr_dir, hr_dir = interp_workload(str(tmp_path / 'data'))
    config['experiment_save_loc'] = str(tmp_path / 'Results')
    config['data'].update(batch_size=2, dataloader_threads=1)
    for table, cutoff in ((config['data']['training_sets']['data_1'], [0, 4]),
                          (config['data']['eval_sets']['data_1'], [0, 2])):
        table.pop('image_shortlist', None)
        table.update(lr=lr_dir, hr=hr_dir, cutoff=cutoff)
    config['model']['internal_params'].update(
        {k: v for k, v in SPAR.items() if k != 'scale'})
    config['training'].update(gpu='off', num_epochs=2, save_samples=True, logging='none')
    path = str(tmp_path / 'recipe.toml')
    toml_io.dump(config, path)
    result = CliRunner().invoke(net_train.experiment_setup, ['--parameters', path],
                                catch_exceptions=False)
    assert result.exit_code == 0, result.output
    base = os.path.join(config['experiment_save_loc'], config['experiment'])
    summary = pd.read_csv(os.path.join(base, 'result_outputs', 'summary.csv'))
    assert list(summary['epoch']) == [0, 1]
    assert np.isfinite(summary[['train-loss', 'val-loss', 'val-PSNR', 'val-SSIM']]
                       .to_numpy()).all()
    saved = torch.load(os.path.join(base, 'saved_models', 'train_model_1'),
                       weights_only=True, map_location='cpu')
    assert saved['model_name'] == recipe and saved['step'] == 4
    assert all(int(v) == 4 for k, v in saved['network'].items()
               if k.endswith('num_batches_tracked'))
    assert len(os.listdir(os.path.join(base, 'result_outputs', 'epoch_1_samples'))) == 1
    config['experiment'] += '_fused'
    config['training']['fused_val'] = True
    toml_io.dump(config, path)
    result = CliRunner().invoke(net_train.experiment_setup, ['--parameters', path],
                                catch_exceptions=False)
    assert result.exit_code == 0, result.output
    fused = pd.read_csv(os.path.join(config['experiment_save_loc'], config['experiment'],
                                     'result_outputs', 'summary.csv'))
    np.testing.assert_allclose(fused['val-PSNR'], summary['val-PSNR'], atol=0.3)
    np.testing.assert_allclose(fused['train-loss'], summary['train-loss'], rtol=1e-4)
