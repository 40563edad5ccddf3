"""sisr_tpu_torch's SRCNN and VDSR against sisr_tpu's on the same weights, on the CPU,
with the Y-channel data they train and validate on.  Models: SRCNN [9, 1, 5] over
[1, 16, 8, 1] ('same' and valid padding), VDSR 4 3x3 convs of 16 features ('same'), and
the default patterns for the keys; 4x, pre-upscaled Y input.

Each case holds: the forwards; the weights bridge through sisr_tpu's convert_srcnn and
convert_vdsr (the reference's ``layer_dict.conv_<i>`` keys) and the default models'
keys and shapes; the Y-channel dataset's train (Y only, crops and flips) and eval
(three channels) items against sisr_tpu's SuperResImages, uint8 transport ignored; the
fused eval (the module on the Y channel of the LR's device bicubic, its output read as
Y); the epoch samples (Y recombined with the upscaled LR's CbCr); both eval protocols
end to end, the standard one's SR images recombining CbCr; training with the MSE loss
and VDSR's clip of 0.1; train_sisr with the standard validation epoch.  int8 VDSR is in
test_torch_int8_vdsr.py.

Bars: forwards 1e-5 abs; dataset items bit-equal; PSNR within 0.01 dB and SSIM within
1e-3 per image against sisr_tpu; each SR image within 1 uint8 LSB of sisr_tpu's;
training losses rtol 2e-4, parameters 5e-5 after the steps."""
import os
import random

import numpy as np
import pandas as pd
import pytest
import torch
from click.testing import CliRunner

import jax
import jax.numpy as jnp

from sisr_tpu.data.datasets import SuperResImages as JaxSuperResImages
from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch import net_train
from sisr_tpu_torch.data.datasets import SuperResImages
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.models.interface import ModelInterface
from sisr_tpu_torch.tools.convert_weights import params_from_state_dict, state_dict_from_jax
from sisr_tpu_torch.utils import toml_io
from test_torch_sparnet import interp_workload
from test_torch_srmd import (assert_metric_rows, cli_against_sisr_tpu, mixed, params_of,
                             uint8_batch)

CASES = {'srcnn': ('srcnn', {'scale': 4, 'kernel_pattern': [9, 1, 5],
                             'channel_pattern': [1, 16, 8, 1]}),
         'srcnn_valid': ('srcnn', {'scale': 4, 'kernel_pattern': [9, 1, 5],
                                   'channel_pattern': [1, 16, 8, 1], 'padding': 'valid'}),
         'vdsr': ('vdsr', {'scale': 4, 'kernel_pattern': [3] * 4,
                           'channel_pattern': [1, 16, 16, 16, 1]})}


def jax_handler(case, params=None, **kwargs):
    name, cfg = CASES[case]
    handler = jax_define_model(name, **{**cfg, **kwargs})
    handler.init_state(spatial=(16, 16))
    if params is not None:
        handler.state = handler.state.replace(params=jax.tree.map(jnp.asarray, params))
    return handler


def port_handler(case, params, **kwargs):
    name, cfg = CASES[case]
    handler = define_model(name, device='cpu', **{**cfg, **kwargs})
    handler.module.load_state_dict(state_dict_from_jax(name, params))
    return handler


@pytest.fixture(scope='module')
def jax_model():
    cache = {}

    def get(case, dtype=None):
        if (case, dtype) not in cache:
            params = params_of(cache[case, None]) if (case, None) in cache else None
            if dtype is not None and params is None:
                params = params_of(get(case))
            cache[case, dtype] = jax_handler(case, params, dtype=dtype, eval_mode=True)
        return cache[case, dtype]
    return get


@pytest.mark.parametrize('case', sorted(CASES))
def test_forward_matches_sisr_tpu_f32(jax_model, case):
    """The Y channel in, the Y channel out: the same size with 'same' padding (VDSR's
    global residual added), 12 pixels smaller a side with valid padding."""
    jax_h = jax_model(case)
    port = port_handler(case, params_of(jax_h))
    x = np.random.RandomState(0).rand(2, 21, 17, 1).astype(np.float32)
    theirs = np.asarray(jax_h.state.apply_fn({'params': jax_h.state.params}, jnp.asarray(x)))
    with torch.no_grad():
        ours = port.forward(torch.from_numpy(x)).numpy()
    assert ours.shape == theirs.shape == ((2, 9, 5, 1) if case == 'srcnn_valid'
                                          else (2, 21, 17, 1))
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)
    assert port.in_channels == 1 and port.colorspace == 'ycbcr' and port.im_input == 'interp'


@pytest.mark.parametrize('case', ['srcnn', 'vdsr'])
def test_bridge_round_trips_through_sisr_tpu_converter(jax_model, case):
    name, cfg = CASES[case]
    params = params_of(jax_model(case))
    state = state_dict_from_jax(name, params)
    n = len(cfg['kernel_pattern'])
    assert sorted(state) == sorted('layer_dict.conv_%d.%s' % (i, p) for i in range(n)
                                   for p in ('weight', 'bias'))
    back = convert_torch_state_dict(name, {k: v.numpy() for k, v in state.items()},
                                    kernel_pattern=cfg['kernel_pattern'])
    ours = jax.tree.map(np.asarray, params_from_state_dict(name, state))
    for tree in (back, ours):
        assert jax.tree.structure(tree) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match='unread'):
        params_from_state_dict(name, {**state, 'layer_dict.stray.weight': torch.zeros(1)})
    with pytest.raises(RuntimeError, match='unconsumed'):
        state_dict_from_jax(name, {**params, 'stray': {'kernel': np.zeros(1)}})


@pytest.mark.parametrize('name', ['srcnn', 'vdsr'])
def test_default_models_have_the_reference_keys(name):
    """SRCNN [9, 5, 5] over [1, 64, 32, 1]; VDSR 20 convs of 64: the reference's
    layer_dict keys and shapes, read by sisr_tpu's converter; VDSR's clip 0.1, MSE."""
    handler = define_model(name, device='cpu', scale=4)
    state = handler.module.state_dict()
    if name == 'srcnn':
        shapes = {'layer_dict.conv_0.weight': (64, 1, 9, 9),
                  'layer_dict.conv_1.weight': (32, 64, 5, 5),
                  'layer_dict.conv_2.weight': (1, 32, 5, 5)}
    else:
        shapes = {'layer_dict.conv_0.weight': (64, 1, 3, 3),
                  'layer_dict.conv_10.weight': (64, 64, 3, 3),
                  'layer_dict.conv_19.weight': (1, 64, 3, 3)}
    for key, shape in shapes.items():
        assert tuple(state[key].shape) == shape, key
    assert len(state) == 2 * (3 if name == 'srcnn' else 20)
    convert_torch_state_dict(name, {k: v.numpy() for k, v in state.items()})
    assert handler.loss_type == 'mse'
    assert handler.grad_clip == (0.1 if name == 'vdsr' else None)


@pytest.mark.parametrize('split', ['train', 'eval'])
def test_y_channel_dataset_items_match_sisr_tpu(tmp_path, split):
    """The Y-channel dataset of a pre-upscaled family: train (Y only, random crops of 12
    and flips, each item under the same ``random`` seed) and eval (three channels) items
    bit-equal to sisr_tpu's; the trainer's uint8 transport is ignored (floats, as
    sisr_tpu's)."""
    lr_dir, hr_dir = interp_workload(str(tmp_path / 'data'), n=3)
    train = split == 'train'
    kwargs = dict(input='interp', colorspace='ycbcr', y_only=train, scale=4,
                  random_crop=12 if train else None, random_augments=True if train else None)
    theirs = JaxSuperResImages(lr_dir=lr_dir, hr_dir=hr_dir, split=None, **kwargs)
    ours = SuperResImages(lr_dir=lr_dir, hr_dir=hr_dir, split=None, **kwargs)
    ours.keep_uint8 = theirs.keep_uint8 = True
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        random.seed(i)
        a = ours[i]
        random.seed(i)
        b = theirs[i]
        for key in ('lr', 'hr'):
            assert a[key].dtype == np.float32
            assert a[key].shape == ((12, 12, 1) if train else (32, 32, 3))
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a['tag'] == b['tag']


@pytest.mark.parametrize('dtype', [None, 'bf16'])
@pytest.mark.parametrize('case', ['srcnn', 'vdsr'])
def test_run_eval_fused_matches_sisr_tpu(jax_model, case, dtype):
    """The fused step on a uint8 batch of 8^2 -> 32^2: the module on the Y channel of
    the LR's device bicubic, its output read as Y; the loss row against HR's Y."""
    jax_h = jax_model(case, dtype)
    port = port_handler(case, params_of(jax_h), dtype=dtype)
    batch = uint8_batch(1, lr=8)
    (keys, theirs), _ = jax_h.run_eval_fused(batch)
    (our_keys, ours), _ = port.run_eval_fused(batch)
    assert our_keys == keys and ours.shape == (len(keys), 3)
    assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))
    (_, with_loss), _ = port.run_eval_fused(batch, request_loss=True, include_lr=False)
    (_, their_loss), _ = jax_h.run_eval_fused(batch, request_loss=True, include_lr=False)
    np.testing.assert_allclose(with_loss[-1].numpy(), np.asarray(their_loss)[-1], rtol=1e-3)


def test_samples_recombine_the_upscaled_chroma(jax_model):
    """super_resolve (the epoch samples) of a Y model on an LR batch with its HR: the
    module's Y on the upscaled LR's Y, with that image's CbCr, in RGB: as the standard
    protocol's recombination (ModelInterface.net_run_and_process) gives it."""
    port = port_handler('vdsr', params_of(jax_model('vdsr')))
    batch = uint8_batch(2, n=2, lr=8)
    ours = port.super_resolve(batch)
    assert ours.shape == (2, 32, 32, 3)
    from sisr_tpu_torch.ops.resize import resize_bicubic
    interp = resize_bicubic(torch.from_numpy(batch['lr']).float() / 255.0, 32, 32).numpy()
    ycbcr = ModelInterface.colorspace_convert(np.clip(interp, 0, 1), colorspace='rgb')
    out_y = port.run_eval(ycbcr[..., :1])[0]
    expected = ModelInterface.colorspace_convert(
        np.concatenate([np.clip(out_y, 0, 1), ycbcr[..., 1:]], -1), colorspace='ycbcr')
    np.testing.assert_allclose(ours, np.clip(expected, 0, 1), atol=2e-5, rtol=0)


@pytest.mark.parametrize('protocol', ['fused', 'standard'])
@pytest.mark.parametrize('case', ['srcnn', 'vdsr'])
def test_cli_protocols_match_sisr_tpu(tmp_path, jax_model, mixed, case, protocol):
    """eval_sisr --no-gpu against sisr_tpu's EvalHub: the fused protocol on 16^2 ->
    64^2 pairs; the standard one on the mixed-size set, each SR image (the model's Y
    with the LR's CbCr) within 1 LSB of sisr_tpu's."""
    jax_h = jax_model(case)
    if protocol == 'fused':
        lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 4, lr_size=16)
    else:
        lr_dir, hr_dir = mixed
    cli_against_sisr_tpu(tmp_path, jax_h, port_handler(case, params_of(jax_h)),
                         CASES[case][0], CASES[case][1], lr_dir, hr_dir,
                         protocol == 'fused', 4 if protocol == 'fused' else 3)


@pytest.mark.parametrize('case', ['srcnn', 'vdsr'])
def test_training_trajectory_matches_sisr_tpu(case):
    """6 train steps on Y batches (HR-size LR), the MSE loss and, for VDSR, its default
    clip of 0.1, from the same weights and batches as sisr_tpu's."""
    name, cfg = CASES[case]
    train = {**cfg, 'lr': 1e-3, 'scheduler': 'cosine_annealing_warm_restarts',
             'scheduler_params': {'t_mult': 1, 'restart_period': 4, 'lr_min': 1e-6}}
    theirs = jax_handler(case, **train)
    port = define_model(name, device='cpu', seed=3, **train)
    port.module.load_state_dict(state_dict_from_jax(name, params_of(theirs)))
    assert port.grad_clip == theirs.grad_clip == (0.1 if case == 'vdsr' else None)
    rng = np.random.RandomState(42)
    ours_losses, their_losses = [], []
    for _ in range(6):
        batch = {'lr': rng.rand(2, 20, 20, 1).astype(np.float32),
                 'hr': rng.rand(2, 20, 20, 1).astype(np.float32)}
        ours_losses.append(float(port.run_train(**batch)[0]))
        their_losses.append(float(theirs.run_train(**batch)[0]))
    np.testing.assert_allclose(ours_losses, their_losses, rtol=2e-4, atol=2e-6)
    ours = jax.tree.map(lambda t: t.detach().numpy(),
                        params_from_state_dict(name, port.module.state_dict()))
    deltas = jax.tree.leaves(jax.tree.map(lambda a, b: float(np.abs(a - np.asarray(b)).max()),
                                          ours, theirs.state.params))
    assert max(deltas) < 5e-5


@pytest.mark.parametrize('case', ['srcnn', 'vdsr'])
def test_train_sisr_with_the_standard_validation(tmp_path, case):
    """train_sisr on a Y-channel recipe over a pre-upscaled folder: crops of 16 and
    flips of the Y channel, the standard validation epoch on the three-channel eval
    items (host Y PSNR/SSIM), two epochs, finite losses and metrics, checkpoints and
    the RGB samples."""
    name, cfg = CASES[case]
    lr_dir, hr_dir = interp_workload(str(tmp_path / 'data'))
    data = {'lr': lr_dir, 'hr': hr_dir}
    config = {'experiment': case + '_y', 'experiment_save_loc': str(tmp_path / 'Results'),
              'data': {'batch_size': 2, 'dataloader_threads': 1,
                       'training_sets': {'data_1': {**data, 'cutoff': [0, 4], 'crop': 16,
                                                    'random_augment': True}},
                       'eval_sets': {'data_1': {**data, 'cutoff': [0, 2]}}},
              'model': {'name': name, 'internal_params': {**cfg, 'lr': 1e-4}},
              'training': {'gpu': 'off', 'seed': 8, 'num_epochs': 2,
                           'metrics': ['PSNR', 'SSIM'], 'logging': 'none'}}
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
    assert saved['model_name'] == name and saved['step'] == 4
    sample = os.path.join(base, 'result_outputs', 'epoch_1_samples')
    from PIL import Image
    with Image.open(os.path.join(sample, sorted(os.listdir(sample))[0])) as im:
        assert im.mode == 'RGB' and im.size == (32, 32)
