"""sisr_tpu_torch's Q-EDSR (EDSR with a ParaCALayer gate on the metadata in every
block) against sisr_tpu's on the same weights, on the CPU, with the gate's
nonlinearity on and off: the forward in f32, the weights bridge both ways and through
sisr_tpu's own converter, the fused eval in f32 and bf16, 5 training steps, and int8
serving (quantisation, calibration, the int8 forward on the same int8 state, the fused
eval, eval_sisr --fused_eval --int8 end to end).

Bars: forward 5e-4 abs; PSNR within 0.01 dB and SSIM within 1e-3 per image; losses
rtol 2e-4; quantised weights bit-identical; calibration scales rtol 1e-5; the int8
forward >= 60 dB PSNR against sisr_tpu's."""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.ops import quantization as jq
from sisr_tpu.ops.metrics import psnr
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch import net_eval
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import quantization as tq
from sisr_tpu_torch.tools.convert_weights import (int8_state_from_jax,
                                                  params_from_state_dict,
                                                  state_dict_from_jax)
from sisr_tpu_torch.utils import toml_io

QEDSR = {'scale': 4, 'num_features': 32, 'num_blocks': 2, 'metadata': ['blur_kernel']}
KEYS = ['blur_kernel'] * 10
BARS = {'PSNR': 0.01, 'SSIM': 1e-3}
NONLINEARITY = [False, True]


def _internal(nonlinearity, **extra):
    return {**QEDSR, 'q_layer_nonlinearity': nonlinearity, **extra}


@pytest.fixture(scope='module')
def jax_qedsr():
    cache = {}

    def get(nonlinearity, dtype=None):
        if (nonlinearity, dtype) not in cache:
            handler = jax_define_model('qedsr', eval_mode=True, dtype=dtype,
                                       **_internal(nonlinearity))
            handler.set_metadata_keys(KEYS)
            handler.init_state(spatial=(16, 16))
            cache[nonlinearity, dtype] = handler
        return cache[nonlinearity, dtype]
    return get


def _params(jax_handler):
    return jax.tree.map(np.asarray, jax_handler.state.params)


def _port(jax_params, nonlinearity, **kwargs):
    handler = define_model('qedsr', device='cpu', **_internal(nonlinearity, **kwargs))
    handler.set_metadata_keys(KEYS)
    handler.module.load_state_dict(state_dict_from_jax('qedsr', jax_params,
                                                       q_layer_nonlinearity=nonlinearity))
    return handler


def _inputs(seed, n=2, size=12):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, size, size, 3).astype(np.float32),
            rng.dirichlet(np.ones(10) * 5, n).astype(np.float32))


def _batch(seed, n=3, lr=16):
    rng = np.random.RandomState(seed)
    return {'lr': rng.randint(0, 256, (n, lr, lr, 3)).astype(np.uint8),
            'hr': rng.randint(0, 256, (n, 4 * lr, 4 * lr, 3)).astype(np.uint8),
            'metadata': rng.rand(n, 10).astype(np.float32)}


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _assert_metric_rows(keys, ours, theirs):
    for i, key in enumerate(keys):
        bar = BARS[key.split('>')[1]]
        np.testing.assert_allclose(ours[i], theirs[i], atol=bar, rtol=0, err_msg=key)


@pytest.mark.parametrize('nonlinearity', NONLINEARITY)
def test_forward_matches_sisr_tpu_f32(jax_qedsr, nonlinearity):
    jax_handler = jax_qedsr(nonlinearity)
    x, meta = _inputs(0)
    theirs = np.asarray(jax_handler.state.apply_fn({'params': jax_handler.state.params}, x,
                                                   metadata=jnp.asarray(meta)))
    port = _port(_params(jax_handler), nonlinearity)
    assert port.uses_metadata and port.colorspace == 'augmented_rgb'
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        ours = port.forward(xt, port.prepare_metadata(xt, torch.from_numpy(meta))).numpy()
    assert ours.shape == theirs.shape == (2, 48, 48, 3)
    np.testing.assert_allclose(ours, theirs, atol=5e-4, rtol=0)


@pytest.mark.parametrize('nonlinearity', NONLINEARITY)
def test_bridge_round_trips_through_sisr_tpu_converter(jax_qedsr, nonlinearity):
    """sisr_tpu tree -> port state_dict (the ReLU shifts the second layer's index)
    -> sisr_tpu's convert_torch_state_dict (no leftover keys) gives the tree back; the
    port's own reader gives it too, reading the flag off the indices."""
    params = _params(jax_qedsr(nonlinearity))
    port = _port(params, nonlinearity)
    state = {k: v.numpy() for k, v in port.module.state_dict().items()}
    assert ('body.1.attention_layer.attribute_integrator.2.weight' in state) == nonlinearity
    assert {'head.weight', 'final_body.weight', 'tail.0.2.weight', 'tail.1.bias'} <= set(state)
    back = convert_torch_state_dict('qedsr', state, num_blocks=2, scale=4,
                                    q_layer_nonlinearity=nonlinearity)
    ours = jax.tree.map(np.asarray, params_from_state_dict('qedsr', port.module.state_dict()))
    for tree in (back, ours):
        assert jax.tree.structure(tree) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)


def test_bridge_rejects_mismatched_trees(jax_qedsr):
    params = _params(jax_qedsr(True))
    with pytest.raises(RuntimeError, match='unconsumed'):
        state_dict_from_jax('qedsr', {**params, 'stray': {'kernel': np.zeros(1)}})
    with pytest.raises(KeyError, match='final_body'):
        state_dict_from_jax('qedsr', {k: v for k, v in params.items() if k != 'final_body'})
    # keys laid out without the ReLU do not load into a model that has it
    port = define_model('qedsr', device='cpu', **_internal(True))
    with pytest.raises(RuntimeError, match='attribute_integrator'):
        port.module.load_state_dict(state_dict_from_jax('qedsr', params))


@pytest.mark.parametrize('nonlinearity', NONLINEARITY)
@pytest.mark.parametrize('dtype', [None, 'bf16'])
def test_run_eval_fused_matches_sisr_tpu(jax_qedsr, nonlinearity, dtype):
    """The fused step with a (N, 10) metadata batch.  In bf16 sisr_tpu runs the gate's
    Dense chain in bf16, the port in f32, rounding once to bf16."""
    jax_handler = jax_qedsr(nonlinearity, dtype)
    batch = _batch(1)
    (keys, theirs), _ = jax_handler.run_eval_fused(batch)
    port = _port(_params(jax_handler), nonlinearity, dtype=dtype)
    (our_keys, ours), _ = port.run_eval_fused(batch)
    assert our_keys == keys and ours.shape == (len(keys), 3)
    _assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))


TRAIN = {'lr': 1e-3, 'scheduler': 'cosine_annealing_warm_restarts',
         'scheduler_params': {'t_mult': 1, 'restart_period': 3, 'lr_min': 1e-6},
         'grad_clip': 0.5}


@pytest.mark.parametrize('nonlinearity', NONLINEARITY)
def test_training_matches_sisr_tpu(nonlinearity):
    """5 run_train steps of a 2-block Q-EDSR (16 features, scale 2) against sisr_tpu's
    from the same weights and batches, across a warm restart: losses within rtol
    2e-4, final parameters within 5e-5.  Training needs no path of its own."""
    arch = _internal(nonlinearity, scale=2, num_features=16, **TRAIN)
    port = define_model('qedsr', device='cpu', seed=3, **arch)
    port.set_metadata_keys(KEYS)
    theirs = jax_define_model('qedsr', eval_mode=False, **arch)
    theirs.set_metadata_keys(KEYS)
    theirs.init_state(spatial=(8, 8), batch=2)

    def to_jax(handler):
        sd = {k: v.detach().numpy().copy() for k, v in handler.module.state_dict().items()}
        return convert_torch_state_dict('qedsr', sd, num_blocks=2, scale=2,
                                        q_layer_nonlinearity=nonlinearity)
    theirs.state = theirs.state.replace(params=to_jax(port))
    rng = np.random.RandomState(42)
    ours_losses, their_losses = [], []
    for _ in range(5):
        batch = {'lr': rng.rand(2, 8, 8, 3).astype(np.float32),
                 'hr': rng.rand(2, 16, 16, 3).astype(np.float32),
                 'metadata': rng.rand(2, 10).astype(np.float32)}
        ours_losses.append(float(port.run_train(**batch)[0]))
        their_losses.append(float(theirs.run_train(**batch)[0]))
    np.testing.assert_allclose(ours_losses, their_losses, rtol=2e-4, atol=2e-6)
    delta = max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
                for a, b in zip(jax.tree.leaves(to_jax(port)),
                                jax.tree.leaves(theirs.state.params)))
    assert delta < 5e-5 and port.step == 5


def test_training_refuses_what_check_trainable_refuses():
    """The perceptual loss is not ported (bf16 training is: it takes a step)."""
    batch = _batch(2, n=2, lr=8)
    handler = define_model('qedsr', device='cpu', dtype='bf16', **QEDSR)
    handler.set_metadata_keys(KEYS)
    assert torch.isfinite(handler.run_train(**batch)[0])
    handler = define_model('qedsr', device='cpu', perceptual=0.1, **QEDSR)
    handler.set_metadata_keys(KEYS)
    with pytest.raises(NotImplementedError, match='perceptual'):
        handler.run_train(**batch)
    evaluator = define_model('qedsr', device='cpu', eval_mode=True, **QEDSR)
    with pytest.raises(RuntimeError, match='eval mode'):
        evaluator.run_train(**batch)


# --- int8 serving ----------------------------------------------------------------------------
def test_quantize_qedsr_params_bit_identical(jax_qedsr):
    params = _params(jax_qedsr(True))
    port = _port(params, True)
    ours = dict(_walk(tq.quantize_qedsr_params(
        params_from_state_dict('qedsr', port.module.state_dict()), 2)))
    theirs = dict(_walk(jq.quantize_qedsr_params(params, 2)))
    assert set(theirs) == {p for p in ours if p[-1] != 'matrix'}
    assert ('block_1', 'attention', 'fc_1', 'kernel') in ours
    for path, value in theirs.items():
        np.testing.assert_array_equal(ours[path].numpy(), np.asarray(value),
                                      err_msg='/'.join(path))


@pytest.mark.parametrize('nonlinearity', NONLINEARITY)
def test_calibrate_qedsr_scales_matches(jax_qedsr, nonlinearity):
    params = _params(jax_qedsr(nonlinearity))
    ours_params = params_from_state_dict('qedsr', _port(params, nonlinearity)
                                         .module.state_dict())
    x, meta = _inputs(2)
    theirs = jq.calibrate_qedsr_scales(params, [x], [meta], num_blocks=2, scale=4,
                                       res_scale=0.1, nonlinearity=nonlinearity, margin=1.1)
    ours = tq.calibrate_qedsr_scales(ours_params, [x], [meta], 2, 4, 0.1, nonlinearity,
                                     margin=1.1)
    assert sorted(ours) == sorted(theirs)
    assert {'block_1.conv_1', 'final_body', 'upsampler.conv_1', 'tail'} <= set(ours)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=0, err_msg=k)
    with pytest.raises(ValueError, match='1 sample batches but 0 metadata'):
        tq.calibrate_qedsr_scales(ours_params, [x], [], 2, 4)


@pytest.mark.parametrize('nonlinearity,residual_dtype', [(False, 'bfloat16'),
                                                         (True, 'bfloat16'),
                                                         (True, 'float32')])
def test_int8_forward_matches_sisr_tpu(jax_qedsr, nonlinearity, residual_dtype):
    params = _params(jax_qedsr(nonlinearity))
    x, meta = _inputs(3)
    qp = jq.quantize_qedsr_params(params, 2)
    cfg = dict(num_blocks=2, scale=4, res_scale=0.1, nonlinearity=nonlinearity)
    scales = jq.calibrate_qedsr_scales(params, [x], [meta], margin=1.1, **cfg)
    x2, meta2 = _inputs(4)
    theirs = np.asarray(jq.qedsr_int8_forward_static(
        qp, scales, jnp.asarray(x2), jnp.asarray(meta2), residual_dtype=residual_dtype,
        **cfg))
    with torch.inference_mode():
        ours = tq.qedsr_int8_forward_static(*int8_state_from_jax(qp, scales),
                                            torch.from_numpy(x2), torch.from_numpy(meta2),
                                            residual_dtype=residual_dtype, **cfg)
    assert ours.dtype == torch.float32 and ours.shape == (2, 48, 48, 3)
    assert psnr(ours.numpy(), theirs, max_value=1.0) >= 60


@pytest.mark.parametrize('nonlinearity', NONLINEARITY)
def test_run_eval_fused_int8_matches_sisr_tpu(jax_qedsr, nonlinearity):
    params = _params(jax_qedsr(nonlinearity))
    jax_handler = jax_define_model('qedsr', eval_mode=True, **_internal(nonlinearity))
    jax_handler.set_metadata_keys(KEYS)
    jax_handler.init_state(spatial=(16, 16))
    jax_handler.state = jax_handler.state.replace(params=jax.tree.map(jnp.asarray, params))
    port = _port(params, nonlinearity)
    batch = _batch(5)
    (_, f32), _ = port.run_eval_fused(batch)
    jax_handler.set_int8(True)
    port.set_int8(True)
    (keys, theirs), _ = jax_handler.run_eval_fused(batch)
    (our_keys, ours), _ = port.run_eval_fused(batch)
    assert our_keys == keys and port._int8_ctx is not None
    _assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))
    assert not torch.equal(ours, f32)


def test_int8_int16_carry_is_bfloat16_and_metadata_is_required(jax_qedsr, capsys):
    """'int16' is EDSR's carry: Q-EDSR prints sisr_tpu's message and runs the bfloat16
    program; calibration without metadata raises sisr_tpu's error."""
    params = _params(jax_qedsr(True))
    port = _port(params, True)
    x, meta = (torch.from_numpy(a) for a in _inputs(6))
    port.set_int8(True, residual_dtype='int16')
    with pytest.raises(RuntimeError, match='int8 QEDSR calibration needs a metadata batch'):
        port._ensure_int8_ctx(x)
    port._ensure_int8_ctx(port._int8_calibration_input(x), meta)
    assert "int8 qedsr: residual_dtype 'int16' is EDSR-only" in capsys.readouterr().out
    program, qparams, scales = port._int8_ctx
    with torch.inference_mode():
        ours = program(x, meta)
        bf16 = tq.qedsr_int8_forward_static(qparams, scales, x, meta, 2, 4, 0.1, True,
                                            residual_dtype='bfloat16')
    torch.testing.assert_close(ours, bf16, atol=0, rtol=0)


def _read_metrics(out_loc, name):
    return pd.read_csv(os.path.join(out_loc, name, 'standard_metrics',
                                    'individual_metrics.csv'), header=[0, 1], index_col=0)


def test_cli_fused_eval_matches_sisr_tpu(tmp_path, jax_qedsr):
    """eval_sisr --fused_eval --no-gpu, without and with --int8, on a folder whose
    degradation_metadata.csv has 10-value blur kernels, against sisr_tpu's EvalHub on
    the same weights."""
    from sisr_tpu.evaluation.standard_eval import EvalHub as JaxEvalHub
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 3, lr_size=16, metadata_cols=10)
    model_loc, out_loc = str(tmp_path / 'Results'), str(tmp_path / 'out')
    jax_handler = jax_qedsr(True)
    for name in ('jax_exp', 'torch_exp'):
        os.makedirs(os.path.join(model_loc, name, 'saved_models'))
        toml_io.dump({'model': {'name': 'qedsr', 'internal_params': _internal(True)}},
                     os.path.join(model_loc, name, 'config.toml'))
    jax_handler.save_model('train_model', 0, os.path.join(model_loc, 'jax_exp', 'saved_models'))
    jax_handler.wait_pending_checkpoints()
    _port(_params(jax_handler), True).save_model(
        'train_model', 0, os.path.join(model_loc, 'torch_exp', 'saved_models'))
    for int8 in (False, True):
        net_eval.eval_run.main(
            args=['--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'torch_exp', '0',
                  '--model_loc', model_loc, '--out_loc', out_loc, '--results_name',
                  'port_%s' % int8, '-m', 'PSNR', '-m', 'SSIM', '--batch_size', '2',
                  '--full_directory', '--fused_eval', '--no_image_comparison',
                  '--no-time_models', '--no-gpu'] + (['--int8'] if int8 else []),
            standalone_mode=False)
        JaxEvalHub(hr_dir=hr_dir, lr_dir=lr_dir, model_and_epoch=[('jax_exp', '0')],
                   results_name='ref_%s' % int8, gpu=False, metrics=['PSNR', 'SSIM'],
                   data_split=None, save_im=False, batch_size=2, full_directory=True,
                   lr_dir_interp=None, model_only=False, scale=4, model_loc=model_loc,
                   out_loc=out_loc, use_test_group=False, no_image_comparison=True,
                   num_image_save=0, qpi_selection=(None, None), data_attributes=None,
                   dataset_name=None, image_shortlist=None, metadata_file=None, sp_gpu=0,
                   time_models=False, recursive=False, fused_eval=True,
                   int8=int8).full_image_protocol()
        ours = _read_metrics(out_loc, 'port_%s' % int8)
        theirs = _read_metrics(out_loc, 'ref_%s' % int8)
        assert list(ours.index) == list(theirs.index) and len(ours) == 3
        for side_ours, side_theirs in (('LR', 'LR'), ('torch_exp', 'jax_exp')):
            for met, bar in BARS.items():
                np.testing.assert_allclose(ours[(side_ours, met)], theirs[(side_theirs, met)],
                                           atol=bar, rtol=0,
                                           err_msg='int8=%s %s %s' % (int8, side_ours, met))
