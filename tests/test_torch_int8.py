"""sisr_tpu_torch's int8 serving of RCAN against sisr_tpu's on the same weights, on the
CPU: quantisation, calibration, one int8 conv, the int8 forward on the same int8
state, the handler's fused eval, eval_sisr --fused_eval --int8 end to end, and the
int8 context across load_model.

Bars: quantised weights and int32 conv sums bit-identical; calibration scales rtol
1e-5 (f32 conv summation order); the int8 forward >= 60 dB PSNR against sisr_tpu's
``ca_epilogue='pallas'`` forward; fused and CLI metrics within 0.01 dB PSNR and 1e-3
SSIM per image."""
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
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch import net_eval
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import channel_attention as ca
from sisr_tpu_torch.ops import quantization as tq
from sisr_tpu_torch.tools.convert_weights import (int8_state_from_jax,
                                                  params_from_state_dict,
                                                  state_dict_from_jax)
from sisr_tpu_torch.utils import toml_io

RCAN = {'scale': 4, 'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 16}
BARS = {'PSNR': 0.01, 'SSIM': 1e-3}


@pytest.fixture(scope='module')
def bridged():
    """(sisr_tpu handler, its params as numpy, the port's handler on the same
    weights, the port's params in sisr_tpu's tree naming)."""
    jax_handler = jax_define_model('rcan', eval_mode=True, **RCAN)
    jax_handler.init_state(spatial=(16, 16))
    jax_params = jax.tree.map(np.asarray, jax_handler.state.params)
    port = _port_rcan(jax_params)
    return jax_handler, jax_params, port, params_from_state_dict(
        'rcan', port.module.state_dict())


@pytest.fixture(scope='module')
def calibration_batch():
    return np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32)


def _port_rcan(jax_params, **kwargs):
    handler = define_model('rcan', device='cpu', **{**RCAN, **kwargs})
    handler.module.load_state_dict(state_dict_from_jax('rcan', jax_params))
    return handler


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def test_quantize_rcan_params_bit_identical(bridged):
    _, jax_params, _, params = bridged
    theirs = dict(_walk(jq.quantize_rcan_params(jax_params, 2, 2)))
    ours = dict(_walk(tq.quantize_rcan_params(params, 2, 2)))
    assert set(theirs) == {p for p in ours if p[-1] != 'matrix'}
    for path, value in theirs.items():
        assert ours[path].dtype == {np.dtype(np.int8): torch.int8,
                                    np.dtype(np.float32): torch.float32}[value.dtype]
        np.testing.assert_array_equal(ours[path].numpy(), np.asarray(value),
                                      err_msg='/'.join(path))


def test_calibrate_rcan_scales_matches(bridged, calibration_batch):
    _, jax_params, _, params = bridged
    theirs = jq.calibrate_rcan_scales(jax_params, [calibration_batch], 2, 2, margin=1.1)
    ours = tq.calibrate_rcan_scales(params, [calibration_batch], 2, 2, margin=1.1)
    assert sorted(ours) == sorted(theirs)
    assert 'group_1.rcab_1.conv_1' in ours and 'upsampler.conv_1' in ours
    for k in theirs:
        assert isinstance(ours[k], np.float32)
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=0, err_msg=k)


@pytest.mark.parametrize('layer', [('group_0', 'rcab_0', 'conv_0'), ('head',), ('tail',)])
def test_conv_int8_static_matches(bridged, calibration_batch, layer):
    """The int32 sums are identical and the dequantised f32 output agrees to 1e-6,
    for a body conv, the head (K = 27 padded to 32) and the tail
    (Cout = 3 padded to 8)."""
    _, jax_params, _, _ = bridged
    qp = jq.quantize_rcan_params(jax_params, 2, 2)
    scales = jq.calibrate_rcan_scales(jax_params, [calibration_batch], 2, 2, margin=1.1)
    entry = qp
    for k in layer:
        entry = entry[k]
    cin = entry['kernel'].shape[2]
    x = (np.random.RandomState(1).randn(2, 12, 10, cin) * 0.5).astype(np.float32)
    x_scale = scales['.'.join(layer)]
    x_q = jnp.clip(jnp.round(jnp.asarray(x) / x_scale), -127, 127).astype(jnp.int8)
    dn = jax.lax.conv_dimension_numbers(x_q.shape, entry['kernel'].shape,
                                        ('NHWC', 'HWIO', 'NHWC'))
    acc_theirs = jax.lax.conv_general_dilated(x_q, entry['kernel'], (1, 1), 'SAME',
                                              dimension_numbers=dn,
                                              preferred_element_type=jnp.int32)
    out_theirs = jq.conv_int8_static(jnp.asarray(x), entry['kernel'], entry['scale'],
                                     x_scale, entry['bias'])

    ours, _ = int8_state_from_jax({'e': entry}, {})
    ours = ours['e']
    x_t = torch.from_numpy(x)
    acc = tq.conv_int8_accumulate(tq.quantize_activations_static(x_t, x_scale),
                                  ours['kernel'], ours['matrix'])
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_theirs))
    out = tq.conv_int8_static(x_t, ours['kernel'], ours['scale'], x_scale, ours['bias'],
                              ours['matrix'])
    np.testing.assert_allclose(out.numpy(), np.asarray(out_theirs), atol=1e-6, rtol=0)


@pytest.mark.parametrize('n,h,w,cin,cout', [(1, 2, 3, 3, 3), (2, 5, 4, 16, 64)])
def test_int_mm_conv_matches_int64_reference(n, h, w, cin, cout):
    """The im2col route (padding K and Cout to multiples of 8, and fewer than 17
    rows up to 17) against an int64 sum written out."""
    rng = np.random.RandomState(2)
    x_q = rng.randint(-127, 128, (n, h, w, cin)).astype(np.int8)
    kernel = rng.randint(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    matrix = tq.pack_kernel_matrix(torch.from_numpy(kernel))
    assert matrix.shape == (-(-9 * cin // 8) * 8, -(-cout // 8) * 8)
    acc = tq.conv_int8_accumulate(torch.from_numpy(x_q), torch.from_numpy(kernel), matrix)
    xp = np.pad(x_q.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    ref = sum(np.einsum('nhwc,co->nhwo', xp[:, i:i + h, j:j + w], kernel[i, j].astype(
        np.int64)) for i in range(3) for j in range(3))
    np.testing.assert_array_equal(acc.numpy(), ref)


def test_pixel_shuffle_matches_sisr_tpu():
    from sisr_tpu.models.blocks import pixel_shuffle
    x = np.random.RandomState(3).rand(2, 3, 5, 12).astype(np.float32)
    np.testing.assert_array_equal(tq.pixel_shuffle(torch.from_numpy(x), 2).numpy(),
                                  np.asarray(pixel_shuffle(jnp.asarray(x), 2)))


@pytest.mark.parametrize('residual_dtype', ['float32', 'bfloat16'])
def test_int8_forward_matches_pallas_epilogue(bridged, calibration_batch, residual_dtype,
                                              monkeypatch):
    """The same int8 state (sisr_tpu's, carried across) through both forwards; every
    RCAB tail goes through fused_channel_attention_residual (its plain version on
    the CPU)."""
    _, jax_params, _, _ = bridged
    qp = jq.quantize_rcan_params(jax_params, 2, 2)
    scales = jq.calibrate_rcan_scales(jax_params, [calibration_batch], 2, 2, margin=1.1)
    x = np.random.RandomState(4).rand(2, 16, 16, 3).astype(np.float32)
    theirs = np.asarray(jq.rcan_int8_forward_static(
        qp, scales, jnp.asarray(x), 2, 2, residual_dtype=residual_dtype,
        ca_epilogue='pallas'))
    tail_calls = []
    orig = tq.fused_channel_attention_residual

    def spy(h, r, *w):
        tail_calls.append((h.dtype, r.dtype))
        return orig(h, r, *w)

    monkeypatch.setattr(tq, 'fused_channel_attention_residual', spy)
    with torch.inference_mode():
        ours = tq.rcan_int8_forward_static(*int8_state_from_jax(qp, scales),
                                           torch.from_numpy(x), 2, 2,
                                           residual_dtype=residual_dtype)
    carry = torch.float32 if residual_dtype == 'float32' else torch.bfloat16
    assert tail_calls == [(torch.float32, carry)] * 4  # one per RCAB
    assert ours.dtype == torch.float32 and ours.shape == (2, 64, 64, 3)
    assert psnr(ours.numpy(), theirs, max_value=1.0) >= 60


def test_int8_forward_rejects_int16_carry(bridged, calibration_batch):
    _, _, _, params = bridged
    qp = tq.quantize_rcan_params(params, 2, 2)
    scales = tq.calibrate_rcan_scales(params, [calibration_batch], 2, 2)
    with pytest.raises(ValueError, match='residual_dtype'):
        tq.rcan_int8_forward_static(qp, scales, torch.rand(1, 8, 8, 3), 2, 2,
                                    residual_dtype='int16')


def _assert_metric_rows(keys, ours, theirs):
    for i, key in enumerate(keys):
        bar = BARS[key.split('>')[1]]
        np.testing.assert_allclose(ours[i], theirs[i], atol=bar, rtol=0, err_msg=key)


@pytest.mark.parametrize('include_lr', [True, False])
def test_run_eval_fused_int8_matches_sisr_tpu(bridged, include_lr):
    """Each handler calibrates on the first batch and runs its int8 program inside
    the fused step.  With ``include_lr`` the LR-baseline rows (bicubic of the LR
    batch, untouched by int8) are compared too; without, only the model rows.
    sisr_tpu's handler uses the 'xla' epilogue, so the two differ in the bf16 cast
    order of each RCAB tail and in the last bit of some calibration scales."""
    _, jax_params, _, _ = bridged
    jax_handler = jax_define_model('rcan', eval_mode=True, **RCAN)
    jax_handler.init_state(spatial=(16, 16))
    jax_handler.state = jax_handler.state.replace(params=jax.tree.map(jnp.asarray,
                                                                      jax_params))
    port = _port_rcan(jax_params)
    rng = np.random.RandomState(5)
    batch = {'lr': rng.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8),
             'hr': rng.randint(0, 256, (3, 64, 64, 3)).astype(np.uint8)}
    (_, f32), _ = port.run_eval_fused(batch, include_lr=include_lr)
    jax_handler.set_int8(True)
    port.set_int8(True)
    (keys, theirs), _ = jax_handler.run_eval_fused(batch, include_lr=include_lr)
    launches = ca.fused_channel_attention.launches
    (our_keys, ours), _ = port.run_eval_fused(batch, include_lr=include_lr)
    assert ca.fused_channel_attention.launches == launches  # the module did not run
    assert our_keys == keys and port._int8_ctx is not None
    _assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))
    assert not torch.equal(ours, f32)  # the metrics are of the quantised output


def test_set_int8_without_a_family_is_ignored(bridged, calibration_batch, capsys):
    """residual_dtype: 'int16' on RCAN calibrates and runs with the bfloat16 carry,
    with sisr_tpu's message; a value no family takes raises; a handler without an
    int8 family ignores set_int8."""
    _, jax_params, _, _ = bridged
    port = _port_rcan(jax_params)
    x = torch.from_numpy(calibration_batch)
    outs = {}
    for rd in ('int16', 'bfloat16'):
        port.set_int8(True, residual_dtype=rd)
        port._ensure_int8_ctx(x)
        with torch.inference_mode():
            outs[rd] = port._int8_ctx[0](x)
    assert "residual_dtype 'int16' is EDSR-only (int16 grid) — using bfloat16." \
        in capsys.readouterr().out
    torch.testing.assert_close(outs['int16'], outs['bfloat16'], atol=0, rtol=0)
    with pytest.raises(ValueError, match='residual_dtype'):
        port.set_int8(True, residual_dtype='float16')
    port = _port_rcan(jax_params)
    port.int8_family = None
    port.set_int8(True)
    assert not port.int8_mode and 'ignoring' in capsys.readouterr().out


@pytest.mark.parametrize('attr,value', [('im_input', 'interp'), ('colorspace', 'ycbcr')])
def test_unported_calibration_inputs_raise(bridged, attr, value):
    """These inputs raised until the pre-upscaled and Y-channel families were ported;
    now they calibrate as sisr_tpu does: given the HR size (the fused path), a
    pre-upscaled family on its module's image (the LR's device bicubic; its Y for a
    ycbcr one: test_torch_int8_vdsr.py); without it (the standard protocol hands that
    image already upscaled), and for a family that takes the LR as it is, the batch
    itself."""
    from sisr_tpu_torch.ops.resize import resize_bicubic
    _, jax_params, _, _ = bridged
    port = _port_rcan(jax_params)
    setattr(port, attr, value)
    x = torch.rand(1, 8, 8, 3)
    assert torch.equal(port._int8_calibration_input(x), x)
    out = port._int8_calibration_input(x, (32, 32))
    expected = resize_bicubic(x, 32, 32) if attr == 'im_input' else x
    torch.testing.assert_close(out, expected, atol=0, rtol=0)


def _write_experiments(root, jax_handler, port):
    for name in ('jax_exp', 'torch_exp'):
        os.makedirs(os.path.join(root, name, 'saved_models'))
        toml_io.dump({'model': {'name': 'rcan', 'internal_params': RCAN}},
                     os.path.join(root, name, 'config.toml'))
    jax_handler.save_model('train_model', 0, os.path.join(root, 'jax_exp', 'saved_models'))
    jax_handler.wait_pending_checkpoints()
    port.save_model('train_model', 0, os.path.join(root, 'torch_exp', 'saved_models'))


def _read_metrics(out_loc, name):
    return pd.read_csv(os.path.join(out_loc, name, 'standard_metrics',
                                    'individual_metrics.csv'), header=[0, 1], index_col=0)


def test_cli_fused_eval_int8_matches_sisr_tpu(tmp_path, bridged):
    from sisr_tpu.evaluation.standard_eval import EvalHub as JaxEvalHub
    jax_handler, _, port, _ = bridged
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 4, lr_size=16)
    model_loc, out_loc = str(tmp_path / 'Results'), str(tmp_path / 'out')
    _write_experiments(model_loc, jax_handler, port)
    common = ['--hr_dir', hr_dir, '--lr_dir', lr_dir, '--model_loc', model_loc,
              '--out_loc', out_loc, '-m', 'PSNR', '-m', 'SSIM', '--batch_size', '2',
              '--full_directory', '--fused_eval', '--no_image_comparison', '--no-gpu',
              '--no-time_models']
    for name, extra in (('port_int8', ['--int8']), ('port_f32', [])):
        net_eval.eval_run.main(args=['-me', 'torch_exp', '0', '--results_name', name]
                               + common + extra, standalone_mode=False)
    JaxEvalHub(hr_dir=hr_dir, lr_dir=lr_dir, model_and_epoch=[('jax_exp', '0')],
               results_name='ref', gpu=False, metrics=['PSNR', 'SSIM'], data_split=None,
               save_im=False, batch_size=2, full_directory=True, lr_dir_interp=None,
               model_only=False, scale=4, model_loc=model_loc, out_loc=out_loc,
               use_test_group=False, no_image_comparison=True, num_image_save=0,
               qpi_selection=(None, None), data_attributes=None, dataset_name=None,
               image_shortlist=None, metadata_file=None, sp_gpu=0, time_models=False,
               recursive=False, fused_eval=True, int8=True).full_image_protocol()

    ours, theirs = _read_metrics(out_loc, 'port_int8'), _read_metrics(out_loc, 'ref')
    f32 = _read_metrics(out_loc, 'port_f32')
    assert list(ours.index) == list(theirs.index) and len(ours) == 4
    for side_ours, side_theirs in (('LR', 'LR'), ('torch_exp', 'jax_exp')):
        for met, bar in BARS.items():
            np.testing.assert_allclose(ours[(side_ours, met)], theirs[(side_theirs, met)],
                                       atol=bar, rtol=0, err_msg='%s %s' % (side_ours, met))
    assert abs(ours[('torch_exp', 'PSNR')].mean() - f32[('torch_exp', 'PSNR')].mean()) < 1.0
    config = toml_io.load(os.path.join(out_loc, 'port_int8', 'config.toml'))
    assert config['int8'] is True


def test_int8_ctx_refreshes_after_load(tmp_path, bridged):
    """load_model drops the quantised state built from the replaced weights; the
    next eval batch requantises and recalibrates, and the output equals a handler
    built fresh from the checkpoint."""
    _, _, src, _ = bridged
    src.save_model('train_model', 0, str(tmp_path))
    rng = np.random.RandomState(6)
    batch = {'lr': rng.randint(0, 256, (1, 8, 8, 3)).astype(np.uint8),
             'hr': rng.randint(0, 256, (1, 32, 32, 3)).astype(np.uint8)}

    handler = define_model('rcan', device='cpu', seed=123, **RCAN)
    handler.set_int8(True)
    handler.run_eval_fused(batch)  # quantises the random-init weights
    stale = handler._int8_ctx
    assert stale is not None
    handler.load_model('train_model', 0, str(tmp_path))
    assert handler._int8_ctx is None and handler.int8_mode
    (_, after_load), _ = handler.run_eval_fused(batch)
    assert handler._int8_ctx is not None and handler._int8_ctx is not stale

    fresh = define_model('rcan', device='cpu', **RCAN)
    fresh.load_model('train_model', 0, str(tmp_path))
    fresh.set_int8(True)
    (_, expected), _ = fresh.run_eval_fused(batch)
    torch.testing.assert_close(after_load, expected, atol=0, rtol=0)
    assert handler._int8_ctx[2] == fresh._int8_ctx[2]  # the same scales


def test_int8_state_from_jax_runs_in_the_handler(bridged, calibration_batch):
    """A handler given sisr_tpu's int8 state runs its forward exactly as the plain
    function does on that state."""
    _, jax_params, _, _ = bridged
    qp = jq.quantize_rcan_params(jax_params, 2, 2)
    scales = jq.calibrate_rcan_scales(jax_params, [calibration_batch], 2, 2, margin=1.1)
    port = _port_rcan(jax_params)
    port.set_int8(True)
    port.load_int8_state(*int8_state_from_jax(qp, scales))
    x = torch.from_numpy(calibration_batch)
    with torch.inference_mode():
        via_handler = port._int8_ctx[0](x)
        direct = tq.rcan_int8_forward_static(*int8_state_from_jax(qp, scales), x, 2, 2)
    torch.testing.assert_close(via_handler, direct, atol=0, rtol=0)
