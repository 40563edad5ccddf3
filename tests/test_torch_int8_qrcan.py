"""sisr_tpu_torch's int8 serving of Q-RCAN against sisr_tpu's on the same weights, on
the CPU, for every QCALayer style, with and without pa_node and q_node: the f32
attention helpers, quantisation, calibration on the handler-prepared metadata, the
int8 forward on the same int8 state (the kernel styles' tail through
fused_channel_attention_residual, or fused_channel_attention before a pa_node, their
plain versions here), the handler's fused eval and
eval_sisr --fused_eval --int8 end to end; and the handler's int8 bookkeeping: a
re-key drops the int8 context, augmented_rgb inputs calibrate, metadata is required.

Bars: quantised weights bit-identical; calibration scales rtol 1e-5; the int8
forward >= 60 dB PSNR against sisr_tpu's; fused and CLI metrics within 0.01 dB PSNR
and 1e-3 SSIM per image."""
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

QRCAN = {'scale': 4, 'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 32, 'reduction': 16}
BARS = {'PSNR': 0.01, 'SSIM': 1e-3}
# case -> (style, structure flags): every style, with and without pa_node and q_node
CASES = {
    'max_concat_q': ('max_concat', {'include_q_layer': True}),  # the e2e_bench config
    'max_concat_pa_q': ('max_concat', {'include_pixel_attention': True,
                                       'include_q_layer': True}),
    'max_concat_selective': ('max_concat', {'include_q_layer': True,
                                            'selective_meta_blocks': [False, True],
                                            'num_q_layers_inner_residual': 1}),
    'standard': ('standard', {}),
    'standard_q': ('standard', {'include_q_layer': True}),
    'modulate_q': ('modulate', {'include_q_layer': True}),
    'modulate_pa': ('modulate', {'include_pixel_attention': True}),
    'mini_concat_q': ('mini_concat', {'include_q_layer': True}),
    'softmax_pa_q': ('softmax', {'include_pixel_attention': True, 'include_q_layer': True}),
    'extended_attention_pa': ('extended_attention', {'include_pixel_attention': True}),
}


def _internal(case):
    style, flags = CASES[case]
    return {**QRCAN, 'style': style,
            'metadata': ['qpi'] if style == 'modulate' else ['blur_kernel'], **flags}


def _keys(case):
    return ['qpi'] if CASES[case][0] == 'modulate' else ['blur_kernel'] * 10


@pytest.fixture(scope='module')
def bridged():
    """case -> (sisr_tpu handler, its params as numpy, the port's handler on the same
    weights, the port's params in sisr_tpu's tree naming)."""
    cache = {}

    def get(case):
        if case not in cache:
            jax_handler = jax_define_model('qrcan', eval_mode=True, **_internal(case))
            jax_handler.set_metadata_keys(_keys(case))
            jax_handler.init_state(spatial=(16, 16))
            jax_params = jax.tree.map(np.asarray, jax_handler.state.params)
            port = _port(case, jax_params)
            cache[case] = (jax_handler, jax_params, port,
                           params_from_state_dict('qrcan', port.module.state_dict()))
        return cache[case]
    return get


def _port(case, jax_params):
    handler = define_model('qrcan', device='cpu', **_internal(case))
    handler.set_metadata_keys(_keys(case))
    handler.module.load_state_dict(state_dict_from_jax('qrcan', jax_params))
    return handler


def _inputs(case, seed, n=2, size=12):
    """An f32 LR batch, and its metadata as each handler prepares it (column
    selection; scale_qpi for 'modulate'), as numpy."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, size, size, 3).astype(np.float32)
    meta = rng.rand(n, len(_keys(case))).astype(np.float32)
    return x, meta


def _prepared(bridged, case, x, meta):
    jax_handler, _, port, _ = bridged(case)
    theirs = np.asarray(jax_handler.prepare_metadata(jnp.asarray(x), jnp.asarray(meta)))
    ours = port.prepare_metadata(torch.from_numpy(x), torch.from_numpy(meta))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-6, atol=1e-7)
    return theirs


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize('case', sorted(CASES))
def test_attention_helpers_match_sisr_tpu(bridged, case):
    """_qca_apply (each style), _pa_apply and _para_ca_apply (with and without the
    nonlinearity) on the same vectors and weights, in f32: 1e-6."""
    _, jax_params, _, params = bridged(case)
    x, meta = _inputs(case, 0)
    meta = _prepared(bridged, case, x, meta)
    style = CASES[case][0]
    rng = np.random.RandomState(1)
    pooled = rng.randn(2, 32).astype(np.float32)
    for g, b in ((0, 0), (1, 1)):
        theirs = jax_params['group_%d' % g]['qrcab_%d' % b]
        ours = params['group_%d' % g]['qrcab_%d' % b]
        np.testing.assert_allclose(
            tq._qca_apply(ours['qca'], torch.from_numpy(pooled), torch.from_numpy(meta),
                          style).numpy(),
            np.asarray(jq._qca_apply(theirs['qca'], jnp.asarray(pooled), jnp.asarray(meta),
                                     style)), atol=1e-6, rtol=0)
        if 'pa_node' in theirs:
            h = rng.randn(2, 5, 4, 32).astype(np.float32)
            np.testing.assert_allclose(
                tq._pa_apply(ours['pa_node'], torch.from_numpy(h)).numpy(),
                np.asarray(jq._pa_apply(theirs['pa_node'], jnp.asarray(h))), atol=1e-6,
                rtol=0)
        if 'q_node' in theirs:
            for nonlinearity in (True, False):
                np.testing.assert_allclose(
                    tq._para_ca_apply(ours['q_node'], torch.from_numpy(meta),
                                      nonlinearity).numpy(),
                    np.asarray(jq._para_ca_apply(theirs['q_node'], jnp.asarray(meta),
                                                 nonlinearity)), atol=1e-6, rtol=0)


@pytest.mark.parametrize('case', ['max_concat_pa_q', 'max_concat_selective',
                                  'extended_attention_pa', 'mini_concat_q'])
def test_quantize_qrcan_params_bit_identical(bridged, case):
    _, jax_params, _, params = bridged(case)
    theirs = dict(_walk(jq.quantize_qrcan_params(jax_params, 2, 2)))
    ours = dict(_walk(tq.quantize_qrcan_params(params, 2, 2)))
    assert set(theirs) == {p for p in ours if p[-1] != 'matrix'}
    for path, value in theirs.items():
        np.testing.assert_array_equal(ours[path].numpy(), np.asarray(value),
                                      err_msg='/'.join(path))


@pytest.mark.parametrize('case', sorted(CASES))
def test_calibrate_qrcan_scales_matches(bridged, case):
    _, jax_params, _, params = bridged(case)
    x, meta = _inputs(case, 2)
    meta = _prepared(bridged, case, x, meta)
    style = CASES[case][0]
    theirs = jq.calibrate_qrcan_scales(jax_params, [x], [meta], style=style,
                                       n_resgroups=2, n_resblocks=2, margin=1.1)
    ours = tq.calibrate_qrcan_scales(params, [x], [meta], style, 2, 2, margin=1.1)
    assert sorted(ours) == sorted(theirs)
    assert {'group_1.qrcab_1.conv_1', 'group_1.final_body', 'final_body'} <= set(ours)
    for k in theirs:
        assert isinstance(ours[k], np.float32)
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=0, err_msg=k)


def test_calibrate_qrcan_scales_refuses_a_count_mismatch(bridged):
    _, _, _, params = bridged('max_concat_q')
    x, meta = _inputs('max_concat_q', 3)
    with pytest.raises(ValueError, match='1 sample batches but 2 metadata'):
        tq.calibrate_qrcan_scales(params, [x], [meta, meta], 'max_concat', 2, 2)
    with pytest.raises(ValueError, match='no calibration batches'):
        tq.calibrate_qrcan_scales(params, [], [], 'max_concat', 2, 2)


@pytest.mark.parametrize('case,residual_dtype', [(c, 'bfloat16') for c in sorted(CASES)]
                         + [('max_concat_q', 'float32'), ('modulate_pa', 'float32')])
def test_int8_forward_matches_sisr_tpu(bridged, case, residual_dtype, monkeypatch):
    """The same int8 state (sisr_tpu's, carried across) through both forwards.  The
    kernel styles make one kernel call per QRCAB on f32 y, with the metadata
    (max_concat) and the expanded metadata (modulate): without a pa_node the whole
    tail, one fused_channel_attention_residual call (cast first, on the carry, with
    the q_node's gate); with one, a fused_channel_attention call.  The other styles
    make none."""
    _, jax_params, _, _ = bridged(case)
    style = CASES[case][0]
    x, meta = _inputs(case, 4)
    meta = _prepared(bridged, case, x, meta)
    qp = jq.quantize_qrcan_params(jax_params, 2, 2)
    scales = jq.calibrate_qrcan_scales(jax_params, [x], [meta], style=style,
                                       n_resgroups=2, n_resblocks=2, margin=1.1)
    x2, meta2 = _inputs(case, 5)
    meta2 = _prepared(bridged, case, x2, meta2)
    theirs = np.asarray(jq.qrcan_int8_forward_static(
        qp, scales, jnp.asarray(x2), jnp.asarray(meta2), style=style, n_resgroups=2,
        n_resblocks=2, residual_dtype=residual_dtype))
    calls = []

    def spy(y, *weights, meta=None, gate=None):
        calls.append(('ca', y.dtype, meta is not None, gate is not None))
        return ca.fused_channel_attention(y, *weights, meta=meta, gate=gate)

    def spy_residual(y, r, *weights, meta=None, gate=None, cast_first=False):
        calls.append(('residual', y.dtype, meta is not None, gate is not None, r.dtype,
                      cast_first))
        return ca.fused_channel_attention_residual(y, r, *weights, meta=meta, gate=gate,
                                                   cast_first=cast_first)

    monkeypatch.setattr(tq, 'fused_channel_attention', spy)
    monkeypatch.setattr(tq, 'fused_channel_attention_residual', spy_residual)
    with torch.inference_mode():
        ours = tq.qrcan_int8_forward_static(*int8_state_from_jax(qp, scales),
                                            torch.from_numpy(x2), torch.from_numpy(meta2),
                                            style, 2, 2, residual_dtype=residual_dtype)
    assert ours.dtype == torch.float32 and ours.shape == (2, 48, 48, 3)
    assert psnr(ours.numpy(), theirs, max_value=1.0) >= 60
    if style not in ca.KERNEL_STYLES:
        assert calls == []
        return
    flags = CASES[case][1]
    carry = torch.float32 if residual_dtype == 'float32' else torch.bfloat16
    blocks = [qp['group_%d' % g]['qrcab_%d' % b] for g in range(2) for b in range(2)]
    expected = [('ca', torch.float32, style == 'max_concat', style == 'modulate')
                if flags.get('include_pixel_attention') else
                ('residual', torch.float32, style == 'max_concat',
                 style == 'modulate' or 'q_node' in blk, carry, True)
                for blk in blocks]
    assert calls == expected


def _assert_metric_rows(keys, ours, theirs):
    for i, key in enumerate(keys):
        bar = BARS[key.split('>')[1]]
        np.testing.assert_allclose(ours[i], theirs[i], atol=bar, rtol=0, err_msg=key)


def _jax_twin(case, jax_params):
    """A fresh sisr_tpu handler of ``case`` on these params (set_int8 changes it)."""
    handler = jax_define_model('qrcan', eval_mode=True, **_internal(case))
    handler.set_metadata_keys(_keys(case))
    handler.init_state(spatial=(16, 16))
    handler.state = handler.state.replace(params=jax.tree.map(jnp.asarray, jax_params))
    return handler


@pytest.mark.parametrize('case', ['max_concat_q', 'modulate_q', 'softmax_pa_q'])
def test_run_eval_fused_int8_matches_sisr_tpu(bridged, case):
    """Each handler calibrates on the first batch and its prepared metadata, and runs
    its int8 program with the batch's metadata inside the fused step."""
    _, jax_params, _, _ = bridged(case)
    jax_handler, port = _jax_twin(case, jax_params), _port(case, jax_params)
    rng = np.random.RandomState(6)
    batch = {'lr': rng.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8),
             'hr': rng.randint(0, 256, (3, 64, 64, 3)).astype(np.uint8),
             'metadata': rng.rand(3, len(_keys(case))).astype(np.float32)}
    (_, f32), _ = port.run_eval_fused(batch)
    jax_handler.set_int8(True)
    port.set_int8(True)
    (keys, theirs), _ = jax_handler.run_eval_fused(batch)
    (our_keys, ours), _ = port.run_eval_fused(batch)
    assert our_keys == keys and port._int8_ctx is not None
    _assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))
    assert not torch.equal(ours, f32)


def _read_metrics(out_loc, name):
    return pd.read_csv(os.path.join(out_loc, name, 'standard_metrics',
                                    'individual_metrics.csv'), header=[0, 1], index_col=0)


def test_cli_fused_eval_int8_matches_sisr_tpu(tmp_path, bridged):
    """eval_sisr --fused_eval --int8 --no-gpu on a folder whose
    degradation_metadata.csv has 10-value blur kernels, against sisr_tpu's EvalHub
    with int8=True on the same weights."""
    from sisr_tpu.evaluation.standard_eval import EvalHub as JaxEvalHub
    case = 'max_concat_q'
    jax_handler, _, port, _ = bridged(case)
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 4, lr_size=16, metadata_cols=10)
    model_loc, out_loc = str(tmp_path / 'Results'), str(tmp_path / 'out')
    for name in ('jax_exp', 'torch_exp'):
        os.makedirs(os.path.join(model_loc, name, 'saved_models'))
        toml_io.dump({'model': {'name': 'qrcan', 'internal_params': _internal(case)}},
                     os.path.join(model_loc, name, 'config.toml'))
    jax_handler.save_model('train_model', 0, os.path.join(model_loc, 'jax_exp', 'saved_models'))
    jax_handler.wait_pending_checkpoints()
    port.save_model('train_model', 0, os.path.join(model_loc, 'torch_exp', 'saved_models'))
    net_eval.eval_run.main(
        args=['--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'torch_exp', '0',
              '--model_loc', model_loc, '--out_loc', out_loc, '--results_name', 'port',
              '-m', 'PSNR', '-m', 'SSIM', '--batch_size', '2', '--full_directory',
              '--fused_eval', '--no_image_comparison', '--no-time_models', '--no-gpu',
              '--int8'], standalone_mode=False)
    JaxEvalHub(hr_dir=hr_dir, lr_dir=lr_dir, model_and_epoch=[('jax_exp', '0')],
               results_name='ref', gpu=False, metrics=['PSNR', 'SSIM'], data_split=None,
               save_im=False, batch_size=2, full_directory=True, lr_dir_interp=None,
               model_only=False, scale=4, model_loc=model_loc, out_loc=out_loc,
               use_test_group=False, no_image_comparison=True, num_image_save=0,
               qpi_selection=(None, None), data_attributes=None, dataset_name=None,
               image_shortlist=None, metadata_file=None, sp_gpu=0, time_models=False,
               recursive=False, fused_eval=True, int8=True).full_image_protocol()
    ours, theirs = _read_metrics(out_loc, 'port'), _read_metrics(out_loc, 'ref')
    assert list(ours.index) == list(theirs.index) and len(ours) == 4
    for side_ours, side_theirs in (('LR', 'LR'), ('torch_exp', 'jax_exp')):
        for met, bar in BARS.items():
            np.testing.assert_allclose(ours[(side_ours, met)], theirs[(side_theirs, met)],
                                       atol=bar, rtol=0, err_msg='%s %s' % (side_ours, met))


def test_rekey_drops_the_int8_context(bridged):
    """The scales were calibrated on the selected metadata columns: a re-key that
    changes the selection drops them (and the cached steps); one that keeps it does
    not."""
    case = 'max_concat_q'
    _, jax_params, _, _ = bridged(case)
    port = _port(case, jax_params)
    port.metadata = ['blur_kernel']
    rng = np.random.RandomState(7)
    batch = {'lr': rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8),
             'hr': rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8),
             'metadata': rng.rand(2, 11).astype(np.float32)}
    port.set_metadata_keys(['qpi'] + ['blur_kernel'] * 10)
    port.set_int8(True)
    port.run_eval_fused(batch)
    calibrated = port._int8_ctx
    assert calibrated is not None and port._eval_step_cache
    port.set_metadata_keys(['qpi'] + ['blur_kernel'] * 10)  # the same columns
    assert port._int8_ctx is calibrated
    port.set_metadata_keys(['blur_kernel'] * 10 + ['qpi'])  # the kernel moved
    assert port._int8_ctx is None and not port._eval_step_cache
    assert not port._warm_eval_shapes
    assert list(port.meta_indices) == list(range(10))
    port.run_eval_fused({**batch, 'metadata': np.roll(batch['metadata'], -1, axis=1)})
    # the same selected values as before the re-key: the same scales
    assert port._int8_ctx[2] == calibrated[2]


def test_augmented_rgb_calibrates_and_needs_metadata(bridged):
    """Q-RCAN's augmented_rgb input is the LR batch itself; calibration without the
    batch's metadata raises sisr_tpu's error."""
    case = 'max_concat_q'
    _, _, port, _ = bridged(case)
    assert port.colorspace == 'augmented_rgb'
    x = torch.rand(1, 8, 8, 3)
    assert port._int8_calibration_input(x) is x
    port.set_int8(True)
    with pytest.raises(RuntimeError, match='int8 QRCAN calibration needs a metadata batch'):
        port._ensure_int8_ctx(x)
    port.set_int8(False)


def test_int8_state_from_jax_runs_in_the_handler(bridged):
    """sisr_tpu's Q-RCAN int8 state carried across: the int8 convs get their packed
    matrix, the f32 qca, pa_node and q_node entries none; a handler given it runs
    program(x, meta) exactly as the plain function does."""
    case = 'max_concat_pa_q'
    _, jax_params, _, _ = bridged(case)
    x, meta = _inputs(case, 8)
    meta = _prepared(bridged, case, x, meta)
    qp = jq.quantize_qrcan_params(jax_params, 2, 2)
    scales = jq.calibrate_qrcan_scales(jax_params, [x], [meta], style='max_concat',
                                       n_resgroups=2, n_resblocks=2, margin=1.1)
    ours, _ = int8_state_from_jax(qp, scales)
    block = ours['group_0']['qrcab_0']
    assert 'matrix' in block['conv_0']
    for part in ('qca', 'pa_node', 'q_node'):
        assert all(path[-1] in ('kernel', 'bias') for path, _ in _walk(block[part]))
    port = _port(case, jax_params)
    port.set_int8(True)
    port.load_int8_state(*int8_state_from_jax(qp, scales))
    xt, mt = torch.from_numpy(x), torch.from_numpy(meta)
    with torch.inference_mode():
        via_handler = port._int8_ctx[0](xt, mt)
        direct = tq.qrcan_int8_forward_static(*int8_state_from_jax(qp, scales), xt, mt,
                                              'max_concat', 2, 2)
    torch.testing.assert_close(via_handler, direct, atol=0, rtol=0)
