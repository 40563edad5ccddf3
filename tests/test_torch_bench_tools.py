"""sisr_tpu_torch's benchmark tools against sisr_tpu's, on the CPU at small sizes: the
e2e configs and the analytic FLOP models equal, the workload's bytes equal, the e2e
protocol's per-image metrics on bridged weights within 0.01 dB / 1e-3, the soak's
bicubic baseline equal, and each tool running to its printed line or JSON (module
sizes shrunk with monkeypatch).  ``ca_epilogue='plain'`` equals ``'kernel'`` here,
where the kernel's wrapper runs its plain version."""
import functools
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax
from PIL import Image

from sisr_tpu.tools import e2e_bench as jax_e2e
from sisr_tpu.tools import flops as jax_flops
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import quantization as qz
from sisr_tpu_torch.tools import (bench_bucketed, bench_ca_epilogue, bench_decode_cache,
                                  bench_models, bench_quantization, e2e_bench, flops,
                                  train_soak)
from sisr_tpu_torch.tools.convert_weights import params_from_state_dict, state_dict_from_jax

EDSR_TINY = {'scale': 4, 'num_features': 8, 'num_blocks': 1}


def test_e2e_configs_equal_sisr_tpus():
    assert e2e_bench.E2E_CONFIGS == jax_e2e.E2E_CONFIGS


@pytest.mark.parametrize('name, grid', [
    ('edsr_flops_per_image', [dict(), dict(feats=256, blocks=32), dict(lr=48, scale=2),
                              dict(lr=32, feats=32, blocks=4, scale=3),
                              dict(scale=8)]),
    ('rcan_flops_per_image', [dict(), dict(groups=5, blocks=10, reduction=8),
                              dict(lr=64, scale=2), dict(feats=32, scale=3)]),
    ('qrcan_flops_per_image', [dict(), dict(num_metadata=10), dict(q_layers=3),
                               dict(feats=32, groups=2, blocks=3, scale=2)]),
])
def test_flop_models_equal_sisr_tpus(name, grid):
    for kwargs in grid:
        assert getattr(flops, name)(**kwargs) == getattr(jax_flops, name)(**kwargs), kwargs


def test_peak_flops_override_and_unknown_card(monkeypatch):
    monkeypatch.setenv('BENCH_PEAK_TFLOPS', '100')
    assert flops.peak_flops() == 100e12
    monkeypatch.delenv('BENCH_PEAK_TFLOPS')
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda device=None: 'Some GPU')
    with pytest.raises(RuntimeError, match='BENCH_PEAK_TFLOPS'):
        flops.peak_flops()
    monkeypatch.setattr(torch.cuda, 'get_device_name',
                        lambda device=None: 'NVIDIA H100 80GB HBM3')
    assert flops.peak_flops() == 989e12


def _files(root):
    out = {}
    for folder, _, names in os.walk(root):
        for name in names:
            with open(os.path.join(folder, name), 'rb') as f:
                out[os.path.relpath(os.path.join(folder, name), root)] = f.read()
    return out


@pytest.mark.parametrize('set5', [False, True])
def test_build_workload_writes_sisr_tpus_bytes(tmp_path, monkeypatch, set5):
    source = None
    if set5:  # a stand-in Set5 folder: two images large enough, one too small
        source = str(tmp_path / 'set5')
        os.makedirs(source)
        rng = np.random.RandomState(3)
        for name, side in (('a.png', 300), ('b.png', 280), ('c.png', 100)):
            Image.fromarray(rng.randint(0, 255, (side, side + 7, 3)).astype(np.uint8)) \
                .save(os.path.join(source, name))
    monkeypatch.setattr(jax_e2e, 'SET5_HR', source or jax_e2e.SET5_HR)
    monkeypatch.setattr(e2e_bench, 'SET5_HR', source or jax_e2e.SET5_HR)
    for cols in (0, 10):
        ours, theirs = str(tmp_path / ('ours%d' % cols)), str(tmp_path / ('theirs%d' % cols))
        assert e2e_bench.build_workload(ours, 3, lr_size=8, metadata_cols=cols) == \
            (os.path.join(ours, 'lr'), os.path.join(ours, 'hr'))
        jax_e2e.build_workload(theirs, 3, lr_size=8, metadata_cols=cols)
        got, want = _files(ours), _files(theirs)
        assert sorted(got) == sorted(want) and got == want
        assert ('lr/degradation_metadata.csv' in got) == bool(cols)


def _individual(out_root):
    return pd.read_csv(os.path.join(out_root, 'bench_eval', 'standard_metrics',
                                    'individual_metrics.csv'), header=[0, 1], index_col=0)


def test_measure_e2e_matches_sisr_tpu_on_bridged_weights(tmp_path, monkeypatch):
    monkeypatch.setenv('BENCH_PASSES', '1')
    lr_dir, hr_dir = jax_e2e.build_workload(str(tmp_path / 'data'), 4, lr_size=16)
    jax_loc = jax_e2e.build_experiment(str(tmp_path / 'jax'), 'exp', 'edsr', EDSR_TINY,
                                       (16, 16))
    from sisr_tpu.models.handlers import define_model as jax_define_model
    jax_handler = jax_define_model('edsr', eval_mode=True, **EDSR_TINY)
    jax_handler.init_state(spatial=(16, 16))
    jax_handler.load_model('train_model', 0, os.path.join(jax_loc, 'exp', 'saved_models'))
    params = jax.tree.map(np.asarray, jax_handler.state.params)

    port_loc = e2e_bench.build_experiment(str(tmp_path / 'port'), 'exp', 'edsr', EDSR_TINY,
                                          (16, 16))
    port = define_model('edsr', device='cpu', **EDSR_TINY)
    port.module.load_state_dict(state_dict_from_jax('edsr', params))
    port.save_model('train_model', 0, os.path.join(port_loc, 'exp', 'saved_models'))

    rate = e2e_bench.measure_e2e(lr_dir, hr_dir, port_loc, str(tmp_path / 'out_port'),
                                 'exp', 2, 4, device='cpu')
    jax_e2e.measure_e2e(lr_dir, hr_dir, jax_loc, str(tmp_path / 'out_jax'), 'exp', 2, 4)
    assert rate > 0
    ours, theirs = _individual(str(tmp_path / 'out_port')), _individual(str(tmp_path /
                                                                            'out_jax'))
    assert list(ours.index) == list(theirs.index) and len(ours) == 4
    for key, bar in (('PSNR', 0.01), ('SSIM', 1e-3)):
        np.testing.assert_allclose(ours[('exp', key)], theirs[('exp', key)], atol=bar,
                                   rtol=0)
        np.testing.assert_allclose(ours[('LR', key)], theirs[('LR', key)], atol=bar, rtol=0)


def test_run_config_measures_the_protocol_and_cleans_up(monkeypatch):
    """run_config's measure_e2e writes a finite per-image CSV, and the temporary folder
    goes after; the e2e config shrunk to a tiny EDSR."""
    monkeypatch.setenv('BENCH_PASSES', '1')
    monkeypatch.setitem(e2e_bench.E2E_CONFIGS, 'edsr',
                        dict(e2e_bench.E2E_CONFIGS['edsr'], internal=EDSR_TINY))
    monkeypatch.setattr(e2e_bench, 'build_workload',
                        functools.partial(e2e_bench.build_workload, lr_size=8))
    measure, seen = e2e_bench.measure_e2e, []

    def measure_and_read(lr_dir, hr_dir, model_loc, out_root, *args, **kwargs):
        rate = measure(lr_dir, hr_dir, model_loc, out_root, *args, **kwargs)
        seen.append((out_root, _individual(out_root)))
        return rate
    monkeypatch.setattr(e2e_bench, 'measure_e2e', measure_and_read)
    assert e2e_bench.run_config('edsr', 2, 2, device='cpu') > 0
    [(out_root, frame)] = seen
    assert len(frame) == 2 and np.isfinite(frame[('bench_edsr', 'PSNR')]).all()
    assert not os.path.exists(os.path.dirname(out_root))


def test_bench_quantization_section_prints_its_lines(monkeypatch, capsys):
    monkeypatch.setattr(bench_quantization, 'BATCH', 2)
    monkeypatch.setattr(bench_quantization, 'ITERS', 1)
    monkeypatch.setattr(bench_quantization, 'HW', 12)
    monkeypatch.setattr(bench_models, 'WARM', 0)
    [result] = bench_quantization.main(['srmd', '--device', 'cpu'])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith('srmd bf16 model           : ') and 'img/s' in lines[0]
    assert lines[1].startswith('srmd int8 static          : ') and 'dB vs f32' in lines[1]
    assert result['bf16_img_s'] > 0 and set(result['int8']) == {'bfloat16'}
    assert result['int8']['bfloat16']['db_vs_f32'] > 20


def test_bench_quantization_edsr_carries(monkeypatch, capsys):
    """EDSR's three carries through one calibration, each line in sisr_tpu's layout."""
    monkeypatch.setattr(bench_quantization, 'ITERS', 1)
    monkeypatch.setattr(bench_models, 'WARM', 0)
    result = bench_quantization._section(
        'edsr', 'edsr', EDSR_TINY, bench_quantization._serving_x(hw=8, batch=2),
        carries=('float32', 'bfloat16', 'int16'), device='cpu',
        lines=('edsr bf16 model           ', 'edsr int8, %-9s res  '))
    lines = capsys.readouterr().out.splitlines()
    assert [line[:26] for line in lines[1:]] == ['edsr int8, float32   res  ',
                                                 'edsr int8, bfloat16  res  ',
                                                 'edsr int8, int16     res  ']
    assert all(v['db_vs_f32'] > 20 for v in result['int8'].values())


def test_bench_bucketed_runs_and_counts_shapes(monkeypatch, capsys):
    monkeypatch.setattr(bench_bucketed, 'N_IMAGES', 4)
    monkeypatch.setattr(bench_bucketed, 'SHAPES', [(8, 12), (12, 8), (20, 20)])
    results = bench_bucketed.main(['--device', 'cpu'])
    out = capsys.readouterr().out
    assert 'bucketed cold-run speedup' in out
    # per shape: 3 input shapes; buckets of 32: every image padded to (32, 32)
    assert [r[2] for r in results.values()] == [3, 1]


def test_bench_decode_cache_prints_its_json(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(e2e_bench.E2E_CONFIGS, 'edsr',
                        dict(e2e_bench.E2E_CONFIGS['edsr'], internal=EDSR_TINY))
    monkeypatch.setattr(e2e_bench, 'build_workload',
                        functools.partial(e2e_bench.build_workload, lr_size=8))
    timed_passes, arms = bench_decode_cache._timed_passes, []

    def passes_and_read(hub, *args, **kwargs):
        out = timed_passes(hub, *args, **kwargs)
        lr_dir = hub.rgb_data.dataset.lr_base
        arms.append((os.listdir(os.path.join(lr_dir, '.decoded_u8'))
                     if os.path.isdir(os.path.join(lr_dir, '.decoded_u8')) else [],
                     pd.read_csv(os.path.join(hub.out_dir, 'standard_metrics',
                                              'individual_metrics.csv'),
                                 header=[0, 1], index_col=0)))
        return out
    monkeypatch.setattr(bench_decode_cache, '_timed_passes', passes_and_read)
    result = bench_decode_cache.main(['--images', '2', '--batch', '2', '--passes', '1',
                                      '--device', 'cpu'])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result and set(line) == {'metric', 'png_img_per_sec',
                                            'sidecar_img_per_sec', 'sidecar_speedup',
                                            'unit', 'recommend_default'}
    # the sidecar arm read the sidecars its warm-up wrote, with the png arm's metrics
    [(_, png), (sidecars, sidecar)] = arms
    assert sidecars
    pd.testing.assert_frame_equal(png, sidecar)


def test_train_soak_writes_its_result(tmp_path, capsys):
    out = str(tmp_path / 'soak')
    result = train_soak.main(['--steps', '2', '--images', '4', '--batch', '2', '--feats',
                              '8', '--blocks', '1', '--out', out, '--device', 'cpu'])
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith('SOAK_RESULT ')]
    assert json.loads(printed[-1][len('SOAK_RESULT '):]) == result
    with open(os.path.join(out, 'soak_result.json')) as f:
        assert json.load(f) == result
    assert sorted(os.listdir(out)) == ['run_tracking.jsonl', 'soak_config.toml',
                                       'soak_result.json', 'summary.csv']
    assert result['steps'] == 2 and result['model'] == 'edsr 8f/1b bf16'
    assert all(np.isfinite(result[k]) for k in ('train_img_per_sec_per_chip',
                                                'db_over_bicubic'))


def test_soak_bicubic_baseline_equals_sisr_tpus(tmp_path):
    from sisr_tpu.evaluation.standard_eval import EvalHub as JaxEvalHub
    from sisr_tpu.ops.metrics import Metrics as JaxMetrics
    lr_dir, hr_dir = jax_e2e.build_workload(str(tmp_path), 5, lr_size=12)
    hub = JaxMetrics(['PSNR'], delimeter='>')
    fake = type('H', (), {'scale': 4})()
    vals = []
    for name in sorted(os.listdir(hr_dir))[:4]:
        lr = np.asarray(Image.open(os.path.join(lr_dir, name)), np.float32)[None] / 255.0
        hr = np.asarray(Image.open(os.path.join(hr_dir, name)), np.float32)[None] / 255.0
        interp, _ = JaxEvalHub._low_res_prep(fake, lr, timing=False)
        res, _ = hub.run_metrics(JaxEvalHub._high_res_prep(fake, interp),
                                 references=JaxEvalHub._high_res_prep(fake, hr), key='LR')
        vals.extend(np.atleast_1d(res['LR>PSNR']).tolist())
    assert train_soak.bicubic_baseline(lr_dir, hr_dir) == pytest.approx(float(np.mean(vals)),
                                                                        abs=1e-9)


def test_bench_models_table_and_failed_row(monkeypatch, capsys):
    monkeypatch.setattr(bench_models, 'BATCH', 1)
    monkeypatch.setattr(bench_models, 'ITERS', 1)
    monkeypatch.setattr(bench_models, 'WARM', 0)
    monkeypatch.setattr(bench_models, 'LR', 8)
    assert bench_models.main(['edsr', 'qedsr', 'sftmd', 'srmd', '--device', 'cpu']) == 0
    rows = capsys.readouterr().out.splitlines()
    assert rows[0].startswith('family') and [r.split()[0] for r in rows[1:]] == \
        ['edsr', 'srmd', 'sftmd', 'qedsr']
    families = bench_models._families()
    monkeypatch.setattr(bench_models, '_families', lambda: families + [
        ('broken', lambda: ('no_such_model', {}, 8, None))])
    assert bench_models.main(['edsr', 'broken', '--device', 'cpu']) == 1
    assert '%-9s %10s  (KeyError' % ('broken', 'FAILED') in capsys.readouterr().out


def test_train_and_val_benches_run(monkeypatch, capsys):
    monkeypatch.setitem(e2e_bench.EDSR_BENCH, 'internal_params', EDSR_TINY)
    monkeypatch.setattr(e2e_bench, 'build_workload',
                        functools.partial(e2e_bench.build_workload, lr_size=8))
    monkeypatch.setattr(e2e_bench, 'TIMED_EPOCHS', 1)
    assert bench_models.main_train({'--train'}, 'cpu')['train_img_s'] > 0
    std, fused = bench_models.main_val('cpu')
    assert std > 0 and fused > 0
    out = capsys.readouterr().out
    assert 'train epoch throughput' in out and 'fused_val' in out


def _int8_rcan(model, **arch):
    handler = define_model(model, eval_mode=True, device='cpu', scale=2, n_feats=16, **arch)
    params = params_from_state_dict(model, handler.module.state_dict())
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 8, 8, 3).astype(np.float32))
    quant = getattr(qz, 'quantize_%s_params' % model)(params, 2, 2)
    scales = getattr(qz, 'calibrate_%s_scales' % model)(params, [x], 2, 2, margin=1.1)
    return quant, scales, x


@pytest.mark.parametrize('model', ['rcan', 'han'])
def test_ca_epilogue_plain_equals_kernel_on_the_cpu(model):
    quant, scales, x = _int8_rcan(model, n_resgroups=2, n_resblocks=2)
    program = getattr(qz, '%s_int8_forward_static' % model)
    with torch.inference_mode():
        kernel = program(quant, scales, x, 2, 2)
        plain = program(quant, scales, x, 2, 2, ca_epilogue='plain')
        assert torch.equal(kernel, program(quant, scales, x, 2, 2, ca_epilogue='kernel'))
    assert torch.equal(kernel, plain)
    with pytest.raises(ValueError, match='ca_epilogue'):
        program(quant, scales, x, 2, 2, ca_epilogue='xla')


def test_bench_ca_epilogue_standalone_on_the_cpu(monkeypatch):
    monkeypatch.setattr(bench_ca_epilogue, 'ITERS', 1)
    for r_dtype in ('bfloat16', 'float32'):
        result = bench_ca_epilogue.bench_standalone(2, 8, 8, 64, device='cpu',
                                                    r_dtype=r_dtype)
        assert result['route'] == 'plain' and result['max_abs_err'] == 0.0
        assert result['shape'] == [2, 8, 8, 64] and result['bound_ms'] is None
    e2e = bench_ca_epilogue.bench_e2e_int8_rcan(2, 8, 2, 2, device='cpu')
    assert e2e['max_abs_err'] == 0.0 and e2e['layers'] == [2, 2]
    witness = e2e['witness_psnr_db_unclipped']
    assert set(witness) == set(bench_ca_epilogue.WITNESS_POOLS)
    assert all(v > 40 for v in witness.values())
