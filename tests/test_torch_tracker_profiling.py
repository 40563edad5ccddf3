"""sisr_tpu_torch's JSONL tracker against sisr_tpu's (the same records for the same
calls, the time field aside), its wiring into train_sisr (``aim_track``, ``aim_home``:
sisr_tpu's run names, parameters and per-epoch metrics) with
``model_cleanup_frequency`` (clean_models every N epochs, as sisr_tpu calls it), and
the profiling helpers on the CPU: a Chrome trace of a block and the plain-clock
device timer."""
import json
import math
import os

import numpy as np
import pandas as pd
import pytest
import torch
from click.testing import CliRunner

from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu.tools.tracker import JsonlTracker as JaxTracker
from sisr_tpu_torch import net_train
from sisr_tpu_torch.tools import helper_cli, profiling
from sisr_tpu_torch.tools.tracker import JsonlTracker
from sisr_tpu_torch.utils import toml_io

INTERNAL = {'scale': 2, 'n_resgroups': 1, 'n_resblocks': 1, 'n_feats': 16,
            'style': 'standard', 'include_q_layer': True, 'metadata': ['blur_kernel'],
            'lr': 1e-3}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_tracker_records_match_sisr_tpu(tmp_path):
    """start, params, metrics (floats, numpy and torch scalars, a diverged NaN and an
    infinity as null, extra context), end: equal but for ``time``."""
    paths = []
    for cls, repo in ((JsonlTracker, tmp_path / 'port'), (JaxTracker, tmp_path / 'ref')):
        tracker = cls('exp', str(repo), run='run_1')
        tracker.set_params({'name': 'qrcan', 'internal_params': {'scale': 4, 'lr': 1e-4,
                                                                 'metadata': ['blur_kernel']}},
                           name='model_parameters')
        tracker.track(0.25, name='train_loss', epoch=0)
        tracker.track(np.float32(21.5), name='val_PSNR', epoch=0, subset='val')
        tracker.track(np.float64('nan'), name='val_loss', epoch=1)
        tracker.track(float('inf'), name='val_SSIM', epoch=1)
        tracker.track([1.0, float('nan')], name='curve', epoch=2)
        tracker.close()
        paths.append(tracker.path)
    ours, theirs = _records(paths[0]), _records(paths[1])
    assert os.path.relpath(paths[0], tmp_path / 'port') == \
        os.path.relpath(paths[1], tmp_path / 'ref') == os.path.join('exp', 'run_1.jsonl')
    assert all(isinstance(r.pop('time'), float) for r in ours + theirs)
    assert ours == theirs
    assert ours[4]['value'] is ours[5]['value'] is None and ours[-2]['value'] == [1.0, None]
    port = JsonlTracker('exp', str(tmp_path / 'torch_scalar'), run='r')
    port.track(torch.tensor(0.5), name='lr', epoch=3)
    port.close()
    assert _records(port.path)[1]['value'] == 0.5


@pytest.fixture(scope='module')
def workload(tmp_path_factory):
    root = tmp_path_factory.mktemp('tracking')
    lr_dir, hr_dir = build_workload(str(root / 'data'), 4, lr_size=10, scale=2,
                                    metadata_cols=10)
    return str(root), lr_dir, hr_dir


def _config(root, lr_dir, hr_dir, experiment, training):
    data_set = {'lr': lr_dir, 'hr': hr_dir, 'degradation_metadata': 'on_site',
                'metadata': ['blur_kernel']}
    path = os.path.join(root, experiment + '.toml')
    toml_io.dump({
        'experiment': experiment, 'experiment_save_loc': root,
        'data': {'batch_size': 2, 'dataloader_threads': 1,
                 'training_sets': {'data_1': {**data_set, 'crop': 5}},
                 'eval_sets': {'data_1': {**data_set, 'cutoff': 2}}},
        'model': {'name': 'qrcan', 'internal_params': INTERNAL},
        'training': {'gpu': 'off', 'seed': 8, 'metrics': ['PSNR', 'SSIM'],
                     'logging': 'none', 'fused_val': True, **training}}, path)
    return path


def _train(cfg, *args):
    result = CliRunner().invoke(net_train.experiment_setup, ['--parameters', cfg, *args],
                                catch_exceptions=False)
    assert result.exit_code == 0, result.output


def test_train_sisr_tracks_and_cleans(workload, monkeypatch):
    """3 epochs with aim_track, then a resume: sisr_tpu's run names, its two params
    records, each epoch's metrics (its summary.csv row) and epoch_time; clean_models
    called at the epochs sisr_tpu calls it (i != 0, i % N == 0) on the experiment
    folder, with the samples, after the checkpoints are on disk."""
    root, lr_dir, hr_dir = workload
    home = os.path.join(root, 'aim')
    calls = []
    real_clean = helper_cli.clean_models

    def clean(folder, **kwargs):
        calls.append((os.path.basename(folder), sorted(os.listdir(os.path.join(
            folder, 'saved_models'))), kwargs))
        return real_clean(folder, **kwargs)
    monkeypatch.setattr(helper_cli, 'clean_models', clean)
    cfg = _config(root, lr_dir, hr_dir, 'tracked', {'aim_track': True, 'aim_home': home,
                                                     'model_cleanup_frequency': 2})
    _train(cfg, '--num_epochs', '3')
    assert calls == [('tracked', ['train_model_0', 'train_model_1', 'train_model_2'],
                      {'clean_samples': True})]
    assert not [d for d in os.listdir(os.path.join(root, 'tracked', 'result_outputs'))
                if d.startswith('epoch_')]
    _train(cfg, '--num_epochs', '1', '--continue_from_epoch', '2')
    runs = sorted(os.listdir(os.path.join(home, 'tracked')))
    assert len(runs) == 2 and runs[0].startswith('continuation_from_epoch_2_tracked')
    assert runs[1].startswith('tracked_')
    first = _records(os.path.join(home, 'tracked', runs[1]))
    assert [r['event'] for r in first[:3]] == ['start', 'params', 'params']
    assert first[1]['params']['name'] == 'qrcan'
    assert first[2]['params'] == {'num_epochs': 3, 'continue_from_epoch': None, 'seed': 8,
                                  'epoch_cutoff': None}
    summary = pd.read_csv(os.path.join(root, 'tracked', 'result_outputs', 'summary.csv'))
    metrics = [r for r in first if r['event'] == 'metric']
    for epoch in range(3):
        row = summary[summary['epoch'] == epoch].iloc[0]
        tracked = {r['name']: r['value'] for r in metrics if r['epoch'] == epoch}
        assert tracked['epoch_time'] > 0
        for key in ('train-loss', 'val-loss', 'val-PSNR', 'val-SSIM', 'learning-rate'):
            assert math.isclose(tracked[key.replace('-', '_')], row[key], rel_tol=1e-5)
    resumed = _records(os.path.join(home, 'tracked', runs[0]))
    assert resumed[2]['params']['continue_from_epoch'] == 2
    assert {r['epoch'] for r in resumed if r['event'] == 'metric'} == {3}


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / 'trace'), name='block') as prof:
        torch.nn.functional.conv2d(torch.rand(1, 3, 16, 16), torch.rand(4, 3, 3, 3))
    assert prof.trace_path == str(tmp_path / 'trace' / 'block.json')
    with open(prof.trace_path) as f:
        events = json.load(f)['traceEvents']
    assert any('conv' in e.get('name', '') for e in events)


def test_device_timer_on_the_cpu(capsys):
    holder = {}
    with profiling.device_timer(holder, label='matmul', device='cpu') as box:
        box['out'] = torch.rand(64, 64) @ torch.rand(64, 64)
    assert box is holder and holder['seconds'] > 0 and holder['out'].shape == (64, 64)
    assert capsys.readouterr().out.startswith('matmul: ')
