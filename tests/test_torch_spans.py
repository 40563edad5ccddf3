"""sisr_tpu_torch's spans and counters (``tools/profiling``: ``span``, ``count``,
``device_allocs``, ``tracing``, ``trace``) on the CPU, and the benchmark's readers of
them on hand-built probe data.

Off: nothing is recorded, every span is one shared do-nothing context, and no CUDA call
is made.  On: nesting, parents, threads and units; the buffer's bound; counts and spans
from more threads than cores; device spans' events (a stand-in for CUDA's).  A tiny
train epoch gives the span tree of every step and the same losses, bit for bit, on and
off; a tiny fused eval pass gives the eval spans and the same CSVs on and off.  Each
reader: idle time given to the innermost main-thread span, a span's own time, and
nothing without data; the probe's log of idle owners and of the launch check.
"""
import os
import sys
import threading

import pytest
import torch

from benchmark.probes import program_spans
from benchmark.spec import Spec
from sisr_tpu_torch.evaluation.standard_eval import EvalHub
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.tools import profiling
from sisr_tpu_torch.tools.e2e_bench import build_workload
from sisr_tpu_torch.training.handler import TrainingHandler
from sisr_tpu_torch.utils import toml_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDSR = {'scale': 2, 'num_features': 8, 'num_blocks': 1}


def _names(records, **match):
    return [s['name'] for s in records['spans']
            if all(s[k] == v for k, v in match.items())]


def _no_cuda(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('a CUDA call while recording is off')
    for name in ('Event', 'memory_stats', 'is_initialized', 'synchronize'):
        monkeypatch.setattr(torch.cuda, name, refuse)


# --- the recorder ------------------------------------------------------------------------
def test_off_records_nothing_and_calls_no_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    assert profiling._RECORDER is None
    shared = profiling.span('train.step', device=True, unit=3)
    assert shared is profiling.span('x') is profiling.device_allocs('cuda:0')
    with shared as inside, profiling.span('y', device=True):
        profiling.count('train.steps')
    assert inside is None
    with profiling.tracing() as rec:
        pass
    assert rec.take()['spans'] == [] and rec.take.__self__._taken


def test_on_records_nesting_parents_units_and_threads():
    with profiling.tracing() as rec:
        with profiling.span('epoch'):
            for step in range(2):
                with profiling.span('wait', unit=step):
                    pass
                with profiling.span('step'):
                    with profiling.span('forward'):
                        pass
            with profiling.span('end'):
                pass
        side = threading.Thread(target=lambda: profiling.span('upload').__enter__()
                                .__exit__(None, None, None))
        side.start()
        side.join()
    with profiling.span('after'):
        pass
    out = rec.take()
    spans = out['spans']
    assert [s['name'] for s in spans] == ['epoch', 'wait', 'step', 'forward', 'wait',
                                          'step', 'forward', 'end', 'upload']
    assert [s['parent'] for s in spans] == [None, 0, 0, 2, 0, 0, 5, 0, None]
    # a unit starts at its wait and holds for its thread until the next, or the end of
    # the outermost span; another thread's spans have none
    assert [s['unit'] for s in spans] == [None, 0, 0, 0, 1, 1, 1, 1, None]
    assert {s['thread'] for s in spans[:-1]} == {out['main_thread']}
    assert spans[-1]['thread'] != out['main_thread']
    for s in spans:
        assert s['start_ns'] <= s['end_ns'] and s['device_ms'] is None
        if s['parent'] is not None:
            parent = spans[s['parent']]
            assert parent['start_ns'] <= s['start_ns'] <= s['end_ns'] <= parent['end_ns']
    with pytest.raises(RuntimeError, match='handed out'):
        rec.take()


def test_bound_and_one_block_at_a_time(monkeypatch):
    monkeypatch.setattr(profiling, 'MAX_SPANS', 3)
    with profiling.tracing() as rec:
        with pytest.raises(RuntimeError, match='already'):
            with profiling.tracing():
                pass
        for i in range(5):
            with profiling.span('s%d' % i):
                pass
    out = rec.take()
    assert [s['name'] for s in out['spans']] == ['s0', 's1', 's2'] and out['dropped'] == 2


def test_threads_lose_no_count_and_keep_their_own_nesting():
    """More threads than cores, switching often: every count lands, and each thread's
    spans nest under its own."""
    threads, rounds = 2 * (os.cpu_count() or 1) + 2, 50

    def work():
        for _ in range(rounds):
            with profiling.span('outer'):
                profiling.count('n')
                with profiling.span('inner'):
                    profiling.count('n', 2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.tracing() as rec:
            workers = [threading.Thread(target=work) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    out = rec.take()
    assert out['counters'] == {'n': 3 * threads * rounds}
    spans = out['spans']
    assert len(spans) == 2 * threads * rounds
    for s in spans:
        if s['name'] == 'inner':
            parent = spans[s['parent']]
            assert parent['name'] == 'outer' and parent['thread'] == s['thread']
        else:
            assert s['parent'] is None


class _Event:
    """A CUDA event's stand-in: its record's order is its time, in ms."""
    clock = [0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        _Event.clock[0] += 1
        self.t = _Event.clock[0]

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_device_spans_read_their_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    monkeypatch.setattr(torch.cuda, 'Event', _Event)
    with profiling.tracing() as rec:
        with profiling.span('step', device=True):
            with profiling.span('backward', device=True):
                pass
            with profiling.span('host'):
                pass
    ms = {s['name']: s['device_ms'] for s in rec.take()['spans']}
    assert ms == {'step': 3.0, 'backward': 1.0, 'host': None}


def test_trace_shows_the_spans(tmp_path):
    with profiling.trace(str(tmp_path), name='spans') as prof:
        with profiling.span('eval.step'):
            torch.ones(4).sum()
    assert _names(prof.spans) == ['eval.step']
    with open(prof.trace_path) as f:
        assert '"eval.step"' in f.read()
    assert profiling._RECORDER is None


# --- the program's spans -----------------------------------------------------------------
@pytest.fixture(scope='module')
def pairs(tmp_path_factory):
    root = tmp_path_factory.mktemp('spans')
    return build_workload(str(root / 'data'), 6, lr_size=8, scale=2)


def _trainer(root, lr_dir, hr_dir):
    data = {'batch_size': 2, 'dataloader_threads': 1,
            'training_sets': {'d': {'lr': lr_dir, 'hr': hr_dir, 'crop': 4,
                                    'random_augment': True}},
            'eval_sets': {'d': {'lr': lr_dir, 'hr': hr_dir, 'cutoff': 1}}}
    return TrainingHandler(experiment_name='x', save_loc=str(root),
                           model_params={'name': 'edsr', 'internal_params': EDSR},
                           gpu='off', data_params=data, num_epochs=1, metrics=[], seed=5,
                           logging=None, save_samples=False)


def test_train_epoch_spans_and_the_same_losses(pairs, tmp_path):
    off = _trainer(tmp_path / 'off', *pairs).train()['train-loss']
    trainer = _trainer(tmp_path / 'on', *pairs)
    with profiling.tracing() as rec:
        on = trainer.train()['train-loss']
    assert on == off and len(on) == 3
    out = rec.take()
    main = [s for s in out['spans'] if s['thread'] == out['main_thread']]
    index = {id(s): i for i, s in enumerate(out['spans'])}
    epoch = index[id(main[0])]
    assert main[0]['name'] == 'train.epoch' and main[0]['parent'] is None
    assert out['counters'] == {'train.steps': 3}
    for step in range(3):
        unit = [s for s in main if s['unit'] == step and s['parent'] == epoch]
        assert [s['name'] for s in unit] == ['train.loader_wait', 'train.step']
        parts = [s['name'] for s in main if s['parent'] == index[id(unit[1])]]
        assert parts == ['train.forward', 'train.backward', 'train.optimizer']
    # the wait that finds the loader done begins the epoch's tail
    assert [s['name'] for s in main if s['unit'] == 3] == [
        'train.loader_wait', 'train.loss_drain', 'train.epoch_end']
    assert len(main) == 1 + 3 * 5 + 1 + 2
    side = sorted(s['name'] for s in out['spans'] if s['thread'] != out['main_thread'])
    assert side == ['loader.batch'] * 3 + ['loader.upload'] * 3


def _hub(model_loc, pairs, out_loc):
    lr_dir, hr_dir = pairs
    return EvalHub(hr_dir=hr_dir, lr_dir=lr_dir, model_and_epoch=[('exp', '0')],
                   results_name='r', gpu=False, metrics=['PSNR', 'SSIM'], data_split=None,
                   save_im=False, batch_size=4, full_directory=True, lr_dir_interp=None,
                   model_only=False, scale=2, model_loc=model_loc, out_loc=str(out_loc),
                   use_test_group=False, no_image_comparison=True, num_image_save=0,
                   qpi_selection=(None, None), data_attributes=None, dataset_name=None,
                   image_shortlist=None, metadata_file=None, sp_gpu=0, time_models=False,
                   recursive=False, fused_eval=True, cache_device=True)


def _csvs(out_loc):
    folder = os.path.join(str(out_loc), 'r', 'standard_metrics')
    return {f: open(os.path.join(folder, f), 'rb').read() for f in sorted(os.listdir(folder))}


def test_fused_eval_spans_and_the_same_csvs(pairs, tmp_path):
    model_loc = str(tmp_path / 'Results')
    os.makedirs(os.path.join(model_loc, 'exp', 'saved_models'))
    toml_io.dump({'model': {'name': 'edsr', 'internal_params': EDSR}},
                 os.path.join(model_loc, 'exp', 'config.toml'))
    define_model('edsr', device='cpu', seed=1, **EDSR).save_model(
        'train_model', 0, os.path.join(model_loc, 'exp', 'saved_models'))
    hub = _hub(model_loc, pairs, tmp_path / 'out')
    csvs = []
    for recording in (False, False, True):  # the first pass fills the batch cache
        if recording:
            with profiling.tracing() as rec:
                hub.full_image_protocol()
        else:
            hub.full_image_protocol()
        csvs.append(_csvs(tmp_path / 'out'))
    assert csvs[2] == csvs[1] == csvs[0] and len(csvs[0]) == 2
    out = rec.take()
    spans = out['spans']
    assert out['counters'] == {'eval.images': 6}
    assert [s['name'] for s in spans if s['parent'] == 0] == [
        'eval.batch_wait', 'eval.step', 'eval.batch_wait', 'eval.step', 'eval.batch_wait',
        'eval.rows_copy', 'eval.report']
    assert spans[0]['name'] == 'eval.pass'
    for i, s in enumerate(spans):
        if s['name'] == 'eval.step':
            assert [c['name'] for c in spans if c['parent'] == i] == [
                'eval.prep', 'eval.forward', 'eval.metrics']
    assert [s['unit'] for s in spans if s['name'] == 'eval.step'] == [0, 1]


# --- the benchmark's readers -------------------------------------------------------------
S = 1_000_000_000  # ns a second


def _span(name, start, end, parent=None, thread=1, device_ms=None):
    return {'name': name, 'start_ns': int(start * S), 'end_ns': int(end * S),
            'parent': parent, 'unit': None, 'thread': thread, 'device_ms': device_ms}


def _probe_data():
    """A 10-s stretch: an epoch (0.5-9.2 s) of two waits and two steps on the main
    thread (1), an upload on another (2); the card busy 2.1-5.8, 6.55-6.6, 7.2-8.8."""
    spans = [_span('train.epoch', 0.5, 9.2), _span('train.loader_wait', 0.6, 2.0, 0),
             _span('train.step', 2.0, 6.0, 0),
             _span('train.backward', 3.0, 5.0, 2, device_ms=50.0),
             _span('train.loader_wait', 6.0, 6.5, 0), _span('train.step', 7.0, 9.0, 0),
             _span('train.backward', 7.5, 8.5, 5, device_ms=70.0),
             _span('loader.upload', 1.0, 1.8, thread=2)]
    device = [(int(a * S), int(b * S), 'k') for a, b in ((2.1, 5.8), (6.55, 6.6),
                                                          (7.2, 8.8))]
    calls = [(int(t * S), int(t * S) + 1000, name) for t, name in (
        (1.0, 'cudaLaunchKernel'), (3.0, 'cudaLaunchKernel'), (4.0, 'cudaMalloc'),
        (9.4, 'cudaLaunchKernel'))]
    return {'spans': spans, 'counters': {'train.steps': 2, 'cuda.device_allocs': 6},
            'dropped': 0, 'main_thread': 1, 'window': (0, 10 * S), 'device': device,
            'calls': calls}


def test_idle_goes_to_the_innermost_main_thread_span():
    idle = program_spans.idle_by_span(_probe_data())
    # gaps: 0-2.1 (mid 1.05: the first wait, not the other thread's upload), 5.8-6.55
    # (the second wait), 6.6-7.2 (the epoch's own time), 8.8-10 (no span)
    assert idle == pytest.approx({'train.loader_wait': 2.85, 'train.epoch': 0.6,
                                  None: 1.2})
    outside, owners = program_spans.launch_spans(_probe_data())
    assert outside == {'cudaLaunchKernel': 1}
    assert owners == {'train.loader_wait': 1, 'train.backward': 1, None: 1}
    # moved a second later, the launch at 3.0 s falls in the step's own time
    assert program_spans.launch_spans(_probe_data(), S)[1]['train.step'] == 1


def test_the_probe_logs_idle_owners_and_the_launch_check(capsys):
    probe = object.__new__(program_spans.ProgramSpans)
    probe._data = _probe_data()
    probe._log()
    lines = capsys.readouterr().err.splitlines()
    assert lines[0].startswith('program spans: 8 recorded (0 dropped)')
    assert 'train.loader_wait 2.850000' in lines[1] and '(none) 1.200000' in lines[1]
    # the gap 6.6-7.2 s: the epoch's own time, while no runtime call runs
    assert 'train.epoch / no host operation 0.600000' in lines[2]
    assert lines[3].startswith('launch calls (3) with the spans moved +0 ns: outside '
                               "every span {'cudaLaunchKernel': 1}")
    assert len(lines) == 6


def _read(metric, job, data):
    return Spec(ROOT).reader(metric).read({'job': job, 'probes': {'program_spans': data}
                                           if data is not None else {}})


@pytest.mark.parametrize('metric,job,value', [
    ('idle_loader_share.train', 'train', 28.5),
    ('idle_unnamed_share.train', 'train', 12.0),
    ('backward_ms_per_step.train', 'train', 60.0),
    ('device_allocs_per_epoch.train', 'train', 6.0),
])
def test_train_readers(metric, job, value):
    assert _read(metric, job, _probe_data()) == pytest.approx(value)
    assert _read(metric, job, None) is None
    empty = dict(_probe_data(), spans=[], counters={}, device=[])
    assert _read(metric, job, empty) is None


def test_eval_reader_and_readers_of_other_jobs():
    spans = [_span('eval.prep', 0, 1, device_ms=4.0), _span('eval.forward', 1, 2,
                                                            device_ms=300.0),
             _span('eval.metrics', 2, 3, device_ms=10.0),
             _span('eval.prep', 3, 4, device_ms=6.0), _span('eval.metrics', 5, 6,
                                                           device_ms=12.0)]
    data = dict(_probe_data(), spans=spans, counters={'eval.images': 8})
    assert _read('fused_metrics_ms_per_img.eval', 'eval', data) == pytest.approx(4.0)
    assert _read('fused_metrics_ms_per_img.eval', 'eval', None) is None
    host_only = dict(data, spans=[dict(s, device_ms=None) for s in spans])
    assert _read('fused_metrics_ms_per_img.eval', 'eval', host_only) is None
    assert _read('idle_loader_share.train', 'eval', data) is None
