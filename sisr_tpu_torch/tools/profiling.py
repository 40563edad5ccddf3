"""Profiling helpers: a ``torch.profiler`` trace, a device timer (PyTorch port of
sisr_tpu's ``tools/profiling.py``; the reference timed with perf_counter and read
nvidia-smi, ref: models/__init__.py:508-511, helper_functions.py:75-91), and the
program's spans and counters.

``trace(log_dir)`` records the enclosed block's host ops and, on a CUDA machine, its
kernels, and writes a Chrome trace (``chrome://tracing``, Perfetto) into ``log_dir``;
the program's spans show in it as ranges of their own.
``device_timer`` times a block of device work: on CUDA with two events on the current
stream around the block and a wait on the second one, so the time is the device's
and the work has finished; on the CPU with a plain clock.

Spans and counters.  The train epoch and the fused eval pass mark their parts with
``span(name)`` (a context manager) and ``count(name, n)``; nothing is recorded unless a
``tracing()`` block is open, and then a span costs one read of a module-level name and
hands back one shared do-nothing context.  Inside ``tracing()`` each span records its
name, its start and end on :data:`clock_ns` (the clock of ``torch.profiler``'s events,
CUPTI's included, so that spans and the card's operations share one timeline), the
enclosing span of its thread, its thread, and its unit (the train step's or the eval
batch's index); ``span(name, device=True)`` also records a pair of CUDA events on the
current stream, whose elapsed time is the span's device time.  The names the program
uses:

* ``train.epoch`` > ``train.loader_wait`` (unit: the step), ``train.step`` >
  (``train.forward``, ``train.backward``, ``train.optimizer``; device), ``train.loss_drain``,
  ``train.epoch_end``; counters ``train.steps`` and ``cuda.device_allocs`` (the caching
  allocator's device allocations during the epoch);
* ``eval.pass`` > ``eval.batch_wait`` (unit: the batch), ``eval.step`` > (``eval.prep``,
  ``eval.forward``, ``eval.metrics``; device), ``eval.rows_copy``, ``eval.report``;
  counter ``eval.images``;
* on the loader's threads: ``loader.batch`` (a batch's items and collation) and
  ``loader.upload`` (its copy to the card).
"""
from collections import defaultdict
from contextlib import contextmanager
import os
import threading
import time

import torch

# torch.profiler stamps its events, and CUPTI's host calls and card operations, on the
# system clock in nanoseconds since the epoch: a span stamped with it lines up with
# them (on an H100 with torch 2.11, every cudaLaunchKernel CUPTI recorded lay between
# this clock's readings just before and after the call)
clock_ns = time.time_ns
MAX_SPANS = 100_000  # a recorder keeps this many spans and counts the rest as dropped

_RECORDER = None  # the open tracing() block's recorder; None while recording is off
_SWITCH = threading.Lock()  # turning recording on or off


@contextmanager
def trace(log_dir, name='trace'):
    """Profile the enclosed block (CPU ops, and CUDA kernels where a card exists) and
    write ``<log_dir>/<name>.json``, a Chrome trace; yields the profiler, whose path is
    ``trace_path`` once the block has ended.  Recording is on for the block: each of
    the program's spans is a ``record_function`` range of the trace, and the records
    are the profiler's ``spans`` afterwards (``Recorder.take``)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tracing(annotate=True) as recorder, profile(activities=activities) as prof:
        yield prof
    prof.spans = recorder.take()
    prof.trace_path = os.path.join(log_dir, '%s.json' % name)
    prof.export_chrome_trace(prof.trace_path)


@contextmanager
def device_timer(result_holder=None, label='', device='cuda'):
    """Time the enclosed block into ``holder['seconds']`` (the yielded dict, or
    ``result_holder``).  ``device`` 'cuda' (or a CUDA device): the elapsed time of CUDA
    events recorded on the current stream before and after the block, after waiting
    for the second (a real completion barrier); 'cpu': a plain clock around the
    block.  The block may leave its output in ``holder['out']``, as sisr_tpu's
    contract has it."""
    holder = result_holder if result_holder is not None else {}
    device = torch.device(device)
    if device.type == 'cuda':
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(torch.cuda.current_stream(device))
        yield holder
        end.record(torch.cuda.current_stream(device))
        end.synchronize()
        holder['seconds'] = start.elapsed_time(end) / 1000.0
    else:
        tic = time.perf_counter()
        yield holder
        holder['seconds'] = time.perf_counter() - tic
    if label:
        print('%s: %.4fs' % (label, holder['seconds']))


class _NoSpan:
    """The context every span and allocation count gives while recording is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name, device=False, unit=None):
    """A context manager marking the enclosed block as the span ``name``.  ``device``:
    also time the block's work on the current CUDA stream.  ``unit``: the index of the
    unit of work the block begins (a train step, an eval batch); it and every later
    span of its thread belong to that unit until another span begins one or the
    thread's outermost span ends."""
    rec = _RECORDER
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name, device, unit)


def count(name, n=1):
    """Add ``n`` to the counter ``name`` (any thread)."""
    rec = _RECORDER
    if rec is not None:
        rec.add(name, n)


def device_allocs(device):
    """A context manager adding to the counter ``cuda.device_allocs`` the device
    allocations (``cudaMalloc``) the caching allocator of ``device`` made during the
    block."""
    rec = _RECORDER
    if rec is None or torch.device(device).type != 'cuda':
        return _NO_SPAN
    return _AllocCount(rec, torch.device(device))


@contextmanager
def tracing(annotate=False):
    """Record spans and counters during the block; yields the :class:`Recorder`,
    which holds them afterwards.  ``annotate``: each span is also a
    ``torch.profiler.record_function`` range.  One block at a time."""
    global _RECORDER
    rec = Recorder(annotate)
    with _SWITCH:
        if _RECORDER is not None:
            raise RuntimeError('spans are being recorded already')
        _RECORDER = rec
    try:
        yield rec
    finally:
        with _SWITCH:
            _RECORDER = None


class Recorder:
    """The spans and counters of one ``tracing()`` block, at most ``MAX_SPANS`` spans."""

    def __init__(self, annotate=False):
        self.limit = MAX_SPANS
        self.annotate = annotate
        self.dropped = 0
        self.main_thread = threading.main_thread().native_id
        # each [name, start_ns, end_ns, parent, unit, thread, (start, end) CUDA events]
        self._spans = []
        self._counters = defaultdict(int)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._taken = False

    def add(self, name, n):
        with self._lock:
            self._counters[name] += n

    def _open(self, name, device, unit):
        local = self._local
        stack = getattr(local, 'stack', None)
        if stack is None:
            stack = local.stack = []
        if unit is not None:
            local.unit = unit
        elif not stack:
            local.unit = None
        events = None
        if device and torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        record = [name, None, None, stack[-1] if stack else None, local.unit,
                  threading.get_native_id(), events]
        with self._lock:
            if len(self._spans) < self.limit:
                index = len(self._spans)
                self._spans.append(record)
            else:
                index = None
                self.dropped += 1
        stack.append(index)
        record[1] = clock_ns()
        if events is not None:
            events[0].record()
        return record

    def _close(self, record):
        if record[6] is not None:
            record[6][1].record()
        record[2] = clock_ns()
        stack = self._local.stack
        stack.pop()
        if not stack:
            self._local.unit = None

    def take(self):
        """The records, once: ``{'spans': [{'name', 'start_ns', 'end_ns' (None while
        open), 'parent' (index in the list, or None), 'unit', 'thread' (native id),
        'device_ms' (None but for a closed device span)}], 'counters': {name: n},
        'dropped': spans past the limit, 'main_thread': native id}``.  Waits for the
        device spans' work."""
        if self._taken:
            raise RuntimeError('the records were handed out already')
        self._taken = True
        with self._lock:
            records, counters = self._spans, dict(self._counters)
            self._spans = []
        spans = []
        for name, start, end, parent, unit, thread, events in records:
            device_ms = None
            if events is not None and end is not None:
                events[1].synchronize()
                device_ms = events[0].elapsed_time(events[1])
            spans.append({'name': name, 'start_ns': start, 'end_ns': end, 'parent': parent,
                          'unit': unit, 'thread': thread, 'device_ms': device_ms})
        return {'spans': spans, 'counters': counters, 'dropped': self.dropped,
                'main_thread': self.main_thread}


class _Span:
    __slots__ = ('rec', 'name', 'device', 'unit', 'record', 'annotation')

    def __init__(self, rec, name, device, unit):
        self.rec, self.name, self.device, self.unit = rec, name, device, unit

    def __enter__(self):
        self.record = self.rec._open(self.name, self.device, self.unit)
        self.annotation = None
        if self.rec.annotate:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.rec._close(self.record)
        return False


class _AllocCount:
    __slots__ = ('rec', 'device', 'before')

    def __init__(self, rec, device):
        self.rec, self.device = rec, device

    def _allocs(self):
        return torch.cuda.memory_stats(self.device).get('num_device_alloc', 0)

    def __enter__(self):
        self.before = self._allocs()
        return self

    def __exit__(self, *exc):
        self.rec.add('cuda.device_allocs', self._allocs() - self.before)
        return False
