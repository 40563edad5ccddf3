"""Profiling helpers: a ``torch.profiler`` trace and a device timer (PyTorch port of
sisr_tpu's ``tools/profiling.py``; the reference timed with perf_counter and read
nvidia-smi, ref: models/__init__.py:508-511, helper_functions.py:75-91).

``trace(log_dir)`` records the enclosed block's host ops and, on a CUDA machine, its
kernels, and writes a Chrome trace (``chrome://tracing``, Perfetto) into ``log_dir``.
``device_timer`` times a block of device work: on CUDA with two events on the current
stream around the block and a wait on the second one, so the time is the device's
and the work has finished; on the CPU with a plain clock.
"""
from contextlib import contextmanager
import os
import time

import torch


@contextmanager
def trace(log_dir, name='trace'):
    """Profile the enclosed block (CPU ops, and CUDA kernels where a card exists) and
    write ``<log_dir>/<name>.json``, a Chrome trace; yields the profiler, whose path is
    ``trace_path`` once the block has ended."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
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
