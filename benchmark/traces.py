"""A profiler trace as plain intervals, and the arithmetic the readers take from it.

A trace is ``{'device': [(start_s, end_s, name)], 'host': [(start_s, end_s, name)],
'window': (start_s, end_s)}``: every operation that ran on the card (kernels, copies,
fills), the host's recorded calls, and the traced stretch's bounds, all on the
profiler's one clock.  The tests build such traces by hand.
"""
import heapq
import sys
import time
from collections import defaultdict

STRETCH = 'benchmark.stretch'


def profile(fn, cuda):
    """Run ``fn`` under ``torch.profiler`` and return its trace.  On the card only the
    CUDA activity is recorded: the card's operations and the host's calls into the
    CUDA runtime (launches, copies, synchronisations), which name the idle gaps.
    Recording every host operator as well costs the host so much on a program of
    many small operators (the int8 path: ~850k events a pass) that the card idles
    for it, and the idle share would measure the profiler.  The window runs from the
    first to the last event when the stretch's own annotation is not recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    tic = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        with record_function(STRETCH):
            fn()
            if cuda:
                torch.cuda.synchronize()
    events = prof.events()
    print('profiled stretch and its %d events read in %.3f s'
          % (len(events), time.perf_counter() - tic), file=sys.stderr, flush=True)
    device, host, window = [], [], None
    for e in events:
        span = (e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
        if e.device_type == DeviceType.CUDA:
            # a host annotation's range on the card's timeline is no operation
            if not getattr(e, 'is_user_annotation', False) and e.name != STRETCH:
                device.append(span)
        elif e.name == STRETCH:
            window = span[:2]
        else:
            host.append(span)
    if window is None and device + host:
        spans = device + host
        window = (min(s for s, _, _ in spans), max(e for _, e, _ in spans))
    return {'device': device, 'host': host, 'window': window}


def merged(intervals, window):
    """The union of ``(start, end, ...)`` intervals clipped to ``window``, as sorted
    disjoint (start, end) pairs."""
    lo, hi = window
    spans = sorted((max(s, lo), min(e, hi)) for s, e, *_ in intervals if e > lo and s < hi)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_s(trace):
    """Seconds of the window in which some operation ran on the card."""
    return sum(e - s for s, e in merged(trace['device'], trace['window']))


def window_s(trace):
    return trace['window'][1] - trace['window'][0]


def device_ops(trace, top=10, width=160):
    """[[name, seconds]] of the card's operations by total time, longest first (names
    cut to ``width`` characters)."""
    total = defaultdict(float)
    for s, e, name in trace['device']:
        total[name[:width]] += e - s
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace, top=10):
    """[[host operation, seconds]]: the card's idle gaps inside the window, each named
    by the innermost host operation running at its middle (of those that cover it,
    the latest to start), summed by name, longest first.  One sweep over the gaps in
    order, with the host operations started so far in a heap by start."""
    lo, hi = trace['window']
    busy = merged(trace['device'], trace['window'])
    edges = [lo] + [t for span in busy for t in span] + [hi]
    host = sorted((s, e, name) for s, e, name in trace['host'] if name != STRETCH)
    started, nxt = [], 0
    total = defaultdict(float)
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        while nxt < len(host) and host[nxt][0] <= mid:
            heapq.heappush(started, (-host[nxt][0], nxt))
            nxt += 1
        while started and host[started[0][1]][1] < mid:  # ended: ended for later gaps too
            heapq.heappop(started)
        total[host[started[0][1]][2] if started else 'no host operation'] += e - s
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]
