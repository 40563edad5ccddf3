"""The program's own spans and counters (``sisr_tpu_torch.tools.profiling``) over the
probe stretch and, in a train job, the card's operations and the host's CUDA runtime
calls from a ``torch.profiler`` of CUDA activity alone (``traces.profile``'s settings),
all on the profiler's clock: nanoseconds since the epoch, which the program's spans are
stamped with.  An eval job runs no profiler here: its readers need the spans' CUDA
events alone, the stretch's ``step_spans`` probe synchronises after every step (so its
idle time would measure that probe), and tracing the forward's thousands of launches
lengthens the hooks' times that ``forward_ms_per_img.eval`` reads.  A program without
the recorder gives no data.

Also the arithmetic the readers share: the card's idle time by the innermost span open
on the program's main thread at each idle gap's middle (``traces.idle_gaps``' rule, over
program spans instead of runtime calls), and where the runtime calls that put work on
the card fall among the spans, a check of the two clocks' alignment that the probe
prints on standard error.
"""
import heapq
import sys
from collections import Counter, defaultdict

from benchmark import traces

LAUNCHES = ('Launch', 'Memcpy', 'Memset')  # runtime calls that put work on the card
SHIFT_NS = 1_000_000  # the misalignment the launch check is also run at, either way


def innermost(points, spans):
    """The name of the innermost span open at each of ``points`` (sorted), None where
    none is: of the ``(start, end, name)`` spans that hold a point, the latest to
    start.  One sweep, with the spans started so far in a heap by start."""
    spans = sorted(spans)
    started, nxt, out = [], 0, []
    for t in points:
        while nxt < len(spans) and spans[nxt][0] <= t:
            heapq.heappush(started, (-spans[nxt][0], nxt))
            nxt += 1
        while started and spans[started[0][1]][1] < t:  # ended: ended for later points too
            heapq.heappop(started)
        out.append(spans[started[0][1]][2] if started else None)
    return out


def closed_spans(data, main_only=True):
    """``(start_ns, end_ns, name)`` of the recorded spans that ended, of the main
    thread only or of every thread."""
    return [(s['start_ns'], s['end_ns'], s['name']) for s in data['spans']
            if s['end_ns'] is not None
            and (not main_only or s['thread'] == data['main_thread'])]


def idle_gaps(data):
    """The card's idle gaps within the stretch, as (start_ns, end_ns)."""
    lo, hi = data['window']
    busy = traces.merged(data['device'], data['window'])
    edges = [lo] + [t for span in busy for t in span] + [hi]
    return [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]


def idle_by_span(data):
    """{span name, or None for no span: seconds} of the card's idle time within the
    stretch, each gap given to the innermost main-thread span open at its middle."""
    gaps = idle_gaps(data)
    owners = innermost([(s + e) / 2 for s, e in gaps], closed_spans(data))
    total = defaultdict(float)
    for (s, e), name in zip(gaps, owners):
        total[name] += (e - s) * 1e-9
    return dict(total)


def launch_spans(data, shift_ns=0):
    """Where the runtime calls that put work on the card fall, with the spans moved by
    ``shift_ns``: ({call name: calls under no span of any thread}, {innermost
    main-thread span or None: calls})."""
    calls = sorted((s, name) for s, _, name in data['calls']
                   if any(word in name for word in LAUNCHES))
    points = [s for s, _ in calls]

    def moved(main_only):
        return [(s + shift_ns, e + shift_ns, n) for s, e, n in closed_spans(data, main_only)]

    anywhere = innermost(points, moved(False))
    outside = Counter(name for (_, name), owner in zip(calls, anywhere) if owner is None)
    return dict(outside), dict(Counter(innermost(points, moved(True))))


class ProgramSpans:
    """Recording on, and in a train job the profiler running, from install to removal;
    the window is the job's stretch itself (the probes' own work around it left out)."""

    def __init__(self, job, profiling):
        self.job = job
        self.clock = profiling.clock_ns
        self.prof = None
        if job.cuda and job.kind == 'train':
            import torch
            from torch.profiler import ProfilerActivity
            self.prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        self._tracing = profiling.tracing()
        self.recorder = self._tracing.__enter__()
        self.window = [self.clock(), None]
        inner = job.stretch

        def stretch():
            self.window[0] = self.clock()
            try:
                return inner()
            finally:
                self.window[1] = self.clock()

        job.stretch = stretch
        self._data = None

    def remove(self):
        if self.window[1] is None:
            self.window[1] = self.clock()
        del self.job.stretch
        self._tracing.__exit__(None, None, None)
        if self.prof is not None:
            self.prof.__exit__(None, None, None)

    def data(self):
        if self._data is None:
            self._data = dict(self.recorder.take(), window=tuple(self.window), device=[],
                              calls=[])
            if self.prof is not None:
                self._read_profile()
            self._log()
        return self._data

    def _read_profile(self):
        from torch.autograd import DeviceType
        for e in self.prof.profiler.kineto_results.events():
            span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            if e.device_type() != DeviceType.CUDA:
                self._data['calls'].append(span)
            elif not e.is_user_annotation():
                self._data['device'].append(span)

    def _log(self):
        d = self._data
        names = Counter(s['name'] for s in d['spans'])
        log('program spans: %d recorded (%d dropped), %s; counters %s'
            % (len(d['spans']), d['dropped'], dict(sorted(names.items())),
               dict(sorted(d['counters'].items()))))
        if not d['device']:
            return
        lo, hi = d['window']
        idle = sorted(idle_by_span(d).items(), key=lambda kv: -kv[1])
        log('card idle in a stretch of %.6f s, by innermost main-thread span (s): %s'
            % ((hi - lo) * 1e-9, ', '.join('%s %.6f' % (name or '(none)', s)
                                           for name, s in idle)))
        gaps = idle_gaps(d)
        mids = [(s + e) / 2 for s, e in gaps]
        pairs = defaultdict(float)
        for (s, e), span, call in zip(gaps, innermost(mids, closed_spans(d)),
                                      innermost(mids, d['calls'])):
            pairs['%s / %s' % (span, call or 'no host operation')] += (e - s) * 1e-9
        log('card idle by span / runtime call (s): %s' % ', '.join(
            '%s %.6f' % kv for kv in sorted(pairs.items(), key=lambda kv: -kv[1])[:12]))
        for shift in (0, SHIFT_NS, -SHIFT_NS):
            outside, owners = launch_spans(d, shift)
            log('launch calls (%d) with the spans moved %+d ns: outside every span %s; '
                'by innermost main-thread span %s'
                % (sum(owners.values()), shift, outside or 'none',
                   dict(sorted(owners.items(), key=lambda kv: str(kv[0])))))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def install(job):
    from sisr_tpu_torch.tools import profiling
    if not hasattr(profiling, 'tracing'):  # a program without the recorder
        return None
    return ProgramSpans(job, profiling)
