"""One run of one cell: set-up, the measured window, the traced stretches when asked,
the comparison with the plain reference, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics; with
``--trace 1`` the window still runs (its rate feeds the MFU readers), then two
stretches of ``trace_*`` units each: one under ``torch.profiler`` (the card's busy
and idle time, the breakdown), one with the probes the per-layer readers ask for
(CUDA events in hooks, host spans).  The last line of standard output is the result.
"""
import argparse
import json
import os
import shutil
import sys
import time

from benchmark import controls, traces
from benchmark.jobs.common import load as load_job
from benchmark.spec import BENCH_DIR, Spec

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'sisr_tpu')


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules(names=None):
    """The top-level names among loaded modules (or ``names``) that are JAX's, its
    libraries' or the JAX package's, compared whole: ``sisr_tpu_torch`` is not
    ``sisr_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split('.')[0] for n in names if n.split('.')[0] in FORBIDDEN})


def peaks_for(kind):
    """The published peaks of the card named ``kind`` (an H100's for any H100), or
    None for a card the table lacks."""
    with open(os.path.join(BENCH_DIR, 'peaks.json')) as f:
        cards = json.load(f)['cards']
    for family, peaks in cards.items():
        if family in (kind or ''):
            return peaks
    return None


def device_info(job, chips):
    import torch
    if not job.cuda:
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 0, 'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(job.device),
            'count': chips, 'memory_peak_bytes': int(torch.cuda.max_memory_allocated())}


def run_cell(spec, name, seed, seconds, trace, device, t0=None, work=None, control=None,
             numbers_out=None):
    """The result of one run of cell ``name`` (a dict, the result line's keys).
    ``control`` is a cell's control from its checks file (``controls.py``), in the
    program's place; ``numbers_out``, a dict, receives every number the comparison
    read, the cell's limits' and the others'."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.cell(name)
    config = spec.config(cell['config'])
    traffic = spec.traffic(cell['traffic'])
    limits = spec.checks(name)['limits']
    judged = None
    if control is not None:
        traffic, config, judged = controls.apply(control, traffic, config)
    work = work or os.path.join(spec.bench_dir, '.work', 'run')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    job = load_job(traffic['job'])(config, traffic, seed, device, work)
    try:
        job.setup()
        setup_s = time.perf_counter() - t0
        done, elapsed = job.window(seconds)
        rate = done / elapsed
        log('window: %d units of work in %.6f s' % (done, elapsed))
        metrics, breakdown, dev_extra = {}, None, {}
        if trace:
            ctx = {'cell': name, 'job': job.kind, 'config': config, 'traffic': traffic,
                   'rate': rate, 'peaks': None, 'facts': job.facts()}
            readers = {m['name']: (m, spec.reader(m['name'])) for m in spec.per_layer(name)}
            if job.cuda:
                import torch
                ctx['peaks'] = peaks_for(torch.cuda.get_device_name(job.device))
            ctx['trace'] = traces.profile(job.stretch, job.cuda)
            if ctx['trace']['window'] is not None and job.cuda:
                dev_extra = {'busy_s': traces.busy_s(ctx['trace']),
                             'window_s': traces.window_s(ctx['trace'])}
                breakdown = {'device_ops': traces.device_ops(ctx['trace']),
                             'idle_gaps': traces.idle_gaps(ctx['trace'])}
            wanted = sorted({p for _, r in readers.values() for p in getattr(r, 'PROBES', ())})
            probes = {p: spec.probe(p).install(job) for p in wanted}
            ctx['stretch_work'], ctx['stretch_s'] = job.stretch()
            ctx['probes'] = {}
            for p, probe in probes.items():
                if probe is not None:
                    probe.remove()
                    ctx['probes'][p] = probe.data()
            for metric, (entry, reader) in readers.items():
                value = reader.read(ctx)
                if value is not None:
                    metrics[metric] = {'value': value, 'unit': entry['unit']}
        else:
            values = {'setup_s': setup_s, traffic['rate_metric']: rate}
            for entry in spec.end_to_end(name):
                metrics[entry['name']] = {'value': values[entry['name']],
                                          'unit': entry['unit']}
        dev = dict(device_info(job, cell['chips']), **dev_extra)
        log('memory_peak_bytes %d' % dev['memory_peak_bytes'])
        log('counters %s' % json.dumps(job.counters()))
        tic = time.perf_counter()
        numbers, failed, checked = job.compare(limits, judged)
        check_s = time.perf_counter() - tic
        if numbers_out is not None:
            numbers_out.update(numbers)
        correct = all(numbers[k] <= limits[k] for k in limits)
        checks = {k: {'value': numbers[k], 'limit': limits[k]} for k in limits}
        result = {'correct': correct, 'attempted': done, 'failed': failed,
                  'metrics': metrics, 'device': dev}
        if breakdown is not None:
            result['breakdown'] = breakdown
        result['checks'] = checks
        log('checked %d answers of the window against the reference in %.3f s'
            % (checked, check_s))
        for k, v in checks.items():
            log('check %s %r limit %r' % (k, v['value'], v['limit']))
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv, t0):
    args = parse_args(argv)
    spec = Spec(os.getcwd())
    cell = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell['chips']:
        log('this cell needs %d CUDA card(s); torch sees %d'
            % (cell['chips'], torch.cuda.device_count() if torch.cuda.is_available() else 0))
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, args.trace, 'cuda', t0)
    found = forbidden_modules()
    if found:
        log('modules of JAX or of the JAX package were loaded: %s' % ', '.join(found))
        return 3
    print(json.dumps(result), flush=True)
    return 0
