"""What ``BENCHMARK.json`` names, found by name under the benchmark's folder:

* ``configs/<config>.json``: a model configuration (the model table as the recipe
  gives it, the widths the reference and the FLOP formulas read, its source);
* ``traffic/<traffic>.json``: a traffic mix, the parameters of the one generator and
  of the job that drives the program (``job``: ``eval`` or ``train``, each a module of
  ``jobs/``);
* ``checks/<cell>.json``: the limits of a cell's comparison with the reference, and
  the control that has to fail them;
* ``metrics/<metric>.py``: the reader of a per-layer metric;
* ``probes/<probe>.py``: an instrument a reader needs in the traced stretch.

A later change adds a configuration, a mix, a cell or a metric by adding such files
and entries, and edits none.
"""
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """The module of the source file ``path``, under ``name``."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


class Spec:
    def __init__(self, root, bench_dir=BENCH_DIR):
        self.root = root
        self.doc = _load_json(os.path.join(root, 'BENCHMARK.json'))
        self.bench_dir = bench_dir

    def cell(self, name):
        for entry in self.doc['workloads']:
            if entry['name'] == name:
                return entry
        raise KeyError('no workload %r in BENCHMARK.json (have: %s)'
                       % (name, ', '.join(w['name'] for w in self.doc['workloads'])))

    def config(self, name):
        entry = next(c for c in self.doc['configs'] if c['name'] == name)
        return _load_json(os.path.join(self.root, entry['file']))

    def traffic(self, name):
        return _load_json(os.path.join(self.bench_dir, 'traffic', name + '.json'))

    def checks(self, cell):
        return _load_json(os.path.join(self.bench_dir, 'checks', cell + '.json'))

    def _applies(self, metric, cell):
        return 'workloads' not in metric or cell in metric['workloads']

    def end_to_end(self, cell):
        return [m for m in self.doc['end_to_end'] if self._applies(m, cell)]

    def per_layer(self, cell):
        return [m for m in self.doc['per_layer'] if self._applies(m, cell)]

    def reader(self, metric):
        path = os.path.join(self.bench_dir, 'metrics', metric + '.py')
        return load_module(path, 'benchmark_metric_' + metric.replace('.', '_'))

    def probe(self, name):
        path = os.path.join(self.bench_dir, 'probes', name + '.py')
        return load_module(path, 'benchmark_probe_' + name)
