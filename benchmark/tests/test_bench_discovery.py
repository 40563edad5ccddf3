"""A configuration, a mix, a cell and a per-layer metric added as new files and
entries, in a copy of the benchmark, are found by name with no existing file edited;
and the harness gives no result where it should give none."""
import hashlib
import json
import os
import subprocess
import sys

from benchmark.harness import run_cell
from benchmark.spec import Spec
from benchmark.tests import tiny


def _digests(folder):
    out = {}
    for base, _, files in os.walk(folder):
        for f in files:
            with open(os.path.join(base, f), 'rb') as fh:
                out[os.path.relpath(os.path.join(base, f), folder)] = \
                    hashlib.sha1(fh.read()).hexdigest()
    return out


def test_new_files_and_entries_are_picked_up(tmp_path):
    root = tiny.make_root(tmp_path)
    bench = os.path.join(root, 'benchmark')
    before = _digests(bench)
    with open(os.path.join(bench, 'metrics', 'images_per_pass.eval.py'), 'w') as f:
        f.write('PROBES = ("step_spans",)\n\n\ndef read(ctx):\n'
                '    return float(len(ctx["probes"]["step_spans"]["seconds"]))\n')
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        doc = json.load(f)
    doc['per_layer'].append({'name': 'images_per_pass.eval', 'unit': 'calls',
                             'better': 'higher', 'source': 'program_span', 'layer': 'x',
                             'moves': 'eval_img_per_s',
                             'workloads': ['edsr_tiny.eval_bf16']})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(doc, f)
    after = _digests(bench)
    # the tiny configuration, mixes and cells, and the metric, are files of their own
    assert all(after[k] == v for k, v in before.items())
    assert {'configs/edsr_tiny.json', 'traffic/eval_bf16_tiny.json',
            'checks/edsr_tiny.eval_bf16.json'} <= set(after)
    spec = Spec(root, bench)
    result = run_cell(spec, 'edsr_tiny.eval_bf16', 3, 0.05, 1, 'cpu',
                      work=str(tmp_path / 'work'))
    assert result['metrics']['images_per_pass.eval']['value'] == 2.0  # 4 images, batch 2
    assert result['correct']


def _run(args, cwd):
    return subprocess.run([sys.executable, 'benchmark/run.py', *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result(tmp_path):
    out = _run(['--workload', 'qrcan.eval_bf16', '--seed', '1', '--seconds', '1',
                '--trace', '0'], tiny.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ''


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's folder."""
    root = tiny.make_root(tmp_path)
    out = _run(['--workload', 'qrcan.eval_bf16', '--seed', '1', '--seconds', '1',
                '--trace', '0'], root)
    assert out.returncode != 0 and out.stdout.strip() == ''
