"""A copy of the benchmark in a temporary root with tiny configurations, mixes and
cells beside the real ones, for runs on the CPU (the harness's look for a card
skipped).  The tiny files are added as a later change would add a cell: new files and
new entries only."""
import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TINY_CONFIGS = {
    'qrcan_tiny': {'base': 'qrcan', 'internal': {'n_resgroups': 1, 'n_resblocks': 2,
                                                 'n_feats': 16},
                   'sizes': {'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16}},
    'edsr_tiny': {'base': 'edsr', 'internal': {'num_blocks': 2, 'num_features': 16},
                  'sizes': {'num_blocks': 2, 'num_features': 16}},
}
TINY_EVAL = {'images': 4, 'lr_size': 16, 'batch': 2, 'check_images': 4, 'check_block': 2,
             'content': {'grid': 4, 'rectangles': 3, 'noise': 3.0}, 'warm_passes': 1}
TINY_TRAIN = {'images': 8, 'lr_size': 24, 'crop': 8, 'batch': 2, 'loader_threads': 2,
              'content': {'grid': 4, 'rectangles': 3, 'noise': 3.0}, 'trace_epochs': 1}
# an int8 eval mix and its checks (the limits read at 128 x 128 on the card), for the
# program's int8 path, which no cell of BENCHMARK.json drives yet
TINY_INT8 = dict(TINY_EVAL, precision='int8', peak='int8')
INT8_CHECKS = {'limits': {'sr_err': 0.2, 'psnr_gap_db': 0.06, 'ssim_gap': 0.0035},
               'control': {'reference_bits': 4}}
# the bf16 eval cells' checks at the tiny depths, whose sound runs read an sr_err of
# about 0.005 on the CPU and whose float8 controls about 0.06
BF16_CHECKS = {'limits': {'sr_err': 0.02, 'ssim_gap': 0.0015},
               'control': {'reference_fp8': True}}
# cell: (config, its mix: (base mix, changes), its checks: a real cell's or a dict)
TINY_CELLS = {
    'qrcan_tiny.eval_bf16': ('qrcan_tiny', ('eval_bf16', TINY_EVAL), BF16_CHECKS),
    'qrcan_tiny.eval_int8': ('qrcan_tiny', ('eval_bf16', TINY_INT8), INT8_CHECKS),
    'edsr_tiny.eval_bf16': ('edsr_tiny', ('eval_bf16', TINY_EVAL), BF16_CHECKS),
    'edsr_tiny.train_f32': ('edsr_tiny', ('train_f32', TINY_TRAIN), 'edsr.train_f32'),
}


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, 'w') as f:
        json.dump(obj, f, indent=1)


def make_root(tmp):
    """A temporary root holding BENCHMARK.json and a copy of the benchmark's folder
    with the tiny cells added; returns it."""
    root = os.path.join(str(tmp), 'root')
    bench = os.path.join(root, 'benchmark')
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns('.work', '.cache',
                                                                 '__pycache__', 'tests'))
    doc = _load(os.path.join(ROOT, 'BENCHMARK.json'))
    for name, tiny in TINY_CONFIGS.items():
        cfg = _load(os.path.join(BENCH, 'configs', tiny['base'] + '.json'))
        cfg['name'] = name
        cfg['model']['internal_params'].update(tiny['internal'])
        cfg['sizes'].update(tiny['sizes'])
        _dump(cfg, os.path.join(bench, 'configs', name + '.json'))
        doc['configs'].append({'name': name, 'source': 'a tiny copy for CPU tests',
                               'file': 'benchmark/configs/%s.json' % name,
                               'reduced': sorted(tiny['internal']), 'why': 'CPU tests'})
    real = {}
    for w in doc['workloads']:
        job = _load(os.path.join(BENCH, 'traffic', w['traffic'] + '.json'))['job']
        real.setdefault(job, set()).add(w['name'])
    for cell, (config, (base, changes), checks) in TINY_CELLS.items():
        mix = _load(os.path.join(BENCH, 'traffic', base + '.json'))
        mix.update(changes)
        tiny_mix = cell.split('.', 1)[1] + '_tiny'
        _dump(mix, os.path.join(bench, 'traffic', tiny_mix + '.json'))
        if isinstance(checks, str):
            checks = _load(os.path.join(BENCH, 'checks', checks + '.json'))
        _dump(checks, os.path.join(bench, 'checks', cell + '.json'))
        doc['workloads'].append({'name': cell, 'config': config, 'traffic': tiny_mix,
                                 'chips': 1, 'why': 'CPU tests'})
        # each tiny cell reports what the real cells of its job report
        for metric in doc['end_to_end'] + doc['per_layer']:
            if set(metric.get('workloads', ())) & real[mix['job']]:
                metric['workloads'].append(cell)
    _dump(doc, os.path.join(root, 'BENCHMARK.json'))
    return root
