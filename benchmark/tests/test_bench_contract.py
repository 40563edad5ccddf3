"""BENCHMARK.json against the form the benchmark's contract sets: keys, names, units,
bounds, files under the benchmark's folder, every configuration used, every cell with
an end-to-end rate, set-up and a per-layer metric, and a check length that fits."""
import json
import os
import re

from benchmark.tests.tiny import BENCH, ROOT

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def _doc():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_keys_names_and_lines():
    doc = _doc()
    assert set(doc) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                        'end_to_end', 'per_layer'}
    assert doc['command'] == ['python3', 'benchmark/run.py'] and doc['paths'] == ['benchmark']
    assert isinstance(doc['run_seconds'], int) and 1 <= doc['run_seconds'] <= 51
    for c in doc['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and _line(c['source']) and _line(c['why'])
        assert c['file'].startswith('benchmark/') and os.path.isfile(os.path.join(ROOT, c['file']))
    for w in doc['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic']) and _line(w['why'])
        assert w['chips'] in (1, 4)
        for folder, name in (('traffic', w['traffic']), ('checks', w['name'])):
            assert os.path.isfile(os.path.join(BENCH, folder, name + '.json'))
    metrics = doc['end_to_end'] + doc['per_layer']
    assert len({m['name'] for m in metrics}) == len(metrics)
    for m in doc['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound', 'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in doc['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source', 'layer', 'moves'}
        assert _line(m['layer']) and os.path.isfile(os.path.join(BENCH, 'metrics',
                                                                 m['name'] + '.py'))
    for m in metrics:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
    assert len(json.dumps(doc)) < 64 * 1024


def test_every_cell_reports_what_it_must():
    doc = _doc()
    assert {w['config'] for w in doc['workloads']} == {c['name'] for c in doc['configs']}
    e2e = {m['name']: m for m in doc['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for w in doc['workloads']:
        mine = [m for m in doc['end_to_end'] if w['name'] in m.get('workloads', [w['name']])]
        assert len(mine) >= 2
        layer = [m for m in doc['per_layer'] if w['name'] in m.get('workloads', [w['name']])]
        assert layer
        for m in layer:  # the metric it moves is reported in each of its cells
            assert w['name'] in e2e[m['moves']].get('workloads', [w['name']])


def test_a_full_check_fits_at_24_cells():
    run = _doc()['run_seconds']
    assert (2 + 14 * 24) * (run + 60) + 24 * 2 * 90 + 1200 <= 43200
