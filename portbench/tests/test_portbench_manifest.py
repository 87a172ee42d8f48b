"""BENCHMARK.json against the benchmark's contract: names, units and
keys, and every file a cell and a metric are found by."""
import json
import os
import re

import pytest

from portbench import loops

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
KEYS = {
    'top': {'command', 'paths', 'run_seconds', 'configs', 'workloads',
            'end_to_end', 'per_layer'},
    'config': {'name', 'source', 'file', 'reduced', 'why'},
    'workload': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}


@pytest.fixture(scope='module')
def manifest():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_keys_and_sizes(manifest):
    assert set(manifest) == KEYS['top']
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 65536
    assert 1 <= len(manifest['configs']) <= 24
    assert 1 <= len(manifest['workloads']) <= 24
    assert 1 <= len(manifest['end_to_end']) <= 16
    assert 1 <= len(manifest['per_layer']) <= 128
    for kind, key in (('config', 'configs'), ('workload', 'workloads'),
                      ('end_to_end', 'end_to_end')):
        for entry in manifest[key]:
            assert set(entry) - {'workloads'} == KEYS[kind] or (
                kind == 'config' and set(entry) == KEYS[kind]), entry
    for m in manifest['per_layer']:
        assert set(m) - {'workloads'} == KEYS['per_layer'], m


def test_names_units_and_text(manifest):
    names = []
    for key in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for entry in manifest[key]:
            assert NAME.match(entry['name']), entry['name']
            names.append((key, entry['name']))
    for key in ('configs', 'workloads'):
        assert len({n for k, n in names if k == key}) == len(
            manifest[key])
    metric_names = [n for k, n in names if k in ('end_to_end', 'per_layer')]
    assert len(set(metric_names)) == len(metric_names)
    for m in manifest['end_to_end'] + manifest['per_layer']:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
    for c in manifest['configs']:
        assert _line(c['source']) and _line(c['why'])
        assert len(c['reduced']) <= 16
        assert all(NAME.match(k) for k in c['reduced'])
    for w in manifest['workloads']:
        assert _line(w['why']) and w['chips'] in (1, 4)
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
    for m in manifest['per_layer']:
        assert _line(m['layer'])
    for word in manifest['command']:
        assert _line(word) and not word.startswith('/') and '..' not in word
    assert len(manifest['command']) <= 32
    for p in manifest['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p


def test_end_to_end(manifest):
    e2e = {m['name']: m for m in manifest['end_to_end']}
    assert e2e['setup_s']['bound'] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in manifest['per_layer']:
        assert m['moves'] in e2e
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')


def test_every_cell_reports_enough(manifest):
    cells = {w['name'] for w in manifest['workloads']}
    e2e = {m['name']: m for m in manifest['end_to_end']}

    def cells_of(m):
        return set(m.get('workloads', cells))

    for m in list(e2e.values()) + manifest['per_layer']:
        assert cells_of(m) <= cells, m['name']
    for cell in cells:
        mine = [n for n, m in e2e.items() if cell in cells_of(m)]
        assert 'setup_s' in mine and len(mine) >= 2, cell
        assert any(cell in cells_of(m) for m in manifest['per_layer'])
    for m in manifest['per_layer']:
        assert cells_of(m) <= cells_of(e2e[m['moves']]), m['name']
    pairs = [(w['config'], w['traffic']) for w in manifest['workloads']]
    assert len(set(pairs)) == len(pairs)
    assert sum(w['chips'] == 4 for w in manifest['workloads']) <= max(
        1, len(cells) // 4)


def test_files_found_by_name(manifest):
    configs = {c['name'] for c in manifest['configs']}
    files = [c['file'] for c in manifest['configs']]
    assert len(set(files)) == len(files)
    for c in manifest['configs']:
        assert c['file'].startswith(tuple(p + '/' for p in
                                          manifest['paths']))
        assert os.path.exists(os.path.join(ROOT, c['file']))
        for part in ('configs', 'reference'):
            assert os.path.exists(os.path.join(HERE, part,
                                               c['name'] + '.py'))
    for w in manifest['workloads']:
        assert w['config'] in configs
        assert os.path.exists(os.path.join(HERE, 'traffic',
                                           w['traffic'] + '.json'))
        assert os.path.exists(os.path.join(HERE, 'limits',
                                           w['name'] + '.json'))
    for m in manifest['per_layer']:
        assert os.path.exists(os.path.join(HERE, 'metrics',
                                           m['name'] + '.py'))


def test_run_seconds_fit_the_full_check(manifest):
    rs = manifest['run_seconds']
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert ((2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
            <= 43200)


def test_each_cell_kind_gives_its_end_to_end_metrics(manifest):
    from types import SimpleNamespace

    from portbench.run import applies, load_json, load_module
    for w in manifest['workloads']:
        kind = load_json('traffic', w['traffic'] + '.json')['kind']
        module = load_module('kinds', kind + '.py')
        assert issubclass(module.Loop, loops.Loop)
        values = module.end_to_end([0.5, 0.25], 0.75,
                                   SimpleNamespace(units=1))
        want = {m['name'] for m in manifest['end_to_end']
                if applies(m, w['name'])} - {'setup_s'}
        assert want <= set(values), (w['name'], values)
        assert all(v > 0 for v in values.values())
