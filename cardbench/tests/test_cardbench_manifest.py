"""BENCHMARK.json against the benchmark's contract, and the files the
harness finds by the names in it."""
import json
import re

import pytest

from cardbench import harness

BENCH_FILE = harness.ROOT / 'BENCHMARK.json'
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}


@pytest.fixture(scope='module')
def bench():
    assert BENCH_FILE.stat().st_size <= 64 * 1024
    return json.loads(BENCH_FILE.read_text())


def one_line(text: str, limit: int = 200) -> bool:
    return 1 <= len(text) <= limit and '\n' not in text and '\t' not in text


def test_top_level(bench):
    assert set(bench) == KEYS
    assert 1 <= len(bench['command']) <= 32
    assert all(one_line(word) for word in bench['command'])
    assert 1 <= len(bench['paths']) <= 16
    for path in bench['paths']:
        assert PATH.match(path) and not path.startswith('/')
        assert '..' not in path.split('/')
    assert isinstance(bench['run_seconds'], int)
    assert 1 <= bench['run_seconds'] <= 51


def test_names_are_unique_and_plain(bench):
    for key in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [e['name'] for e in bench[key]]
        assert len(names) == len(set(names)), key
        assert all(NAME.match(n) for n in names), names
    metrics = [m['name'] for m in bench['end_to_end'] + bench['per_layer']]
    assert len(metrics) == len(set(metrics))


def test_configs(bench):
    assert 1 <= len(bench['configs']) <= 24
    files = set()
    for config in bench['configs']:
        assert set(config) == {'name', 'source', 'file', 'reduced', 'why'}
        assert one_line(config['source']) and one_line(config['why'])
        assert config['file'].startswith(bench['paths'][0] + '/')
        assert (harness.ROOT / config['file']).is_file()
        assert config['file'] not in files
        files.add(config['file'])
        assert len(config['reduced']) <= 16
        assert all(NAME.match(k) for k in config['reduced'])
        sizes = json.loads((harness.ROOT / config['file']).read_text())
        for key in config['reduced']:
            assert key in sizes
            assert not key.endswith(('_dim', '_rank'))
    used = {w['config'] for w in bench['workloads']}
    assert used == {c['name'] for c in bench['configs']}


def test_workloads(bench):
    cells = bench['workloads']
    assert 1 <= len(cells) <= 24
    pairs = {(w['config'], w['traffic']) for w in cells}
    assert len(pairs) == len(cells)
    assert sum(w['chips'] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4)
        assert one_line(w['why']) and NAME.match(w['traffic'])
        traffic = harness.HERE / 'traffic' / f'{w["traffic"]}.json'
        generator = json.loads(traffic.read_text())['generator']
        assert (harness.HERE / 'generators' / f'{generator}.py').is_file()


def test_metrics(bench):
    cells = {w['name'] for w in bench['workloads']}
    e2e = {m['name']: m for m in bench['end_to_end']}
    assert 'setup_s' in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(bench['per_layer']) <= 128
    for m in bench['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in bench['end_to_end'] + bench['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert set(m.get('workloads', cells)) <= cells
    for m in bench['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                          'layer', 'moves'}
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert one_line(m['layer'])
        moved = e2e[m['moves']]
        assert set(m['workloads']) <= set(moved.get('workloads', cells))
        assert harness.reader_path(m['name']).is_file()
        if m['name'].endswith('_roofline') or '_roofline.' in m['name']:
            assert m['unit'] == '%'


def test_every_cell_reports_set_up_another_metric_and_a_layer(bench):
    for w in bench['workloads']:
        cell = harness.Cell(bench, w['name'])
        names = {m['name'] for m in cell.end_to_end}
        assert 'setup_s' in names and len(names) >= 2
        assert cell.per_layer
