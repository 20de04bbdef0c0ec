"""The harness finds every configuration, traffic mix, driver, limit and
metric reader by its name in BENCHMARK.json, and the file keeps to the
benchmark's contract."""
import json
import re

import pytest

from perfbench.harness import registry

BENCH = registry.load_benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


@pytest.mark.parametrize('workload', [w['name'] for w in BENCH['workloads']])
def test_every_cell_resolves(workload):
    cell = registry.cell(workload)
    assert cell.config['name'] == cell.config_name
    assert 'config' in cell.config and cell.limits
    driver = registry.driver(cell.traffic)
    assert callable(driver.run)
    e2e = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m['moves'] in e2e
        assert callable(registry.reader(m['name']))


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        registry.cell('no_such.cell')


def test_contract_shapes():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= BENCH['run_seconds'] <= 51
    names = [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    names += [w['name'] for w in BENCH['workloads']]
    names += [c['name'] for c in BENCH['configs']]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert m['source'] in SOURCES
    for c in BENCH['configs']:
        assert c['file'].startswith('perfbench/')
        assert all(NAME.match(k) for k in c['reduced'])
        with open(registry.ROOT / c['file']) as f:
            assert json.load(f)['reduced'].keys() == set(c['reduced'])
    used = {w['config'] for w in BENCH['workloads']}
    assert used == {c['name'] for c in BENCH['configs']}
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))
    assert all(len(w['why']) <= 200 and w['chips'] == 1
               for w in BENCH['workloads'])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_per_layer_metrics_are_reported_where_they_move():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    for m in BENCH['per_layer']:
        moved = e2e[m['moves']]
        for w in m['workloads']:
            assert w in moved.get('workloads', [w])
