"""Every cell, configuration, driver and metric of BENCHMARK.json is
found by its name, and the file keeps to the benchmark's contract."""
import importlib
import importlib.util
import json
import os
import re

import pytest

from cwm_bench import harness

with open(os.path.join(harness.ROOT, 'BENCHMARK.json')) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]
METRICS = [m['name'] for m in BENCH['per_layer']]


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['cwm_bench']
    assert 1 <= BENCH['run_seconds'] <= 51
    names = [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert len(names) == len(set(names))
    assert 'setup_s' in names


@pytest.mark.parametrize('entry', BENCH['end_to_end'] + BENCH['per_layer'],
                         ids=lambda m: m['name'])
def test_metric_entry(entry):
    assert NAME.match(entry['name']) and UNIT.match(entry['unit'])
    assert entry['better'] in ('lower', 'higher')
    if 'bound' in entry:
        assert 0.01 <= entry['bound'] <= 0.25
        assert entry['source'] in ('host_clock', 'device_trace')
    else:
        e2e = {m['name'] for m in BENCH['end_to_end']}
        assert entry['moves'] in e2e and entry['layer'].strip()
        assert set(entry['workloads']) <= set(CELLS)
    if 'roofline' in entry['name'] or 'mfu' in entry['name']:
        assert entry['unit'] == '%'


@pytest.mark.parametrize('cell', CELLS)
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert c.spec['name'] == cell and c.spec['config'] == c.workload['config']
    assert c.workload['chips'] in (1, 4)
    assert len(c.workload['why']) <= 200
    e2e = {m['name'] for m in c.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert c.per_layer, 'every cell reports a per-layer metric'
    driver = harness.load_driver(c.spec['driver'])
    assert hasattr(driver, 'Run') and hasattr(driver, 'control')
    assert set(c.spec['limits']) and all(
        v >= 0 for v in c.spec['limits'].values())


@pytest.mark.parametrize('cfg', BENCH['configs'], ids=lambda c: c['name'])
def test_config_file(cfg):
    path = os.path.join(harness.ROOT, cfg['file'])
    assert cfg['file'].startswith('cwm_bench/configs/')
    with open(path) as f:
        data = json.load(f)
    assert data['name'] == cfg['name'] and data['reduced'] == cfg['reduced']
    assert data['source'] == cfg['source']
    assert any(w['config'] == cfg['name'] for w in BENCH['workloads'])


@pytest.mark.parametrize('name', METRICS)
def test_metric_reader_loads_by_name(name):
    path = os.path.join(harness.BENCH_DIR, 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location('m_' + name.replace(
        '.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert callable(module.read)


def test_result_keys_of_a_cell():
    """A run's result as the harness builds it, on a stand-in driver."""
    assert harness.check_lines({'a': {'value': 1.0, 'limit': 2.0}}) == [
        'check a: 1.0 (limit 2.0)']
