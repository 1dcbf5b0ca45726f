"""``BENCHMARK.json`` against the benchmark's contract, and every cell's
files resolved by name."""

import json
import os
import re

import pytest

from portbench import manifest

ROOT = manifest.ROOT
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
TOP = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
       'end_to_end', 'per_layer'}
MAN = manifest.load()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and '\n' not in text and '\t' not in text


def test_top_level_keys_and_command():
    assert set(MAN) == TOP
    assert 1 <= len(MAN['paths']) <= 16
    for path in MAN['paths']:
        assert re.match(r'^[A-Za-z0-9_./-]{1,200}$', path)
        assert not path.startswith('/') and '..' not in path.split('/')
        assert os.path.isdir(os.path.join(ROOT, path))
    assert 1 <= len(MAN['command']) <= 32
    assert all(_line(w) and not w.startswith('/') for w in MAN['command'])
    assert isinstance(MAN['run_seconds'], int)
    assert 1 <= MAN['run_seconds'] <= 51
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 64 * 1024


def test_names_units_and_keys():
    names = {}
    for section, keys in (('configs', {'name', 'source', 'file', 'reduced',
                                       'why'}),
                          ('workloads', {'name', 'config', 'traffic',
                                         'chips', 'why'}),
                          ('end_to_end', {'name', 'unit', 'better', 'bound',
                                          'source'}),
                          ('per_layer', {'name', 'unit', 'better', 'source',
                                         'layer', 'moves'})):
        for entry in MAN[section]:
            allowed = keys | ({'workloads'} if section in (
                'end_to_end', 'per_layer') else set())
            assert keys <= set(entry) <= allowed, entry
            assert NAME.match(entry['name'])
            names.setdefault(section, []).append(entry['name'])
            if 'unit' in entry:
                assert UNIT.match(entry['unit'])
                assert entry['better'] in ('lower', 'higher')
            if 'why' in entry:
                assert _line(entry['why'])
    for section, listed in names.items():
        assert len(listed) == len(set(listed)), section
    metric_names = names['end_to_end'] + names['per_layer']
    assert len(metric_names) == len(set(metric_names))


def test_bounds_and_sources():
    e2e = {m['name']: m for m in MAN['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in MAN['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in MAN['per_layer']:
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert _line(m['layer']) and m['moves'] in e2e
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'


@pytest.mark.parametrize('work', MAN['workloads'], ids=lambda w: w['name'])
def test_every_cell_resolves_by_name(work):
    cell = manifest.cell(work['name'])
    assert work['chips'] in (1, 4)
    assert cell['driver'].Driver
    assert 'setup_s' in cell['end_to_end'] and len(cell['end_to_end']) >= 2
    assert cell['per_layer']
    for mod in list(cell['end_to_end'].values()) + list(
            cell['per_layer'].values()):
        assert callable(mod.read)
    config = cell['config']
    assert config['reduced'] == next(
        c for c in MAN['configs'] if c['name'] == work['config'])['reduced']
    assert set(config['stages']) and config['checks']
    assert cell['mix']['kind'] in ('tissue_tiles', 'blob_volumes')


def test_configs_and_files_under_paths():
    files = [c['file'] for c in MAN['configs']]
    assert len(files) == len(set(files))
    for c in MAN['configs']:
        assert c['file'].startswith(tuple(p + '/' for p in MAN['paths']))
        with open(os.path.join(ROOT, c['file'])) as fh:
            config = json.load(fh)
        assert config['name'] == c['name'] and config['source'] == c['source']
    used = {w['config'] for w in MAN['workloads']}
    assert used == {c['name'] for c in MAN['configs']}
    pairs = [(w['config'], w['traffic']) for w in MAN['workloads']]
    assert len(pairs) == len(set(pairs))
