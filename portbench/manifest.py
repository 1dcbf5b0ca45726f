"""``BENCHMARK.json`` and the files it names, resolved by name: a cell's
configuration (its ``file``), traffic mix (``portbench/traffic/<traffic>
.json``), driver (``portbench/drivers/<config's driver>.py``) and metric
readers (``portbench/end_to_end/<name>.py``, ``portbench/metrics/<name>
.py``)."""

import importlib
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, 'portbench')


def load(root=ROOT):
    with open(os.path.join(root, 'BENCHMARK.json')) as fh:
        return json.load(fh)


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def applies(metric, workload, end_to_end):
    """Whether a metric is reported in a cell: the cells of its
    ``workloads``, or else every cell that reports the metric it moves."""
    if 'workloads' in metric:
        return workload in metric['workloads']
    moves = metric.get('moves')
    if moves is None:
        return True
    return applies(end_to_end[moves], workload, end_to_end)


def cell(name, manifest=None, root=ROOT):
    """Everything one run of cell ``name`` needs."""
    manifest = manifest or load(root)
    work = {w['name']: w for w in manifest['workloads']}
    if name not in work:
        raise KeyError('no workload %r in BENCHMARK.json' % name)
    w = work[name]
    conf = {c['name']: c for c in manifest['configs']}[w['config']]
    config = _json(os.path.join(root, conf['file']))
    mix = _json(os.path.join(root, 'portbench', 'traffic',
                             w['traffic'] + '.json'))
    e2e = {m['name']: m for m in manifest['end_to_end']}
    return {
        'workload': w, 'config': config, 'mix': mix,
        'driver': importlib.import_module('portbench.drivers.'
                                          + config['driver']),
        'end_to_end': {n: importlib.import_module('portbench.end_to_end.'
                                                  + n)
                       for n, m in e2e.items() if applies(m, name, e2e)},
        'per_layer': {m['name']: importlib.import_module(
            'portbench.metrics.' + m['name'])
            for m in manifest['per_layer'] if applies(m, name, e2e)},
        'units': {m['name']: m['unit']
                  for m in manifest['end_to_end'] + manifest['per_layer']},
    }
