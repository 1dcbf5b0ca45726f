"""The readers of the program's gather span and EM counters on a synthetic
summary and counter snapshot, and their loud failures."""

import importlib

import pytest

from portbench import counters
from portbench.trace import TraceError

STAGES_3D = ['upload', 'slic', 'counts', 'features', 'fit',
             'predict_proba', 'edges', 'mrf', 'lookup', 'fetch']
STAGES_2D = ['upload', 'slic', 'enforce', 'features', 'predict_proba',
             'edges', 'mrf', 'fetch']
EM = {'em_runs': 16, 'em_iters': 16 * 99, 'em_restart_iters': 16 * 9 * 99,
      'em_active_iters': 2851, 'em_refits': 1}


def _read(name, ctx):
    return importlib.import_module('portbench.metrics.' + name).read(ctx)


def _ctx(stages, gather=None, items=8, snapshot=None):
    summary = {'items': items, 'stages': {
        'fetch': {'count': items, 'host_us': 9000.0 * items,
                  'busy_us': 0.0, 'kernels': 0}}}
    if gather is not None:
        summary['stages']['gather'] = gather
    ctx = {'summary': summary, 'config': {'stages': stages}, 'mix': {}}
    if snapshot is not None:
        ctx['counters'] = snapshot
    return ctx


def test_gather_ms_per_item():
    gather = {'count': 8, 'host_us': 8 * 1234.5, 'busy_us': 0.0,
              'kernels': 0}
    assert _read('gather_ms', _ctx(STAGES_2D, gather)) == pytest.approx(
        1.2345)


@pytest.mark.parametrize('count', [None, 7])
def test_gather_ms_missing_or_dropped_raises(count):
    gather = None if count is None else {'count': count, 'host_us': 1.0,
                                         'busy_us': 0.0, 'kernels': 0}
    with pytest.raises(TraceError):
        _read('gather_ms', _ctx(STAGES_3D, gather))


def test_gather_ms_none_without_fetch():
    assert _read('gather_ms', _ctx(['slic'])) is None


def test_em_ratios_from_a_snapshot():
    ctx = _ctx(STAGES_3D, snapshot=dict(EM))
    assert _read('em_iters', ctx) == 99.0
    assert _read('em_useful_share', ctx) == pytest.approx(
        100.0 * 2851 / (16 * 9 * 99))


@pytest.mark.parametrize('drop', ['em_runs', 'em_iters', 'em_active_iters',
                                  'em_restart_iters'])
def test_em_readers_raise_on_a_missing_counter(drop):
    snapshot = {k: v for k, v in EM.items() if k != drop}
    ctx = _ctx(STAGES_3D, snapshot=snapshot)
    name = 'em_iters' if drop in ('em_runs', 'em_iters') \
        else 'em_useful_share'
    with pytest.raises(TraceError):
        _read(name, ctx)


def test_em_readers_raise_on_an_empty_window():
    ctx = _ctx(STAGES_3D, snapshot={})
    for name in ('em_iters', 'em_useful_share'):
        with pytest.raises(TraceError):
            _read(name, ctx)


def test_em_readers_none_without_a_fit():
    ctx = _ctx(STAGES_2D, snapshot=dict(EM))
    assert _read('em_iters', ctx) is None
    assert _read('em_useful_share', ctx) is None


def test_snapshot_falls_back_to_the_program():
    """Without a snapshot in ``ctx`` the readers take the program's
    counters, which only a profiler session moves."""
    torch = pytest.importorskip('torch')
    from torch.profiler import ProfilerActivity, profile

    from pyimsegm_tpu_torch.models import gmm
    from pyimsegm_tpu_torch.utils import device
    device.reset_counters()
    g = torch.Generator().manual_seed(0)
    x = torch.cat([torch.randn(100, 2, generator=g),
                   torch.randn(100, 2, generator=g) + 8.0])
    with profile(activities=[ProfilerActivity.CPU]):
        gmm.gmm_fit(torch.Generator().manual_seed(0), x, torch.ones(200),
                    2, n_init=3)
    ctx = _ctx(STAGES_3D)
    assert counters.snapshot(ctx) == device.counters()
    assert _read('em_iters', ctx) == 99.0
    assert 0.0 < _read('em_useful_share', ctx) < 100.0
    device.reset_counters()
