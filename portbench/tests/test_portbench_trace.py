"""The trace reduction on a synthetic event list: busy union, gaps, kernel
attribution by launch time to the innermost range, and loud failures."""

import pytest

from portbench import metrics, trace


def _x(cat, name, ts, dur, **args):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
            'args': args}


def _events():
    """Two items; stages slic and mrf; kernels launched inside them."""
    ev = [_x('user_annotation', trace.ITEM_RANGE, 0, 100),
          _x('user_annotation', trace.ITEM_RANGE, 100, 100)]
    for base in (0, 100):
        ev += [_x('user_annotation', 'pyimsegm:slic', base + 0, 40),
               _x('user_annotation', 'pyimsegm:mrf', base + 50, 40),
               _x('user_annotation', 'pyimsegm:inner', base + 60, 5)]
        # launches at +10 (slic), +55 (mrf), +61 (inner, inside mrf)
        for k, (t, dur, start) in enumerate(((10, 20, 12), (55, 10, 57),
                                             (61, 4, 70))):
            corr = base + k
            ev.append(_x('cuda_runtime', 'cudaLaunchKernel', base + t, 1,
                         correlation=corr))
            ev.append(_x('kernel', 'k%d' % k, base + start, dur,
                         correlation=corr))
        ev.append(_x('gpu_memcpy', 'Memcpy DtoH', base + 90, 5))
    return ev


def test_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 45)]
    assert trace.union_length(iv, 0, 50) == 15 + 11 + 5
    assert trace.union_length(iv, 8, 25) == 7 + 5
    assert trace.gaps(iv, 0, 50) == [(15, 20), (31, 40), (45, 50)]
    assert trace.gaps([], 0, 3) == [(0, 3)]


def test_summary_of_synthetic_trace():
    s = trace.summarise(_events())
    assert s['items'] == 2 and s['window_us'] == 200
    # per item: kernels 12-32, 57-67, 70-74, memcpy 90-95
    assert s['busy_us'] == 2 * (20 + 10 + 4 + 5)
    assert s['stages']['slic'] == {'count': 2, 'host_us': 80.0,
                                   'busy_us': 40.0, 'kernels': 2}
    assert s['stages']['mrf']['busy_us'] == 20.0
    assert s['stages']['inner']['busy_us'] == 8.0      # innermost range
    assert s['device_ops']['k0'] == 40.0
    idle = s['idle_by_range']
    # gaps: 0-12 and 32-57 open in slic, 67-70 and 74-90 in mrf (the inner
    # range ends at 65), 95-112 and 195-200 outside; item 2 repeats all
    # but its first, which merged with item 1's last
    assert idle['pyimsegm:slic'] == 12 + 25 + 25
    assert idle['pyimsegm:mrf'] == 2 * (3 + 16)
    assert idle[trace.OUTSIDE] == 17 + 5
    assert sum(idle.values()) + s['busy_us'] == s['window_us']


def test_readers_on_synthetic_trace():
    s = trace.summarise(_events())
    ctx = {'summary': s, 'mix': {'shape': [10, 10]},
           'config': {'stages': ['slic', 'mrf', 'edges']}}
    with pytest.raises(trace.TraceError):       # edges dropped
        metrics.busy_ms_per_item(ctx, ('edges', 'mrf'))
    ctx['config']['stages'] = ['slic', 'mrf']
    assert metrics.busy_ms_per_item(ctx, ('slic',)) == 0.02
    assert metrics.busy_ms_per_item(ctx, ('fit',)) is None
    from portbench.metrics import device_idle_share
    assert device_idle_share.read(ctx) == pytest.approx(100 * (1 - 78 / 200))


def test_dropped_events_fail_loudly():
    ev = [e for e in _events() if not (e['cat'] == 'cuda_runtime'
                                       and e['args']['correlation'] == 1)]
    with pytest.raises(trace.TraceError):
        trace.summarise(ev)
    ev = [e for e in _events() if e['name'] != trace.ITEM_RANGE]
    with pytest.raises(trace.TraceError):
        trace.summarise(ev)
    ev = [e for e in _events() if not (e['name'] == 'pyimsegm:mrf'
                                       and e['ts'] == 150)]
    s = trace.summarise(ev)
    ctx = {'summary': s, 'mix': {}, 'config': {'stages': ['mrf']}}
    with pytest.raises(trace.TraceError):
        metrics.busy_ms_per_item(ctx, ('mrf',))


def test_top_lists_seconds():
    assert trace.top({'a': 2e6, 'b': 5e6, 'c': 1.0}, 2) == [['b', 5.0],
                                                              ['a', 2.0]]
