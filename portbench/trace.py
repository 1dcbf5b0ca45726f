"""Device trace of a run's traced window, and its reduction to what the
per-layer readers take.

A traced window runs the cell's items under ``torch.profiler`` (CPU and
CUDA activities), each item inside a ``portbench:item`` range; the
profile is exported as a chrome trace into ``TMPDIR``, read back, and the
file deleted.  :func:`summarise` reduces the event list:

* the window: from the first item range's start to the last one's end, on
  the trace's clock;
* device busy time: the union of kernel, memcpy and memset intervals
  inside the window;
* per ``pyimsegm:<stage>`` range of the program: how often it ran, its host
  time, and the kernels whose launch (the runtime or driver call that the
  kernel's correlation id names) falls inside it, innermost range first,
  with their summed durations (so idle gaps inside a stage never count);
* the idle gaps of the device inside the window, each named by the
  innermost range the host was in when the gap opened.
"""

import bisect
import json
import os
import tempfile

ITEM_RANGE = 'portbench:item'
STAGE_PREFIX = 'pyimsegm:'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
OUTSIDE = 'outside any range'


class TraceError(RuntimeError):
    """The profiler dropped events the reduction needs."""


def profile_items(call, items):
    """Run ``call(item)`` on each item under the profiler; return the chrome
    trace's event list."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for item in items:
            with record_function(ITEM_RANGE):
                call(item)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)['traceEvents']
    finally:
        os.remove(path)


def union_length(intervals, lo, hi):
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """(start, end) gaps of the union of the intervals inside [lo, hi]."""
    out, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


class _Ranges:
    """Innermost-range lookup over (start, end, name) host ranges, which
    nest but never cross."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges)
        self.starts = [r[0] for r in self.ranges]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            s, e, name = self.ranges[i]
            if s <= t < e:
                return name
            i -= 1
        return None


def summarise(events):
    """Reduce a chrome trace's events (see the module docstring).

    :returns: dict with ``window_us``, ``busy_us``, ``items``, ``stages``
        ({stage: {'count', 'host_us', 'busy_us', 'kernels'}}),
        ``device_ops`` ({name: us}) and ``idle_by_range`` ({name: us})
    """
    items, stage_ranges, device, launches = [], [], [], {}
    kernels = []
    for ev in events:
        if ev.get('ph') != 'X':
            continue
        cat, name = ev.get('cat', ''), ev.get('name', '')
        ts, dur = float(ev['ts']), float(ev.get('dur', 0.0))
        if cat == 'user_annotation':
            if name == ITEM_RANGE:
                items.append((ts, ts + dur))
            elif name.startswith(STAGE_PREFIX):
                stage_ranges.append((ts, ts + dur, name[len(STAGE_PREFIX):]))
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, name))
            if cat == 'kernel':
                kernels.append((ev.get('args', {}).get('correlation'), dur))
        elif cat in LAUNCH_CATS:
            corr = ev.get('args', {}).get('correlation')
            if corr is not None:
                launches[corr] = ts
    if not items:
        raise TraceError('no %s range in the trace' % ITEM_RANGE)
    lo, hi = min(s for s, _ in items), max(e for _, e in items)
    spans = [(s, e) for s, e, _ in device]
    ranges = _Ranges(stage_ranges)
    stages = {}
    for s, e, name in stage_ranges:
        if lo <= s < hi:
            st = stages.setdefault(name, {'count': 0, 'host_us': 0.0,
                                          'busy_us': 0.0, 'kernels': 0})
            st['count'] += 1
            st['host_us'] += e - s
    unmatched = 0
    for corr, dur in kernels:
        t = launches.get(corr)
        if t is None:
            unmatched += 1
            continue
        if not lo <= t < hi:
            continue
        name = ranges.at(t)
        if name is None or name not in stages:
            continue
        stages[name]['busy_us'] += dur
        stages[name]['kernels'] += 1
    if unmatched:
        raise TraceError('%d kernels without their launch call in the trace'
                         % unmatched)
    ops = {}
    for s, e, name in device:
        if lo <= s < hi:
            ops[name] = ops.get(name, 0.0) + (e - s)
    idle = {}
    for s, e in gaps(spans, lo, hi):
        name = ranges.at(s)
        name = OUTSIDE if name is None else STAGE_PREFIX + name
        idle[name] = idle.get(name, 0.0) + (e - s)
    return {'window_us': hi - lo, 'busy_us': union_length(spans, lo, hi),
            'items': len(items), 'stages': stages, 'device_ops': ops,
            'idle_by_range': idle}


def top(mapping, n=10, width=120):
    """[[name, seconds], ...] of the n largest microsecond values, each
    name cut to ``width`` characters (kernel names run to hundreds)."""
    return [[k[:width], v / 1e6]
            for k, v in sorted(mapping.items(), key=lambda kv: -kv[1])[:n]]
