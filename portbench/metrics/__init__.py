"""Per-layer metrics: one module each, named as the metric, whose
``read(ctx)`` returns the metric's value from a traced window, or None
where the cell's path has nothing for it to read.

``ctx`` holds ``summary`` (:func:`portbench.trace.summarise`), ``config``
and ``mix``.  A reader raises :class:`portbench.trace.TraceError` where
the profiler dropped what it reads; it never reads a drop as 0.
"""

from portbench.trace import TraceError


def stage(ctx, name):
    """The stage's record, or None where the cell's path has no such
    stage; raises where the path has it and the trace lacks its ranges or
    its kernels."""
    if name not in ctx['config']['stages']:
        return None
    st = ctx['summary']['stages'].get(name)
    if st is None or st['count'] != ctx['summary']['items']:
        raise TraceError('range pyimsegm:%s missing from traced items' % name)
    return st


def busy_ms_per_item(ctx, names):
    """Device busy ms per item of the kernels launched in the named stages
    of the path; None where the path has none of them."""
    got = [st for st in (stage(ctx, n) for n in names) if st is not None]
    if not got:
        return None
    if sum(st['kernels'] for st in got) == 0:
        raise TraceError('no kernel attributed to %s' % ', '.join(names))
    return sum(st['busy_us'] for st in got) / 1e3 / ctx['summary']['items']
