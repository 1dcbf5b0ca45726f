"""The program's counters (``pyimsegm_tpu_torch.utils.device.counters``),
as the per-layer readers of counters take them.

The program counts only while a profiler session records, so in a run
the counts are those of the traced window (every attempt of it): set-up,
warm calls and the check items run untraced.  A reader takes
``ctx['counters']`` where the caller put a snapshot there, else the
program's own counters at the time it reads; it reads ratios, so neither
a retried trace nor the item count biases it.
"""

from portbench.trace import TraceError


def snapshot(ctx):
    """{name: count} of the traced window."""
    if 'counters' in ctx:
        return ctx['counters']
    from pyimsegm_tpu_torch.utils import device
    return device.counters()


def ratio(ctx, num, den):
    """``num / den`` of the window's counters; raises where either is
    missing or the denominator is 0 (never read as 0)."""
    got = snapshot(ctx)
    missing = [n for n in (num, den) if n not in got]
    if missing or not got[den]:
        raise TraceError('counter %s missing from the traced window'
                         % ', '.join(missing or [den]))
    return got[num] / got[den]
