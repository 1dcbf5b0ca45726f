"""Host ms per item of pyimsegm:gather, the host's numpy work after the
last device-to-host copy of each fetch (inside pyimsegm:fetch)."""

from portbench.trace import TraceError


def read(ctx):
    if 'fetch' not in ctx['config']['stages']:
        return None
    summary = ctx['summary']
    st = summary['stages'].get('gather')
    if st is None or st['count'] != summary['items']:
        raise TraceError('range pyimsegm:gather missing from traced items')
    return st['host_us'] / 1e3 / summary['items']
