"""Host ms per item of the entry's upload and fetch ranges (the host I/O
of the pipelines layer)."""

from portbench.metrics import stage


def read(ctx):
    got = [stage(ctx, n) for n in ('upload', 'fetch')]
    if None in got:
        return None
    return sum(st['host_us'] for st in got) / 1e3 / ctx['summary']['items']
