"""Device kernels per item launched in pyimsegm:edges and pyimsegm:mrf
(the MRF loops are bound by their launch count)."""

from portbench.metrics import stage


def read(ctx):
    got = [stage(ctx, n) for n in ('edges', 'mrf')]
    if None in got:
        return None
    return sum(st['kernels'] for st in got) / ctx['summary']['items']
