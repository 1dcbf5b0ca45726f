"""Device busy ms per item of the kernels launched in pyimsegm:edges and
pyimsegm:mrf."""

from portbench.metrics import busy_ms_per_item


def read(ctx):
    return busy_ms_per_item(ctx, ('edges', 'mrf'))
