"""Device busy ms per item of the kernels launched in pyimsegm:fit and
pyimsegm:predict_proba (the model / classifier layer)."""

from portbench.metrics import busy_ms_per_item


def read(ctx):
    return busy_ms_per_item(ctx, ('fit', 'predict_proba'))
