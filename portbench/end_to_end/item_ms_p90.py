"""The 90th percentile, over all items of the window, of one item's
host-clock latency in ms (numpy's linear interpolation)."""

import numpy as np


def read(window):
    return float(np.percentile(np.asarray(window['latencies_s']) * 1e3, 90))
