"""Picture elements (pixels in 2D, voxels in 3D) segmented per second over
all the window's items and all its time, in millions."""


def read(window):
    n = len(window['latencies_s'])
    return n * window['elements'] / window['window_s'] / 1e6
