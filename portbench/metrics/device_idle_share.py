"""Share (%) of the traced window in which no kernel, memcpy or memset ran
on the device, both from the trace's device timestamps."""


def read(ctx):
    s = ctx['summary']
    return 100.0 * (1.0 - s['busy_us'] / s['window_us'])
