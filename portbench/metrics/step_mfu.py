"""The whole step's share (%) of the card's f32 peak: the counted f32
operations of the traced items (``portbench.roofline.step_ops``) over the
traced window at 67 TFLOP/s.  It bounds the kernels' rooflines: a stage
taken off the path leaves its roofline silent but not this."""

from portbench import roofline


def read(ctx):
    s = ctx['summary']
    ops = roofline.step_ops(ctx['config'], ctx['mix']) * s['items']
    return 100.0 * ops / (s['window_us'] / 1e6 * roofline.F32_OPS_PER_S)
