"""EM iterations per EM run of the GMM fit (program counters em_iters /
em_runs); None where the cell's path fits no model."""

from portbench.counters import ratio


def read(ctx):
    if 'fit' not in ctx['config']['stages']:
        return None
    return ratio(ctx, 'em_iters', 'em_runs')
