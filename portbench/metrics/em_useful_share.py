"""Share (%) of the EM restart-iterations in which the restart had not
yet converged (program counters 100 * em_active_iters /
em_restart_iters); the rest recompute a frozen restart.  None where the
cell's path fits no model."""

from portbench.counters import ratio


def read(ctx):
    if 'fit' not in ctx['config']['stages']:
        return None
    return 100.0 * ratio(ctx, 'em_active_iters', 'em_restart_iters')
