"""idle_share.phys: 100 minus the union of the profiled pair's kernel
intervals over the unprofiled pair's wall time, %."""

from metric_math import idle_share


def read(ctx):
    return idle_share(ctx.profile.busy_s, ctx.pair_wall_s)
