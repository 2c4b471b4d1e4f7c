"""ad_dyn_s: the host timer of the dynamics AD sweep, in the timed pair, s."""

from metric_math import timers_sum


def read(ctx):
    return timers_sum(ctx.timers, ("step_ad.dyn",))
