"""physics_s: the host timers of the moist and turbulence TL and AD, in
the timed pair, s."""

from metric_math import timers_sum


def read(ctx):
    return timers_sum(ctx.timers, ("step_tl.moist", "step_ad.moist",
                                   "step_tl.turb", "step_ad.turb"))
