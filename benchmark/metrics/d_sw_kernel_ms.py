"""d_sw_kernel_ms: device time of the kernels under the scopes d_sw and
d_sw_pert in the profiled pair, ms."""

from metric_math import scope_ms


def read(ctx):
    return scope_ms(ctx.profile, ("d_sw", "d_sw_pert"))
