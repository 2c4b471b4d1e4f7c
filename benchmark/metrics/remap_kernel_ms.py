"""remap_kernel_ms: device time of the kernels under the scope remap in
the profiled pair, ms."""

from metric_math import scope_ms


def read(ctx):
    return scope_ms(ctx.profile, ("remap",))
