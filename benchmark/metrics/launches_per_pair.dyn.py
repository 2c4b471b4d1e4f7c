"""launches_per_pair.dyn: the kernels launched in the profiled pair."""


def read(ctx):
    return ctx.profile.launches or None
