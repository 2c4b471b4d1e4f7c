"""phys_pair_s: seconds per TL+AD pair with the physics, over the whole
window (host clock)."""

from metric_math import rate_s


def read(ctx):
    return rate_s(ctx.elapsed_s, ctx.pairs)
