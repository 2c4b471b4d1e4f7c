"""pair_mfu.dyn: the configuration's float32 operations per pair over the
unprofiled pair's wall time, as a share of the H100's float32 peak, %."""

from metric_math import mfu


def read(ctx):
    ops = ctx.conf.get("ops_per_pair", {}).get("count")
    return mfu(ops, ctx.pair_wall_s, ctx.peaks.F32_OPS_PER_S)
