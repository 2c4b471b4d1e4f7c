"""Global reductions: the reproducible g_sum (fv_grid_utils_nlm.F90:
2873-2924).

Counterpart of fv3jedi_lm_tpu/ops/reductions.py.  The reference's `g_sum`
is an area-weighted global sum with an optional bitwise-reproducible path
(FMS `mpp_global_sum(..., BITWISE_EFP_SUM)`, whose result does not depend
on the MPI layout).  The JAX package sums with a sequential Neumaier scan;
here the compensated sum is a pairwise tree over a power-of-two padding:
each level adds neighbouring pairs and keeps the exact rounding error of
every addition (Knuth's TwoSum, branch-free), the errors summed alongside.
That is about log2(n) levels of a few tensor operations (16 at c96)
instead of n sequential steps, and the result is the exact sum to within
an ulp or two, whatever the order the values come in.

`g_sum` is linear in `p`, so it is a `torch.autograd.Function` whose
tangent is the g_sum of the tangent and whose cotangent is the incoming
cotangent times the area (over the global area in mode 1); it works
under `torch.func.jvp` and autograd alike.  `area` is a constant.
"""

from __future__ import annotations

import torch

#: below which no energy correction applies (fv_mapz_nlm.F90:39)
CONSV_MIN = 0.001


def compensated_sum(x):
    """Sum of all entries of `x` by the pairwise TwoSum tree; a 0-dim
    tensor."""
    s = x.reshape(-1)
    n = s.numel()
    size = 1
    while size < n:
        size *= 2
    if size > n:
        s = torch.cat([s, s.new_zeros(size - n)])
    c = torch.zeros_like(s)
    while s.numel() > 1:
        a, b = s[0::2], s[1::2]
        t = a + b
        z = t - a
        err = (a - (t - z)) + (b - z)
        c = c[0::2] + c[1::2] + err
        s = t
    return (s + c)[0]


def _g_sum(p, area, mode, reproduce):
    x = p * area
    if reproduce:
        s = compensated_sum(x)
        return s / compensated_sum(area) if mode == 1 else s
    s = x.sum()
    return s / area.sum() if mode == 1 else s


class _GSum(torch.autograd.Function):
    @staticmethod
    def forward(p, area, mode, reproduce):
        return _g_sum(p, area, mode, reproduce)

    @staticmethod
    def setup_context(ctx, inputs, output):
        p, area, mode, reproduce = inputs
        ctx.mode = mode
        ctx.reproduce = reproduce
        ctx.save_for_backward(area)
        ctx.save_for_forward(area)

    @staticmethod
    def jvp(ctx, dp, darea, dmode, dreproduce):
        (area,) = ctx.saved_tensors
        if dp is None:
            return area.new_zeros(())
        return _g_sum(dp, area, ctx.mode, ctx.reproduce)

    @staticmethod
    def backward(ctx, g):
        (area,) = ctx.saved_tensors
        w = area
        if ctx.mode == 1:
            w = area / (compensated_sum(area) if ctx.reproduce
                        else area.sum())
        return g * w, None, None, None


def g_sum(p, area, mode: int = 0, reproduce: bool = True):
    """Area-weighted global sum of a compute-domain field.

    p, area: same-shape tensors (e.g. (6, ny, nx)).  mode 1 divides by the
    global area (fv_grid_utils_nlm.F90:2917-2921); reproduce=True takes
    the compensated sum, False the plain `sum`."""
    return _GSum.apply(p, area, mode, reproduce)
