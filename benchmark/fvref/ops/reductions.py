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
an ulp or two, whatever the order the values come in.  On a
decomposition each rank gathers every rank's tiles and assembles the
cube's six faces before the tree, so the tree, and its result, are the
single process's bit for bit.

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


def _sum(x, reproduce):
    return compensated_sum(x) if reproduce else x.sum()


def _gather(x, faces):
    """The whole cube's (6, n, n) field: `x` itself on one process, every
    rank's tiles assembled in face order on a decomposition."""
    return x if faces is None else faces.gather_cube(x)


def _g_sum(p, area, total, reproduce, faces):
    s = _sum(_gather(p * area, faces), reproduce)
    return s if total is None else s / total


class _GSum(torch.autograd.Function):
    @staticmethod
    def forward(p, area, total, reproduce, faces):
        return _g_sum(p, area, total, reproduce, faces)

    @staticmethod
    def setup_context(ctx, inputs, output):
        p, area, total, reproduce, faces = inputs
        ctx.reproduce, ctx.faces = reproduce, faces
        ctx.save_for_backward(area, total)
        ctx.save_for_forward(area, total)

    @staticmethod
    def jvp(ctx, dp, *_):
        area, total = ctx.saved_tensors
        if dp is None:
            return area.new_zeros(())
        return _g_sum(dp, area, total, ctx.reproduce, ctx.faces)

    @staticmethod
    def backward(ctx, g):
        area, total = ctx.saved_tensors
        if ctx.faces is not None:
            # every rank holds the sum and passes it on: its cotangent is
            # the sum of the ranks' cotangents
            g = torch.cat(ctx.faces.all_gather(g.reshape(1))).sum()
        w = area if total is None else area / total
        return g * w, None, None, None, None


def global_area(area, reproduce: bool = True, faces=None):
    """The sum of `area` over the cube, gathered from every rank on a
    decomposition: g_sum's divisor in mode 1.  The reference's g_sum
    sums it on its first call and keeps it (`global_area`); a caller that
    sums in mode 1 more than once computes it here once and passes it."""
    return _sum(_gather(area, faces), reproduce)


def g_sum(p, area, mode: int = 0, reproduce: bool = True, faces=None,
          total=None):
    """Area-weighted global sum of a compute-domain field.

    p, area: same-shape tensors (e.g. (6, ny, nx)).  mode 1 divides by the
    global area (fv_grid_utils_nlm.F90:2917-2921): `total`, from
    `global_area`, or summed here when None; reproduce=True takes the
    compensated sum, False the plain `sum`.  On a face decomposition
    (`faces`, the rank's parallel/faces.FaceGroup; p and area (nf, ny,
    nx), its tiles) the products are gathered from every rank, assembled
    into the cube's (6, n, n) in face order and summed by the same tree,
    so the sum is bitwise the single process's, whatever the layout.
    Each rank holds the sum and passes it on, so the cotangent of `p` is
    `area` times the sum of the ranks' cotangents of the sum, gathered
    from them all."""
    if mode != 1:
        total = None
    elif total is None:
        total = global_area(area, reproduce, faces)
    return _GSum.apply(p, area, total, reproduce, faces)
