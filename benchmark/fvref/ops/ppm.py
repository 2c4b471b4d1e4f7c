"""PPM flux operators (xppm / yppm) for FV transport, iord 1-13.

Counterpart of fv3jedi_lm_tpu/ops/ppm.py (model/tp_core_nlm.F90:291-951):
piecewise-parabolic reconstruction with the scheme family selected by
`iord`:

  1  first-order upwind
  2  unlimited ("perfectly linear") PPM, the linearization's pert scheme
  3,4,5,6,7  selectively-limited fast schemes
  8  Lin PPM with fast monotone constraint
  9,13  positive-definite constraints
  10 Lin's modification of the Huynh constraint
  11 van-Leer-type via PPM
  12 same family (10's relaxative variant, tp_core_nlm.F90:505)

The operator works along a chosen axis (`ax` = -1 for xppm, -2 for yppm)
with no transposes.  q is a padded center tensor of width IC = n + 2*ng
along `ax`; edge-indexed tensors have width IC + 1 with edge e between
cells e-1, e; face edges at e = ng and e = ng + n.
"""

from __future__ import annotations

import torch

from .. import NG
from ..core.freeze import fabs, fbool, fmax, fmin, fsign_mul, fwhere

# reconstruction coefficients (tp_core_nlm.F90:40-70)
P1 = 7.0 / 12.0
P2 = -1.0 / 12.0
C1 = -2.0 / 14.0
C2 = 11.0 / 14.0
C3 = 5.0 / 14.0
S11 = 11.0 / 14.0
S14 = 4.0 / 7.0
S15 = 3.0 / 14.0
R3 = 1.0 / 3.0
NEAR_ZERO = 1.0e-25
PPM_FAC = 1.5


class _Ax:
    """Slicing helpers along the working axis (-1 or -2)."""

    def __init__(self, ax: int):
        self.ax = ax

    def get(self, x, i):
        return x[..., i] if self.ax == -1 else x[..., i, :]

    def rng(self, x, a, b):
        return x[..., a:b] if self.ax == -1 else x[..., a:b, :]

    def stk(self, vs):
        return torch.stack(vs, dim=self.ax)

    def cat(self, ps):
        return torch.cat(ps, dim=self.ax)

    def size(self, x):
        return x.shape[self.ax]

    def zeros_like_w(self, x, w):
        if self.ax == -1:
            return x.new_zeros(x.shape[:-1] + (w,))
        return x.new_zeros(x.shape[:-2] + (w, x.shape[-1]))

    def exp(self, v):
        """Add back the working axis to a single-line value."""
        return v[..., None] if self.ax == -1 else v[..., None, :]


_AXX = _Ax(-1)
_AXY = _Ax(-2)


def set_cols(a, updates, A: _Ax = _AXX):
    """A copy of `a` with single lines along the working axis replaced.

    updates: list of (static index, value of the line's shape)."""
    out = a.clone()
    for col, val in updates:
        if A.ax == -1:
            out[..., col] = val
        else:
            out[..., col, :] = val
    return out


def _edge_interp(q, dxa, i0, A: _Ax):
    """Two-sided face-edge interface value (tp_core_nlm.F90:346-349); i0
    is the padded index of the cell right of the edge."""
    qm, q0, q1, q2 = (A.get(q, i0 - 2), A.get(q, i0 - 1), A.get(q, i0),
                      A.get(q, i0 + 1))
    dm, d0, d1, d2 = (A.get(dxa, i0 - 2), A.get(dxa, i0 - 1),
                      A.get(dxa, i0), A.get(dxa, i0 + 1))
    return 0.5 * (
        ((2.0 * d0 + dm) * q0 - d0 * qm) / (dm + d0)
        + ((2.0 * d1 + d2) * q1 - d1 * q2) / (d1 + d2)
    )


def pert_ppm(a0, al, ar, iv):
    """PPM constraint in perturbation form (tp_core_nlm.F90:953-1011)."""
    r12 = 1.0 / 12.0
    if iv == 0:
        a4 = -3.0 * (ar + al)
        da1 = ar - al
        f_min = a0 + 0.25 / fwhere(a4 == 0, 1.0, a4) * da1**2 + a4 * r12
        need_fix = (torch.abs(da1) < -a4) & (f_min < 0.0)
        both_pos = (ar > 0.0) & (al > 0.0)
        da1_pos = da1 > 0.0
        zero = torch.zeros_like(ar)
        ar_f = fwhere(both_pos, zero, fwhere(da1_pos, -2.0 * al, ar))
        al_f = fwhere(both_pos, zero, fwhere(da1_pos, al, -2.0 * ar))
        ar_n = fwhere(need_fix, ar_f, ar)
        al_n = fwhere(need_fix, al_f, al)
        pos = a0 > 0.0
        return fwhere(pos, al_n, 0.0), fwhere(pos, ar_n, 0.0)
    opp = al * ar < 0.0
    da1 = al - ar
    da2 = da1**2
    a6da = 3.0 * (al + ar) * da1
    ar_n = fwhere(a6da < -da2, -2.0 * al, ar)
    al_n = fwhere(a6da > da2, -2.0 * ar, al)
    return fwhere(opp, al_n, 0.0), fwhere(opp, ar_n, 0.0)


def _bl_br_low(q, dxa, iord, A: _Ax, lo=True, hi=True):
    """bl/br for iord < 8 with the cubed-sphere face-edge interface
    overrides (tp_core_nlm.F90:341-369) at the low (west/south) and high
    (east/north) face edges where `lo`/`hi`; cell-aligned."""
    ic = A.size(q)
    n = ic - 2 * NG
    z = A.zeros_like_w(q, 2)
    al = A.cat([z, P1 * (A.rng(q, 1, ic - 2) + A.rng(q, 2, ic - 1))
                + P2 * (A.rng(q, 0, ic - 3) + A.rng(q, 3, ic)), z])
    if iord == 7:
        half = 0.5 * (A.rng(q, 0, ic - 1) + A.rng(q, 1, ic))
        alv = A.rng(al, 1, ic)
        al = A.cat([A.rng(al, 0, 1), fwhere(alv < 0.0, half, alv),
                    A.rng(al, ic, ic + 1)])
    e_w = NG          # west face edge index
    e_e = NG + n      # east face edge
    edge_vals = []
    if lo:
        edge_vals += [
            (e_w - 1, C1 * A.get(q, e_w - 3) + C2 * A.get(q, e_w - 2)
             + C3 * A.get(q, e_w - 1)),
            (e_w, _edge_interp(q, dxa, e_w, A)),
            (e_w + 1, C3 * A.get(q, e_w) + C2 * A.get(q, e_w + 1)
             + C1 * A.get(q, e_w + 2))]
    if hi:
        edge_vals += [
            (e_e - 1, C1 * A.get(q, e_e - 3) + C2 * A.get(q, e_e - 2)
             + C3 * A.get(q, e_e - 1)),
            (e_e, _edge_interp(q, dxa, e_e, A)),
            (e_e + 1, C3 * A.get(q, e_e) + C2 * A.get(q, e_e + 1)
             + C1 * A.get(q, e_e + 2))]
    if iord == 7:
        edge_vals = [(e, fmax(0.0, v)) for e, v in edge_vals]
    al = set_cols(al, edge_vals, A)
    return A.rng(al, 0, ic) - q, A.rng(al, 1, ic + 1) - q


def _bl_br_high(q, dxa, iord, A: _Ax, lo=True, hi=True):
    """bl/br for iord >= 8 (monotone family) with the edge fixes at the
    face edges `lo`/`hi` as in _bl_br_low; cell-aligned."""
    ic = A.size(q)
    n = ic - 2 * NG

    qm1 = A.rng(q, 0, ic - 2)
    qp1 = A.rng(q, 2, ic)
    q0 = A.rng(q, 1, ic - 1)
    xt = 0.25 * (qp1 - qm1)
    dm_i = fsign_mul(xt, fmin(
        fabs(xt),
        fmin(fmax(fmax(qm1, q0), qp1) - q0,
             q0 - fmin(fmin(qm1, q0), qp1)),
    ))
    z1 = A.zeros_like_w(q, 1)
    dm = A.cat([z1, dm_i, z1])

    al = A.cat([
        z1,
        0.5 * (A.rng(q, 0, ic - 1) + A.rng(q, 1, ic))
        + R3 * (A.rng(dm, 0, ic - 1) - A.rng(dm, 1, ic)),
        z1,
    ])

    bl = A.rng(al, 0, ic) - q
    br = A.rng(al, 1, ic + 1) - q

    if iord in (8, 11):
        xt2 = (2.0 if iord == 8 else PPM_FAC) * dm
        bl = -fsign_mul(xt2, fmin(fabs(xt2), fabs(bl)))
        br = fsign_mul(xt2, fmin(fabs(xt2), fabs(br)))
    else:  # 9, 10, 12, 13
        dq = A.cat([2.0 * (A.rng(q, 1, ic) - A.rng(q, 0, ic - 1)), z1])
        dqm1 = torch.roll(dq, 1, dims=A.ax)
        dqm2 = torch.roll(dq, 2, dims=A.ax)
        dqp1 = torch.roll(dq, -1, dims=A.ax)
        dmm1 = torch.roll(dm, 1, dims=A.ax)
        dmp1 = torch.roll(dm, -1, dims=A.ax)
        flat = torch.abs(dmm1) + torch.abs(dm) + torch.abs(dmp1) < NEAR_ZERO
        noisy = torch.abs(3.0 * (bl + br)) > torch.abs(bl - br)
        pmp_2 = dqm1
        lac_2 = pmp_2 - 0.75 * dqm2
        br_l = fmin(fmax(0.0, fmax(pmp_2, lac_2)),
                    fmax(br, fmin(0.0, fmin(pmp_2, lac_2))))
        pmp_1 = -dq
        lac_1 = pmp_1 + 0.75 * dqp1
        bl_l = fmin(fmax(0.0, fmax(pmp_1, lac_1)),
                    fmax(bl, fmin(0.0, fmin(pmp_1, lac_1))))
        bl = fwhere(flat, 0.0, fwhere(noisy, bl_l, bl))
        br = fwhere(flat, 0.0, fwhere(noisy, br_l, br))
    if iord in (9, 13):  # additional positive-definite constraint
        bl, br = pert_ppm(q, bl, br, 0)

    # ---- cubed-sphere edge fixes (tp_core_nlm.F90:531-569) ----
    e_w, e_e = NG, NG + n
    i0 = e_w - 1
    iN = e_e - 2
    parts_l, parts_r = [], []
    if lo:
        b_l_w, b_r_w = _west_fix(q, dxa, dm, i0, e_w, A)
        parts_l += [A.rng(bl, 0, i0), b_l_w]
        parts_r += [A.rng(br, 0, i0), b_r_w]
        start = i0 + 3
    else:
        start = 0
    if hi:
        b_l_e, b_r_e = _east_fix(q, dxa, dm, iN, e_e, A)
        parts_l += [A.rng(bl, start, iN), b_l_e, A.rng(bl, iN + 3, A.size(q))]
        parts_r += [A.rng(br, start, iN), b_r_e, A.rng(br, iN + 3, A.size(q))]
    else:
        parts_l.append(A.rng(bl, start, A.size(q)))
        parts_r.append(A.rng(br, start, A.size(q)))
    if len(parts_l) == 1:
        return bl, br
    return A.cat(parts_l), A.cat(parts_r)


def _west_fix(q, dxa, dm, i0, e_w, A):
    """bl/br of the three cells right of the west (south) face edge."""
    bl0 = S14 * A.get(dm, i0 - 1) + S11 * (A.get(q, i0 - 1) - A.get(q, i0))
    xt = _edge_interp(q, dxa, e_w, A)
    xt = fmax(xt, fmin(fmin(A.get(q, i0 - 1), A.get(q, i0)),
                       fmin(A.get(q, i0 + 1), A.get(q, i0 + 2))))
    xt = fmin(xt, fmax(fmax(A.get(q, i0 - 1), A.get(q, i0)),
                       fmax(A.get(q, i0 + 1), A.get(q, i0 + 2))))
    br0 = xt - A.get(q, i0)
    bl1 = xt - A.get(q, i0 + 1)
    xt1 = (S15 * A.get(q, i0 + 1) + S11 * A.get(q, i0 + 2)
           - S14 * A.get(dm, i0 + 2))
    br1 = xt1 - A.get(q, i0 + 1)
    bl2 = xt1 - A.get(q, i0 + 2)
    al3 = 0.5 * (A.get(q, i0 + 2) + A.get(q, i0 + 3)) + R3 * (
        A.get(dm, i0 + 2) - A.get(dm, i0 + 3))
    br2 = al3 - A.get(q, i0 + 2)
    return pert_ppm(A.rng(q, i0, i0 + 3), A.stk([bl0, bl1, bl2]),
                    A.stk([br0, br1, br2]), 1)


def _east_fix(q, dxa, dm, iN, e_e, A):
    """bl/br of the east (north) face edge's cells npx-2, npx-1, npx ->
    padded e_e-2, e_e-1, e_e."""
    blN0 = (0.5 * (A.get(q, iN - 1) + A.get(q, iN))
            + R3 * (A.get(dm, iN - 1) - A.get(dm, iN)) - A.get(q, iN))
    xtN = (S15 * A.get(q, iN + 1) + S11 * A.get(q, iN)
           + S14 * A.get(dm, iN))
    brN0 = xtN - A.get(q, iN)
    blN1 = xtN - A.get(q, iN + 1)
    xtE = _edge_interp(q, dxa, e_e, A)
    xtE = fmax(xtE, fmin(fmin(A.get(q, iN), A.get(q, iN + 1)),
                         fmin(A.get(q, iN + 2), A.get(q, iN + 3))))
    xtE = fmin(xtE, fmax(fmax(A.get(q, iN), A.get(q, iN + 1)),
                         fmax(A.get(q, iN + 2), A.get(q, iN + 3))))
    brN1 = xtE - A.get(q, iN + 1)
    blN2 = xtE - A.get(q, iN + 2)
    brN2 = S11 * (A.get(q, iN + 3) - A.get(q, iN + 2)) - S14 * A.get(dm, iN + 3)
    return pert_ppm(A.rng(q, iN, iN + 3), A.stk([blN0, blN1, blN2]),
                    A.stk([brN0, brN1, brN2]), 1)


def _flux_from_blbr(q, c, bl, br, e0, e1, A: _Ax):
    """Upwind PPM flux at edges e in [e0, e1); c is edge-aligned."""
    qL = A.rng(q, e0 - 1, e1 - 1)
    qR = A.rng(q, e0, e1)
    blL = A.rng(bl, e0 - 1, e1 - 1)
    brL = A.rng(br, e0 - 1, e1 - 1)
    blR = A.rng(bl, e0, e1)
    brR = A.rng(br, e0, e1)
    b0L = blL + brL
    b0R = blR + brR
    fpos = qL + (1.0 - c) * (brL - c * b0L)
    fneg = qR + (1.0 + c) * (blR + c * b0R)
    return fwhere(c > 0.0, fpos, fneg)


def xppm(q, c, iord, dxa, ax: int = -1, tile=None):
    """PPM flux along axis `ax`.  q: padded width IC along ax; c: courant
    at the compute edges [NG, NG+n+1) along ax.  Returns the flux, width
    n+1 along ax.  The face-edge fixes act at the edges of the model's
    `tile` along ax that it owns (both when None: a whole face).

    `iord` may be a per-level blend `(iord_main, iord_sponge, ksp)` with
    ksp a static int: levels [0, ksp) use the sponge scheme (the
    linearization's perturbation sponge override, dyn_core_tlm.F90:
    861-875); the level batch is split so each scheme runs once on its own
    band."""
    if isinstance(iord, tuple):
        main, sponge, ksp = iord
        return torch.cat([xppm(q[:ksp], c[:ksp], sponge, dxa, ax, tile),
                          xppm(q[ksp:], c[ksp:], main, dxa, ax, tile)],
                         dim=0)
    if not 1 <= iord <= 13:
        raise ValueError(f"xppm iord={iord!r}: the schemes are 1-13")
    A = _AXX if ax == -1 else _AXY
    lo, hi = edges(tile, ax)[:2]
    n = A.size(q) - 2 * NG
    if A.size(c) != n + 1:
        raise ValueError(f"courant width {A.size(c)} != {n + 1}")
    e0, e1 = NG, NG + n + 1
    if iord == 1:
        return fwhere(c > 0.0, A.rng(q, e0 - 1, e1 - 1), A.rng(q, e0, e1))
    if iord >= 8:
        bl, br = _bl_br_high(q, dxa, iord, A, lo, hi)
        return _flux_from_blbr(q, c, bl, br, e0, e1, A)
    bl, br = _bl_br_low(q, dxa, iord, A, lo, hi)
    if iord in (2, 7):
        return _flux_from_blbr(q, c, bl, br, e0, e1, A)
    return _flux_selective(q, c, bl, br, iord, e0, e1, A)


def _flux_selective(q, c, bl, br, iord, e0, e1, A: _Ax):
    """The selectively-limited fluxes of iord 3-6 (tp_core_nlm.F90:
    383-455); the smoothness indicators are frozen decisions."""
    b0 = bl + br
    x0 = torch.abs(b0)
    x1 = torch.abs(bl - br)
    if iord in (3, 4):
        smt5 = x0 < x1
        smt6 = 3.0 * x0 < x1
    elif iord == 5:
        smt5 = bl * br < 0.0
    else:  # 6
        smt5 = 3.0 * x0 < x1
    smt5 = fbool(smt5)
    if iord in (3, 4):
        smt6 = fbool(smt6)
    qL = A.rng(q, e0 - 1, e1 - 1)
    qR = A.rng(q, e0, e1)
    blL = A.rng(bl, e0 - 1, e1 - 1)
    brL = A.rng(br, e0 - 1, e1 - 1)
    blR = A.rng(bl, e0, e1)
    brR = A.rng(br, e0, e1)
    b0L = A.rng(b0, e0 - 1, e1 - 1)
    b0R = A.rng(b0, e0, e1)
    smt5L = A.rng(smt5, e0 - 1, e1 - 1)
    smt5R = A.rng(smt5, e0, e1)
    if iord == 3:
        smt6L = A.rng(smt6, e0 - 1, e1 - 1)
        smt6R = A.rng(smt6, e0, e1)
        fx1p = torch.where(
            smt6L | smt5R, brL - c * b0L,
            torch.where(smt5L, fsign_mul(brL, fmin(fabs(blL), fabs(brL))),
                        0.0))
        fx1n = torch.where(
            smt6R | smt5L, blR + c * b0R,
            torch.where(smt5R, fsign_mul(blR, fmin(fabs(blR), fabs(brR))),
                        0.0))
        return fwhere(c > 0.0, qL + (1.0 - c) * fx1p, qR + (1.0 + c) * fx1n)
    if iord == 4:
        smt6L = A.rng(smt6, e0 - 1, e1 - 1)
        smt6R = A.rng(smt6, e0, e1)
        fx1p = torch.where(smt6L | smt5R, (1.0 - c) * (brL - c * b0L), 0.0)
        fx1n = torch.where(smt6R | smt5L, (1.0 + c) * (blR + c * b0R), 0.0)
        return fwhere(c > 0.0, qL + fx1p, qR + fx1n)
    # iord 5, 6
    cpos = fbool(c > 0.0)
    fx1 = torch.where(cpos, (1.0 - c) * (brL - c * b0L),
                      (1.0 + c) * (blR + c * b0R))
    base = torch.where(cpos, qL, qR)
    return base + torch.where(smt5L | smt5R, fx1, 0.0)


def yppm(q, c, jord, dya, tile=None):
    """PPM flux in y: the same operator along axis -2."""
    return xppm(q, c, jord, dya, ax=-2, tile=tile)


def edges(tile, ax):
    """Whether `tile` owns the low and the high face edge along `ax` and
    the low and the high one across it (all of them when None: a whole
    face)."""
    if tile is None:
        return True, True, True, True
    if ax == -1:
        return tile.west, tile.east, tile.south, tile.north
    return tile.south, tile.north, tile.west, tile.east
