"""Lin-Rood C-grid shallow-water operators.

Counterpart of fv3jedi_lm_tpu/ops/sw_core.py (model/sw_core_nlm.F90):
  d2a2c_vect  (:2746)  D -> A -> C wind interpolation with cube-edge fixes
  c_sw        (:77)    C-grid half step
  divergence_corner (:1661), del6_vt_flux (:1547)

Indexing: Fortran index f (1-based, compute domain 1..n) maps to padded
python index f-1+NG for every stagger, in the coordinates of the model's
tile (grid["tile"], the whole face on one process); the edge and corner
fixes act where the tile owns that face edge or cube corner.  Leading
dims (npz, nf) broadcast.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import NG
from ..core.freeze import fbool, fwhere
from ..parallel import halo

A1 = 0.5625
A2 = -0.0625
C1 = -2.0 / 14.0
C2 = 11.0 / 14.0
C3 = 5.0 / 14.0


def F2P(i: int) -> int:
    return i - 1 + NG


def SL(lo: int, hi: int) -> slice:
    """Fortran inclusive index range -> python slice (any stagger)."""
    return slice(F2P(lo), F2P(hi) + 1)


#: static index/sign tensors of the corner copies, keyed by content+device
_IDX_CACHE: dict = {}


def _static(device, dtype, *arrays):
    """Tensors of static index lists (and, with a dtype, one sign list
    last) on `device`, built once."""
    key = (str(device), dtype) + tuple(tuple(a) for a in arrays)
    hit = _IDX_CACHE.get(key)
    if hit is None:
        hit = tuple(
            torch.as_tensor(np.asarray(a, np.int64), device=device)
            for a in (arrays if dtype is None else arrays[:-1]))
        if dtype is not None:
            hit = hit + (torch.as_tensor(np.asarray(arrays[-1], np.float64),
                                         dtype=dtype, device=device),)
        _IDX_CACHE[key] = hit
    return hit


# ----------------------------------------------------------------------
# d2a2c_vect
# ----------------------------------------------------------------------

def _edge_interpolate4(ua4, dxa4):
    """edge_interpolate4: ua4/dxa4 are lists of 4 lines."""
    t1 = dxa4[0] + dxa4[1]
    t2 = dxa4[2] + dxa4[3]
    return 0.5 * (
        ((t1 + dxa4[1]) * ua4[1] - dxa4[1] * ua4[0]) / t1
        + ((t2 + dxa4[2]) * ua4[2] - dxa4[2] * ua4[3]) / t2
    )


def _corner_put(dst, src, upd):
    """dst with dst[..., t] = sign * src[..., s] for every (t, s, sign) in
    upd (no source aliases a target)."""
    if not upd:
        return dst
    p = F2P
    tj, ti, sj, si, sg = _static(
        dst.device, dst.dtype,
        [p(t[0]) for t, _, _ in upd], [p(t[1]) for t, _, _ in upd],
        [p(s[0]) for _, s, _ in upd], [p(s[1]) for _, s, _ in upd],
        [s for _, _, s in upd])
    out = dst.clone()
    out[..., tj, ti] = sg * src[..., sj, si]
    return out


def tile_of(grid, npx):
    """The model's tile (grid["tile"]) of faces of npx - 1 cells, with its
    B extents X = nx + 1, Y = ny + 1: where a tile owns a face edge, the
    edge is its B line 1 or X (Y), as the face's is 1 or npx."""
    T = grid["tile"]
    if T.n != npx - 1:
        raise ValueError(f"a tile of faces of {T.n} cells at npx={npx}")
    return T, T.nx + 1, T.ny + 1


def cells(grid):
    """The index of the tile's compute cells in a padded (..., jy, jx)
    field."""
    T = grid["tile"]
    return (Ellipsis, SL(1, T.ny), SL(1, T.nx))


def _corners(T, groups):
    """The entries of `groups` ({"sw"|"se"|"ne"|"nw": [...]}) at the cube
    corners the tile owns, in sw, se, ne, nw order."""
    own = {"sw": T.south and T.west, "se": T.south and T.east,
           "ne": T.north and T.east, "nw": T.north and T.west}
    return [e for k in ("sw", "se", "ne", "nw") if own[k] for e in groups[k]]


def face_span(T, axis, lo, hi, lo_free, hi_free):
    """The face's padded index range [F2P(lo), F2P(hi)] (Fortran indices
    of the face, inclusive) along `axis` ("y" or "x") in the tile's padded
    coordinates, cut to [lo_free, hi_free]: a stencil bounded by the face's
    edges (npt..npx-npt, 3..npy-2) covers the same cells of the face on
    every tile."""
    off = T.j0 if axis == "y" else T.i0
    return slice(max(F2P(lo) - off, lo_free), min(F2P(hi) - off, hi_free) + 1)


def d2a2c_vect(u, v, grid, npx):
    """Returns (ua, va, uc, vc, ut, vt).  dord4 assumed True (c_sw call)."""
    T, X, Y = tile_of(grid, npx)
    jcy, jcx = u.shape[-2] - 1, u.shape[-1]
    p = F2P
    sin_sg = grid["sin_sg"]
    cosa_u = grid["cosa_u"]
    cosa_v = grid["cosa_v"]
    cosa_s = grid["cosa_s"]
    rsin_u = grid["rsin_u"]
    rsin_v = grid["rsin_v"]
    rsin2 = grid["rsin2"]
    dxa = grid["dxa"]
    dya = grid["dya"]
    npt = 4

    # ---- A-grid midpoint winds: 4th order in the interior, 2nd order
    # within npt cells of a face edge (sw_core_nlm.F90:2846-2898) ----
    utmp = 0.5 * (u[..., 0:jcy, :] + u[..., 1:jcy + 1, :])
    vtmp = 0.5 * (v[..., :, 0:jcx] + v[..., :, 1:jcx + 1])
    # the face's Fortran npt..npx-npt
    npx_f = T.n + 1
    b4y = face_span(T, "y", npt, npx_f - npt, 1, jcy - 2)
    b4x = face_span(T, "x", npt, npx_f - npt, 0, jcx - 1)
    utmp[..., b4y, b4x] = (A2 * (u[..., 0:jcy - 2, :] + u[..., 3:jcy + 1, :])
                           + A1 * (u[..., 1:jcy - 1, :] + u[..., 2:jcy, :])
                           )[..., b4y.start - 1:b4y.stop - 1, b4x]
    b4y = face_span(T, "y", npt, npx_f - npt, 0, jcy - 1)
    b4x = face_span(T, "x", npt, npx_f - npt, 1, jcx - 2)
    vtmp[..., b4y, b4x] = (A2 * (v[..., :, 0:jcx - 2] + v[..., :, 3:jcx + 1])
                           + A1 * (v[..., :, 1:jcx - 1] + v[..., :, 2:jcx])
                           )[..., b4y, b4x.start - 1:b4x.stop - 1]

    # ---- contravariant cell-center winds ----
    ua = (utmp - vtmp * cosa_s) * rsin2
    va = (vtmp - utmp * cosa_s) * rsin2

    # ---- utmp corner fixes, X-dir (sw_core_nlm.F90:2906-2926) ----
    je = T.ny
    utmp = _corner_put(utmp, vtmp, _corners(T, dict(
        sw=[((0, i), (1 - i, 0), -1.0) for i in (-2, -1, 0)],
        nw=[((Y, i), (je + i, 0), 1.0) for i in (-2, -1, 0)],
        se=[((0, X + i), (i + 1, X), 1.0) for i in (0, 1, 2)],
        ne=[((Y, X + i), (je - i, X), -1.0) for i in (0, 1, 2)])))

    # ---- uc interior 4th order (sw_core_nlm.F90:2936-2944) ----
    uc = u.new_zeros(u.shape[:-2] + (jcy, jcx + 1))
    uc[..., :, 2:jcx - 1] = (A2 * (utmp[..., :, 0:jcx - 3]
                                   + utmp[..., :, 3:jcx])
                             + A1 * (utmp[..., :, 1:jcx - 2]
                                     + utmp[..., :, 2:jcx - 1]))

    # ---- ua corner fixes, X-dir (sw_core_nlm.F90:2946-2962) ----
    ua = _corner_put(ua, va, _corners(T, dict(
        sw=[((0, -1), (2, 0), -1.0), ((0, 0), (1, 0), -1.0)],
        se=[((0, X), (1, X), 1.0), ((0, X + 1), (2, X), 1.0)],
        ne=[((Y, X), (Y - 1, X), -1.0), ((Y, X + 1), (Y - 2, X), -1.0)],
        nw=[((Y, -1), (Y - 2, 0), 1.0), ((Y, 0), (Y - 1, 0), 1.0)])))

    # ---- west/east edge columns of uc/ut (sw_core_nlm.F90:2964-3000) ----
    def col(x, i):
        return x[..., :, p(i)]

    def x_edge_cols(edge_i):
        if edge_i == 1:
            ucm1 = C1 * col(utmp, -2) + C2 * col(utmp, -1) + C3 * col(utmp, 0)
            ucp1 = C1 * col(utmp, 3) + C2 * col(utmp, 2) + C3 * col(utmp, 1)
            cols = (-1, 0, 1, 2)
            sg3 = sin_sg[2][..., :, p(0)]
            sg1 = sin_sg[0][..., :, p(1)]
        else:
            ucm1 = (C1 * col(utmp, X - 3) + C2 * col(utmp, X - 2)
                    + C3 * col(utmp, X - 1))
            ucp1 = (C3 * col(utmp, X) + C2 * col(utmp, X + 1)
                    + C1 * col(utmp, X + 2))
            cols = (X - 2, X - 1, X, X + 1)
            sg3 = sin_sg[2][..., :, p(X - 1)]
            sg1 = sin_sg[0][..., :, p(X)]
        ute = _edge_interpolate4([col(ua, c) for c in cols],
                                 [col(dxa, c) for c in cols])
        uce = fwhere(ute > 0.0, ute * sg3, ute * sg1)
        return p(edge_i), ucm1, uce, ucp1, ute

    x_edges = ([x_edge_cols(1)] if T.west else []) + (
        [x_edge_cols(X)] if T.east else [])
    for ei, ucm1, uce, ucp1, _ in x_edges:
        uc[..., :, ei - 1] = ucm1
        uc[..., :, ei] = uce
        uc[..., :, ei + 1] = ucp1
    ut = (uc - v * cosa_u) * rsin_u
    for ei, _, _, _, ute in x_edges:
        ut[..., :, ei] = ute

    # ---- vtmp corner fixes, Y-dir (sw_core_nlm.F90:3004-3024) ----
    ie = T.nx
    vtmp = _corner_put(vtmp, utmp, _corners(T, dict(
        sw=[((j, 0), (0, 1 - j), -1.0) for j in (-2, -1, 0)],
        se=[((j, X), (0, ie + j), 1.0) for j in (-2, -1, 0)],
        nw=[((Y + j, 0), (Y, j + 1), 1.0) for j in (0, 1, 2)],
        ne=[((Y + j, X), (Y, ie - j), -1.0) for j in (0, 1, 2)])))
    va = _corner_put(va, ua, _corners(T, dict(
        sw=[((-1, 0), (0, 2), -1.0), ((0, 0), (0, 1), -1.0)],
        se=[((0, X), (0, X - 1), 1.0), ((-1, X), (0, X - 2), 1.0)],
        ne=[((Y, X), (Y, X - 1), -1.0), ((Y + 1, X), (Y, X - 2), -1.0)],
        nw=[((Y, 0), (Y, 1), 1.0), ((Y + 1, 0), (Y, 2), 1.0)])))

    # ---- vc: interior + edge rows (sw_core_nlm.F90:3026-3058) ----
    vc = v.new_zeros(v.shape[:-2] + (jcy + 1, jcx))
    vc[..., 2:jcy - 1, :] = (A2 * (vtmp[..., 0:jcy - 3, :]
                                   + vtmp[..., 3:jcy, :])
                             + A1 * (vtmp[..., 1:jcy - 2, :]
                                     + vtmp[..., 2:jcy - 1, :]))

    def row(x, j):
        return x[..., p(j), :]

    def y_edge_rows(edge_j):
        if edge_j == 1:
            vcm1 = C1 * row(vtmp, -2) + C2 * row(vtmp, -1) + C3 * row(vtmp, 0)
            vcp1 = C1 * row(vtmp, 3) + C2 * row(vtmp, 2) + C3 * row(vtmp, 1)
            rows = (-1, 0, 1, 2)
            sg4 = sin_sg[3][..., p(0), :]
            sg2 = sin_sg[1][..., p(1), :]
        else:
            vcm1 = (C1 * row(vtmp, Y - 3) + C2 * row(vtmp, Y - 2)
                    + C3 * row(vtmp, Y - 1))
            vcp1 = (C3 * row(vtmp, Y) + C2 * row(vtmp, Y + 1)
                    + C1 * row(vtmp, Y + 2))
            rows = (Y - 2, Y - 1, Y, Y + 1)
            sg4 = sin_sg[3][..., p(Y - 1), :]
            sg2 = sin_sg[1][..., p(Y), :]
        vte = _edge_interpolate4([row(va, r) for r in rows],
                                 [row(dya, r) for r in rows])
        vce = fwhere(vte > 0.0, vte * sg4, vte * sg2)
        return p(edge_j), vcm1, vce, vcp1, vte

    y_edges = ([y_edge_rows(1)] if T.south else []) + (
        [y_edge_rows(Y)] if T.north else [])
    for ej, vcm1, vce, vcp1, _ in y_edges:
        vc[..., ej - 1, :] = vcm1
        vc[..., ej, :] = vce
        vc[..., ej + 1, :] = vcp1
    vt = (vc - u * cosa_v) * rsin_v
    for ej, _, _, _, vte in y_edges:
        vt[..., ej, :] = vte

    return ua, va, uc, vc, ut, vt


# ----------------------------------------------------------------------
# scalar corner fills used inside c_sw (sw_core_nlm.F90:3186-3297)
# ----------------------------------------------------------------------

def _f4c_upd(dir_, X, Y):
    """The (target (i, j), source (i, j)) copies of fill_4corners at each
    cube corner, X and Y the B extents of the tile."""
    if dir_ == 1:
        return dict(
            sw=[((-1, 0), (0, 2)), ((0, 0), (0, 1))],
            se=[((X + 1, 0), (X, 2)), ((X, 0), (X, 1))],
            nw=[((0, Y), (0, Y - 1)), ((-1, Y), (0, Y - 2))],
            ne=[((X, Y), (X, Y - 1)), ((X + 1, Y), (X, Y - 2))])
    return dict(
        sw=[((0, 0), (1, 0)), ((0, -1), (2, 0))],
        se=[((X, 0), (X - 1, 0)), ((X, -1), (X - 2, 0))],
        nw=[((0, Y), (1, Y)), ((0, Y + 1), (2, Y))],
        ne=[((X, Y), (X - 1, Y)), ((X, Y + 1), (X - 2, Y))])


def fill_4corners(q, dir_, T):
    """fill_4corners for a center scalar (2-deep), sw_core_nlm.F90:3232+,
    at the cube corners the tile `T` owns.  No source aliases a target,
    so one gather and one scatter equal the reference's sequential
    order."""
    upd = _corners(T, _f4c_upd(dir_, T.nx + 1, T.ny + 1))
    if not upd:
        return q
    p = F2P
    tj, ti, sj, si = _static(
        q.device, None,
        [p(t[1]) for t, _ in upd], [p(t[0]) for t, _ in upd],
        [p(s[1]) for _, s in upd], [p(s[0]) for _, s in upd])
    out = q.clone()
    out[..., tj, ti] = q[..., sj, si]
    return out


# ----------------------------------------------------------------------
# divergence_corner (sw_core_nlm.F90:1661-1768)
# ----------------------------------------------------------------------

def divergence_corner(u, v, ua, va, grid, npx):
    """B-grid divergence of the D-grid wind; returns divg_d (..., jb, jb)."""
    T, X, Y = tile_of(grid, npx)
    jcy, jcx = ua.shape[-2:]
    jby, jbx = jcy + 1, jcx + 1
    p = F2P
    sin_sg = grid["sin_sg"]
    cos_sg = grid["cos_sg"]
    dxc = grid["dxc"]
    dyc = grid["dyc"]
    rarea_c = grid["rarea_c"]

    uf = u.new_zeros(u.shape)
    uf[..., 1:jby - 1, :] = (
        u[..., 1:jby - 1, :]
        - 0.25 * (va[..., 0:jcy - 1, :] + va[..., 1:jcy, :])
        * (cos_sg[3][..., 0:jcy - 1, :] + cos_sg[1][..., 1:jcy, :])
    ) * dyc[..., 1:jby - 1, :] * 0.5 * (
        sin_sg[3][..., 0:jcy - 1, :] + sin_sg[1][..., 1:jcy, :])
    for jf in [1] * T.south + [Y] * T.north:
        jj = p(jf)
        uf[..., jj, :] = (u[..., jj, :] * dyc[..., jj, :] * 0.5
                          * (sin_sg[3][..., jj - 1, :] + sin_sg[1][..., jj, :]))

    vf = v.new_zeros(v.shape)
    vf[..., :, 1:jbx - 1] = (
        v[..., :, 1:jbx - 1]
        - 0.25 * (ua[..., :, 0:jcx - 1] + ua[..., :, 1:jcx])
        * (cos_sg[2][..., :, 0:jcx - 1] + cos_sg[0][..., :, 1:jcx])
    ) * dxc[..., :, 1:jbx - 1] * 0.5 * (
        sin_sg[2][..., :, 0:jcx - 1] + sin_sg[0][..., :, 1:jcx])
    for if_ in [1] * T.west + [X] * T.east:
        ii = p(if_)
        vf[..., :, ii] = (v[..., :, ii] * dxc[..., :, ii] * 0.5
                          * (sin_sg[2][..., :, ii - 1] + sin_sg[0][..., :, ii]))

    divg = u.new_zeros(u.shape[:-2] + (jby, jbx))
    divg[..., 1:jcy, 1:jcx] = ((vf[..., 0:jcy - 1, 1:jcx]
                                - vf[..., 1:jcy, 1:jcx])
                               + (uf[..., 1:jcy, 0:jcx - 1]
                                  - uf[..., 1:jcy, 1:jcx]))
    # corner B points: the 3 valid terms set directly
    if T.south and T.west:
        divg[..., p(1), p(1)] = (-vf[..., p(1), p(1)] + uf[..., p(1), p(0)]
                                 - uf[..., p(1), p(1)])
    if T.south and T.east:
        divg[..., p(1), p(X)] = (-vf[..., p(1), p(X)]
                                 + uf[..., p(1), p(X - 1)]
                                 - uf[..., p(1), p(X)])
    if T.north and T.east:
        divg[..., p(Y), p(X)] = (vf[..., p(Y - 1), p(X)]
                                 + uf[..., p(Y), p(X - 1)]
                                 - uf[..., p(Y), p(X)])
    if T.north and T.west:
        divg[..., p(Y), p(1)] = (vf[..., p(Y - 1), p(1)]
                                 + uf[..., p(Y), p(0)] - uf[..., p(Y), p(1)])
    return rarea_c * divg


# ----------------------------------------------------------------------
# del6_vt_flux (sw_core_nlm.F90:1547-1658)
# ----------------------------------------------------------------------

def del6_vt_flux(nord, damp, q, grid, topo):
    """Returns (d2, fx2, fy2): damped field + diffusive fluxes (full width)."""
    del6_u = grid["del6_u"]
    del6_v = grid["del6_v"]
    rarea = grid["rarea"]
    jcy, jcx = q.shape[-2:]

    d2 = damp * q
    if nord > 0:
        d2 = halo.copy_corners(d2, topo, 1)
    fx2 = q.new_zeros(q.shape[:-1] + (jcx + 1,))
    fx2[..., 1:jcx] = del6_v[..., 1:jcx] * (d2[..., 0:jcx - 1] - d2[..., 1:jcx])
    if nord > 0:
        d2 = halo.copy_corners(d2, topo, 2)
    fy2 = q.new_zeros(q.shape[:-2] + (jcy + 1,) + q.shape[-1:])
    fy2[..., 1:jcy, :] = del6_u[..., 1:jcy, :] * (d2[..., 0:jcy - 1, :]
                                                   - d2[..., 1:jcy, :])

    for _ in range(nord):
        d2 = (fx2[..., :, 0:jcx] - fx2[..., :, 1:jcx + 1]
              + fy2[..., 0:jcy, :] - fy2[..., 1:jcy + 1, :]) * rarea
        d2 = halo.copy_corners(d2, topo, 1)
        fx2[..., 1:jcx] = del6_v[..., 1:jcx] * (d2[..., 1:jcx]
                                                - d2[..., 0:jcx - 1])
        d2 = halo.copy_corners(d2, topo, 2)
        fy2[..., 1:jcy, :] = del6_u[..., 1:jcy, :] * (d2[..., 1:jcy, :]
                                                       - d2[..., 0:jcy - 1, :])
    return d2, fx2, fy2


# ----------------------------------------------------------------------
# c_sw: C-grid Lin-Rood half step (sw_core_nlm.F90:77-489)
# ----------------------------------------------------------------------

def c_sw(delp, pt, u, v, w, uc, vc, grid, dt2, nord, npx, hydrostatic=False):
    """C-grid half-step on halo-filled padded fields.  uc/vc are replaced
    by d2a2c_vect's winds (as in the reference).  Returns
    (delpc, ptc, wc, uc_new, vc_new, divg_d, ua, va, ut, vt); hydrostatic,
    w is not transported and wc is zero."""
    T, X, Y = tile_of(grid, npx)
    ny, nx = T.ny, T.nx
    jcy, jcx = delp.shape[-2:]
    p = F2P

    dy = grid["dy"]
    dx = grid["dx"]
    dxc = grid["dxc"]
    dyc = grid["dyc"]
    sin_sg = grid["sin_sg"]
    cos_sg = grid["cos_sg"]
    cosa_u = grid["cosa_u"]
    cosa_v = grid["cosa_v"]
    sina_u = grid["sina_u"]
    sina_v = grid["sina_v"]
    rarea = grid["rarea"]
    rarea_c = grid["rarea_c"]
    rdxc = grid["rdxc"]
    rdyc = grid["rdyc"]
    fC = grid["fC"]

    ua, va, uc, vc, ut, vt = d2a2c_vect(u, v, grid, npx)

    if nord > 0:
        divg_d = divergence_corner(u, v, ua, va, grid, npx)
    else:
        divg_d = u.new_zeros(u.shape[:-2] + (jcy + 1, jcx + 1))

    # ---- courant-like transport winds (sw_core_nlm.F90:160-180) ----
    ut_s = torch.zeros_like(ut)
    sel = fbool(ut[..., :, 1:jcx] > 0.0)
    ut_s[..., :, 1:jcx] = (dt2 * ut[..., :, 1:jcx] * dy[..., :, 1:jcx]
                           * torch.where(sel, sin_sg[2][..., :, 0:jcx - 1],
                                         sin_sg[0][..., :, 1:jcx]))
    vt_s = torch.zeros_like(vt)
    selv = fbool(vt[..., 1:jcy, :] > 0.0)
    vt_s[..., 1:jcy, :] = (dt2 * vt[..., 1:jcy, :] * dx[..., 1:jcy, :]
                           * torch.where(selv, sin_sg[3][..., 0:jcy - 1, :],
                                         sin_sg[1][..., 1:jcy, :]))
    ut = ut_s
    vt = vt_s

    # ---- transport delp / pt / w (sw_core_nlm.F90:182-284) ----
    delp_x = fill_4corners(delp, 1, T)
    pt_x = fill_4corners(pt, 1, T)
    selx = fbool(ut[..., :, 1:jcx] > 0.0)

    def upx(f):
        return torch.where(selx, f[..., :, 0:jcx - 1], f[..., :, 1:jcx])

    fx1 = torch.zeros_like(ut)
    fx1[..., :, 1:jcx] = ut[..., :, 1:jcx] * upx(delp_x)
    fx = torch.zeros_like(ut)
    fx[..., :, 1:jcx] = fx1[..., :, 1:jcx] * upx(pt_x)
    if not hydrostatic:
        fx2 = torch.zeros_like(ut)
        fx2[..., :, 1:jcx] = fx1[..., :, 1:jcx] * upx(fill_4corners(w, 1, T))

    delp_y = fill_4corners(delp, 2, T)
    pt_y = fill_4corners(pt, 2, T)
    sely = fbool(vt[..., 1:jcy, :] > 0.0)

    def upy(f):
        return torch.where(sely, f[..., 0:jcy - 1, :], f[..., 1:jcy, :])

    fy1 = torch.zeros_like(vt)
    fy1[..., 1:jcy, :] = vt[..., 1:jcy, :] * upy(delp_y)
    fy = torch.zeros_like(vt)
    fy[..., 1:jcy, :] = fy1[..., 1:jcy, :] * upy(pt_y)
    if not hydrostatic:
        fy2 = torch.zeros_like(vt)
        fy2[..., 1:jcy, :] = fy1[..., 1:jcy, :] * upy(fill_4corners(w, 2, T))

    # cell updates over [is-1, ie+1] x [js-1, je+1] = cells 0..n+1
    csy = slice(p(0), p(ny + 1) + 1)
    csx = slice(p(0), p(nx + 1) + 1)
    esy = slice(p(0), p(ny + 2) + 1)
    esx = slice(p(0), p(nx + 2) + 1)

    def div(gx, gy):
        return (gx[..., csy, esx][..., :, :-1] - gx[..., csy, esx][..., :, 1:]
                + gy[..., esy, csx][..., :-1, :] - gy[..., esy, csx][..., 1:, :]
                ) * rarea[..., csy, csx]

    div1 = div(fx1, fy1)
    divt = div(fx, fy)
    delpc = torch.zeros_like(delp)
    delpc_i = delp[..., csy, csx] + div1
    delpc[..., csy, csx] = delpc_i
    ptc = torch.zeros_like(pt)
    ptc[..., csy, csx] = (pt[..., csy, csx] * delp[..., csy, csx]
                          + divt) / delpc_i
    wc = torch.zeros_like(w)
    if not hydrostatic:
        wc[..., csy, csx] = (w[..., csy, csx] * delp[..., csy, csx]
                             + div(fx2, fy2)) / delpc_i

    # ---- kinetic energy (sw_core_nlm.F90:286-365), cells 0..n+1 ----
    ke_pos = uc[..., csy, p(0):p(nx + 1) + 1].clone()   # uc(i,j)
    ke_neg = uc[..., csy, p(1):p(nx + 2) + 1].clone()   # uc(i+1,j)
    if T.west:
        v_1 = v[..., csy, p(1)]
        uc_1 = uc[..., csy, p(1)]
        ke_pos[..., :, 1] = (uc_1 * sin_sg[0][..., csy, p(1)]
                             + v_1 * cos_sg[0][..., csy, p(1)])
        ke_neg[..., :, 0] = (uc_1 * sin_sg[2][..., csy, p(0)]
                             + v_1 * cos_sg[2][..., csy, p(0)])
    if T.east:
        v_n = v[..., csy, p(X)]
        uc_n = uc[..., csy, p(X)]
        ke_pos[..., :, X] = (uc_n * sin_sg[0][..., csy, p(X)]
                             + v_n * cos_sg[0][..., csy, p(X)])
        ke_neg[..., :, X - 1] = (uc_n * sin_sg[2][..., csy, p(X - 1)]
                                 + v_n * cos_sg[2][..., csy, p(X - 1)])
    ke_x = fwhere(ua[..., csy, csx] > 0.0, ke_pos, ke_neg)

    vo_pos = vc[..., p(0):p(ny + 1) + 1, csx].clone()
    vo_neg = vc[..., p(1):p(ny + 2) + 1, csx].clone()
    if T.south:
        u_1 = u[..., p(1), csx]
        vc_1 = vc[..., p(1), csx]
        vo_pos[..., 1, :] = (vc_1 * sin_sg[1][..., p(1), csx]
                             + u_1 * cos_sg[1][..., p(1), csx])
        vo_neg[..., 0, :] = (vc_1 * sin_sg[3][..., p(0), csx]
                             + u_1 * cos_sg[3][..., p(0), csx])
    if T.north:
        u_n = u[..., p(Y), csx]
        vc_n = vc[..., p(Y), csx]
        vo_pos[..., Y, :] = (vc_n * sin_sg[1][..., p(Y), csx]
                             + u_n * cos_sg[1][..., p(Y), csx])
        vo_neg[..., Y - 1, :] = (vc_n * sin_sg[3][..., p(Y - 1), csx]
                                 + u_n * cos_sg[3][..., p(Y - 1), csx])
    ke_y = fwhere(va[..., csy, csx] > 0.0, vo_pos, vo_neg)

    dt4 = 0.5 * dt2
    ke = torch.zeros_like(delp)
    ke[..., csy, csx] = dt4 * (ua[..., csy, csx] * ke_x
                               + va[..., csy, csx] * ke_y)

    # ---- circulation -> absolute vorticity on B grid (:367-400) ----
    fxc = uc * dxc
    fyc = vc * dyc
    bsy = slice(p(1), p(Y) + 1)
    bsx = slice(p(1), p(X) + 1)
    vort_c = (fxc[..., p(0):p(Y - 1) + 1, bsx] - fxc[..., p(1):p(Y) + 1, bsx]
              + fyc[..., bsy, p(1):p(X) + 1]
              - fyc[..., bsy, p(0):p(X - 1) + 1])
    # 3-term corner circulation, set directly
    if T.south and T.west:
        vort_c[..., 0, 0] = (fxc[..., p(0), p(1)] - fxc[..., p(1), p(1)]
                             + fyc[..., p(1), p(1)])
    if T.south and T.east:
        vort_c[..., 0, X - 1] = (fxc[..., p(0), p(X)] - fxc[..., p(1), p(X)]
                                 - fyc[..., p(1), p(X - 1)])
    if T.north and T.east:
        vort_c[..., Y - 1, X - 1] = (fxc[..., p(Y - 1), p(X)]
                                     - fxc[..., p(Y), p(X)]
                                     - fyc[..., p(Y), p(X - 1)])
    if T.north and T.west:
        vort_c[..., Y - 1, 0] = (fxc[..., p(Y - 1), p(1)]
                                 - fxc[..., p(Y), p(1)]
                                 + fyc[..., p(Y), p(1)])
    vort_b = fC[..., bsy, bsx] + rarea_c[..., bsy, bsx] * vort_c

    # ---- vorticity transport & wind update (:402-489) ----
    rsy = slice(p(1), p(ny) + 1)
    rsx = slice(p(1), p(nx) + 1)
    fy1 = dt2 * (v[..., rsy, bsx] - uc[..., rsy, bsx] * cosa_u[..., rsy, bsx]
                 ) / sina_u[..., rsy, bsx]
    if T.west:
        fy1[..., :, 0] = dt2 * v[..., rsy, p(1)]
    if T.east:
        fy1[..., :, X - 1] = dt2 * v[..., rsy, p(X)]
    fyv = fwhere(fy1 > 0.0, vort_b[..., 0:ny, :], vort_b[..., 1:ny + 1, :])

    fx1v = dt2 * (u[..., bsy, rsx] - vc[..., bsy, rsx] * cosa_v[..., bsy, rsx]
                  ) / sina_v[..., bsy, rsx]
    if T.south:
        fx1v[..., 0, :] = dt2 * u[..., p(1), rsx]
    if T.north:
        fx1v[..., Y - 1, :] = dt2 * u[..., p(Y), rsx]
    fxv = fwhere(fx1v > 0.0, vort_b[..., :, 0:nx], vort_b[..., :, 1:nx + 1])

    uc_new = uc.clone()
    uc_new[..., rsy, bsx] += (fy1 * fyv + rdxc[..., rsy, bsx]
                              * (ke[..., rsy, p(0):p(nx) + 1]
                                 - ke[..., rsy, p(1):p(X) + 1]))
    vc_new = vc.clone()
    vc_new[..., bsy, rsx] += (-fx1v * fxv + rdyc[..., bsy, rsx]
                              * (ke[..., p(0):p(ny) + 1, rsx]
                                 - ke[..., p(1):p(Y) + 1, rsx]))

    # ut/vt: the dt2-scaled C-grid transport winds (area-flux form), which
    # the NH update_dz_c consumes
    return delpc, ptc, wc, uc_new, vc_new, divg_d, ua, va, ut, vt
