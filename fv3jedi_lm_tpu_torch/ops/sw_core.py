"""Lin-Rood C-grid shallow-water operators.

Counterpart of fv3jedi_lm_tpu/ops/sw_core.py (model/sw_core_nlm.F90):
  d2a2c_vect  (:2746)  D -> A -> C wind interpolation with cube-edge fixes
  c_sw        (:77)    C-grid half step
  divergence_corner (:1661), del6_vt_flux (:1547)

Indexing: Fortran index f (1-based, compute domain 1..n) maps to padded
python index f-1+NG for every stagger.  Leading dims (npz, 6) broadcast.
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
    p = F2P
    tj, ti, sj, si, sg = _static(
        dst.device, dst.dtype,
        [p(t[0]) for t, _, _ in upd], [p(t[1]) for t, _, _ in upd],
        [p(s[0]) for _, s, _ in upd], [p(s[1]) for _, s, _ in upd],
        [s for _, _, s in upd])
    out = dst.clone()
    out[..., tj, ti] = sg * src[..., sj, si]
    return out


def d2a2c_vect(u, v, grid, npx):
    """Returns (ua, va, uc, vc, ut, vt).  dord4 assumed True (c_sw call)."""
    n = npx - 1
    npy = npx
    jc = n + 2 * NG
    jb = jc + 1
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
    utmp = 0.5 * (u[..., 0:jc, :] + u[..., 1:jc + 1, :])
    vtmp = 0.5 * (v[..., :, 0:jc] + v[..., :, 1:jc + 1])
    b4 = slice(npt - 1 + NG, npx - npt - 1 + NG + 1)   # Fortran npt..npx-npt
    utmp[..., b4, b4] = (A2 * (u[..., 0:jc - 2, :] + u[..., 3:jc + 1, :])
                         + A1 * (u[..., 1:jc - 1, :] + u[..., 2:jc, :])
                         )[..., b4.start - 1:b4.stop - 1, b4]
    vtmp[..., b4, b4] = (A2 * (v[..., :, 0:jc - 2] + v[..., :, 3:jc + 1])
                         + A1 * (v[..., :, 1:jc - 1] + v[..., :, 2:jc])
                         )[..., b4, b4.start - 1:b4.stop - 1]

    # ---- contravariant cell-center winds ----
    ua = (utmp - vtmp * cosa_s) * rsin2
    va = (vtmp - utmp * cosa_s) * rsin2

    # ---- utmp corner fixes, X-dir (sw_core_nlm.F90:2906-2926) ----
    je = n
    utmp = _corner_put(utmp, vtmp, [
        ((0, i), (1 - i, 0), -1.0) for i in (-2, -1, 0)] + [
        ((npy, i), (je + i, 0), 1.0) for i in (-2, -1, 0)] + [
        ((0, npx + i), (i + 1, npx), 1.0) for i in (0, 1, 2)] + [
        ((npy, npx + i), (je - i, npx), -1.0) for i in (0, 1, 2)])

    # ---- uc interior 4th order (sw_core_nlm.F90:2936-2944) ----
    uc = u.new_zeros(u.shape[:-2] + (jc, jb))
    uc[..., :, 2:jc - 1] = (A2 * (utmp[..., :, 0:jc - 3] + utmp[..., :, 3:jc])
                            + A1 * (utmp[..., :, 1:jc - 2]
                                    + utmp[..., :, 2:jc - 1]))

    # ---- ua corner fixes, X-dir (sw_core_nlm.F90:2946-2962) ----
    ua = _corner_put(ua, va, [
        ((0, -1), (2, 0), -1.0), ((0, 0), (1, 0), -1.0),
        ((0, npx), (1, npx), 1.0), ((0, npx + 1), (2, npx), 1.0),
        ((npy, npx), (npy - 1, npx), -1.0),
        ((npy, npx + 1), (npy - 2, npx), -1.0),
        ((npy, -1), (npy - 2, 0), 1.0), ((npy, 0), (npy - 1, 0), 1.0)])

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
            ucm1 = (C1 * col(utmp, npx - 3) + C2 * col(utmp, npx - 2)
                    + C3 * col(utmp, npx - 1))
            ucp1 = (C3 * col(utmp, npx) + C2 * col(utmp, npx + 1)
                    + C1 * col(utmp, npx + 2))
            cols = (npx - 2, npx - 1, npx, npx + 1)
            sg3 = sin_sg[2][..., :, p(npx - 1)]
            sg1 = sin_sg[0][..., :, p(npx)]
        ute = _edge_interpolate4([col(ua, c) for c in cols],
                                 [col(dxa, c) for c in cols])
        uce = fwhere(ute > 0.0, ute * sg3, ute * sg1)
        return p(edge_i), ucm1, uce, ucp1, ute

    x_edges = [x_edge_cols(1), x_edge_cols(npx)]
    for ei, ucm1, uce, ucp1, _ in x_edges:
        uc[..., :, ei - 1] = ucm1
        uc[..., :, ei] = uce
        uc[..., :, ei + 1] = ucp1
    ut = (uc - v * cosa_u) * rsin_u
    for ei, _, _, _, ute in x_edges:
        ut[..., :, ei] = ute

    # ---- vtmp corner fixes, Y-dir (sw_core_nlm.F90:3004-3024) ----
    ie = n
    vtmp = _corner_put(vtmp, utmp, [
        ((j, 0), (0, 1 - j), -1.0) for j in (-2, -1, 0)] + [
        ((j, npx), (0, ie + j), 1.0) for j in (-2, -1, 0)] + [
        ((npy + j, 0), (npy, j + 1), 1.0) for j in (0, 1, 2)] + [
        ((npy + j, npx), (npy, ie - j), -1.0) for j in (0, 1, 2)])
    va = _corner_put(va, ua, [
        ((-1, 0), (0, 2), -1.0), ((0, 0), (0, 1), -1.0),
        ((0, npx), (0, npx - 1), 1.0), ((-1, npx), (0, npx - 2), 1.0),
        ((npy, npx), (npy, npx - 1), -1.0),
        ((npy + 1, npx), (npy, npx - 2), -1.0),
        ((npy, 0), (npy, 1), 1.0), ((npy + 1, 0), (npy, 2), 1.0)])

    # ---- vc: interior + edge rows (sw_core_nlm.F90:3026-3058) ----
    vc = v.new_zeros(v.shape[:-2] + (jb, jc))
    vc[..., 2:jc - 1, :] = (A2 * (vtmp[..., 0:jc - 3, :] + vtmp[..., 3:jc, :])
                            + A1 * (vtmp[..., 1:jc - 2, :]
                                    + vtmp[..., 2:jc - 1, :]))

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
            vcm1 = (C1 * row(vtmp, npy - 3) + C2 * row(vtmp, npy - 2)
                    + C3 * row(vtmp, npy - 1))
            vcp1 = (C3 * row(vtmp, npy) + C2 * row(vtmp, npy + 1)
                    + C1 * row(vtmp, npy + 2))
            rows = (npy - 2, npy - 1, npy, npy + 1)
            sg4 = sin_sg[3][..., p(npy - 1), :]
            sg2 = sin_sg[1][..., p(npy), :]
        vte = _edge_interpolate4([row(va, r) for r in rows],
                                 [row(dya, r) for r in rows])
        vce = fwhere(vte > 0.0, vte * sg4, vte * sg2)
        return p(edge_j), vcm1, vce, vcp1, vte

    y_edges = [y_edge_rows(1), y_edge_rows(npy)]
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

def _f4c_upd(dir_, npx):
    npy = npx
    if dir_ == 1:
        return [
            ((-1, 0), (0, 2)), ((0, 0), (0, 1)),
            ((npx + 1, 0), (npx, 2)), ((npx, 0), (npx, 1)),
            ((0, npy), (0, npy - 1)), ((-1, npy), (0, npy - 2)),
            ((npx, npy), (npx, npy - 1)), ((npx + 1, npy), (npx, npy - 2)),
        ]
    return [
        ((0, 0), (1, 0)), ((0, -1), (2, 0)),
        ((npx, 0), (npx - 1, 0)), ((npx, -1), (npx - 2, 0)),
        ((0, npy), (1, npy)), ((0, npy + 1), (2, npy)),
        ((npx, npy), (npx - 1, npy)), ((npx, npy + 1), (npx - 2, npy)),
    ]


def fill_4corners(q, dir_, npx):
    """fill_4corners for a center scalar (2-deep), sw_core_nlm.F90:3232+.
    No source aliases a target, so one gather and one scatter equal the
    reference's sequential order."""
    p = F2P
    upd = _f4c_upd(dir_, npx)
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
    n = npx - 1
    npy = npx
    jc = n + 2 * NG
    jb = jc + 1
    p = F2P
    sin_sg = grid["sin_sg"]
    cos_sg = grid["cos_sg"]
    dxc = grid["dxc"]
    dyc = grid["dyc"]
    rarea_c = grid["rarea_c"]

    uf = u.new_zeros(u.shape)
    uf[..., 1:jb - 1, :] = (
        u[..., 1:jb - 1, :]
        - 0.25 * (va[..., 0:jc - 1, :] + va[..., 1:jc, :])
        * (cos_sg[3][..., 0:jc - 1, :] + cos_sg[1][..., 1:jc, :])
    ) * dyc[..., 1:jb - 1, :] * 0.5 * (
        sin_sg[3][..., 0:jc - 1, :] + sin_sg[1][..., 1:jc, :])
    for jf in (1, npy):
        jj = p(jf)
        uf[..., jj, :] = (u[..., jj, :] * dyc[..., jj, :] * 0.5
                          * (sin_sg[3][..., jj - 1, :] + sin_sg[1][..., jj, :]))

    vf = v.new_zeros(v.shape)
    vf[..., :, 1:jb - 1] = (
        v[..., :, 1:jb - 1]
        - 0.25 * (ua[..., :, 0:jc - 1] + ua[..., :, 1:jc])
        * (cos_sg[2][..., :, 0:jc - 1] + cos_sg[0][..., :, 1:jc])
    ) * dxc[..., :, 1:jb - 1] * 0.5 * (
        sin_sg[2][..., :, 0:jc - 1] + sin_sg[0][..., :, 1:jc])
    for if_ in (1, npx):
        ii = p(if_)
        vf[..., :, ii] = (v[..., :, ii] * dxc[..., :, ii] * 0.5
                          * (sin_sg[2][..., :, ii - 1] + sin_sg[0][..., :, ii]))

    divg = u.new_zeros(u.shape[:-2] + (jb, jb))
    divg[..., 1:jc, 1:jc] = ((vf[..., 0:jc - 1, 1:jc] - vf[..., 1:jc, 1:jc])
                             + (uf[..., 1:jc, 0:jc - 1] - uf[..., 1:jc, 1:jc]))
    # corner B points: the 3 valid terms set directly
    divg[..., p(1), p(1)] = (-vf[..., p(1), p(1)] + uf[..., p(1), p(0)]
                             - uf[..., p(1), p(1)])
    divg[..., p(1), p(npx)] = (-vf[..., p(1), p(npx)]
                               + uf[..., p(1), p(npx - 1)]
                               - uf[..., p(1), p(npx)])
    divg[..., p(npy), p(npx)] = (vf[..., p(npy - 1), p(npx)]
                                 + uf[..., p(npy), p(npx - 1)]
                                 - uf[..., p(npy), p(npx)])
    divg[..., p(npy), p(1)] = (vf[..., p(npy - 1), p(1)]
                               + uf[..., p(npy), p(0)] - uf[..., p(npy), p(1)])
    return rarea_c * divg


# ----------------------------------------------------------------------
# del6_vt_flux (sw_core_nlm.F90:1547-1658)
# ----------------------------------------------------------------------

def del6_vt_flux(nord, damp, q, grid, topo):
    """Returns (d2, fx2, fy2): damped field + diffusive fluxes (full width)."""
    del6_u = grid["del6_u"]
    del6_v = grid["del6_v"]
    rarea = grid["rarea"]
    jc = q.shape[-1]

    d2 = damp * q
    if nord > 0:
        d2 = halo.copy_corners(d2, topo, 1)
    fx2 = q.new_zeros(q.shape[:-1] + (jc + 1,))
    fx2[..., 1:jc] = del6_v[..., 1:jc] * (d2[..., 0:jc - 1] - d2[..., 1:jc])
    if nord > 0:
        d2 = halo.copy_corners(d2, topo, 2)
    fy2 = q.new_zeros(q.shape[:-2] + (jc + 1,) + q.shape[-1:])
    fy2[..., 1:jc, :] = del6_u[..., 1:jc, :] * (d2[..., 0:jc - 1, :]
                                                 - d2[..., 1:jc, :])

    for _ in range(nord):
        d2 = (fx2[..., :, 0:jc] - fx2[..., :, 1:jc + 1]
              + fy2[..., 0:jc, :] - fy2[..., 1:jc + 1, :]) * rarea
        d2 = halo.copy_corners(d2, topo, 1)
        fx2[..., 1:jc] = del6_v[..., 1:jc] * (d2[..., 1:jc] - d2[..., 0:jc - 1])
        d2 = halo.copy_corners(d2, topo, 2)
        fy2[..., 1:jc, :] = del6_u[..., 1:jc, :] * (d2[..., 1:jc, :]
                                                     - d2[..., 0:jc - 1, :])
    return d2, fx2, fy2


# ----------------------------------------------------------------------
# c_sw: C-grid Lin-Rood half step (sw_core_nlm.F90:77-489)
# ----------------------------------------------------------------------

def c_sw(delp, pt, u, v, w, uc, vc, grid, dt2, nord, npx, hydrostatic=False):
    """C-grid half-step on halo-filled padded fields.  uc/vc are replaced
    by d2a2c_vect's winds (as in the reference).  Returns
    (delpc, ptc, wc, uc_new, vc_new, divg_d, ua, va, ut, vt); hydrostatic,
    w is not transported and wc is zero."""
    n = npx - 1
    npy = npx
    jc = n + 2 * NG
    jb = jc + 1
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
        divg_d = u.new_zeros(u.shape[:-2] + (jb, jb))

    # ---- courant-like transport winds (sw_core_nlm.F90:160-180) ----
    ut_s = torch.zeros_like(ut)
    sel = fbool(ut[..., :, 1:jc] > 0.0)
    ut_s[..., :, 1:jc] = (dt2 * ut[..., :, 1:jc] * dy[..., :, 1:jc]
                          * torch.where(sel, sin_sg[2][..., :, 0:jc - 1],
                                        sin_sg[0][..., :, 1:jc]))
    vt_s = torch.zeros_like(vt)
    selv = fbool(vt[..., 1:jc, :] > 0.0)
    vt_s[..., 1:jc, :] = (dt2 * vt[..., 1:jc, :] * dx[..., 1:jc, :]
                          * torch.where(selv, sin_sg[3][..., 0:jc - 1, :],
                                        sin_sg[1][..., 1:jc, :]))
    ut = ut_s
    vt = vt_s

    # ---- transport delp / pt / w (sw_core_nlm.F90:182-284) ----
    delp_x = fill_4corners(delp, 1, npx)
    pt_x = fill_4corners(pt, 1, npx)
    selx = fbool(ut[..., :, 1:jc] > 0.0)

    def upx(f):
        return torch.where(selx, f[..., :, 0:jc - 1], f[..., :, 1:jc])

    fx1 = torch.zeros_like(ut)
    fx1[..., :, 1:jc] = ut[..., :, 1:jc] * upx(delp_x)
    fx = torch.zeros_like(ut)
    fx[..., :, 1:jc] = fx1[..., :, 1:jc] * upx(pt_x)
    if not hydrostatic:
        fx2 = torch.zeros_like(ut)
        fx2[..., :, 1:jc] = fx1[..., :, 1:jc] * upx(fill_4corners(w, 1, npx))

    delp_y = fill_4corners(delp, 2, npx)
    pt_y = fill_4corners(pt, 2, npx)
    sely = fbool(vt[..., 1:jc, :] > 0.0)

    def upy(f):
        return torch.where(sely, f[..., 0:jc - 1, :], f[..., 1:jc, :])

    fy1 = torch.zeros_like(vt)
    fy1[..., 1:jc, :] = vt[..., 1:jc, :] * upy(delp_y)
    fy = torch.zeros_like(vt)
    fy[..., 1:jc, :] = fy1[..., 1:jc, :] * upy(pt_y)
    if not hydrostatic:
        fy2 = torch.zeros_like(vt)
        fy2[..., 1:jc, :] = fy1[..., 1:jc, :] * upy(fill_4corners(w, 2, npx))

    # cell updates over [is-1, ie+1]^2 = cells 0..n+1
    cs = slice(p(0), p(n + 1) + 1)
    es = slice(p(0), p(n + 2) + 1)

    def div(gx, gy):
        return (gx[..., cs, es][..., :, :-1] - gx[..., cs, es][..., :, 1:]
                + gy[..., es, cs][..., :-1, :] - gy[..., es, cs][..., 1:, :]
                ) * rarea[..., cs, cs]

    div1 = div(fx1, fy1)
    divt = div(fx, fy)
    delpc = torch.zeros_like(delp)
    delpc_i = delp[..., cs, cs] + div1
    delpc[..., cs, cs] = delpc_i
    ptc = torch.zeros_like(pt)
    ptc[..., cs, cs] = (pt[..., cs, cs] * delp[..., cs, cs] + divt) / delpc_i
    wc = torch.zeros_like(w)
    if not hydrostatic:
        wc[..., cs, cs] = (w[..., cs, cs] * delp[..., cs, cs]
                           + div(fx2, fy2)) / delpc_i

    # ---- kinetic energy (sw_core_nlm.F90:286-365), cells 0..n+1 ----
    ke_pos = uc[..., cs, p(0):p(n + 1) + 1].clone()   # uc(i,j)
    ke_neg = uc[..., cs, p(1):p(n + 2) + 1].clone()   # uc(i+1,j)
    v_1 = v[..., cs, p(1)]
    v_n = v[..., cs, p(npx)]
    uc_1 = uc[..., cs, p(1)]
    uc_n = uc[..., cs, p(npx)]
    ke_pos[..., :, 1] = (uc_1 * sin_sg[0][..., cs, p(1)]
                         + v_1 * cos_sg[0][..., cs, p(1)])
    ke_pos[..., :, npx] = (uc_n * sin_sg[0][..., cs, p(npx)]
                           + v_n * cos_sg[0][..., cs, p(npx)])
    ke_neg[..., :, 0] = (uc_1 * sin_sg[2][..., cs, p(0)]
                         + v_1 * cos_sg[2][..., cs, p(0)])
    ke_neg[..., :, npx - 1] = (uc_n * sin_sg[2][..., cs, p(npx - 1)]
                               + v_n * cos_sg[2][..., cs, p(npx - 1)])
    ke_x = fwhere(ua[..., cs, cs] > 0.0, ke_pos, ke_neg)

    vo_pos = vc[..., p(0):p(n + 1) + 1, cs].clone()
    vo_neg = vc[..., p(1):p(n + 2) + 1, cs].clone()
    u_1 = u[..., p(1), cs]
    u_n = u[..., p(npy), cs]
    vc_1 = vc[..., p(1), cs]
    vc_n = vc[..., p(npy), cs]
    vo_pos[..., 1, :] = (vc_1 * sin_sg[1][..., p(1), cs]
                         + u_1 * cos_sg[1][..., p(1), cs])
    vo_pos[..., npy, :] = (vc_n * sin_sg[1][..., p(npy), cs]
                           + u_n * cos_sg[1][..., p(npy), cs])
    vo_neg[..., 0, :] = (vc_1 * sin_sg[3][..., p(0), cs]
                         + u_1 * cos_sg[3][..., p(0), cs])
    vo_neg[..., npy - 1, :] = (vc_n * sin_sg[3][..., p(npy - 1), cs]
                               + u_n * cos_sg[3][..., p(npy - 1), cs])
    ke_y = fwhere(va[..., cs, cs] > 0.0, vo_pos, vo_neg)

    dt4 = 0.5 * dt2
    ke = torch.zeros_like(delp)
    ke[..., cs, cs] = dt4 * (ua[..., cs, cs] * ke_x + va[..., cs, cs] * ke_y)

    # ---- circulation -> absolute vorticity on B grid (:367-400) ----
    fxc = uc * dxc
    fyc = vc * dyc
    bs = slice(p(1), p(npx) + 1)
    vort_c = (fxc[..., p(0):p(npy - 1) + 1, bs] - fxc[..., p(1):p(npy) + 1, bs]
              + fyc[..., bs, p(1):p(npx) + 1]
              - fyc[..., bs, p(0):p(npx - 1) + 1])
    # 3-term corner circulation, set directly
    vort_c[..., 0, 0] = (fxc[..., p(0), p(1)] - fxc[..., p(1), p(1)]
                         + fyc[..., p(1), p(1)])
    vort_c[..., 0, npx - 1] = (fxc[..., p(0), p(npx)] - fxc[..., p(1), p(npx)]
                               - fyc[..., p(1), p(npx - 1)])
    vort_c[..., npy - 1, npx - 1] = (fxc[..., p(npy - 1), p(npx)]
                                     - fxc[..., p(npy), p(npx)]
                                     - fyc[..., p(npy), p(npx - 1)])
    vort_c[..., npy - 1, 0] = (fxc[..., p(npy - 1), p(1)]
                               - fxc[..., p(npy), p(1)]
                               + fyc[..., p(npy), p(1)])
    vort_b = fC[..., bs, bs] + rarea_c[..., bs, bs] * vort_c

    # ---- vorticity transport & wind update (:402-489) ----
    rs = slice(p(1), p(n) + 1)
    fy1 = dt2 * (v[..., rs, bs] - uc[..., rs, bs] * cosa_u[..., rs, bs]
                 ) / sina_u[..., rs, bs]
    fy1[..., :, 0] = dt2 * v[..., rs, p(1)]
    fy1[..., :, npx - 1] = dt2 * v[..., rs, p(npx)]
    fyv = fwhere(fy1 > 0.0, vort_b[..., 0:n, :], vort_b[..., 1:n + 1, :])

    fx1v = dt2 * (u[..., bs, rs] - vc[..., bs, rs] * cosa_v[..., bs, rs]
                  ) / sina_v[..., bs, rs]
    fx1v[..., 0, :] = dt2 * u[..., p(1), rs]
    fx1v[..., npy - 1, :] = dt2 * u[..., p(npy), rs]
    fxv = fwhere(fx1v > 0.0, vort_b[..., :, 0:n], vort_b[..., :, 1:n + 1])

    uc_new = uc.clone()
    uc_new[..., rs, bs] += (fy1 * fyv + rdxc[..., rs, bs]
                            * (ke[..., rs, p(0):p(n) + 1]
                               - ke[..., rs, p(1):p(npx) + 1]))
    vc_new = vc.clone()
    vc_new[..., bs, rs] += (-fx1v * fxv + rdyc[..., bs, rs]
                            * (ke[..., p(0):p(n) + 1, rs]
                               - ke[..., p(1):p(npy) + 1, rs]))

    # ut/vt: the dt2-scaled C-grid transport winds (area-flux form), which
    # the NH update_dz_c consumes
    return delpc, ptc, wc, uc_new, vc_new, divg_d, ua, va, ut, vt
