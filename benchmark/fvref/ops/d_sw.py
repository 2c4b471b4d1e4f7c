"""D-grid Lin-Rood forward step (d_sw) and B-point wind advection (xtp_u/ytp_v).

Counterpart of fv3jedi_lm_tpu/ops/d_sw.py (model/sw_core_nlm.F90: `d_sw`
:492-1544, `xtp_u` :1970, `ytp_v` :2312): hydrostatic and
nonhydrostatic, the trajectory schemes hord 8/9 and the perturbation
schemes (also as a per-level band, see ppm.xppm), with vorticity
damping and the d_con damping heat.

Shapes (ny x nx cells of the model's tile, the whole face on one
process; jc = n+2ng, jb = jc+1 along each axis; leading dims broadcast):
  u, vt, divg_u : (..., nf, jby, jcx)   rows = B lines, cols = cells
  v, ut, divg_v : (..., nf, jcy, jbx)
  uc            : (..., nf, jcy, jbx)   C-grid u (cols = B)
  vc            : (..., nf, jby, jcx)
  delp/pt/w/wk  : (..., nf, jcy, jcx)
  B-point arrays: (..., nf, jby, jbx)
The edge and corner fixes act where the tile owns that face edge or
cube corner.
"""

from __future__ import annotations

import torch

from .. import NG
from ..core.freeze import fabs, fbool, fmax, fmin, fsign_mul, fwhere
from ..parallel import halo
from . import ppm
from .a2b_edge import a2b_ord4
from .ppm import C1, C2, C3, P1, P2
from .sw_core import F2P, SL, del6_vt_flux, face_span, tile_of
from .transport import fv_tp_2d, mask_band

R3 = 1.0 / 3.0
NEAR_ZERO = 1.0e-9  # sw_core_nlm.F90:37
S11 = 11.0 / 14.0
S14 = 4.0 / 7.0
S15 = 3.0 / 14.0


def _mask(m, like):
    """A static numpy level mask as a bool tensor on `like`'s device."""
    return torch.as_tensor(m, device=like.device)


def _del6_vt_flux_masked(nord_n, damps, mask0, q, grid, topo):
    """del6_vt_flux at per-level order: order-0 on mask0 levels, nord_n
    elsewhere (the sponge-band override of dyn_core_nlm.F90:536-630), with
    the level batch split statically at the sponge band edge.
    damps = (damp4 order-0, damp4 order-n), each (npz,1,1,1)."""
    if nord_n == 0:
        return del6_vt_flux(0, damps[0], q, grid, topo)
    k0, mixed = mask_band(mask0)
    if k0 == 0:
        return del6_vt_flux(nord_n, damps[1], q, grid, topo)
    outA = del6_vt_flux(0, damps[0][:k0], q[:k0], grid, topo)
    if mixed:
        outAn = del6_vt_flux(nord_n, damps[1][:k0], q[:k0], grid, topo)
        m0 = _mask(mask0[:k0], q)
        outA = tuple(torch.where(m0, a, b) for a, b in zip(outA, outAn))
    if k0 == q.shape[0]:
        return outA
    outB = del6_vt_flux(nord_n, damps[1][k0:], q[k0:], grid, topo)
    return tuple(torch.cat([a, b], dim=0) for a, b in zip(outA, outB))


def _edge_2sided(q, dxm, e, A):
    """Two-sided face-edge value at edge-index e between cells e-1 | e."""
    qm, q0, q1, q2 = (A.get(q, e - 2), A.get(q, e - 1), A.get(q, e),
                      A.get(q, e + 1))
    dm, d0, d1, d2 = (A.get(dxm, e - 2), A.get(dxm, e - 1), A.get(dxm, e),
                      A.get(dxm, e + 1))
    return 0.5 * (
        ((2.0 * d0 + dm) * q0 - d0 * qm) / (dm + d0)
        + ((2.0 * d1 + d2) * q1 - d1 * q2) / (d1 + d2)
    )


def _zero_ends(x, lo, hi):
    """x with the first and last line of the other axis set to zero (the
    perpendicular-edge zeroing at j==1 / j==npy), each where the tile owns
    that face edge (`lo`, `hi`)."""
    if not (lo or hi):
        return x
    out = x.clone()
    if lo:
        out[..., 0] = 0.0
    if hi:
        out[..., -1] = 0.0
    return out


def _flux_low(q, cb, iord, dxm, A, qL, qR, rdxL, rdxR, edges):
    """The schemes iord 2-7 with their face-edge fixes (sw_core_nlm.F90
    xtp_u iord < 8); `edges` = (lo, hi, perpendicular lo, perpendicular
    hi), the face edges the tile owns."""
    lo, hi, plo, phi = edges
    ic = A.size(q)
    n = ic - 2 * NG
    npx = n + 1
    p = F2P
    b0s = p(1)
    z2 = A.zeros_like_w(q, 2)
    al = A.cat([z2, P1 * (A.rng(q, 1, ic - 2) + A.rng(q, 2, ic - 1))
                + P2 * (A.rng(q, 0, ic - 3) + A.rng(q, 3, ic)), z2])
    bl = A.rng(al, 0, ic) - q
    br = A.rng(al, 1, ic + 1) - q
    set_l, set_r = [], []
    if lo:
        # west edge fixes (cells 0, 1, 2 -> padded p(0)..p(2))
        i1 = p(1)
        xt = (C3 * A.get(q, i1) + C2 * A.get(q, i1 + 1)
              + C1 * A.get(q, i1 + 2))
        br_i1_a = xt - A.get(q, i1)
        bl_i1p1 = xt - A.get(q, i1 + 1)
        br_i1p1 = A.get(al, i1 + 3) - A.get(q, i1 + 1)
        bl0 = (C1 * A.get(q, i1 - 3) + C2 * A.get(q, i1 - 2)
               + C3 * A.get(q, i1 - 1) - A.get(q, i1 - 1))
        xte = _edge_2sided(q, dxm, i1, A)
        br0 = xte - A.get(q, i1 - 1)
        bl1 = xte - A.get(q, i1)
        set_l += [(i1 - 1, _zero_ends(bl0, plo, phi)),
                  (i1, _zero_ends(bl1, plo, phi)), (i1 + 1, bl_i1p1)]
        set_r += [(i1 - 1, _zero_ends(br0, plo, phi)),
                  (i1, _zero_ends(br_i1_a, plo, phi)), (i1 + 1, br_i1p1)]
    if hi:
        # east edge (cells npx-2, npx-1, npx)
        iN = p(npx - 2)
        bl_iN = A.get(al, iN) - A.get(q, iN)
        xt = (C1 * A.get(q, iN - 1) + C2 * A.get(q, iN)
              + C3 * A.get(q, iN + 1))
        br_iN = xt - A.get(q, iN)
        bl_iNp1_a = xt - A.get(q, iN + 1)
        xte = _edge_2sided(q, dxm, p(npx), A)
        brN1 = xte - A.get(q, iN + 1)
        blN2 = xte - A.get(q, iN + 2)
        brN2 = (C3 * A.get(q, iN + 2) + C2 * A.get(q, iN + 3)
                + C1 * A.get(q, iN + 4) - A.get(q, iN + 2))
        set_l += [(iN, bl_iN), (iN + 1, _zero_ends(bl_iNp1_a, plo, phi)),
                  (iN + 2, _zero_ends(blN2, plo, phi))]
        set_r += [(iN, br_iN), (iN + 1, _zero_ends(brN1, plo, phi)),
                  (iN + 2, _zero_ends(brN2, plo, phi))]
    bl = ppm.set_cols(bl, set_l, A)
    br = ppm.set_cols(br, set_r, A)
    b0 = bl + br
    blL = A.rng(bl, b0s - 1, b0s + n)
    brL = A.rng(br, b0s - 1, b0s + n)
    b0L = A.rng(b0, b0s - 1, b0s + n)
    blR = A.rng(bl, b0s, b0s + n + 1)
    brR = A.rng(br, b0s, b0s + n + 1)
    b0R = A.rng(b0, b0s, b0s + n + 1)
    cflp = cb * rdxL
    cfln = cb * rdxR
    if iord == 2:
        return fwhere(cb > 0.0,
                      qL + (1.0 - cflp) * (brL - cflp * b0L),
                      qR + (1.0 + cfln) * (blR + cfln * b0R))
    x0 = torch.abs(b0)
    x1 = torch.abs(bl - br)
    if iord in (3, 4):
        smt5 = fbool(x0 < x1)
        smt6 = fbool(3.0 * x0 < x1)
        s5L = A.rng(smt5, b0s - 1, b0s + n)
        s6L = A.rng(smt6, b0s - 1, b0s + n)
        s5R = A.rng(smt5, b0s, b0s + n + 1)
        s6R = A.rng(smt6, b0s, b0s + n + 1)
        if iord == 3:
            fx0p = torch.where(
                s6L | s5R, brL - cflp * b0L,
                torch.where(s5L, fsign_mul(brL, fmin(fabs(blL), fabs(brL))),
                            0.0))
            fx0n = torch.where(
                s6R | s5L, blR + cfln * b0R,
                torch.where(s5R, fsign_mul(blR, fmin(fabs(blR), fabs(brR))),
                            0.0))
            return fwhere(cb > 0.0, qL + (1.0 - cflp) * fx0p,
                          qR + (1.0 + cfln) * fx0n)
        fx0p = torch.where(s6L | s5R, (1.0 - cflp) * (brL - cflp * b0L), 0.0)
        fx0n = torch.where(s6R | s5L, (1.0 + cfln) * (blR + cfln * b0R), 0.0)
        return fwhere(cb > 0.0, qL + fx0p, qR + fx0n)
    # iord 5, 6, 7
    if iord == 5:
        smt5 = fbool(bl * br < 0.0)
    else:
        smt5 = fbool(torch.abs(3.0 * b0) < x1)
    s5L = A.rng(smt5, b0s - 1, b0s + n)
    s5R = A.rng(smt5, b0s, b0s + n + 1)
    cbpos = fbool(cb > 0.0)
    fx0 = torch.where(cbpos, (1.0 - cflp) * (brL - cflp * b0L),
                      (1.0 + cfln) * (blR + cfln * b0R))
    base = torch.where(cbpos, qL, qR)
    return base + torch.where(s5L | s5R, fx0, 0.0)


def _xtp_flux(q, cb, iord, dxm, rdxm, A, edges):
    """Advective flux of a D-grid wind component along its own line, iord
    1-13 (sw_core_nlm.F90:1970-2306).

    Works along axis `A.ax` (-1 for xtp_u rows, -2 for ytp_v columns).
    q: cells, width jc along A.ax; cb: courant at B indices 1..n+1;
    dxm/rdxm metric aligned with q; `edges` as in _flux_low.  Returns the
    flux, width n+1."""
    if not 1 <= iord <= 13:
        raise ValueError(f"xtp_u/ytp_v iord={iord!r}: the schemes are 1-13")
    lo, hi, plo, phi = edges
    ic = A.size(q)
    n = ic - 2 * NG
    npx = n + 1
    p = F2P
    b0s = p(1)  # python index of B point 1
    qL = A.rng(q, b0s - 1, b0s + n)
    qR = A.rng(q, b0s, b0s + n + 1)
    rdxL = A.rng(rdxm, b0s - 1, b0s + n)
    rdxR = A.rng(rdxm, b0s, b0s + n + 1)
    if iord == 1:
        return fwhere(cb > 0.0, qL, qR)
    if iord < 8:
        return _flux_low(q, cb, iord, dxm, A, qL, qR, rdxL, rdxR, edges)

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
    dq = A.cat([A.rng(q, 1, ic) - A.rng(q, 0, ic - 1), z1])

    al = A.cat([
        z1,
        0.5 * (A.rng(q, 0, ic - 1) + A.rng(q, 1, ic))
        + R3 * (A.rng(dm, 0, ic - 1) - A.rng(dm, 1, ic)),
        z1,
    ])
    bl = A.rng(al, 0, ic) - q
    br = A.rng(al, 1, ic + 1) - q
    if iord == 8:
        xt2 = 2.0 * dm
        bl = -fsign_mul(xt2, fmin(fabs(xt2), fabs(bl)))
        br = fsign_mul(xt2, fmin(fabs(xt2), fabs(br)))
    elif iord in (9, 10):
        dqm1 = torch.roll(dq, 1, dims=A.ax)
        dqm2 = torch.roll(dq, 2, dims=A.ax)
        dqp1 = torch.roll(dq, -1, dims=A.ax)
        pmp_1 = -2.0 * dq
        lac_1 = pmp_1 + 1.5 * dqp1
        bl_l = fmin(fmax(0.0, fmax(pmp_1, lac_1)),
                    fmax(bl, fmin(0.0, fmin(pmp_1, lac_1))))
        pmp_2 = 2.0 * dqm1
        lac_2 = pmp_2 - 1.5 * dqm2
        br_l = fmin(fmax(0.0, fmax(pmp_2, lac_2)),
                    fmax(br, fmin(0.0, fmin(pmp_2, lac_2))))
        if iord == 9:
            bl, br = bl_l, br_l
        else:
            dmm1 = torch.roll(dm, 1, dims=A.ax)
            dmp1 = torch.roll(dm, -1, dims=A.ax)
            flat = (torch.abs(dm) < NEAR_ZERO) & (
                torch.abs(dmm1) + torch.abs(dmp1) < NEAR_ZERO)
            noisy = torch.abs(3.0 * (bl + br)) > torch.abs(bl - br)
            bl = fwhere(flat, 0.0, fwhere(noisy, bl_l, bl))
            br = fwhere(flat, 0.0, fwhere(noisy, br_l, br))
    # iord 11-13: the unlimited bl/br as computed

    set_l, set_r = [], []
    if lo:
        # west edge (sw_core_nlm.F90:2237-2261)
        i1 = p(1)
        br_i1p1_a = A.get(al, i1 + 3) - A.get(q, i1 + 1)
        xt = (S15 * A.get(q, i1) + S11 * A.get(q, i1 + 1)
              - S14 * A.get(dm, i1 + 1))
        bl_i1p1_a = xt - A.get(q, i1 + 1)
        br_i1_a = xt - A.get(q, i1)
        bl0 = S14 * A.get(dm, i1 - 2) - S11 * A.get(dq, i1 - 2)
        xte = _edge_2sided(q, dxm, i1, A)
        bl_i1m1 = _zero_ends(bl0, plo, phi)
        br_i1m1 = _zero_ends(xte - A.get(q, i1 - 1), plo, phi)
        bl_i1 = _zero_ends(xte - A.get(q, i1), plo, phi)
        br_i1 = _zero_ends(br_i1_a, plo, phi)
        b2l, b2r = ppm.pert_ppm(A.rng(q, i1 + 1, i1 + 2), A.exp(bl_i1p1_a),
                                A.exp(br_i1p1_a), 1)
        set_l += [(i1 - 1, bl_i1m1), (i1, bl_i1), (i1 + 1, A.get(b2l, 0))]
        set_r += [(i1 - 1, br_i1m1), (i1, br_i1), (i1 + 1, A.get(b2r, 0))]

    if hi:
        # east edge (:2264-2290)
        iN = p(npx - 2)
        bl_iN_a = A.get(al, iN) - A.get(q, iN)
        xt = (S15 * A.get(q, iN + 1) + S11 * A.get(q, iN)
              + S14 * A.get(dm, iN))
        br_iN_a = xt - A.get(q, iN)
        bl_iNp1_a = xt - A.get(q, iN + 1)
        brN2 = S11 * A.get(dq, iN + 2) - S14 * A.get(dm, iN + 3)
        xte = _edge_2sided(q, dxm, p(npx), A)
        bl_iNp1 = _zero_ends(bl_iNp1_a, plo, phi)
        br_iNp1 = _zero_ends(xte - A.get(q, iN + 1), plo, phi)
        bl_iNp2 = _zero_ends(xte - A.get(q, iN + 2), plo, phi)
        br_iNp2 = _zero_ends(brN2, plo, phi)
        b2l, b2r = ppm.pert_ppm(A.rng(q, iN, iN + 1), A.exp(bl_iN_a),
                                A.exp(br_iN_a), 1)
        set_l += [(iN, A.get(b2l, 0)), (iN + 1, bl_iNp1), (iN + 2, bl_iNp2)]
        set_r += [(iN, A.get(b2r, 0)), (iN + 1, br_iNp1), (iN + 2, br_iNp2)]

    bl = ppm.set_cols(bl, set_l, A)
    br = ppm.set_cols(br, set_r, A)

    b0 = bl + br
    brL = A.rng(br, b0s - 1, b0s + n)
    b0L = A.rng(b0, b0s - 1, b0s + n)
    blR = A.rng(bl, b0s, b0s + n + 1)
    b0R = A.rng(b0, b0s, b0s + n + 1)
    cflp = cb * rdxL
    cfln = cb * rdxR
    return fwhere(
        cb > 0.0,
        qL + (1.0 - cflp) * (brL - cflp * b0L),
        qR + (1.0 + cfln) * (blR + cfln * b0R),
    )


def xtp_u(cb, u, dx, rdx, iord, npx, tile=None):
    """Flux of u along x at B points (sw_core_nlm.F90:1970).

    cb: (..., jby, jbx) courant (only B 1..X/Y read); u: (..., jby, jcx).
    Returns (..., Y, X) flux at B points (j, i) of the tile, [1, npx]^2 on
    a whole face (`tile` None).  `iord` may be a per-level band (main,
    sponge, ksp), see ppm.xppm."""
    if isinstance(iord, tuple):
        main, sponge, ksp = iord
        return torch.cat([xtp_u(cb[:ksp], u[:ksp], dx, rdx, sponge, npx,
                                tile),
                          xtp_u(cb[ksp:], u[ksp:], dx, rdx, main, npx,
                                tile)])
    bsy = SL(1, u.shape[-2] - 2 * NG)
    bsx = SL(1, u.shape[-1] - 2 * NG + 1)
    return _xtp_flux(u[..., bsy, :], cb[..., bsy, bsx], iord,
                     dx[..., bsy, :], rdx[..., bsy, :], ppm._AXX,
                     ppm.edges(tile, -1))


def ytp_v(cb, v, dy, rdy, jord, npx, tile=None):
    """Flux of v along y at B points (sw_core_nlm.F90:2312): the same
    operator along axis -2."""
    if isinstance(jord, tuple):
        main, sponge, ksp = jord
        return torch.cat([ytp_v(cb[:ksp], v[:ksp], dy, rdy, sponge, npx,
                                tile),
                          ytp_v(cb[ksp:], v[ksp:], dy, rdy, main, npx,
                                tile)])
    bsy = SL(1, v.shape[-2] - 2 * NG + 1)
    bsx = SL(1, v.shape[-1] - 2 * NG)
    return _xtp_flux(v[..., :, bsx], cb[..., bsy, bsx], jord,
                     dy[..., :, bsx], rdy[..., :, bsx], ppm._AXY,
                     ppm.edges(tile, -2))


def _contravariant_winds(uc, vc, grid, dt, npx):
    """Contravariant C-grid winds ut/vt with the cube-edge and corner
    fixes (sw_core_nlm.F90:650-840), each where the tile owns that face
    edge or cube corner."""
    T, X, Y = tile_of(grid, npx)
    jcy, jcx = uc.shape[-2], vc.shape[-1]
    p = F2P
    sin_sg = grid["sin_sg"]
    cosa_u = grid["cosa_u"]
    cosa_v = grid["cosa_v"]
    rsin_u = grid["rsin_u"]
    rsin_v = grid["rsin_v"]

    # interior formula; rows j in {0, 1} (south) and {npy-1, npy} (north)
    # stay zero
    ut = torch.zeros_like(uc)
    ut[..., 0:jcy, 1:jcx] = (
        uc[..., 0:jcy, 1:jcx]
        - 0.25 * cosa_u[..., 0:jcy, 1:jcx]
        * (vc[..., 0:jcy, 0:jcx - 1] + vc[..., 0:jcy, 1:jcx]
           + vc[..., 1:jcy + 1, 0:jcx - 1] + vc[..., 1:jcy + 1, 1:jcx])
    ) * rsin_u[..., 0:jcy, 1:jcx]
    for j in [0, 1] * T.south + [Y - 1, Y] * T.north:
        ut[..., p(j), :] = 0.0

    vt = torch.zeros_like(vc)
    vt[..., 1:jcy, 0:jcx] = (
        vc[..., 1:jcy, 0:jcx]
        - 0.25 * cosa_v[..., 1:jcy, 0:jcx]
        * (uc[..., 0:jcy - 1, 0:jcx] + uc[..., 0:jcy - 1, 1:jcx + 1]
           + uc[..., 1:jcy, 0:jcx] + uc[..., 1:jcy, 1:jcx + 1])
    ) * rsin_v[..., 1:jcy, 0:jcx]
    for j in [1] * T.south + [Y] * T.north:
        vt[..., p(j), :] = 0.0

    # west/east edge cols: ut = uc / sin_sg (:687-694)
    for e in [p(1)] * T.west + [p(X)] * T.east:
        sel = fbool(uc[..., :, e] * dt > 0.0)
        ut[..., :, e] = uc[..., :, e] / torch.where(
            sel, sin_sg[2][..., :, e - 1], sin_sg[0][..., :, e])
    # south/north edge rows for vt (:718-743)
    for e in [p(1)] * T.south + [p(Y)] * T.north:
        sel = fbool(vc[..., e, :] * dt > 0.0)
        vt[..., e, :] = vc[..., e, :] / torch.where(
            sel, sin_sg[3][..., e - 1, :], sin_sg[1][..., e, :])

    # secondary edge fixes (no rsin factor), sw_core_nlm.F90:696-749:
    # along the face edge between its corner regions
    npy_f = T.n + 1
    rs2 = face_span(T, "y", 3, npy_f - 2, 1, jcy - 1)
    utm = slice(rs2.start - 1, rs2.stop - 1)
    ut0 = rs2
    for i0 in [0, 1] * T.west + [X - 1, X] * T.east:
        c0 = p(i0)
        vt[..., rs2, c0] = (
            vc[..., rs2, c0]
            - 0.25 * cosa_v[..., rs2, c0]
            * (ut[..., utm, c0] + ut[..., utm, c0 + 1]
               + ut[..., ut0, c0] + ut[..., ut0, c0 + 1]))
    cs2 = face_span(T, "x", 3, npy_f - 2, 1, jcx - 1)
    vtm = slice(cs2.start - 1, cs2.stop - 1)
    vt0 = cs2
    for j0 in [0, 1] * T.south + [Y - 1, Y] * T.north:
        r0 = p(j0)
        ut[..., r0, cs2] = (
            uc[..., r0, cs2]
            - 0.25 * cosa_u[..., r0, cs2]
            * (vt[..., r0, vtm] + vt[..., r0, vt0]
               + vt[..., r0 + 1, vtm] + vt[..., r0 + 1, vt0]))

    # corner 2x2 solves (:752-836), in the reference's order.  Each entry:
    # (target of ut or vt, its three same-component neighbours of the
    # other component, the diagonal point D of uc/vc, the three
    # neighbours of the target's own component around D)
    def at(i, j):
        return (Ellipsis, p(j), p(i))

    def solve_u(t, vts, d, uts):
        damp = 1.0 / (1.0 - 0.0625 * cosa_u[at(*t)] * cosa_v[at(*d)])
        ut[at(*t)] = (
            uc[at(*t)]
            - 0.25 * cosa_u[at(*t)]
            * (vt[at(*vts[0])] + vt[at(*vts[1])] + vt[at(*vts[2])]
               + vc[at(*d)]
               - 0.25 * cosa_v[at(*d)]
               * (ut[at(*uts[0])] + ut[at(*uts[1])] + ut[at(*uts[2])]))
        ) * damp

    def solve_v(t, uts, d, vts):
        damp = 1.0 / (1.0 - 0.0625 * cosa_u[at(*d)] * cosa_v[at(*t)])
        vt[at(*t)] = (
            vc[at(*t)]
            - 0.25 * cosa_v[at(*t)]
            * (ut[at(*uts[0])] + ut[at(*uts[1])] + ut[at(*uts[2])]
               + uc[at(*d)]
               - 0.25 * cosa_u[at(*d)]
               * (vt[at(*vts[0])] + vt[at(*vts[1])] + vt[at(*vts[2])]))
        ) * damp

    if T.south and T.west:
        solve_u((2, 0), ((1, 1), (2, 1), (2, 0)), (1, 0),
                ((1, 0), (1, -1), (2, -1)))
        solve_v((0, 2), ((1, 1), (1, 2), (0, 2)), (0, 1),
                ((0, 1), (-1, 1), (-1, 2)))
        solve_u((2, 1), ((1, 1), (2, 1), (2, 2)), (1, 2),
                ((1, 1), (1, 2), (2, 2)))
        solve_v((1, 2), ((1, 1), (1, 2), (2, 2)), (2, 1),
                ((1, 1), (2, 1), (2, 2)))
    if T.south and T.east:
        solve_u((X - 1, 0), ((X - 1, 1), (X - 2, 1), (X - 2, 0)), (X - 1, 0),
                ((X, 0), (X, -1), (X - 1, -1)))
        solve_v((X, 2), ((X, 1), (X, 2), (X + 1, 2)), (X + 1, 1),
                ((X, 1), (X + 1, 1), (X + 1, 2)))
        solve_u((X - 1, 1), ((X - 1, 1), (X - 2, 1), (X - 2, 2)), (X - 1, 2),
                ((X, 1), (X, 2), (X - 1, 2)))
        solve_v((X - 1, 2), ((X, 1), (X, 2), (X - 1, 2)), (X - 1, 1),
                ((X - 1, 1), (X - 2, 1), (X - 2, 2)))
    if T.north and T.east:
        solve_u((X - 1, Y), ((X - 1, Y), (X - 2, Y), (X - 2, Y + 1)),
                (X - 1, Y + 1), ((X, Y), (X, Y + 1), (X - 1, Y + 1)))
        solve_v((X, Y - 1), ((X, Y - 1), (X, Y - 2), (X + 1, Y - 2)),
                (X + 1, Y - 1), ((X, Y), (X + 1, Y), (X + 1, Y - 1)))
        solve_u((X - 1, Y - 1), ((X - 1, Y), (X - 2, Y), (X - 2, Y - 1)),
                (X - 1, Y - 1), ((X, Y - 1), (X, Y - 2), (X - 1, Y - 2)))
        solve_v((X - 1, Y - 1), ((X, Y - 1), (X, Y - 2), (X - 1, Y - 2)),
                (X - 1, Y - 1), ((X - 1, Y), (X - 2, Y), (X - 2, Y - 1)))
    if T.north and T.west:
        solve_u((2, Y), ((1, Y), (2, Y), (2, Y + 1)), (1, Y + 1),
                ((1, Y), (1, Y + 1), (2, Y + 1)))
        solve_v((0, Y - 1), ((1, Y - 1), (1, Y - 2), (0, Y - 2)), (0, Y - 1),
                ((0, Y), (-1, Y), (-1, Y - 1)))
        solve_u((2, Y - 1), ((1, Y), (2, Y), (2, Y - 1)), (1, Y - 1),
                ((1, Y - 1), (1, Y - 2), (2, Y - 2)))
        solve_v((1, Y - 1), ((1, Y - 1), (1, Y - 2), (2, Y - 2)), (2, Y - 1),
                ((1, Y), (2, Y), (2, Y - 1)))
    return ut, vt


def d_sw(
    delp, pt, u, v, w, uc, vc, ua, va, divg_d,
    xflux, yflux, cx, cy,
    grid, topo, dt, npx,
    hord_mt, hord_vt, hord_tm, hord_dp,
    kcoef, hydrostatic=False,
):
    """One D-grid forward (large-dt) step for the whole npz level batch.

    Returns a dict with updated fields, accumulated flux capacitors,
    advective courant/area fluxes, the saved B-grid divergence and the
    heat source (sw_core_nlm.F90:492-1544).  `kcoef` is the per-level
    sponge-band damping configuration of dyn_core._kcoef (or _kcoef_pert).
    Hydrostatic, w passes through untouched."""
    nord = kcoef["nord"]
    nord_v = kcoef["nord_v"]
    nord_t = kcoef["nord_t"]
    nord_w = kcoef["nord_w"]
    do_vort_damp = kcoef["do_vort_damp"]
    dddmp = kcoef["dddmp"]
    d4_bg = kcoef["d4_bg"]
    kgb = kcoef["ke_bg"]
    d2_divg_k = kcoef["d2_divg"]
    damp_v_k = kcoef["damp_v"]
    damp_w_k = kcoef["damp_w"]
    damp_t_k = kcoef["damp_t"]
    d_con = kcoef["d_con"]
    dcon_k = kcoef["dcon"]
    nord0_k = kcoef["nord0"]
    nordv0_k = kcoef["nordv0"]
    nordt0_k = kcoef["nordt0"]
    nordw0_k = kcoef["nordw0"]
    T, X, Y = tile_of(grid, npx)
    ny, nx = T.ny, T.nx
    jcy, jcx = delp.shape[-2:]
    jby, jbx = jcy + 1, jcx + 1
    p = F2P

    sin_sg = grid["sin_sg"]
    cosa_u = grid["cosa_u"]
    cosa_v = grid["cosa_v"]
    cosa = grid["cosa"]
    rsina = grid["rsina"]
    sina_u = grid["sina_u"]
    sina_v = grid["sina_v"]
    f0 = grid["f0"]
    rarea = grid["rarea"]
    rarea_c = grid["rarea_c"]
    area = grid["area"]
    dx = grid["dx"]
    dy = grid["dy"]
    dxc = grid["dxc"]
    dyc = grid["dyc"]
    rdx = grid["rdx"]
    rdy = grid["rdy"]
    rdxa = grid["rdxa"]
    rdya = grid["rdya"]
    divg_u = grid["divg_u"]
    divg_v = grid["divg_v"]
    da_min_c = grid["da_min_c"]
    da_min = grid["da_min"]
    cosa_s = grid["cosa_s"]
    rsin2 = grid["rsin2"]

    ut, vt = _contravariant_winds(uc, vc, grid, dt, npx)

    # ---------------------------------------------------------------
    # advective courant numbers and area fluxes (:851-900)
    # ---------------------------------------------------------------
    esx = SL(1, X)  # B cols 1..X
    esy = SL(1, Y)
    xfx0 = dt * ut[..., :, esx]                      # (..., jcy, nx+1)
    selx = fbool(xfx0 > 0.0)
    crx = torch.where(selx, xfx0 * rdxa[..., :, p(0):p(nx) + 1],
                      xfx0 * rdxa[..., :, p(1):p(X) + 1])
    xfx = dy[..., :, esx] * xfx0 * torch.where(
        selx, sin_sg[2][..., :, p(0):p(nx) + 1],
        sin_sg[0][..., :, p(1):p(X) + 1])
    yfx0 = dt * vt[..., esy, :]                      # (..., ny+1, jcx)
    sely = fbool(yfx0 > 0.0)
    cry = torch.where(sely, yfx0 * rdya[..., p(0):p(ny) + 1, :],
                      yfx0 * rdya[..., p(1):p(Y) + 1, :])
    yfx = dx[..., esy, :] * yfx0 * torch.where(
        sely, sin_sg[3][..., p(0):p(ny) + 1, :],
        sin_sg[1][..., p(1):p(Y) + 1, :])

    csy = SL(1, ny)  # compute cells
    csx = SL(1, nx)
    ra_x = area[..., :, csx] + (xfx[..., :, :-1] - xfx[..., :, 1:])
    ra_y = area[..., csy, :] + (yfx[..., :-1, :] - yfx[..., 1:, :])

    # ---------------------------------------------------------------
    # delp / w / pt transport (:904-1032)
    # ---------------------------------------------------------------
    if do_vort_damp:
        damp_vk = (damp_v_k * da_min, (damp_v_k * da_min) ** (nord_v + 1),
                   nord_v, nordv0_k)
        damp_tk = (damp_t_k * da_min, (damp_t_k * da_min) ** (nord_t + 1),
                   nord_t, nordt0_k)
    else:
        damp_vk = damp_tk = None
    fx, fy = fv_tp_2d(delp, crx, cry, hord_dp, xfx, yfx, grid, topo,
                      ra_x, ra_y, damp_k=damp_vk)

    cx = cx + crx
    cy = cy + cry
    xflux = xflux + fx
    yflux = yflux + fy

    if hydrostatic:
        heat_source = delp.new_zeros(delp.shape[:-2] + (ny, nx))
    else:
        dd8 = kgb * abs(dt)
        _, fx2w, fy2w = _del6_vt_flux_masked(
            nord_w,
            (damp_w_k * da_min_c, (damp_w_k * da_min_c) ** (nord_w + 1)),
            nordw0_k, w, grid, topo)
        fxw_c = fx2w[..., csy, p(1):p(X) + 1]
        fyw_c = fy2w[..., p(1):p(Y) + 1, csx]
        dw = ((fxw_c[..., :, :-1] - fxw_c[..., :, 1:])
              + (fyw_c[..., :-1, :] - fyw_c[..., 1:, :])) * rarea[..., csy, csx]
        heat_source = dd8 - dw * (w[..., csy, csx] + 0.5 * dw)
        gxw, gyw = fv_tp_2d(w, crx, cry, hord_vt, xfx, yfx, grid, topo,
                            ra_x, ra_y, mfx=fx, mfy=fy)
        w_num = (delp[..., csy, csx] * w[..., csy, csx]
                 + ((gxw[..., :, :-1] - gxw[..., :, 1:])
                    + (gyw[..., :-1, :] - gyw[..., 1:, :]))
                 * rarea[..., csy, csx])

    gx, gy = fv_tp_2d(pt, crx, cry, hord_tm, xfx, yfx, grid, topo, ra_x,
                      ra_y, mfx=fx, mfy=fy, mass=delp, damp_k=damp_tk)

    delp_new = delp.clone()
    delp_new[..., csy, csx] += (((fx[..., :, :-1] - fx[..., :, 1:])
                                 + (fy[..., :-1, :] - fy[..., 1:, :]))
                                * rarea[..., csy, csx])
    pt_new = pt.clone()
    pt_new[..., csy, csx] = (
        pt[..., csy, csx] * delp[..., csy, csx]
        + ((gx[..., :, :-1] - gx[..., :, 1:]) + (gy[..., :-1, :] - gy[..., 1:, :]))
        * rarea[..., csy, csx]
    ) / delp_new[..., csy, csx]

    # ---------------------------------------------------------------
    # kinetic-energy fluxes on the B grid (:1045-1200)
    # ---------------------------------------------------------------
    dt5 = 0.5 * dt
    dt4 = 0.25 * dt
    bsly = SL(1, Y)
    bslx = SL(1, X)
    # the B lines between the face edges: 2..npx-1, across the tile's
    # B lines 1..X (Y) where it has no face edge
    riy = slice(p(2) if T.south else p(1), (p(Y - 1) if T.north else p(Y)) + 1)
    rix = slice(p(2) if T.west else p(1), (p(X - 1) if T.east else p(X)) + 1)

    def sh(s, d):
        return slice(s.start + d, s.stop + d)

    vb = u.new_zeros(u.shape[:-2] + (jby, jbx))
    vb[..., riy, rix] = dt5 * (
        (vc[..., riy, sh(rix, -1)] + vc[..., riy, rix])
        - (uc[..., sh(riy, -1), rix] + uc[..., riy, rix])
        * cosa[..., riy, rix]
    ) * rsina[..., riy, rix]
    if T.west:
        vb[..., riy, p(1)] = dt4 * (-vt[..., riy, p(-1)]
                                    + 3.0 * (vt[..., riy, p(0)]
                                             + vt[..., riy, p(1)])
                                    - vt[..., riy, p(2)])
    if T.east:
        vb[..., riy, p(X)] = dt4 * (-vt[..., riy, p(X - 2)]
                                    + 3.0 * (vt[..., riy, p(X - 1)]
                                             + vt[..., riy, p(X)])
                                    - vt[..., riy, p(X + 1)])
    if T.south:
        vb[..., p(1), bslx] = dt5 * (vt[..., p(1), p(0):p(nx) + 1]
                                     + vt[..., p(1), p(1):p(X) + 1])
    if T.north:
        vb[..., p(Y), bslx] = dt5 * (vt[..., p(Y), p(0):p(nx) + 1]
                                     + vt[..., p(Y), p(1):p(X) + 1])

    ub_f = ytp_v(vb, v, dy, rdy, hord_mt, npx, T)   # flux of v (..., Y, X)
    ke_b = vb[..., bsly, bslx] * ub_f

    ub = u.new_zeros(u.shape[:-2] + (jby, jbx))
    ub[..., bsly, rix] = dt5 * (
        (uc[..., p(0):p(Y - 1) + 1, rix] + uc[..., p(1):p(Y) + 1, rix])
        - (vc[..., bsly, sh(rix, -1)] + vc[..., bsly, rix])
        * cosa[..., bsly, rix]
    ) * rsina[..., bsly, rix]
    if T.south:
        ub[..., p(1), rix] = dt4 * (-ut[..., p(-1), rix]
                                    + 3.0 * (ut[..., p(0), rix]
                                             + ut[..., p(1), rix])
                                    - ut[..., p(2), rix])
    if T.north:
        ub[..., p(Y), rix] = dt4 * (-ut[..., p(Y - 2), rix]
                                    + 3.0 * (ut[..., p(Y - 1), rix]
                                             + ut[..., p(Y), rix])
                                    - ut[..., p(Y + 1), rix])
    if T.west:
        ub[..., bsly, p(1)] = dt5 * (ut[..., p(0):p(ny) + 1, p(1)]
                                     + ut[..., p(1):p(Y) + 1, p(1)])
    if T.east:
        ub[..., bsly, p(X)] = dt5 * (ut[..., p(0):p(ny) + 1, p(X)]
                                     + ut[..., p(1):p(Y) + 1, p(X)])

    vb_f = xtp_u(ub, u, dx, rdx, hord_mt, npx, T)
    ke_b = 0.5 * (ke_b + ub[..., bsly, bslx] * vb_f)

    # corner KE fixes (:1184-1215)
    def at(i, j):
        return (Ellipsis, p(j), p(i))

    dt6 = dt / 6.0
    if T.south and T.west:
        ke_b[..., 0, 0] = dt6 * (
            (ut[at(1, 1)] + ut[at(1, 0)]) * u[..., p(1), p(1)]
            + (vt[at(1, 1)] + vt[at(0, 1)]) * v[..., p(1), p(1)]
            + (ut[at(1, 1)] + vt[at(1, 1)]) * u[..., p(1), p(0)])
    if T.south and T.east:
        ke_b[..., 0, X - 1] = dt6 * (
            (ut[at(X, 1)] + ut[at(X, 0)]) * u[..., p(1), p(X - 1)]
            + (vt[at(X, 1)] + vt[at(X - 1, 1)]) * v[..., p(1), p(X)]
            + (ut[at(X, 1)] - vt[at(X - 1, 1)]) * u[..., p(1), p(X)])
    if T.north and T.east:
        ke_b[..., Y - 1, X - 1] = dt6 * (
            (ut[at(X, Y)] + ut[at(X, Y - 1)]) * u[..., p(Y), p(X - 1)]
            + (vt[at(X, Y)] + vt[at(X - 1, Y)]) * v[..., p(Y - 1), p(X)]
            + (ut[at(X, Y - 1)] + vt[at(X - 1, Y)]) * u[..., p(Y), p(X)])
    if T.north and T.west:
        ke_b[..., Y - 1, 0] = dt6 * (
            (ut[at(1, Y)] + ut[at(1, Y - 1)]) * u[..., p(Y), p(1)]
            + (vt[at(1, Y)] + vt[at(0, Y)]) * v[..., p(Y - 1), p(1)]
            + (ut[at(1, Y - 1)] - vt[at(1, Y)]) * u[..., p(Y), p(0)])
    ke = u.new_zeros(u.shape[:-2] + (jby, jbx))
    ke[..., bsly, bslx] = ke_b

    # ---------------------------------------------------------------
    # circulation components & relative vorticity (:1217-1235)
    # ---------------------------------------------------------------
    vt_c = u * dx      # (..., jby, jcx)
    ut_c = v * dy      # (..., jcy, jbx)
    wk = rarea * ((vt_c[..., 0:jcy, :] - vt_c[..., 1:jcy + 1, :])
                  + (ut_c[..., :, 1:jcx + 1] - ut_c[..., :, 0:jcx]))

    w_new = w
    if not hydrostatic:
        w_new = w.clone()
        w_new[..., csy, csx] = w_num / delp_new[..., csy, csx] + dw

    # ---------------------------------------------------------------
    # divergence damping (:1297-1432)
    # ---------------------------------------------------------------
    bsy, bsx = bsly, bslx

    def _div_damp_d2(uS, vS, vaS, uaS, ucS, vcS, d2kS):
        """del-2 path: B-grid divergence from covariant winds; returns
        (vort_b0 at B 1..X/Y, delpc on the full B array)."""
        csx = SL(0, nx + 1)
        ptc_s = uS.new_zeros(uS.shape[:-2] + (jby, jcx))
        ptc_s[..., bsy, csx] = (
            uS[..., bsy, csx]
            - 0.5 * (vaS[..., p(0):p(Y - 1) + 1, csx]
                     + vaS[..., p(1):p(Y) + 1, csx]) * cosa_v[..., bsy, csx]
        ) * dyc[..., bsy, csx] * sina_v[..., bsy, csx]
        for jrow in [p(1)] * T.south + [p(Y)] * T.north:
            selj = fbool(vcS[..., jrow, csx] > 0.0)
            ptc_s[..., jrow, csx] = (
                uS[..., jrow, csx] * dyc[..., jrow, csx]
                * torch.where(selj, sin_sg[3][..., jrow - 1, csx],
                              sin_sg[1][..., jrow, csx]))
        csy = SL(0, ny + 1)
        vort_s = uS.new_zeros(uS.shape[:-2] + (jcy, jbx))
        vort_s[..., csy, rix] = (
            vS[..., csy, rix]
            - 0.5 * (uaS[..., csy, sh(rix, -1)]
                     + uaS[..., csy, rix]) * cosa_u[..., csy, rix]
        ) * dxc[..., csy, rix] * sina_u[..., csy, rix]
        for icol in [p(1)] * T.west + [p(X)] * T.east:
            seli = fbool(ucS[..., csy, icol] > 0.0)
            vort_s[..., csy, icol] = (
                vS[..., csy, icol] * dxc[..., csy, icol]
                * torch.where(seli, sin_sg[2][..., csy, icol - 1],
                              sin_sg[0][..., csy, icol]))
        delpc_b = (vort_s[..., p(0):p(Y - 1) + 1, bsx]
                   - vort_s[..., p(1):p(Y) + 1, bsx]
                   + ptc_s[..., bsy, p(0):p(X - 1) + 1]
                   - ptc_s[..., bsy, p(1):p(X) + 1])
        # 3-term corner formulas, set directly
        if T.south and T.west:
            delpc_b[..., 0, 0] = (-vort_s[..., p(1), p(1)]
                                  + ptc_s[..., p(1), p(0)]
                                  - ptc_s[..., p(1), p(1)])
        if T.south and T.east:
            delpc_b[..., 0, X - 1] = (-vort_s[..., p(1), p(X)]
                                      + ptc_s[..., p(1), p(X - 1)]
                                      - ptc_s[..., p(1), p(X)])
        if T.north and T.east:
            delpc_b[..., Y - 1, X - 1] = (vort_s[..., p(Y - 1), p(X)]
                                          + ptc_s[..., p(Y), p(X - 1)]
                                          - ptc_s[..., p(Y), p(X)])
        if T.north and T.west:
            delpc_b[..., Y - 1, 0] = (vort_s[..., p(Y - 1), p(1)]
                                      + ptc_s[..., p(Y), p(0)]
                                      - ptc_s[..., p(Y), p(1)])
        delpc_b = rarea_c[..., bsy, bsx] * delpc_b
        dampc = da_min_c * fmax(d2kS, fmin(0.20, dddmp * fabs(delpc_b * dt)))
        vort_b0 = dampc * delpc_b
        delpc_full = uS.new_zeros(uS.shape[:-2] + (jby, jbx))
        delpc_full[..., bsy, bsx] = delpc_b
        return vort_b0, delpc_full

    def _div_damp_dn(divg_dS, wkS, d2kS):
        """del-(2nord+2) path on divg_d; returns (vort_bn at B 1..X/Y, dd)."""
        dd = divg_dS
        n2 = nord + 1
        for nloop in range(1, nord + 1):
            fill_c = nord - nloop != 0
            if fill_c:
                dd = halo.fill_corners_scalar(dd, topo, "bgrid", 1)
            vcd = dd.new_zeros(dd.shape[:-2] + (jby, jcx))
            vcd[..., :, 0:jcx] = (dd[..., :, 1:jcx + 1]
                                  - dd[..., :, 0:jcx]) * divg_u
            if fill_c:
                dd = halo.fill_corners_scalar(dd, topo, "bgrid", 2)
            ucd = dd.new_zeros(dd.shape[:-2] + (jcy, jbx))
            ucd[..., 0:jcy, :] = (dd[..., 1:jcy + 1, :]
                                  - dd[..., 0:jcy, :]) * divg_v
            if fill_c:
                vcd, ucd = halo.fill_corners_vector(vcd, ucd, topo, "dgrid")
            dd_new = torch.zeros_like(dd)
            dd_new[..., 1:jcy, 1:jcx] = (
                (ucd[..., 0:jcy - 1, 1:jcx] - ucd[..., 1:jcy, 1:jcx])
                + (vcd[..., 1:jcy, 0:jcx - 1] - vcd[..., 1:jcy, 1:jcx]))
            if T.south and T.west:
                dd_new[..., p(1), p(1)] = (-ucd[..., p(1), p(1)]
                                           + vcd[..., p(1), p(0)]
                                           - vcd[..., p(1), p(1)])
            if T.south and T.east:
                dd_new[..., p(1), p(X)] = (-ucd[..., p(1), p(X)]
                                           + vcd[..., p(1), p(X - 1)]
                                           - vcd[..., p(1), p(X)])
            if T.north and T.east:
                dd_new[..., p(Y), p(X)] = (ucd[..., p(Y - 1), p(X)]
                                           + vcd[..., p(Y), p(X - 1)]
                                           - vcd[..., p(Y), p(X)])
            if T.north and T.west:
                dd_new[..., p(Y), p(1)] = (ucd[..., p(Y - 1), p(1)]
                                           + vcd[..., p(Y), p(0)]
                                           - vcd[..., p(Y), p(1)])
            dd = dd_new * rarea_c
        if dddmp < 1.0e-5:
            vort_sm = dd.new_zeros(dd.shape[:-2] + (Y, X))
        else:
            wkb = a2b_ord4(wkS, grid)
            sm2 = divg_dS[..., bsy, bsx] ** 2 + wkb[..., bsy, bsx] ** 2
            smpos = fbool(sm2 > 0.0)
            vort_sm = abs(dt) * torch.where(
                smpos, torch.sqrt(torch.where(smpos, sm2, 1.0)), 0.0)
        dd8 = (da_min_c * d4_bg) ** n2
        damp2 = da_min_c * fmax(d2kS, fmin(0.20, dddmp * vort_sm))
        vort_bn = damp2 * divg_dS[..., bsy, bsx] + dd8 * dd[..., bsy, bsx]
        return vort_bn, dd

    # del-2 levels [0, k0) (some of them del-n when `mixed`), del-n after
    k0, mixed = mask_band(nord0_k) if nord > 0 else (0, False)
    if nord == 0:
        vort_b, delpc_full = _div_damp_d2(u, v, va, ua, uc, vc, d2_divg_k)
        divd_saved = delpc_full
        divg_d_new = divg_d
    elif k0 == 0:
        vort_b, dd = _div_damp_dn(divg_d, wk, d2_divg_k)
        divd_saved = divg_d
        divg_d_new = dd
    else:
        vort_bA, delpcA = _div_damp_d2(
            u[:k0], v[:k0], va[:k0], ua[:k0], uc[:k0], vc[:k0],
            d2_divg_k[:k0])
        dsavA, dnewA = delpcA, divg_d[:k0]
        if mixed:
            vort_bAn, ddA = _div_damp_dn(divg_d[:k0], wk[:k0], d2_divg_k[:k0])
            mA = _mask(nord0_k[:k0], u)
            vort_bA = torch.where(mA, vort_bA, vort_bAn)
            dsavA = torch.where(mA, delpcA, divg_d[:k0])
            dnewA = torch.where(mA, divg_d[:k0], ddA)
        if k0 < u.shape[0]:
            vort_bB, ddB = _div_damp_dn(divg_d[k0:], wk[k0:], d2_divg_k[k0:])
            vort_b = torch.cat([vort_bA, vort_bB], dim=0)
            divd_saved = torch.cat([dsavA, divg_d[k0:]], dim=0)
            divg_d_new = torch.cat([dnewA, ddB], dim=0)
        else:
            vort_b, divd_saved, divg_d_new = vort_bA, dsavA, dnewA
    ke[..., bsy, bsx] += vort_b

    # ---------------------------------------------------------------
    # absolute-vorticity transport & wind update (:1450-1486)
    # ---------------------------------------------------------------
    vort_a = wk + f0
    fxv, fyv = fv_tp_2d(vort_a, crx, cry, hord_vt, xfx, yfx, grid, topo,
                        ra_x, ra_y)
    u_c = (vt_c[..., bsy, csx]
           + (ke[..., bsy, p(1):p(nx) + 1] - ke[..., bsy, p(2):p(X) + 1])
           + fyv)
    v_c = (ut_c[..., csy, bsx]
           + (ke[..., p(1):p(ny) + 1, bsx] - ke[..., p(2):p(Y) + 1, bsx])
           - fxv)
    if do_vort_damp:
        # vorticity damping (:1490-1494)
        _, fx2d, fy2d = _del6_vt_flux_masked(
            nord_v,
            (damp_v_k * da_min_c, (damp_v_k * da_min_c) ** (nord_v + 1)),
            nordv0_k, wk, grid, topo)
    if d_con > 1.0e-5:
        # heating due to the damping (:1436-1448, 1496-1530)
        ub_h = vort_b[..., :, 0:nx] - vort_b[..., :, 1:X]
        vb_h = vort_b[..., 0:ny, :] - vort_b[..., 1:Y, :]
        if do_vort_damp:
            ub_h = ub_h + fy2d[..., bsy, csx]
            vb_h = vb_h - fx2d[..., csy, bsx]
        ub_h2 = ub_h * rdx[..., bsy, csx]
        fy_h = u_c * rdx[..., bsy, csx]
        gy_h = fy_h * ub_h2
        vb_h2 = vb_h * rdy[..., csy, bsx]
        fx_h = v_c * rdy[..., csy, bsx]
        gx_h = fx_h * vb_h2
        dampc2 = 0.25 * dcon_k
        u2 = fy_h[..., 0:ny, :] + fy_h[..., 1:ny + 1, :]
        du2 = ub_h2[..., 0:ny, :] + ub_h2[..., 1:ny + 1, :]
        v2 = fx_h[..., :, 0:nx] + fx_h[..., :, 1:nx + 1]
        dv2 = vb_h2[..., :, 0:nx] + vb_h2[..., :, 1:nx + 1]
        heat_source = delp_new[..., csy, csx] * (
            heat_source - dampc2 * rsin2[..., csy, csx] * (
                (ub_h2[..., 0:ny, :] ** 2 + ub_h2[..., 1:ny + 1, :] ** 2
                 + vb_h2[..., :, 0:nx] ** 2 + vb_h2[..., :, 1:nx + 1] ** 2)
                + 2.0 * (gy_h[..., 0:ny, :] + gy_h[..., 1:ny + 1, :]
                         + gx_h[..., :, 0:nx] + gx_h[..., :, 1:nx + 1])
                - cosa_s[..., csy, csx] * (u2 * dv2 + v2 * du2 + du2 * dv2)))
    if do_vort_damp:
        # add the diffusive fluxes to the momentum (:1533-1543)
        u_c = u_c + fy2d[..., bsy, csx]
        v_c = v_c + (-fx2d[..., csy, bsx])
    u_new = u.clone()
    u_new[..., bsy, csx] = u_c
    v_new = v.clone()
    v_new[..., csy, bsx] = v_c

    return dict(
        delp=delp_new, pt=pt_new, u=u_new, v=v_new, w=w_new,
        divg_d=divg_d_new, divd_b=divd_saved,
        cx=cx, cy=cy, xflux=xflux, yflux=yflux,
        crx=crx, cry=cry, xfx=xfx, yfx=yfx,
        heat_source=heat_source,
    )
