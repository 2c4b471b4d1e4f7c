"""D-grid Lin-Rood forward step (d_sw) and B-point wind advection (xtp_u/ytp_v).

Counterpart of fv3jedi_lm_tpu/ops/d_sw.py (model/sw_core_nlm.F90: `d_sw`
:492-1544, `xtp_u` :1970, `ytp_v` :2312): hydrostatic and
nonhydrostatic, the trajectory schemes hord 8/9 and the perturbation
schemes (also as a per-level band, see ppm.xppm), with vorticity
damping and the d_con damping heat.

Shapes (n cells/side, jc = n+2ng, jb = jc+1; leading dims broadcast):
  u, vt, divg_u : (..., 6, jb, jc)   rows = B lines, cols = cells
  v, ut, divg_v : (..., 6, jc, jb)
  uc            : (..., 6, jc, jb)   C-grid u (cols = B)
  vc            : (..., 6, jb, jc)
  delp/pt/w/wk  : (..., 6, jc, jc)
  B-point arrays: (..., 6, jb, jb)
"""

from __future__ import annotations

import torch

from .. import NG
from ..core.freeze import fabs, fbool, fmax, fmin, fsign_mul, fwhere
from ..parallel import halo
from . import ppm
from .a2b_edge import a2b_ord4
from .ppm import C1, C2, C3, P1, P2
from .sw_core import F2P, SL, del6_vt_flux
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


def _zero_ends(x):
    """x with the first and last line of the other axis set to zero (the
    perpendicular-edge zeroing at j==1 / j==npy)."""
    out = x.clone()
    out[..., 0] = 0.0
    out[..., -1] = 0.0
    return out


def _flux_low(q, cb, iord, dxm, npx, A, qL, qR, rdxL, rdxR):
    """The schemes iord 2-7 with their face-edge fixes (sw_core_nlm.F90
    xtp_u iord < 8)."""
    ic = A.size(q)
    n = ic - 2 * NG
    p = F2P
    b0s = p(1)
    z2 = A.zeros_like_w(q, 2)
    al = A.cat([z2, P1 * (A.rng(q, 1, ic - 2) + A.rng(q, 2, ic - 1))
                + P2 * (A.rng(q, 0, ic - 3) + A.rng(q, 3, ic)), z2])
    bl = A.rng(al, 0, ic) - q
    br = A.rng(al, 1, ic + 1) - q
    # west edge fixes (cells 0, 1, 2 -> padded p(0)..p(2))
    i1 = p(1)
    xt = C3 * A.get(q, i1) + C2 * A.get(q, i1 + 1) + C1 * A.get(q, i1 + 2)
    br_i1_a = xt - A.get(q, i1)
    bl_i1p1 = xt - A.get(q, i1 + 1)
    br_i1p1 = A.get(al, i1 + 3) - A.get(q, i1 + 1)
    bl0 = (C1 * A.get(q, i1 - 3) + C2 * A.get(q, i1 - 2)
           + C3 * A.get(q, i1 - 1) - A.get(q, i1 - 1))
    xte = _edge_2sided(q, dxm, i1, A)
    br0 = xte - A.get(q, i1 - 1)
    bl1 = xte - A.get(q, i1)
    # east edge (cells npx-2, npx-1, npx)
    iN = p(npx - 2)
    bl_iN = A.get(al, iN) - A.get(q, iN)
    xt = C1 * A.get(q, iN - 1) + C2 * A.get(q, iN) + C3 * A.get(q, iN + 1)
    br_iN = xt - A.get(q, iN)
    bl_iNp1_a = xt - A.get(q, iN + 1)
    xte = _edge_2sided(q, dxm, p(npx), A)
    brN1 = xte - A.get(q, iN + 1)
    blN2 = xte - A.get(q, iN + 2)
    brN2 = (C3 * A.get(q, iN + 2) + C2 * A.get(q, iN + 3)
            + C1 * A.get(q, iN + 4) - A.get(q, iN + 2))
    bl = ppm.set_cols(bl, [(i1 - 1, _zero_ends(bl0)), (i1, _zero_ends(bl1)),
                           (i1 + 1, bl_i1p1), (iN, bl_iN),
                           (iN + 1, _zero_ends(bl_iNp1_a)),
                           (iN + 2, _zero_ends(blN2))], A)
    br = ppm.set_cols(br, [(i1 - 1, _zero_ends(br0)),
                           (i1, _zero_ends(br_i1_a)), (i1 + 1, br_i1p1),
                           (iN, br_iN), (iN + 1, _zero_ends(brN1)),
                           (iN + 2, _zero_ends(brN2))], A)
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


def _xtp_flux(q, cb, iord, dxm, rdxm, npx, A):
    """Advective flux of a D-grid wind component along its own line, iord
    1-13 (sw_core_nlm.F90:1970-2306).

    Works along axis `A.ax` (-1 for xtp_u rows, -2 for ytp_v columns).
    q: cells, width jc along A.ax; cb: courant at B indices 1..npx;
    dxm/rdxm metric aligned with q.  Returns the flux, width n+1."""
    if not 1 <= iord <= 13:
        raise ValueError(f"xtp_u/ytp_v iord={iord!r}: the schemes are 1-13")
    ic = A.size(q)
    n = ic - 2 * NG
    p = F2P
    b0s = p(1)  # python index of B point 1
    qL = A.rng(q, b0s - 1, b0s + n)
    qR = A.rng(q, b0s, b0s + n + 1)
    rdxL = A.rng(rdxm, b0s - 1, b0s + n)
    rdxR = A.rng(rdxm, b0s, b0s + n + 1)
    if iord == 1:
        return fwhere(cb > 0.0, qL, qR)
    if iord < 8:
        return _flux_low(q, cb, iord, dxm, npx, A, qL, qR, rdxL, rdxR)

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

    # west edge (sw_core_nlm.F90:2237-2261)
    i1 = p(1)
    br_i1p1_a = A.get(al, i1 + 3) - A.get(q, i1 + 1)
    xt = (S15 * A.get(q, i1) + S11 * A.get(q, i1 + 1)
          - S14 * A.get(dm, i1 + 1))
    bl_i1p1_a = xt - A.get(q, i1 + 1)
    br_i1_a = xt - A.get(q, i1)
    bl0 = S14 * A.get(dm, i1 - 2) - S11 * A.get(dq, i1 - 2)
    xte = _edge_2sided(q, dxm, i1, A)
    bl_i1m1 = _zero_ends(bl0)
    br_i1m1 = _zero_ends(xte - A.get(q, i1 - 1))
    bl_i1 = _zero_ends(xte - A.get(q, i1))
    br_i1 = _zero_ends(br_i1_a)
    b2l, b2r = ppm.pert_ppm(A.rng(q, i1 + 1, i1 + 2), A.exp(bl_i1p1_a),
                            A.exp(br_i1p1_a), 1)
    bl_i1p1 = A.get(b2l, 0)
    br_i1p1 = A.get(b2r, 0)

    # east edge (:2264-2290)
    iN = p(npx - 2)
    bl_iN_a = A.get(al, iN) - A.get(q, iN)
    xt = (S15 * A.get(q, iN + 1) + S11 * A.get(q, iN)
          + S14 * A.get(dm, iN))
    br_iN_a = xt - A.get(q, iN)
    bl_iNp1_a = xt - A.get(q, iN + 1)
    brN2 = S11 * A.get(dq, iN + 2) - S14 * A.get(dm, iN + 3)
    xte = _edge_2sided(q, dxm, p(npx), A)
    bl_iNp1 = _zero_ends(bl_iNp1_a)
    br_iNp1 = _zero_ends(xte - A.get(q, iN + 1))
    bl_iNp2 = _zero_ends(xte - A.get(q, iN + 2))
    br_iNp2 = _zero_ends(brN2)
    b2l, b2r = ppm.pert_ppm(A.rng(q, iN, iN + 1), A.exp(bl_iN_a),
                            A.exp(br_iN_a), 1)
    bl_iN = A.get(b2l, 0)
    br_iN = A.get(b2r, 0)

    bl = ppm.set_cols(bl, [(i1 - 1, bl_i1m1), (i1, bl_i1), (i1 + 1, bl_i1p1),
                           (iN, bl_iN), (iN + 1, bl_iNp1), (iN + 2, bl_iNp2)],
                      A)
    br = ppm.set_cols(br, [(i1 - 1, br_i1m1), (i1, br_i1), (i1 + 1, br_i1p1),
                           (iN, br_iN), (iN + 1, br_iNp1), (iN + 2, br_iNp2)],
                      A)

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


def xtp_u(cb, u, dx, rdx, iord, npx):
    """Flux of u along x at B points (sw_core_nlm.F90:1970).

    cb: (..., jb, jb) courant (only B 1..npx read); u: (..., jb, jc).
    Returns (..., npx, npx) flux at B points (j, i) in [1, npx]^2.
    `iord` may be a per-level band (main, sponge, ksp), see ppm.xppm."""
    if isinstance(iord, tuple):
        main, sponge, ksp = iord
        return torch.cat([xtp_u(cb[:ksp], u[:ksp], dx, rdx, sponge, npx),
                          xtp_u(cb[ksp:], u[ksp:], dx, rdx, main, npx)])
    bs = SL(1, npx)
    return _xtp_flux(u[..., bs, :], cb[..., bs, bs], iord,
                     dx[..., bs, :], rdx[..., bs, :], npx, ppm._AXX)


def ytp_v(cb, v, dy, rdy, jord, npx):
    """Flux of v along y at B points (sw_core_nlm.F90:2312): the same
    operator along axis -2."""
    if isinstance(jord, tuple):
        main, sponge, ksp = jord
        return torch.cat([ytp_v(cb[:ksp], v[:ksp], dy, rdy, sponge, npx),
                          ytp_v(cb[ksp:], v[ksp:], dy, rdy, main, npx)])
    bs = SL(1, npx)
    return _xtp_flux(v[..., :, bs], cb[..., bs, bs], jord,
                     dy[..., :, bs], rdy[..., :, bs], npx, ppm._AXY)


def _contravariant_winds(uc, vc, grid, dt, npx):
    """Contravariant C-grid winds ut/vt with the cube-edge and corner
    fixes (sw_core_nlm.F90:650-840)."""
    n = npx - 1
    npy = npx
    jc = n + 2 * NG
    p = F2P
    sin_sg = grid["sin_sg"]
    cosa_u = grid["cosa_u"]
    cosa_v = grid["cosa_v"]
    rsin_u = grid["rsin_u"]
    rsin_v = grid["rsin_v"]

    # interior formula; rows j in {0, 1, npy-1, npy} stay zero
    ut = torch.zeros_like(uc)
    ut[..., 0:jc, 1:jc] = (
        uc[..., 0:jc, 1:jc]
        - 0.25 * cosa_u[..., 0:jc, 1:jc]
        * (vc[..., 0:jc, 0:jc - 1] + vc[..., 0:jc, 1:jc]
           + vc[..., 1:jc + 1, 0:jc - 1] + vc[..., 1:jc + 1, 1:jc])
    ) * rsin_u[..., 0:jc, 1:jc]
    for j in (0, 1, npy - 1, npy):
        ut[..., p(j), :] = 0.0

    vt = torch.zeros_like(vc)
    vt[..., 1:jc, 0:jc] = (
        vc[..., 1:jc, 0:jc]
        - 0.25 * cosa_v[..., 1:jc, 0:jc]
        * (uc[..., 0:jc - 1, 0:jc] + uc[..., 0:jc - 1, 1:jc + 1]
           + uc[..., 1:jc, 0:jc] + uc[..., 1:jc, 1:jc + 1])
    ) * rsin_v[..., 1:jc, 0:jc]
    for j in (1, npy):
        vt[..., p(j), :] = 0.0

    # west/east edge cols: ut = uc / sin_sg (:687-694)
    for e in (p(1), p(npx)):
        sel = fbool(uc[..., :, e] * dt > 0.0)
        ut[..., :, e] = uc[..., :, e] / torch.where(
            sel, sin_sg[2][..., :, e - 1], sin_sg[0][..., :, e])
    # south/north edge rows for vt (:718-743)
    for e in (p(1), p(npy)):
        sel = fbool(vc[..., e, :] * dt > 0.0)
        vt[..., e, :] = vc[..., e, :] / torch.where(
            sel, sin_sg[3][..., e - 1, :], sin_sg[1][..., e, :])

    # secondary edge fixes (no rsin factor), sw_core_nlm.F90:696-749
    rs2 = SL(3, npy - 2)
    utm = SL(2, npy - 3)
    ut0 = SL(3, npy - 2)
    for i0 in (0, 1, npx - 1, npx):
        c0 = p(i0)
        vt[..., rs2, c0] = (
            vc[..., rs2, c0]
            - 0.25 * cosa_v[..., rs2, c0]
            * (ut[..., utm, c0] + ut[..., utm, c0 + 1]
               + ut[..., ut0, c0] + ut[..., ut0, c0 + 1]))
    cs2 = SL(3, npx - 2)
    vtm = SL(2, npx - 3)
    vt0 = SL(3, npx - 2)
    for j0 in (0, 1, npy - 1, npy):
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

    X = npx
    Y = npy
    # sw corner
    solve_u((2, 0), ((1, 1), (2, 1), (2, 0)), (1, 0),
            ((1, 0), (1, -1), (2, -1)))
    solve_v((0, 2), ((1, 1), (1, 2), (0, 2)), (0, 1),
            ((0, 1), (-1, 1), (-1, 2)))
    solve_u((2, 1), ((1, 1), (2, 1), (2, 2)), (1, 2),
            ((1, 1), (1, 2), (2, 2)))
    solve_v((1, 2), ((1, 1), (1, 2), (2, 2)), (2, 1),
            ((1, 1), (2, 1), (2, 2)))
    # se corner
    solve_u((X - 1, 0), ((X - 1, 1), (X - 2, 1), (X - 2, 0)), (X - 1, 0),
            ((X, 0), (X, -1), (X - 1, -1)))
    solve_v((X, 2), ((X, 1), (X, 2), (X + 1, 2)), (X + 1, 1),
            ((X, 1), (X + 1, 1), (X + 1, 2)))
    solve_u((X - 1, 1), ((X - 1, 1), (X - 2, 1), (X - 2, 2)), (X - 1, 2),
            ((X, 1), (X, 2), (X - 1, 2)))
    solve_v((X - 1, 2), ((X, 1), (X, 2), (X - 1, 2)), (X - 1, 1),
            ((X - 1, 1), (X - 2, 1), (X - 2, 2)))
    # ne corner
    solve_u((X - 1, Y), ((X - 1, Y), (X - 2, Y), (X - 2, Y + 1)),
            (X - 1, Y + 1), ((X, Y), (X, Y + 1), (X - 1, Y + 1)))
    solve_v((X, Y - 1), ((X, Y - 1), (X, Y - 2), (X + 1, Y - 2)),
            (X + 1, Y - 1), ((X, Y), (X + 1, Y), (X + 1, Y - 1)))
    solve_u((X - 1, Y - 1), ((X - 1, Y), (X - 2, Y), (X - 2, Y - 1)),
            (X - 1, Y - 1), ((X, Y - 1), (X, Y - 2), (X - 1, Y - 2)))
    solve_v((X - 1, Y - 1), ((X, Y - 1), (X, Y - 2), (X - 1, Y - 2)),
            (X - 1, Y - 1), ((X - 1, Y), (X - 2, Y), (X - 2, Y - 1)))
    # nw corner
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
    n = npx - 1
    npy = npx
    jc = n + 2 * NG
    jb = jc + 1
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
    es = SL(1, npx)  # B cols 1..npx
    xfx0 = dt * ut[..., :, es]                       # (..., jc, n+1)
    selx = fbool(xfx0 > 0.0)
    crx = torch.where(selx, xfx0 * rdxa[..., :, p(0):p(n) + 1],
                      xfx0 * rdxa[..., :, p(1):p(npx) + 1])
    xfx = dy[..., :, es] * xfx0 * torch.where(
        selx, sin_sg[2][..., :, p(0):p(n) + 1],
        sin_sg[0][..., :, p(1):p(npx) + 1])
    yfx0 = dt * vt[..., es, :]                       # (..., n+1, jc)
    sely = fbool(yfx0 > 0.0)
    cry = torch.where(sely, yfx0 * rdya[..., p(0):p(n) + 1, :],
                      yfx0 * rdya[..., p(1):p(npy) + 1, :])
    yfx = dx[..., es, :] * yfx0 * torch.where(
        sely, sin_sg[3][..., p(0):p(n) + 1, :],
        sin_sg[1][..., p(1):p(npy) + 1, :])

    cs = SL(1, n)  # compute cells
    ra_x = area[..., :, cs] + (xfx[..., :, :-1] - xfx[..., :, 1:])
    ra_y = area[..., cs, :] + (yfx[..., :-1, :] - yfx[..., 1:, :])

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
        heat_source = delp.new_zeros(delp.shape[:-2] + (n, n))
    else:
        dd8 = kgb * abs(dt)
        _, fx2w, fy2w = _del6_vt_flux_masked(
            nord_w,
            (damp_w_k * da_min_c, (damp_w_k * da_min_c) ** (nord_w + 1)),
            nordw0_k, w, grid, topo)
        fxw_c = fx2w[..., cs, p(1):p(npx) + 1]
        fyw_c = fy2w[..., p(1):p(npy) + 1, cs]
        dw = ((fxw_c[..., :, :-1] - fxw_c[..., :, 1:])
              + (fyw_c[..., :-1, :] - fyw_c[..., 1:, :])) * rarea[..., cs, cs]
        heat_source = dd8 - dw * (w[..., cs, cs] + 0.5 * dw)
        gxw, gyw = fv_tp_2d(w, crx, cry, hord_vt, xfx, yfx, grid, topo,
                            ra_x, ra_y, mfx=fx, mfy=fy)
        w_num = (delp[..., cs, cs] * w[..., cs, cs]
                 + ((gxw[..., :, :-1] - gxw[..., :, 1:])
                    + (gyw[..., :-1, :] - gyw[..., 1:, :]))
                 * rarea[..., cs, cs])

    gx, gy = fv_tp_2d(pt, crx, cry, hord_tm, xfx, yfx, grid, topo, ra_x,
                      ra_y, mfx=fx, mfy=fy, mass=delp, damp_k=damp_tk)

    delp_new = delp.clone()
    delp_new[..., cs, cs] += (((fx[..., :, :-1] - fx[..., :, 1:])
                               + (fy[..., :-1, :] - fy[..., 1:, :]))
                              * rarea[..., cs, cs])
    pt_new = pt.clone()
    pt_new[..., cs, cs] = (
        pt[..., cs, cs] * delp[..., cs, cs]
        + ((gx[..., :, :-1] - gx[..., :, 1:]) + (gy[..., :-1, :] - gy[..., 1:, :]))
        * rarea[..., cs, cs]
    ) / delp_new[..., cs, cs]

    # ---------------------------------------------------------------
    # kinetic-energy fluxes on the B grid (:1045-1200)
    # ---------------------------------------------------------------
    dt5 = 0.5 * dt
    dt4 = 0.25 * dt
    bsl = SL(1, npx)
    ri = SL(2, npy - 1)
    vb = u.new_zeros(u.shape[:-2] + (jb, jb))
    vb[..., ri, ri] = dt5 * (
        (vc[..., ri, p(1):p(npx - 2) + 1] + vc[..., ri, p(2):p(npx - 1) + 1])
        - (uc[..., p(1):p(npy - 2) + 1, ri] + uc[..., p(2):p(npy - 1) + 1, ri])
        * cosa[..., ri, ri]
    ) * rsina[..., ri, ri]
    vb[..., ri, p(1)] = dt4 * (-vt[..., ri, p(-1)]
                               + 3.0 * (vt[..., ri, p(0)] + vt[..., ri, p(1)])
                               - vt[..., ri, p(2)])
    vb[..., ri, p(npx)] = dt4 * (-vt[..., ri, p(npx - 2)]
                                 + 3.0 * (vt[..., ri, p(npx - 1)]
                                          + vt[..., ri, p(npx)])
                                 - vt[..., ri, p(npx + 1)])
    vb[..., p(1), bsl] = dt5 * (vt[..., p(1), p(0):p(n) + 1]
                                + vt[..., p(1), p(1):p(npx) + 1])
    vb[..., p(npy), bsl] = dt5 * (vt[..., p(npy), p(0):p(n) + 1]
                                  + vt[..., p(npy), p(1):p(npx) + 1])

    ub_f = ytp_v(vb, v, dy, rdy, hord_mt, npx)   # flux of v (..., npx, npx)
    ke_b = vb[..., bsl, bsl] * ub_f

    rall = SL(1, npy)
    ub = u.new_zeros(u.shape[:-2] + (jb, jb))
    ub[..., rall, ri] = dt5 * (
        (uc[..., p(0):p(npy - 1) + 1, ri] + uc[..., p(1):p(npy) + 1, ri])
        - (vc[..., rall, p(1):p(npx - 2) + 1] + vc[..., rall, p(2):p(npx - 1) + 1])
        * cosa[..., rall, ri]
    ) * rsina[..., rall, ri]
    ub[..., p(1), ri] = dt4 * (-ut[..., p(-1), ri]
                               + 3.0 * (ut[..., p(0), ri] + ut[..., p(1), ri])
                               - ut[..., p(2), ri])
    ub[..., p(npy), ri] = dt4 * (-ut[..., p(npy - 2), ri]
                                 + 3.0 * (ut[..., p(npy - 1), ri]
                                          + ut[..., p(npy), ri])
                                 - ut[..., p(npy + 1), ri])
    ub[..., rall, p(1)] = dt5 * (ut[..., p(0):p(n) + 1, p(1)]
                                 + ut[..., p(1):p(npy) + 1, p(1)])
    ub[..., rall, p(npx)] = dt5 * (ut[..., p(0):p(n) + 1, p(npx)]
                                   + ut[..., p(1):p(npy) + 1, p(npx)])

    vb_f = xtp_u(ub, u, dx, rdx, hord_mt, npx)
    ke_b = 0.5 * (ke_b + ub[..., bsl, bsl] * vb_f)

    # corner KE fixes (:1184-1215)
    def at(i, j):
        return (Ellipsis, p(j), p(i))

    dt6 = dt / 6.0
    X = npx
    Y = npy
    ke_b[..., 0, 0] = dt6 * (
        (ut[at(1, 1)] + ut[at(1, 0)]) * u[..., p(1), p(1)]
        + (vt[at(1, 1)] + vt[at(0, 1)]) * v[..., p(1), p(1)]
        + (ut[at(1, 1)] + vt[at(1, 1)]) * u[..., p(1), p(0)])
    ke_b[..., 0, X - 1] = dt6 * (
        (ut[at(X, 1)] + ut[at(X, 0)]) * u[..., p(1), p(X - 1)]
        + (vt[at(X, 1)] + vt[at(X - 1, 1)]) * v[..., p(1), p(X)]
        + (ut[at(X, 1)] - vt[at(X - 1, 1)]) * u[..., p(1), p(X)])
    ke_b[..., Y - 1, X - 1] = dt6 * (
        (ut[at(X, Y)] + ut[at(X, Y - 1)]) * u[..., p(Y), p(X - 1)]
        + (vt[at(X, Y)] + vt[at(X - 1, Y)]) * v[..., p(Y - 1), p(X)]
        + (ut[at(X, Y - 1)] + vt[at(X - 1, Y)]) * u[..., p(Y), p(X)])
    ke_b[..., Y - 1, 0] = dt6 * (
        (ut[at(1, Y)] + ut[at(1, Y - 1)]) * u[..., p(Y), p(1)]
        + (vt[at(1, Y)] + vt[at(0, Y)]) * v[..., p(Y - 1), p(1)]
        + (ut[at(1, Y - 1)] - vt[at(1, Y)]) * u[..., p(Y), p(0)])
    ke = u.new_zeros(u.shape[:-2] + (jb, jb))
    ke[..., bsl, bsl] = ke_b

    # ---------------------------------------------------------------
    # circulation components & relative vorticity (:1217-1235)
    # ---------------------------------------------------------------
    vt_c = u * dx      # (..., jb, jc)
    ut_c = v * dy      # (..., jc, jb)
    wk = rarea * ((vt_c[..., 0:jc, :] - vt_c[..., 1:jc + 1, :])
                  + (ut_c[..., :, 1:jc + 1] - ut_c[..., :, 0:jc]))

    w_new = w
    if not hydrostatic:
        w_new = w.clone()
        w_new[..., cs, cs] = w_num / delp_new[..., cs, cs] + dw

    # ---------------------------------------------------------------
    # divergence damping (:1297-1432)
    # ---------------------------------------------------------------
    bs = SL(1, npx)

    def _div_damp_d2(uS, vS, vaS, uaS, ucS, vcS, d2kS):
        """del-2 path: B-grid divergence from covariant winds; returns
        (vort_b0 at B 1..npx, delpc on the full B array)."""
        csx = SL(0, n + 1)
        ptc_s = uS.new_zeros(uS.shape[:-2] + (jb, jc))
        ptc_s[..., bs, csx] = (
            uS[..., bs, csx]
            - 0.5 * (vaS[..., p(0):p(npy - 1) + 1, csx]
                     + vaS[..., p(1):p(npy) + 1, csx]) * cosa_v[..., bs, csx]
        ) * dyc[..., bs, csx] * sina_v[..., bs, csx]
        for jrow in (p(1), p(npy)):
            selj = fbool(vcS[..., jrow, csx] > 0.0)
            ptc_s[..., jrow, csx] = (
                uS[..., jrow, csx] * dyc[..., jrow, csx]
                * torch.where(selj, sin_sg[3][..., jrow - 1, csx],
                              sin_sg[1][..., jrow, csx]))
        csy = SL(0, n + 1)
        is2 = SL(2, npx - 1)
        vort_s = uS.new_zeros(uS.shape[:-2] + (jc, jb))
        vort_s[..., csy, is2] = (
            vS[..., csy, is2]
            - 0.5 * (uaS[..., csy, p(1):p(npx - 2) + 1]
                     + uaS[..., csy, p(2):p(npx - 1) + 1]) * cosa_u[..., csy, is2]
        ) * dxc[..., csy, is2] * sina_u[..., csy, is2]
        for icol in (p(1), p(npx)):
            seli = fbool(ucS[..., csy, icol] > 0.0)
            vort_s[..., csy, icol] = (
                vS[..., csy, icol] * dxc[..., csy, icol]
                * torch.where(seli, sin_sg[2][..., csy, icol - 1],
                              sin_sg[0][..., csy, icol]))
        delpc_b = (vort_s[..., p(0):p(npy - 1) + 1, bs]
                   - vort_s[..., p(1):p(npy) + 1, bs]
                   + ptc_s[..., bs, p(0):p(npx - 1) + 1]
                   - ptc_s[..., bs, p(1):p(npx) + 1])
        # 3-term corner formulas, set directly
        delpc_b[..., 0, 0] = (-vort_s[..., p(1), p(1)]
                              + ptc_s[..., p(1), p(0)] - ptc_s[..., p(1), p(1)])
        delpc_b[..., 0, X - 1] = (-vort_s[..., p(1), p(X)]
                                  + ptc_s[..., p(1), p(X - 1)]
                                  - ptc_s[..., p(1), p(X)])
        delpc_b[..., Y - 1, X - 1] = (vort_s[..., p(Y - 1), p(X)]
                                      + ptc_s[..., p(Y), p(X - 1)]
                                      - ptc_s[..., p(Y), p(X)])
        delpc_b[..., Y - 1, 0] = (vort_s[..., p(Y - 1), p(1)]
                                  + ptc_s[..., p(Y), p(0)]
                                  - ptc_s[..., p(Y), p(1)])
        delpc_b = rarea_c[..., bs, bs] * delpc_b
        dampc = da_min_c * fmax(d2kS, fmin(0.20, dddmp * fabs(delpc_b * dt)))
        vort_b0 = dampc * delpc_b
        delpc_full = uS.new_zeros(uS.shape[:-2] + (jb, jb))
        delpc_full[..., bs, bs] = delpc_b
        return vort_b0, delpc_full

    def _div_damp_dn(divg_dS, wkS, d2kS):
        """del-(2nord+2) path on divg_d; returns (vort_bn at B 1..npx, dd)."""
        dd = divg_dS
        n2 = nord + 1
        for nloop in range(1, nord + 1):
            fill_c = nord - nloop != 0
            if fill_c:
                dd = halo.fill_corners_scalar(dd, topo, "bgrid", 1)
            vcd = dd.new_zeros(dd.shape[:-2] + (jb, jc))
            vcd[..., :, 0:jc] = (dd[..., :, 1:jc + 1] - dd[..., :, 0:jc]) * divg_u
            if fill_c:
                dd = halo.fill_corners_scalar(dd, topo, "bgrid", 2)
            ucd = dd.new_zeros(dd.shape[:-2] + (jc, jb))
            ucd[..., 0:jc, :] = (dd[..., 1:jc + 1, :] - dd[..., 0:jc, :]) * divg_v
            if fill_c:
                vcd, ucd = halo.fill_corners_vector(vcd, ucd, topo, "dgrid")
            dd_new = torch.zeros_like(dd)
            dd_new[..., 1:jc, 1:jc] = (
                (ucd[..., 0:jc - 1, 1:jc] - ucd[..., 1:jc, 1:jc])
                + (vcd[..., 1:jc, 0:jc - 1] - vcd[..., 1:jc, 1:jc]))
            dd_new[..., p(1), p(1)] = (-ucd[..., p(1), p(1)]
                                       + vcd[..., p(1), p(0)]
                                       - vcd[..., p(1), p(1)])
            dd_new[..., p(1), p(X)] = (-ucd[..., p(1), p(X)]
                                       + vcd[..., p(1), p(X - 1)]
                                       - vcd[..., p(1), p(X)])
            dd_new[..., p(Y), p(X)] = (ucd[..., p(Y - 1), p(X)]
                                       + vcd[..., p(Y), p(X - 1)]
                                       - vcd[..., p(Y), p(X)])
            dd_new[..., p(Y), p(1)] = (ucd[..., p(Y - 1), p(1)]
                                       + vcd[..., p(Y), p(0)]
                                       - vcd[..., p(Y), p(1)])
            dd = dd_new * rarea_c
        if dddmp < 1.0e-5:
            vort_sm = dd.new_zeros(dd.shape[:-2] + (npx, npx))
        else:
            wkb = a2b_ord4(wkS, grid)
            sm2 = divg_dS[..., bs, bs] ** 2 + wkb[..., bs, bs] ** 2
            smpos = fbool(sm2 > 0.0)
            vort_sm = abs(dt) * torch.where(
                smpos, torch.sqrt(torch.where(smpos, sm2, 1.0)), 0.0)
        dd8 = (da_min_c * d4_bg) ** n2
        damp2 = da_min_c * fmax(d2kS, fmin(0.20, dddmp * vort_sm))
        vort_bn = damp2 * divg_dS[..., bs, bs] + dd8 * dd[..., bs, bs]
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
    ke[..., bs, bs] += vort_b

    # ---------------------------------------------------------------
    # absolute-vorticity transport & wind update (:1450-1486)
    # ---------------------------------------------------------------
    vort_a = wk + f0
    fxv, fyv = fv_tp_2d(vort_a, crx, cry, hord_vt, xfx, yfx, grid, topo,
                        ra_x, ra_y)
    u_c = (vt_c[..., bs, cs]
           + (ke[..., bs, p(1):p(n) + 1] - ke[..., bs, p(2):p(npx) + 1])
           + fyv)
    v_c = (ut_c[..., cs, bs]
           + (ke[..., p(1):p(n) + 1, bs] - ke[..., p(2):p(npy) + 1, bs])
           - fxv)
    if do_vort_damp:
        # vorticity damping (:1490-1494)
        _, fx2d, fy2d = _del6_vt_flux_masked(
            nord_v,
            (damp_v_k * da_min_c, (damp_v_k * da_min_c) ** (nord_v + 1)),
            nordv0_k, wk, grid, topo)
    if d_con > 1.0e-5:
        # heating due to the damping (:1436-1448, 1496-1530)
        ub_h = vort_b[..., :, 0:n] - vort_b[..., :, 1:npx]
        vb_h = vort_b[..., 0:n, :] - vort_b[..., 1:npy, :]
        if do_vort_damp:
            ub_h = ub_h + fy2d[..., bs, cs]
            vb_h = vb_h - fx2d[..., cs, bs]
        ub_h2 = ub_h * rdx[..., bs, cs]
        fy_h = u_c * rdx[..., bs, cs]
        gy_h = fy_h * ub_h2
        vb_h2 = vb_h * rdy[..., cs, bs]
        fx_h = v_c * rdy[..., cs, bs]
        gx_h = fx_h * vb_h2
        dampc2 = 0.25 * dcon_k
        u2 = fy_h[..., 0:n, :] + fy_h[..., 1:n + 1, :]
        du2 = ub_h2[..., 0:n, :] + ub_h2[..., 1:n + 1, :]
        v2 = fx_h[..., :, 0:n] + fx_h[..., :, 1:n + 1]
        dv2 = vb_h2[..., :, 0:n] + vb_h2[..., :, 1:n + 1]
        heat_source = delp_new[..., cs, cs] * (
            heat_source - dampc2 * rsin2[..., cs, cs] * (
                (ub_h2[..., 0:n, :] ** 2 + ub_h2[..., 1:n + 1, :] ** 2
                 + vb_h2[..., :, 0:n] ** 2 + vb_h2[..., :, 1:n + 1] ** 2)
                + 2.0 * (gy_h[..., 0:n, :] + gy_h[..., 1:n + 1, :]
                         + gx_h[..., :, 0:n] + gx_h[..., :, 1:n + 1])
                - cosa_s[..., cs, cs] * (u2 * dv2 + v2 * du2 + du2 * dv2)))
    if do_vort_damp:
        # add the diffusive fluxes to the momentum (:1533-1543)
        u_c = u_c + fy2d[..., bs, cs]
        v_c = v_c + (-fx2d[..., cs, bs])
    u_new = u.clone()
    u_new[..., bs, cs] = u_c
    v_new = v.clone()
    v_new[..., cs, bs] = v_c

    return dict(
        delp=delp_new, pt=pt_new, u=u_new, v=v_new, w=w_new,
        divg_d=divg_d_new, divd_b=divd_saved,
        cx=cx, cy=cy, xflux=xflux, yflux=yflux,
        crx=crx, cry=cry, xfx=xfx, yfx=yfx,
        heat_source=heat_source,
    )
