"""Nonhydrostatic vertical solvers.

Counterpart of fv3jedi_lm_tpu/core/nh_core.py (model/nh_utils_nlm.F90):

* `sim1_solver` (:1177-1310) — the plain PyTorch SIM1 semi-implicit solver,
  the k-recurrences as Python loops over k, columns batched on the
  trailing axis.  It is the reference for the CUDA kernel
  (ops/cuda_sim1.py), the path taken for tensors on the CPU, and the
  solver the tangent-linear and adjoint sweeps differentiate.
* `riem_solver_c` (:297-404) and `riem_solver3` (:406-573) — the C- and
  D-grid wrappers around SIM1.
* `edge_profile` (:1519-1614), `update_dz_c` (:43-181), `update_dz_d`
  (:183-295) — the interface-height advection.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import NG
from ..constants import GRAV, RGAS
from ..ops.sw_core import del6_vt_flux, fill_4corners, tile_of
from ..ops.transport import fv_tp_2d
from .freeze import fbool, fmax, fscan

DZ_MIN = 2.0  # minimum layer thickness (m), nh_utils_nlm.F90:41
R3 = 1.0 / 3.0


def sim1_solver(dt, dm2, pt2, pm2, pem, w2, dz2, ws, kappa, p_fac=0.05):
    """SIM1_solver (nh_utils_nlm.F90:1177-1310), non-MOIST_CAPPA branch.

    Shapes: dm2/pt2/pm2/w2/dz2 (km, B); pem (km+1, B); ws (B,).
    Returns (pe, w2_new, dz2_new) with pe (km+1, B) the nonhydrostatic
    pressure perturbation at edges."""
    km = dm2.shape[0]
    gama = 1.0 / (1.0 - kappa)
    t1g = gama * 2.0 * dt * dt
    rdt = 1.0 / dt
    capa1 = kappa - 1.0

    # t1g/x as a true division: a Python scalar over a tensor would be
    # evaluated as reciprocal(x)*t1g, rounding twice
    t1g_t = torch.tensor(t1g, dtype=dm2.dtype, device=dm2.device)
    w1 = w2
    pe_l = torch.exp(gama * torch.log(-dm2 / dz2 * RGAS * pt2)) - pm2
    g_rat = dm2[:-1] / dm2[1:]                        # (km-1, B)
    bb = torch.cat([2.0 * (1.0 + g_rat), torch.full_like(dm2[:1], 2.0)])
    dd = torch.cat([3.0 * (pe_l[:-1] + g_rat * pe_l[1:]), 3.0 * pe_l[-1:]])

    # --- Thomas sweep for pp (the pressure-perturbation interpolant) ---
    pp = [None] * (km + 1)
    gam = [None] * km
    bet = bb[0]
    pp[0] = torch.zeros_like(bet)
    pp[1] = dd[0] / bet
    for k in range(2, km + 1):
        gam[k - 1] = g_rat[k - 2] / bet
        bet = bb[k - 1] - gam[k - 1]
        pp[k] = (dd[k - 1] - pp[k - 1]) / bet
    for k in range(km, 1, -1):
        pp[k - 1] = pp[k - 1] - gam[k - 1] * pp[k]

    # --- implicit w solver ---
    aa = [t1g_t / (dz2[k] + dz2[k + 1]) * (pem[k + 1] + pp[k + 1])
          for k in range(km - 1)]
    w = [None] * km
    bet = dm2[0] - aa[0]
    w[0] = (dm2[0] * w1[0] + dt * pp[1]) / bet
    for k in range(2, km):
        gam[k - 1] = aa[k - 2] / bet
        bet = dm2[k - 1] - (aa[k - 2] + aa[k - 1] + aa[k - 2] * gam[k - 1])
        w[k - 1] = (dm2[k - 1] * w1[k - 1] + dt * (pp[k] - pp[k - 1])
                    - aa[k - 2] * w[k - 2]) / bet
    p1 = t1g_t / dz2[km - 1] * (pem[km] + pp[km])
    gam[km - 1] = aa[km - 2] / bet
    bet = dm2[km - 1] - (aa[km - 2] + p1 + aa[km - 2] * gam[km - 1])
    w[km - 1] = (dm2[km - 1] * w1[km - 1] + dt * (pp[km] - pp[km - 1])
                 - p1 * ws - aa[km - 2] * w[km - 2]) / bet
    for k in range(km - 1, 0, -1):
        w[k - 1] = w[k - 1] - gam[k] * w[k]
    w_new = torch.stack(w)

    # --- pressure perturbation at edges from the w change, summed
    # sequentially in k (as the reference's loop and the CUDA kernel) ---
    dpe = dm2 * (w_new - w1) * rdt
    pe = [torch.zeros_like(pem[0])]
    for k in range(km):
        pe.append(pe[k] + dpe[k])
    pe = torch.stack(pe)

    # --- hypsometric dz update (bottom-up recurrence) ---
    def dz_of(p1v, k):
        arg = fmax(p_fac * pm2[k], p1v + pm2[k])
        return -dm2[k] * RGAS * pt2[k] * torch.exp(capa1 * torch.log(arg))

    dz = [None] * km
    p1v = (pe[km - 1] + 2.0 * pe[km]) * R3
    dz[km - 1] = dz_of(p1v, km - 1)
    for k in range(km - 1, 0, -1):
        p1v = (pe[k - 1] + bb[k - 1] * pe[k] + g_rat[k - 1] * pe[k + 1]) * R3 \
            - g_rat[k - 1] * p1v
        dz[k - 1] = dz_of(p1v, k - 1)
    return pe, w_new, torch.stack(dz)


def _sim1(dt, dmg, pt2, pm2, pem, w2, dz2, ws2, akap, p_fac, use_kernel):
    """SIM1 in every mode: this frozen copy has no kernel, so the plain
    `sim1_solver` serves the trajectory substep too (`use_kernel` is kept
    for the callers' signature)."""
    return sim1_solver(dt, dmg, pt2, pm2, pem, w2, dz2, ws2, akap, p_fac)


def _rev_cumsum(x):
    """cumsum from the bottom: out[k] = sum_{k' >= k} x[k']."""
    return torch.flip(torch.cumsum(torch.flip(x, [0]), dim=0), [0])


def riem_solver_c(dt, akap, ptop, hs, w3, pt, delp, gz, ws, p_fac=0.05,
                  use_kernel=True):
    """Riem_Solver_c (nh_utils_nlm.F90:297-404): C-grid semi-implicit
    solve on padded fields (npz[, +1], 6, jy, jx).  INPUT gz is height in
    meters (from update_dz_c), OUTPUT gz is height*grav anchored at hs.
    Returns (pef, gz_new, w_new)."""
    km = delp.shape[0]
    shp = delp.shape[1:]
    # garbage-lane sanitizers (never binding on valid columns): the padded
    # corner wedges carry undefined delp/pt/gz; keep them finite
    dm = torch.clamp(delp.reshape(km, -1), min=1e-10)
    pt2 = torch.clamp(pt.reshape(km, -1), min=1e-10)
    w2 = w3.reshape(km, -1)
    gz2 = gz.reshape(km + 1, -1)
    hs2 = hs.reshape(-1)
    ws2 = ws.reshape(-1)

    pem = torch.cat([torch.full_like(dm[:1], ptop),
                     ptop + torch.cumsum(dm, dim=0)])
    dz2 = torch.clamp(gz2[1:] - gz2[:-1], max=-1e-2)
    pm2 = dm / torch.clamp(torch.log(pem[1:] / pem[:-1]), min=1e-30)
    dmg = dm / GRAV

    pe, w_new, dz_new = _sim1(dt, dmg, pt2, pm2, pem, w2, dz2, ws2,
                              akap, p_fac, use_kernel)

    pef = pe + pem                     # full edge pressure; pe[0] = 0 -> ptop
    gz_new = torch.cat([hs2[None] - _rev_cumsum(dz_new * GRAV), hs2[None]])
    return (pef.reshape((km + 1,) + shp),
            gz_new.reshape((km + 1,) + shp),
            w_new.reshape((km,) + shp))


def riem_solver3(dt, akap, ptop, zs, ws, pt, delp, zh, w, p_fac=0.05,
                 use_kernel=True):
    """Riem_Solver3 (nh_utils_nlm.F90:406-573), a_imp > 0.999 (the SIM1
    branch), USE_COND off, fp_out false (the only form dyn_core uses).
    Inputs padded (npz[, +1], 6, jy, jx); zh is HEIGHT in meters.  Returns
    a dict with w, delz, zh, pe (hydrostatic edge), peln, pk3, ppe (the NH
    pressure perturbation at edges)."""
    km = delp.shape[0]
    shp = delp.shape[1:]
    dm_p = torch.clamp(delp.reshape(km, -1), min=1e-10)
    pt2 = torch.clamp(pt.reshape(km, -1), min=1e-10)
    w2 = w.reshape(km, -1)
    zh2 = zh.reshape(km + 1, -1)
    zs2 = zs.reshape(-1)
    ws2 = ws.reshape(-1)

    pem = torch.cat([torch.full_like(dm_p[:1], ptop),
                     ptop + torch.cumsum(dm_p, dim=0)])
    peln2 = torch.log(pem)
    pk3 = torch.exp(akap * peln2)
    pm2 = dm_p / torch.clamp(peln2[1:] - peln2[:-1], min=1e-30)
    dmg = dm_p / GRAV
    dz2 = torch.clamp(zh2[1:] - zh2[:-1], max=-1e-2)

    pe2, w_new, dz_new = _sim1(dt, dmg, pt2, pm2, pem, w2, dz2, ws2,
                               akap, p_fac, use_kernel)

    zh_new = torch.cat([zs2[None] - _rev_cumsum(dz_new), zs2[None]])

    def rs(x, k):
        return x.reshape((k,) + shp)

    return dict(w=rs(w_new, km), delz=rs(dz_new, km),
                zh=rs(zh_new, km + 1), pe=rs(pem, km + 1),
                peln=rs(peln2, km + 1), pk3=rs(pk3, km + 1),
                ppe=rs(pe2, km + 1))


def edge_profile(q, dp0):
    """edge_profile (nh_utils_nlm.F90:1519-1614, non-uniform branch, no
    limiter): tridiagonal edge-value reconstruction of a layer-mean
    profile.  q: (km, ...) layer means; dp0: (km,) static reference
    thickness, so the coefficients are precomputed host-side.  Returns
    (km+1, ...) edge values."""
    km = q.shape[0]
    dp0 = np.asarray(dp0, np.float64)
    g0 = dp0[1] / dp0[0]
    xt1_top = 2.0 * g0 * (g0 + 1.0)
    bet_top = g0 * (g0 + 0.5)
    gam = np.zeros(km + 1)
    bet = np.zeros(km + 1)
    gam[0] = (1.0 + g0 * (g0 + 1.5)) / bet_top
    bet[0] = bet_top
    gks = np.zeros(km + 1)
    for k in range(1, km):                      # Fortran k=2..km
        gk = dp0[k - 1] / dp0[k]
        gks[k] = gk
        bet[k] = 2.0 + 2.0 * gk - gam[k - 1]
        gam[k] = gk / bet[k]
    gk = gks[km - 1]
    a_bot = 1.0 + gk * (gk + 1.5)
    xt1_bot = 2.0 * gk * (gk + 1.0)
    xt2_bot = gk * (gk + 0.5) - a_bot * gam[km - 1]

    qe = [None] * (km + 1)
    qe[0] = (float(xt1_top) * q[0] + q[1]) / float(bet_top)
    for k in range(1, km):
        qe[k] = (3.0 * (q[k - 1] + float(gks[k]) * q[k]) - qe[k - 1]) \
            / float(bet[k])
    qe[km] = (float(xt1_bot) * q[-1] + q[-2] - float(a_bot) * qe[km - 1]) \
        / float(xt2_bot)
    for k in range(km - 1, -1, -1):
        qe[k] = qe[k] - float(gam[k]) * qe[k + 1]
    return torch.stack(qe)


def _mono_up(zh):
    """zh(k) >= zh(k+1) + dz_min, swept bottom-up."""
    def mono(zh_kp1, zh_k):
        out = fmax(zh_k, zh_kp1 + DZ_MIN)
        return out, out

    _, zh_up = fscan(mono, zh[-1], zh[:-1], reverse=True)
    return torch.cat([zh_up, zh[-1:]])


def update_dz_d(dt, dp0, zs, zh, crx, cry, xfx, yfx, hord, grid, topo,
                damp=None, ndif=0):
    """update_dz_d (nh_utils_nlm.F90:183-295): advance the D-grid height
    field with the fv_tp_2d transport of each interface, using
    edge-profile-reconstructed courant numbers/area fluxes, the optional
    del-n damping, then the monotonicity floor and surface vertical
    velocity.

    crx/xfx: (km, 6, jy, n+1) at D x-edges (from d_sw); cry/yfx mirrored;
    zh (km+1, 6, jc, jc) heights in meters; damp None or a (km+1, 1, 1, 1)
    del-n damping coefficient of static order ndif.  Returns
    (zh_new, ws)."""
    rdt = 1.0 / dt
    area = grid["area"]
    jcy, jcx = zh.shape[-2:]

    crx_adv = edge_profile(crx, dp0)
    xfx_adv = edge_profile(xfx, dp0)
    cry_adv = edge_profile(cry, dp0)
    yfx_adv = edge_profile(yfx, dp0)

    csy, csx = slice(NG, jcy - NG), slice(NG, jcx - NG)
    ra_x = area[..., :, csx] + (xfx_adv[..., :, :-1] - xfx_adv[..., :, 1:])
    ra_y = area[..., csy, :] + (yfx_adv[..., :-1, :] - yfx_adv[..., 1:, :])

    fx, fy = fv_tp_2d(zh, crx_adv, cry_adv, hord, xfx_adv, yfx_adv, grid,
                      topo, ra_x, ra_y)
    num = (zh[..., csy, csx] * area[..., csy, csx]
           + (fx[..., :, :-1] - fx[..., :, 1:])
           + (fy[..., :-1, :] - fy[..., 1:, :]))
    den = ra_x[..., csy, :] + ra_y[..., :, csx] - area[..., csy, csx]
    zh_c = num / den
    if damp is not None and ndif > 0:
        _, fx2, fy2 = del6_vt_flux(ndif, damp, zh, grid, topo)
        fx2 = fx2[..., csy, slice(NG, jcx - NG + 1)]
        fy2 = fy2[..., slice(NG, jcy - NG + 1), csx]
        zh_c = zh_c + ((fx2[..., :, :-1] - fx2[..., :, 1:])
                       + (fy2[..., :-1, :] - fy2[..., 1:, :])
                       ) * grid["rarea"][..., csy, csx]
    zh_new = zh.clone()
    zh_new[..., csy, csx] = zh_c

    ws = (zs - zh_new[-1]) * rdt
    return _mono_up(zh_new), ws


def update_dz_c(dt, dp0, zs, ut, vt, gz, grid, npx):
    """update_dz_c (nh_utils_nlm.F90:43-181): advance the C-grid
    geopotential height with upwind advection by the interface-interpolated
    (ut, vt) transport winds; returns (gz_new, ws).

    ut: (km, 6, jc, jb) c_sw transport winds; vt: (km, 6, jb, jc);
    gz: (km+1, 6, jc, jc); dp0 (km,) reference thickness (numpy);
    zs (6, jc, jc)."""
    km = ut.shape[0]
    rdt = 1.0 / dt
    area = grid["area"]
    dp0 = np.asarray(dp0, np.float64)

    def lev(x):
        return torch.as_tensor(x.reshape(km - 1, 1, 1, 1), dtype=ut.dtype,
                               device=ut.device)

    top_ratio = float(dp0[0] / (dp0[0] + dp0[1]))
    bot_ratio = float(dp0[km - 1] / (dp0[km - 2] + dp0[km - 1]))
    int_ratio = lev(1.0 / (dp0[:-1] + dp0[1:]))
    d_hi = lev(dp0[1:])
    d_lo = lev(dp0[:-1])

    def interfaces(t):
        return torch.cat([
            (t[0] + (t[0] - t[1]) * top_ratio)[None],
            (d_hi * t[:-1] + d_lo * t[1:]) * int_ratio,
            (t[-1] + (t[-1] - t[-2]) * bot_ratio)[None],
        ])

    xfx = interfaces(ut)
    yfx = interfaces(vt)

    T, _, _ = tile_of(grid, npx)
    jcy, jcx = gz.shape[-2:]
    gx = fill_4corners(gz, 1, T)
    selx = fbool(xfx[..., :, 1:jcx] > 0.0)
    fx = xfx[..., :, 1:jcx] * torch.where(selx, gx[..., :, 0:jcx - 1],
                                          gx[..., :, 1:jcx])
    gy = fill_4corners(gz, 2, T)
    sely = fbool(yfx[..., 1:jcy, :] > 0.0)
    fy = yfx[..., 1:jcy, :] * torch.where(sely, gy[..., 0:jcy - 1, :],
                                          gy[..., 1:jcy, :])

    iy, ix = slice(1, jcy - 1), slice(1, jcx - 1)
    num = (gz[..., iy, ix] * area[..., iy, ix]
           + (fx[..., iy, :-1] - fx[..., iy, 1:])
           + (fy[..., :-1, ix] - fy[..., 1:, ix]))
    den = (area[..., iy, ix]
           + (xfx[..., iy, 1:jcx - 1] - xfx[..., iy, 2:jcx])
           + (yfx[..., 1:jcy - 1, ix] - yfx[..., 2:jcy, ix]))
    gz_new = gz.clone()
    gz_new[..., iy, ix] = num / den

    ws = (zs - gz_new[-1]) * rdt
    return _mono_up(gz_new), ws
