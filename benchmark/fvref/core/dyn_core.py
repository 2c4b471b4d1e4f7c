"""Acoustic (Lagrangian-dynamics) core: the n_split loop.

Counterpart of fv3jedi_lm_tpu/core/dyn_core.py (model/dyn_core_nlm.F90).
Vertical axis leading: 3-D fields (npz, 6, jy, jx), interface fields
(npz+1, 6, jy, jx).  One acoustic substep (dyn_core_nlm.F90:288-1000):

  a: halo(u,v[,w]) -> c_sw -> hydrostatic: geopk -> p_grad_c
                              NH: update_dz_c -> Riem_Solver_C (SIM1) ->
                                  p_grad_c (delpc form)
     -> halo(uc,vc)
  b: d_sw (trajectory scheme [+ perturbation scheme, mixed])
  c: halo(delp,pt) -> hydrostatic: geopk -> one_grad_p
                      NH: update_dz_d -> Riem_Solver3 (SIM1) -> nh_p_grad

mode="mixed" is the linearization target of the tangent-linear and adjoint
sweeps (core/staged.py): d_sw runs the trajectory and the perturbation
schemes and `freeze.mix_primal` takes the value from the first and the
derivative from the second (dyn_core_tlm.F90:835-960).  The options:
beta > 0 (grad1_p_update / split_p_grad, off-centered with the previous
substep's gradient), d_ext (the external-mode damping vector), d_con
(the damping heat source, applied in acoustic_finish), fill_dp (mix_dp
after d_sw) and Rayleigh_fast (an inline per-level drag factor).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import NG
from ..constants import CP as CP_AIR
from ..constants import GRAV, RGAS
from ..ops.a2b_edge import a2b_ord2, a2b_ord4
from ..ops.d_sw import d_sw
from ..ops.sw_core import F2P, SL, c_sw, tile_of
from ..parallel import halo
from ..timing import scope
from .freeze import fabs, fbool, fmax, fmin, fscan, fsign_mul, mix_primal
from .nh_core import riem_solver3, riem_solver_c, update_dz_c, update_dz_d


def geopk(ptop, delp, pt, hs, akap):
    """Hydrostatic pressures + geopotential (dyn_core_nlm.F90:1954-2087).

    pt is virtual potential temperature; computed on the full padded
    domain.  Returns (pe, peln, pk, gz, pkz)."""
    delp_s = fmax(delp, 1.0e-30)
    pe = torch.cat([delp.new_full((1,) + delp.shape[1:], ptop),
                    ptop + torch.cumsum(delp_s, dim=0)])
    peln = torch.log(pe)
    pk = torch.exp(akap * peln)
    dgz = CP_AIR * pt * (pk[1:] - pk[:-1])
    rev = torch.flip(torch.cumsum(torch.flip(dgz, [0]), dim=0), [0])
    gz = torch.cat([hs[None] + rev, hs[None]])
    dpeln = peln[1:] - peln[:-1]
    ok = fbool(dpeln > 0.0)
    pkz = (pk[1:] - pk[:-1]) / (akap * torch.where(ok, dpeln, 1.0))
    pkz = torch.where(ok, pkz, 1.0)
    return pe, peln, pk, gz, pkz


def p_grad_c(dt2, pkc, gz, uc, vc, grid, npx, delpc=None):
    """C-grid pressure-gradient update (dyn_core_nlm.F90:1369-1428).
    Hydrostatic: pkc is pe**kappa and the layer weight its difference;
    nonhydrostatic (delpc given): pkc is the FULL pressure from
    Riem_Solver_C and the layer weight is delpc (:1394-1404)."""
    p = F2P
    T, X, Y = tile_of(grid, npx)
    rdxc = grid["rdxc"]
    rdyc = grid["rdyc"]
    wk = delpc if delpc is not None else pkc[1:] - pkc[:-1]

    bsx, bsy = SL(1, X), SL(1, Y)
    csx, csy = SL(1, T.nx), SL(1, T.ny)
    cm = slice(p(0), p(T.nx) + 1)   # cells i-1 window for B cols 1..X
    c0 = slice(p(1), p(X) + 1)      # cells i window

    uc = uc.clone()
    uc[..., csy, bsx] += (
        dt2 * rdxc[..., csy, bsx] / (wk[..., csy, cm] + wk[..., csy, c0])
        * ((gz[1:][..., csy, cm] - gz[:-1][..., csy, c0])
           * (pkc[1:][..., csy, c0] - pkc[:-1][..., csy, cm])
           + (gz[:-1][..., csy, cm] - gz[1:][..., csy, c0])
           * (pkc[1:][..., csy, cm] - pkc[:-1][..., csy, c0])))
    rm = slice(p(0), p(T.ny) + 1)
    r0 = slice(p(1), p(Y) + 1)
    vc = vc.clone()
    vc[..., bsy, csx] += (
        dt2 * rdyc[..., bsy, csx] / (wk[..., rm, csx] + wk[..., r0, csx])
        * ((gz[1:][..., rm, csx] - gz[:-1][..., r0, csx])
           * (pkc[1:][..., r0, csx] - pkc[:-1][..., rm, csx])
           + (gz[:-1][..., rm, csx] - gz[1:][..., r0, csx])
           * (pkc[1:][..., rm, csx] - pkc[:-1][..., r0, csx])))
    return uc, vc


def one_grad_p(u, v, pk, gz, dt, grid, npx, ptop, akap, divg2=None):
    """D-grid pressure gradient, hydrostatic (dyn_core_nlm.F90:1645-1778);
    `divg2` (B-grid, from _d_ext_divg2) adds the external-mode damping
    when d_ext > 0."""
    rdx = grid["rdx"]
    rdy = grid["rdy"]
    ptk = ptop ** akap

    # B-grid interface fields
    top = pk.new_full(pk.shape[1:-2] + _b_shape(pk), ptk)[None]
    pk_b = torch.cat([top, a2b_ord4(pk[1:], grid)])
    gz_b = a2b_ord4(gz, grid)

    (bsy, bsx), (csy, csx), (b0, b1), (r0, r1) = _b_slices(grid, npx)
    if divg2 is not None:
        wk2 = divg2[..., bsy, b0] - divg2[..., bsy, b1]
        wk1 = divg2[..., r0, bsx] - divg2[..., r1, bsx]
    else:
        wk2 = wk1 = 0.0
    wk = pk_b[1:] - pk_b[:-1]
    u_new = u.clone()
    u_new[..., bsy, csx] = rdx[..., bsy, csx] * (
        wk2 + u[..., bsy, csx]
        + dt / (wk[..., bsy, b0] + wk[..., bsy, b1])
        * ((gz_b[1:][..., bsy, b0] - gz_b[:-1][..., bsy, b1])
           * (pk_b[1:][..., bsy, b1] - pk_b[:-1][..., bsy, b0])
           + (gz_b[:-1][..., bsy, b0] - gz_b[1:][..., bsy, b1])
           * (pk_b[1:][..., bsy, b0] - pk_b[:-1][..., bsy, b1])))
    v_new = v.clone()
    v_new[..., csy, bsx] = rdy[..., csy, bsx] * (
        wk1 + v[..., csy, bsx]
        + dt / (wk[..., r0, bsx] + wk[..., r1, bsx])
        * ((gz_b[1:][..., r0, bsx] - gz_b[:-1][..., r1, bsx])
           * (pk_b[1:][..., r1, bsx] - pk_b[:-1][..., r0, bsx])
           + (gz_b[:-1][..., r0, bsx] - gz_b[1:][..., r1, bsx])
           * (pk_b[1:][..., r0, bsx] - pk_b[:-1][..., r1, bsx])))
    return u_new, v_new


def _b_shape(x):
    """The (jby, jbx) of a padded center field x."""
    return (x.shape[-2] + 1, x.shape[-1] + 1)


def _b_slices(grid, npx):
    """The tile's ((B rows, B cols), (cell rows, cell cols), (B cols i,
    i+1 of cells 1..nx), (B rows j, j+1 of cells 1..ny))."""
    p = F2P
    T, X, Y = tile_of(grid, npx)
    return ((SL(1, Y), SL(1, X)), (SL(1, T.ny), SL(1, T.nx)),
            (slice(p(1), p(T.nx) + 1), slice(p(2), p(X) + 1)),
            (slice(p(1), p(T.ny) + 1), slice(p(2), p(Y) + 1)))


def _grad(gz_b, f_b, den, dt, r0, c0, r1, c1):
    """One component of the B-grid pressure-gradient integral."""
    return dt / (den[..., r0, c0] + den[..., r1, c1]) * (
        (gz_b[1:][..., r0, c0] - gz_b[:-1][..., r1, c1])
        * (f_b[1:][..., r1, c1] - f_b[:-1][..., r0, c0])
        + (gz_b[:-1][..., r0, c0] - gz_b[1:][..., r1, c1])
        * (f_b[1:][..., r0, c0] - f_b[:-1][..., r1, c1]))


def grad1_p_update(u, v, pk, gz, divg2, du, dv, dt, grid, npx, ptop, akap,
                   beta_d):
    """Hydrostatic beta > 0 off-centered pressure gradient (grad1_p_update,
    dyn_core_nlm.F90:1781-1872): beta_d of the previous substep's gradient
    (du/dv, zero at each dyn_core entry; beta_d == 0 on the first substep,
    :367-374) plus (1 - beta_d) of the current one.  Returns the winds and
    the current gradients for the next substep."""
    rdx = grid["rdx"]
    rdy = grid["rdy"]
    alpha = 1.0 - beta_d

    top = pk.new_full(pk.shape[1:-2] + _b_shape(pk), ptop ** akap)[None]
    pk_b = torch.cat([top, a2b_ord4(pk[1:], grid)])
    gz_b = a2b_ord4(gz, grid)
    wk = pk_b[1:] - pk_b[:-1]

    (bsy, bsx), (csy, csx), (b0, b1), (r0, r1) = _b_slices(grid, npx)
    du_new = _grad(gz_b, pk_b, wk, dt, bsy, b0, bsy, b1)
    wk2 = divg2[..., bsy, b0] - divg2[..., bsy, b1]
    u_new = u.clone()
    u_new[..., bsy, csx] = ((u[..., bsy, csx] + beta_d * du + wk2
                             + alpha * du_new) * rdx[..., bsy, csx])
    dv_new = _grad(gz_b, pk_b, wk, dt, r0, bsx, r1, bsx)
    wk1 = divg2[..., r0, bsx] - divg2[..., r1, bsx]
    v_new = v.clone()
    v_new[..., csy, bsx] = ((v[..., csy, bsx] + beta_d * dv + wk1
                             + alpha * dv_new) * rdy[..., csy, bsx])
    return u_new, v_new, du_new, dv_new


def split_p_grad(u, v, pp, gz, delp, pk3, du, dv, dt, grid, npx, ptop, akap,
                 beta_d):
    """Nonhydrostatic beta > 0 off-centered pressure gradient
    (split_p_grad, dyn_core_nlm.F90:1531-1641, use_logp=.false.): the
    hydrostatic component off-centered with the previous substep's stored
    gradient (du/dv), the perturbation-pressure component applied in full
    each substep."""
    rdx = grid["rdx"]
    rdy = grid["rdy"]
    alpha = 1.0 - beta_d

    top_pk = pk3.new_full(pk3.shape[1:-2] + _b_shape(pk3),
                          ptop ** akap)[None]
    pk_b = torch.cat([top_pk, a2b_ord4(pk3[1:], grid)])
    pp_b = torch.cat([torch.zeros_like(top_pk), a2b_ord4(pp[1:], grid)])
    gz_b = a2b_ord4(gz, grid)
    dp_b = a2b_ord4(delp, grid)
    wk = pk_b[1:] - pk_b[:-1]

    (bsy, bsx), (csy, csx), (b0, b1), (r0, r1) = _b_slices(grid, npx)
    du_new = _grad(gz_b, pk_b, wk, dt, bsy, b0, bsy, b1)
    dun = _grad(gz_b, pp_b, dp_b, dt, bsy, b0, bsy, b1)
    u_new = u.clone()
    u_new[..., bsy, csx] = ((u[..., bsy, csx] + beta_d * du + alpha * du_new
                             + dun) * rdx[..., bsy, csx])
    dv_new = _grad(gz_b, pk_b, wk, dt, r0, bsx, r1, bsx)
    dvn = _grad(gz_b, pp_b, dp_b, dt, r0, bsx, r1, bsx)
    v_new = v.clone()
    v_new[..., csy, bsx] = ((v[..., csy, bsx] + beta_d * dv + alpha * dv_new
                             + dvn) * rdy[..., csy, bsx])
    return u_new, v_new, du_new, dv_new


def nh_p_grad(u, v, pp, gz, delp, pk3, dt, grid, npx, ptop, akap):
    """Nonhydrostatic D-grid pressure gradient (dyn_core_nlm.F90:1431-1528,
    use_logp=.false.): the hydrostatic gradient on pk3 = p**kappa layers
    plus the perturbation-pressure (pp) gradient on delp layers, both via
    4th-order B-grid corner interpolation."""
    rdx = grid["rdx"]
    rdy = grid["rdy"]
    ptk = ptop ** akap

    top_pk = pk3.new_full(pk3.shape[1:-2] + _b_shape(pk3), ptk)[None]
    pk_b = torch.cat([top_pk, a2b_ord4(pk3[1:], grid)])
    pp_b = torch.cat([torch.zeros_like(top_pk), a2b_ord4(pp[1:], grid)])
    gz_b = a2b_ord4(gz, grid)
    dp_b = a2b_ord4(delp, grid)

    wk = pk_b[1:] - pk_b[:-1]
    (bsy, bsx), (csy, csx), (b0, b1), (r0, r1) = _b_slices(grid, npx)
    du1 = _grad(gz_b, pk_b, wk, dt, bsy, b0, bsy, b1)
    dun = _grad(gz_b, pp_b, dp_b, dt, bsy, b0, bsy, b1)
    u_new = u.clone()
    u_new[..., bsy, csx] = (u[..., bsy, csx] + du1 + dun) * rdx[..., bsy, csx]

    dv1 = _grad(gz_b, pk_b, wk, dt, r0, bsx, r1, bsx)
    dvn = _grad(gz_b, pp_b, dp_b, dt, r0, bsx, r1, bsx)
    v_new = v.clone()
    v_new[..., csy, bsx] = (v[..., csy, bsx] + dv1 + dvn) * rdy[..., csy, bsx]
    return u_new, v_new


def del2_cubed(q, cd, grid, topo, nmax, npx):
    """Del-2 filter, e.g. of omega or the heat source (dyn_core_nlm.F90:
    2090-2199): min(3, nmax) passes, each a 3-cell mean at the four cube
    corners then one del-2 flux divergence."""
    p = F2P
    T, X, Y = tile_of(grid, npx)
    nx, ny = T.nx, T.ny
    jcy, jcx = q.shape[-2:]
    del6_u = grid["del6_u"]
    del6_v = grid["del6_v"]
    rarea = grid["rarea"]
    c3 = 1.0 / 3.0
    q = halo.fill_halo_center(q, topo)
    corners = [e for own, e in (
        (T.south and T.west, ((1, 1), (0, 1), (1, 0))),
        (T.south and T.east, ((nx, 1), (X, 1), (nx, 0))),
        (T.north and T.east, ((nx, ny), (X, ny), (nx, Y))),
        (T.north and T.west, ((1, ny), (0, ny), (1, Y)))) if own]
    for _ in range(min(3, nmax)):
        q = q.clone()
        for (ci, cj), (ai, aj), (bi, bj) in corners:
            m = (q[..., p(cj), p(ci)] + q[..., p(aj), p(ai)]
                 + q[..., p(bj), p(bi)]) * c3
            q[..., p(cj), p(ci)] = m
            q[..., p(aj), p(ai)] = m
            q[..., p(bj), p(bi)] = m
        qx = halo.copy_corners(q, topo, 1)
        fx = del6_v[..., :, 1:jcx] * (qx[..., :, 0:jcx - 1] - qx[..., :, 1:jcx])
        qy = halo.copy_corners(q, topo, 2)
        fy = del6_u[..., 1:jcy, :] * (qy[..., 0:jcy - 1, :] - qy[..., 1:jcy, :])
        q = q.clone()
        q[..., 1:jcy - 1, 1:jcx - 1] += cd * rarea[..., 1:jcy - 1, 1:jcx - 1] * (
            fx[..., 1:jcy - 1, 0:jcx - 2] - fx[..., 1:jcy - 1, 1:jcx - 1]
            + fy[..., 0:jcy - 2, 1:jcx - 1] - fy[..., 1:jcy - 1, 1:jcx - 1])
    return q


def pem_interfaces(delp, ptop):
    """Interface pressures from the padded delp (the pem capture at the
    start of the last acoustic substep, dyn_core_nlm.F90:378-392)."""
    return torch.cat([delp.new_full((1,) + delp.shape[1:], ptop),
                      ptop + torch.cumsum(delp, dim=0)])


def adv_pe(ua, va, pem, om, grid, npx):
    """Omega's advective term V . grad(pe) by Green's theorem
    (dyn_core_nlm.F90:1263-1364, use_old_omega path).

    ua/va: the A-grid contravariant winds of the last substep's c_sw; pem:
    the interface pressures captured at the start of that substep; om:
    (pe - pem)*rdt on the padded domain.  Interface winds are mid-level
    averages (the bottom layer its own); grad(pe) comes from B-grid corner
    pressures (a2b_ord2) integrated around each cell with the en1/en2 edge
    normals.  Returns om with the term added on the compute lanes."""
    (bsy, bsx), (csy, csx), (b0, b1), (r0, r1) = _b_slices(grid, npx)

    up = torch.cat([0.5 * (ua[:-1] + ua[1:]), ua[-1:]])
    vp = torch.cat([0.5 * (va[:-1] + va[1:]), va[-1:]])
    v3 = (up[None][..., csy, csx] * grid["ec1"][:, None][..., csy, csx]
          + vp[None][..., csy, csx] * grid["ec2"][:, None][..., csy, csx])
    pb = a2b_ord2(pem[1:], grid)
    pdx = ((pb[..., bsy, b0] + pb[..., bsy, b1])
           * grid["dx"][..., bsy, csx] * grid["en1"][:, None][..., bsy, csx])
    pdy = ((pb[..., r0, bsx] + pb[..., r1, bsx])
           * grid["dy"][..., csy, bsx] * grid["en2"][:, None][..., csy, bsx])
    grad = ((pdx[..., 1:, :] - pdx[..., :-1, :])
            + (pdy[..., :, 1:] - pdy[..., :, :-1]))
    om = om.clone()
    om[..., csy, csx] += (0.5 * grid["rarea"][..., csy, csx]
                          * (v3 * grad).sum(0))
    return om


def mix_dp(delp, pt, w, dp_ref, hydrostatic):
    """Thin-layer delp mixing (mix_dp, dyn_core_nlm.F90:1875-1952), after
    d_sw in every acoustic substep when `fill_dp` is on (:697): a layer
    thinner than dpmin(k) = 1 % of its reference thickness borrows mass
    from the layer below, mixing pt (and w when nonhydrostatic)
    conservatively; the bottom layer borrows from the (already mixed)
    layer above.  The downward pass is sequential in k (a layer's
    borrowing thins the next one before it is examined), a frozen-branch
    `fscan` (MIX_DP_TLM's PUSHCONTROL, dyn_core_tlm.F90:4385)."""
    npz = delp.shape[0]
    if npz < 2:
        return delp, pt, w
    dpmin = torch.as_tensor(0.01 * np.asarray(dp_ref), dtype=delp.dtype,
                            device=delp.device)
    nh = (w is not None) and (not hydrostatic)
    wz = w if nh else torch.zeros_like(pt)

    def body(delp_cur, x):
        dpm, delp_next, pt_k, pt_next, w_k, w_next = x
        need = fbool(delp_cur < dpm)
        dp = torch.where(need, dpm - delp_cur, 0.0)
        pt_new = torch.where(need, (pt_k * delp_cur + pt_next * dp) / dpm,
                             pt_k)
        w_new = torch.where(need, (w_k * delp_cur + w_next * dp) / dpm, w_k)
        delp_new = torch.where(need, dpm, delp_cur)
        return delp_next - dp, (delp_new, pt_new, w_new)

    xs = (dpmin[:-1], delp[1:], pt[:-1], pt[1:], wz[:-1], wz[1:])
    last, (delp_o, pt_o, w_o) = fscan(body, delp[0], xs)

    # bottom layer: borrow from the layer above (its mixed values)
    dpm_b = dpmin[-1]
    need_b = fbool(last < dpm_b)
    dp_b = torch.where(need_b, dpm_b - last, 0.0)
    pt_b = torch.where(need_b, (pt[-1] * last + pt_o[-1] * dp_b) / dpm_b,
                       pt[-1])
    w_b = torch.where(need_b, (wz[-1] * last + w_o[-1] * dp_b) / dpm_b,
                      wz[-1])
    delp_b = torch.where(need_b, dpm_b, last)
    delp_out = torch.cat([delp_o[:-1], (delp_o[-1] - dp_b)[None],
                          delp_b[None]])
    pt_out = torch.cat([pt_o, pt_b[None]])
    if not nh:
        return delp_out, pt_out, w
    return delp_out, pt_out, torch.cat([w_o, w_b[None]])


def _rayleigh_fast_factor(cfg, npz, dt, ptop, pm, like):
    """Per-level inline Rayleigh drag factor rf(k) = 1/(1 + dt/tau0*sin^2)
    (Rayleigh_fast, dyn_core_nlm.F90:2219-2287); 1 below rf_cutoff.  A
    (npz, 1, 1, 1) tensor like `like`."""
    rff = np.ones(npz)
    for k in range(npz):
        if pm[k] < cfg.rf_cutoff:
            r = (dt / (cfg.tau * 86400.0)
                 * np.sin(0.5 * np.pi * np.log(cfg.rf_cutoff / pm[k])
                          / np.log(cfg.rf_cutoff / ptop)) ** 2)
            rff[k] = 1.0 / (1.0 + r)
        else:
            break
    return torch.as_tensor(rff.reshape(npz, 1, 1, 1), dtype=like.dtype,
                           device=like.device)


def _d_ext_divg2(delp_b, divd_b, d2_ext):
    """divg2 = d_ext*da_min_c * sum_k(delp_b*div_b)/sum_k(delp_b) at B
    points (dyn_core_nlm.F90:707-728); the inputs are per-level B-grid
    tensors, zero outside B 1..npx, where the quotient is masked."""
    wk = delp_b.sum(0)
    dv = (delp_b * divd_b).sum(0)
    wkpos = fbool(wk > 0.0)
    return torch.where(wkpos, d2_ext * dv / torch.where(wkpos, wk, 1.0), 0.0)


def _kcoef(cfg, npz, dtype, device):
    """Per-level damping coefficients/masks from the sponge bands
    (dyn_core_nlm.F90:536-630), in masked form for d_sw."""
    bands = _sponge_bands(cfg, npz)
    d2 = np.zeros(npz)
    dv = np.zeros(npz)
    dw = np.zeros(npz)
    dtm = np.zeros(npz)
    dcon = np.zeros(npz)
    nord_k = np.zeros(npz, int)
    nordv_k = np.zeros(npz, int)
    nordt_k = np.zeros(npz, int)
    nordw_k = np.zeros(npz, int)
    for (k0, k1, pars) in bands:
        d2[k0:k1] = pars["d2_divg"]
        dv[k0:k1] = pars["damp_v"]
        dw[k0:k1] = pars["damp_w"]
        dtm[k0:k1] = pars["damp_t"]
        dcon[k0:k1] = pars["d_con"]
        nord_k[k0:k1] = pars["nord"]
        nordv_k[k0:k1] = pars["nord_v"]
        nordt_k[k0:k1] = pars["nord_t"]
        nordw_k[k0:k1] = pars["nord_w"]

    def a(x):
        return torch.as_tensor(x.reshape(npz, 1, 1, 1), dtype=dtype,
                               device=device)

    def m(x):
        # static numpy masks: consumers split the level batch at the
        # sponge band edge
        return np.asarray(x).reshape(npz, 1, 1, 1)

    nv = min(2, cfg.nord)
    return dict(
        nord=cfg.nord, nord_v=nv, nord_t=nv, nord_w=nv,
        dddmp=cfg.dddmp, d4_bg=cfg.d4_bg, d_con=cfg.d_con, ke_bg=cfg.ke_bg,
        do_vort_damp=cfg.do_vort_damp,
        d2_divg=a(d2), damp_v=a(dv), damp_w=a(dw), damp_t=a(dtm), dcon=a(dcon),
        nord0=m(nord_k == 0), nordv0=m(nordv_k == 0),
        nordt0=m(nordt_k == 0), nordw0=m(nordw_k == 0),
    )


def _kcoef_pert(cfg, npz, dtype, device):
    """Per-level PERTURBATION damping coefficients (dyn_core_tlm.F90:
    835-920): nord_pert del-nord damping with d2_divg_pert =
    min(0.20, d2_bg_pert) outside the perturbation sponge; inside (k <=
    n_sponge_pert) nord drops to 0 with the d2_bg_k1/k2/ks_pert cascade,
    nord_w drops to 0 with damp_w = d2, and vorticity damping becomes del-2
    with damp_v = 0.5*d2.  nord_t/damp_t keep their non-sponge values."""
    nsp = cfg.n_sponge_pert
    nv = min(2, cfg.nord_pert)
    base_damp = cfg.vtdm4_pert if cfg.do_vort_damp_pert else 0.0
    d2 = np.empty(npz)
    dv = np.empty(npz)
    dw = np.empty(npz)
    dtm = np.full(npz, base_damp)
    nord_k = np.empty(npz, int)
    nordv_k = np.empty(npz, int)
    nordw_k = np.empty(npz, int)
    nordt_k = np.full(npz, nv, int)
    for k0 in range(npz):
        k = k0 + 1  # Fortran level
        nord_k[k0] = cfg.nord_pert
        nordv_k[k0] = nv
        nordw_k[k0] = nv
        d2k = min(0.20, cfg.d2_bg_pert)
        dv[k0] = base_damp
        dw[k0] = base_damp
        if k <= nsp:
            nord_k[k0] = 0
            dref = (cfg.d2_bg_k1_pert if k == 1
                    else cfg.d2_bg_k2_pert if k == 2
                    else cfg.d2_bg_ks_pert)
            if cfg.d2_bg_pert > 0.01:
                d2k = max(cfg.d2_bg_pert, dref)
            elif dref > 0.01:
                d2k = dref
            else:
                d2k = 0.01
            nordw_k[k0] = 0
            dw[k0] = d2k
            if cfg.do_vort_damp_pert:
                nordv_k[k0] = 0
                dv[k0] = 0.5 * d2k
        d2[k0] = d2k

    def a(x):
        return torch.as_tensor(x.reshape(npz, 1, 1, 1), dtype=dtype,
                               device=device)

    def m(x):
        return np.asarray(x).reshape(npz, 1, 1, 1)

    return dict(
        nord=cfg.nord_pert, nord_v=nv, nord_t=nv, nord_w=nv,
        dddmp=cfg.dddmp_pert, d4_bg=cfg.d4_bg_pert, d_con=cfg.d_con,
        ke_bg=cfg.ke_bg, do_vort_damp=cfg.do_vort_damp_pert,
        d2_divg=a(d2), damp_v=a(dv), damp_w=a(dw), damp_t=a(dtm),
        # the trajectory's per-level d_con rides along (no pert d_con)
        dcon=_kcoef(cfg, npz, dtype, device)["dcon"],
        nord0=m(nord_k == 0), nordv0=m(nordv_k == 0),
        nordt0=m(nordt_k == 0), nordw0=m(nordw_k == 0),
    )


def _sponge_hords(cfg, npz, mains, ks_val):
    """Per-variable advection options with the perturbation-sponge override
    (dyn_core_tlm.F90:861-875): levels k <= n_sponge_pert-1 use `ks_val`,
    carried as the static band `(main, ks_val, ksp)`."""
    ksp = min(max(cfg.n_sponge_pert - 1, 0), npz)

    def h(main):
        if ksp > 0 and main != ks_val:
            return (main, ks_val, ksp)
        return main
    return dict(hord_mt=h(mains[0]), hord_vt=h(mains[1]),
                hord_tm=h(mains[2]), hord_dp=h(mains[3]))


def _pert_hords(cfg, npz):
    """Perturbation advection options with the sponge override."""
    return _sponge_hords(
        cfg, npz, (cfg.hord_mt_pert, cfg.hord_vt_pert, cfg.hord_tm_pert,
                   cfg.hord_dp_pert), cfg.hord_ks_pert)


def _traj_sponge_hords(cfg, npz):
    """Trajectory advection options inside the linearization: in the
    perturbation sponge levels the trajectory also drops to hord_ks_traj
    (dyn_core_tlm.F90:862-868)."""
    return _sponge_hords(
        cfg, npz, (cfg.hord_mt, cfg.hord_vt, cfg.hord_tm, cfg.hord_dp),
        cfg.hord_ks_traj)


def acoustic_carry(state, cfg, npz):
    """Initial acoustic-loop carry from the interface state (zeroed heat
    source and vert block, filled by the final substep; NH interface
    heights)."""
    jcy, jcx = state["delp"].shape[-2:]
    ny, nx = jcy - 2 * NG, jcx - 2 * NG
    lead = state["u"].shape[:-2]
    u = state["u"]
    out = dict(
        u=u, v=state["v"], w=state["w"],
        delp=state["delp"], pt=state["pt"],
        uc=state["uc"], vc=state["vc"], divgd=state["divgd"],
        mfx=state["mfx"], mfy=state["mfy"], cx=state["cx"], cy=state["cy"],
        heat_source=u.new_zeros(lead + (ny, nx)),
        pe=u.new_zeros((npz + 1,) + lead[1:] + (jcy, jcx)),
        peln=u.new_zeros((npz + 1,) + lead[1:] + (jcy, jcx)),
        pk=u.new_zeros((npz + 1,) + lead[1:] + (jcy, jcx)),
        pkz=u.new_zeros(lead + (jcy, jcx)),
    )
    if cfg.beta > 0.0:
        # the previous substep's pressure gradient and the substep counter
        # of the off-centering (dyn_core_nlm.F90:254-258), zero at every
        # dyn_core entry: beta_d = 0 on substep 1 is the reference's
        # it == 1 reset (:367-374)
        out["du"] = u.new_zeros(lead + (ny + 1, nx))
        out["dv"] = u.new_zeros(lead + (ny, nx + 1))
        out["itc"] = u.new_zeros(())
    if not cfg.hydrostatic:
        # interface heights from delz, zh(km+1) = zs (dyn_core_nlm.F90:
        # 323-352)
        zs = state["phis"] / GRAV
        out["zh"] = torch.cat([zs[None] - torch.flip(
            torch.cumsum(torch.flip(state["delz"], [0]), dim=0), [0]),
            zs[None]])
        out["delz"] = state["delz"]
        out["ws"] = u.new_zeros(lead[1:] + (jcy, jcx))
    return out


def _detached(args):
    return tuple(a.detach() if isinstance(a, torch.Tensor) else a
                 for a in args)


def make_acoustic_substep(grid, topo, cfg, dt_remap, akap, ptop, npz, dtype,
                          mode="traj", dp_ref=None, pm=None):
    """Build the one-acoustic-substep function substep(carry, consts);
    consts = {"phis": padded surface geopotential}.  Stages a, b, c are
    exposed as `substep.stages` (the adjoint takes one stage's vjp at a
    time).

    mode="traj": the nonlinear step's substep; SIM1 runs as the CUDA kernel
    on the card.  mode="mixed": the linearization target (module
    docstring); it calls the plain `nh_core.sim1_solver`, which the sweeps
    differentiate, as the JAX package does (its Pallas SIM1 serves the
    trajectory path only).  dp_ref/pm: the reference thickness and
    pressure of each level (fill_dp, NH, Rayleigh_fast)."""
    if mode not in ("traj", "mixed"):
        raise ValueError(f"acoustic substep mode {mode!r}")
    npx = cfg.npx
    dt = dt_remap / cfg.n_split
    dt2 = 0.5 * dt
    device = grid["area"].device
    kcoef = _kcoef(cfg, npz, dtype, device)
    use_kernel = mode == "traj"
    mix_hord = mode == "mixed" and cfg.split_hord
    mix_damp = mode == "mixed" and cfg.split_damp
    # trajectory-side advection inside the linearization: the perturbation
    # sponge levels drop to hord_*_ks_traj when split
    hords_t = (_traj_sponge_hords(cfg, npz) if mix_hord else dict(
        hord_mt=cfg.hord_mt, hord_vt=cfg.hord_vt,
        hord_tm=cfg.hord_tm, hord_dp=cfg.hord_dp))
    if mix_hord or mix_damp:
        hords_p = (_pert_hords(cfg, npz) if mix_hord else dict(
            hord_mt=cfg.hord_mt, hord_vt=cfg.hord_vt,
            hord_tm=cfg.hord_tm, hord_dp=cfg.hord_dp))
        kcoef_p = _kcoef_pert(cfg, npz, dtype, device) if mix_damp else kcoef
    else:
        hords_p = kcoef_p = None
    rff = None
    if cfg.rayleigh_fast and cfg.tau > 0.0 and pm is not None:
        rff = _rayleigh_fast_factor(cfg, npz, abs(dt), ptop, pm,
                                    grid["area"])

    def stage_a(c, consts):
        """halo(u,v[,w]) -> c_sw -> geopk/p_grad_c (hydrostatic) or
        update_dz_c/Riem_Solver_C/p_grad_c (NH) -> halo(uc,vc)."""
        phis = consts["phis"]
        w = c["w"]
        with scope("halo_uv"):
            u, v = halo.fill_halo_dgrid(c["u"], c["v"], topo)
            if not cfg.hydrostatic:
                w = halo.fill_halo_center(w, topo)
        with scope("c_sw"):
            delpc, ptc, wc, uc, vc, divgd, ua, va, ut_c, vt_c = c_sw(
                c["delp"], c["pt"], u, v, w, c["uc"], c["vc"], grid, dt2,
                cfg.nord, npx, hydrostatic=cfg.hydrostatic)
        if cfg.nord > 0:
            divgd = halo.fill_halo_corner(divgd, topo)
        if cfg.hydrostatic:
            with scope("geopk_c"):
                _, _, pkc_c, gz_c, _ = geopk(ptop, delpc, ptc, phis, akap)
            with scope("p_grad_c"):
                uc, vc = p_grad_c(dt2, pkc_c, gz_c, uc, vc, grid, npx)
        else:
            # NH C-stage (dyn_core_nlm.F90:437-504)
            zs = phis / GRAV
            with scope("update_dz_c"):
                gz_m, ws3 = update_dz_c(dt2, dp_ref, zs, ut_c, vt_c, c["zh"],
                                        grid, npx)
            with scope("riem_c"):
                pkc_c, gz_c, _ = riem_solver_c(dt2, akap, ptop, phis, wc, ptc,
                                               delpc, gz_m, ws3, cfg.p_fac,
                                               use_kernel=use_kernel)
            with scope("p_grad_c"):
                uc, vc = p_grad_c(dt2, pkc_c, gz_c, uc, vc, grid, npx, delpc)
        uc, vc = halo.fill_halo_cgrid(uc, vc, topo)
        ab = dict(u=u, v=v, w=w, delp=c["delp"], pt=c["pt"], uc=uc, vc=vc,
                  divgd=divgd, ua=ua, va=va,
                  mfx=c["mfx"], mfy=c["mfy"], cx=c["cx"], cy=c["cy"],
                  heat_source=c["heat_source"])
        if cfg.beta > 0.0:
            ab.update(du=c["du"], dv=c["dv"], itc=c["itc"])
        if not cfg.hydrostatic:
            ab.update(zh=c["zh"], delz=c["delz"], ws=c["ws"])
        if cfg.d_ext > 0.0:
            ab["wk_dext"] = a2b_ord2(c["delp"], grid)   # per-level B delp
        return ab

    def stage_b(ab, consts):
        """d_sw (trajectory scheme [+ perturbation scheme, mixed])."""
        dsw_args = (ab["delp"], ab["pt"], ab["u"], ab["v"], ab["w"],
                    ab["uc"], ab["vc"], ab["ua"], ab["va"], ab["divgd"],
                    ab["mfx"], ab["mfy"], ab["cx"], ab["cy"])
        if hords_p is not None:
            # only the value of the trajectory scheme is used: run it on
            # detached inputs so that no derivative is carried through it
            targs = _detached(dsw_args)
        else:
            targs = dsw_args
        with scope("d_sw"):
            r = d_sw(*targs, grid, topo, dt, npx,
                     hords_t["hord_mt"], hords_t["hord_vt"],
                     hords_t["hord_tm"], hords_t["hord_dp"],
                     kcoef, hydrostatic=cfg.hydrostatic)
        if hords_p is not None:
            with scope("d_sw_pert"):
                r_p = d_sw(*dsw_args, grid, topo, dt, npx,
                           hords_p["hord_mt"], hords_p["hord_vt"],
                           hords_p["hord_tm"], hords_p["hord_dp"],
                           kcoef_p, hydrostatic=cfg.hydrostatic)
            r = mix_primal(r, r_p)
        if cfg.fill_dp:
            # thin-layer delp mixing before the delp/pt halo refresh
            # (dyn_core_nlm.F90:697)
            w_in = None if cfg.hydrostatic else r["w"]
            dmix, tmix, wmix = mix_dp(r["delp"], r["pt"], w_in, dp_ref,
                                      cfg.hydrostatic)
            r = dict(r, delp=dmix, pt=tmix)
            if w_in is not None:
                r["w"] = wmix
        bc = dict(
            delp=r["delp"], pt=r["pt"], u=r["u"], v=r["v"],
            w=ab["w"] if cfg.hydrostatic else r["w"],
            divgd=r["divg_d"], divd_b=r["divd_b"],
            mfx=r["xflux"], mfy=r["yflux"], cx=r["cx"], cy=r["cy"],
            heat_source=ab["heat_source"] + r["heat_source"],
            uc=ab["uc"], vc=ab["vc"],
        )
        if cfg.beta > 0.0:
            bc.update(du=ab["du"], dv=ab["dv"], itc=ab["itc"])
        if not cfg.hydrostatic:
            bc.update(zh=ab["zh"], delz=ab["delz"], ws=ab["ws"],
                      # per-substep courant numbers / area fluxes for
                      # update_dz_d
                      crx=r["crx"], cry=r["cry"], xfx=r["xfx"], yfx=r["yfx"])
        if cfg.d_ext > 0.0:
            bc["wk_dext"] = ab["wk_dext"]
        return bc

    def stage_c(bc, consts):
        """halo(delp,pt) -> geopk -> one_grad_p / grad1_p_update
        (hydrostatic), or update_dz_d -> Riem_Solver3 -> nh_p_grad /
        split_p_grad (NH, dyn_core_nlm.F90:762-880; pkz is the
        instantaneous NH equation of state) [-> Rayleigh_fast]."""
        phis = consts["phis"]
        delp = halo.fill_halo_center(bc["delp"], topo)
        pt = halo.fill_halo_center(bc["pt"], topo)
        u, v = bc["u"], bc["v"]
        # the external-mode damping vector (dyn_core_nlm.F90:707-728)
        if cfg.d_ext > 0.0:
            divg2 = _d_ext_divg2(bc["wk_dext"], bc["divd_b"],
                                 cfg.d_ext * grid["da_min_c"])
        else:
            divg2 = None
        if cfg.beta > 0.0:
            # no off-centering on the first substep of a dyn_core call
            # (beta_d = 0, dyn_core_nlm.F90:367-374)
            itc = bc["itc"]
            beta_d = torch.where(itc == 0.0, torch.zeros_like(itc),
                                 torch.full_like(itc, cfg.beta))
            if divg2 is None:
                divg2 = u.new_zeros(u.shape[1:-2] + _b_shape(delp))
        if cfg.hydrostatic:
            with scope("geopk_d"):
                pe, peln, pkc, gz, pkz = geopk(ptop, delp, pt, phis, akap)
            if cfg.beta > 0.0:
                with scope("grad1_p_update"):
                    u, v, du_n, dv_n = grad1_p_update(
                        u, v, pkc, gz, divg2, bc["du"], bc["dv"], dt, grid,
                        npx, ptop, akap, beta_d)
                extra = dict(du=du_n, dv=dv_n, itc=bc["itc"] + 1.0)
            else:
                with scope("one_grad_p"):
                    u, v = one_grad_p(u, v, pkc, gz, dt, grid, npx, ptop,
                                      akap, divg2)
                extra = {}
            w = bc["w"]
        else:
            zs_m = phis / GRAV
            with scope("update_dz_d"):
                zh_m, ws = update_dz_d(dt, dp_ref, zs_m, bc["zh"], bc["crx"],
                                       bc["cry"], bc["xfx"], bc["yfx"],
                                       cfg.hord_tm, grid, topo)
            with scope("riem_3"):
                sol = riem_solver3(dt, akap, ptop, zs_m, ws, pt, delp, zh_m,
                                   bc["w"], cfg.p_fac, use_kernel=use_kernel)
            zh2 = halo.fill_halo_center(sol["zh"], topo)
            pp = halo.fill_halo_center(sol["ppe"], topo)
            gz = zh2 * GRAV
            k1k = akap / (1.0 - akap)
            rrg = -RGAS / GRAV
            pkz = torch.exp(k1k * torch.log(torch.clamp(
                rrg * delp / torch.clamp(sol["delz"], max=-1e-2)
                * torch.clamp(pt, min=1e-10), min=1e-30)))
            extra = dict(zh=zh2, delz=sol["delz"], ws=ws)
            if cfg.beta > 0.0:
                with scope("split_p_grad"):
                    u, v, du_n, dv_n = split_p_grad(
                        u, v, pp, gz, delp, sol["pk3"], bc["du"], bc["dv"],
                        dt, grid, npx, ptop, akap, beta_d)
                extra.update(du=du_n, dv=dv_n, itc=bc["itc"] + 1.0)
            else:
                with scope("nh_p_grad"):
                    u, v = nh_p_grad(u, v, pp, gz, delp, sol["pk3"], dt,
                                     grid, npx, ptop, akap)
            pe, peln, pkc = sol["pe"], sol["peln"], sol["pk3"]
            w = sol["w"]
        if rff is not None:
            u = u * rff
            v = v * rff
            if not cfg.hydrostatic:
                w = w * rff
        return dict(
            u=u, v=v, w=w, delp=delp, pt=pt, uc=bc["uc"], vc=bc["vc"],
            divgd=bc["divgd"],
            mfx=bc["mfx"], mfy=bc["mfy"], cx=bc["cx"], cy=bc["cy"],
            heat_source=bc["heat_source"],
            pe=pe, peln=peln, pk=pkc, pkz=pkz, **extra,
        )

    def substep(c, consts):
        return stage_c(stage_b(stage_a(c, consts), consts), consts)

    substep.stages = (stage_a, stage_b, stage_c)
    return substep


def acoustic_finish(state, carry, grid, topo, cfg, dt_remap, npz):
    """Post-acoustic-loop work (dyn_core_nlm.F90:935-1100): the D-edge
    single-ownership fix, and with d_con the damping heat source into pt
    (:1051-1100).  Returns (state, vert)."""
    u, v = halo.fix_shared_edges_dgrid(carry["u"], carry["v"], topo)
    delp, pt = carry["delp"], carry["pt"]
    n_con = _n_con(cfg, npz)
    if cfg.d_con > 1.0e-5 and n_con != 0:
        T = grid["tile"]
        cs = (SL(1, T.ny), SL(1, T.nx))
        hs_full = torch.zeros_like(delp)
        hs_full[(Ellipsis,) + cs] = carry["heat_source"]
        hs_full = del2_cubed(hs_full, 0.20 * grid["da_min"], grid, topo,
                             min(3, cfg.nord + 1), cfg.npx)
        dtmp = hs_full[(Ellipsis,) + cs] / (CP_AIR * delp[(Ellipsis,) + cs])
        delt = abs(dt_remap) * cfg.delt_max
        kidx = torch.arange(npz, device=delp.device)[:, None, None, None]
        upd = torch.where(kidx < 3, dtmp,
                          fsign_mul(dtmp, fmin(delt, fabs(dtmp)))
                          ) / carry["pkz"][(Ellipsis,) + cs]
        upd = torch.where(kidx < n_con, upd, 0.0)
        pt = pt.clone()
        pt[(Ellipsis,) + cs] += upd
    state = dict(
        state, u=u, v=v, w=carry["w"], delp=delp, pt=pt,
        uc=carry["uc"], vc=carry["vc"], divgd=carry["divgd"],
        mfx=carry["mfx"], mfy=carry["mfy"], cx=carry["cx"], cy=carry["cy"],
    )
    if "delz" in carry:
        state.update(delz=carry["delz"], ws=carry["ws"])
    vert = dict(pk=carry["pk"], pe=carry["pe"], peln=carry["peln"],
                pkz=carry["pkz"])
    return state, vert


def dyn_core(state, grid, topo, cfg, dt_remap, akap, ptop, dp_ref, pm=None,
             compute_omega=False):
    """One mdt step = n_split trajectory acoustic substeps from the
    interface state.  Returns the final carry (post_acoustic_stage of
    core/fv_dynamics.py finishes it with acoustic_finish) and omega, None
    unless `compute_omega` on the hydrostatic path: the use_old_omega
    diagnostic (dyn_core_nlm.F90:378-392, 969-982) captures pem at the
    start of the last substep, then omega = (pe - pem)*rdt plus adv_pe
    with that substep's c_sw A-grid winds."""
    dtype = state["u"].dtype
    npz = state["delp"].shape[0]
    substep = make_acoustic_substep(grid, topo, cfg, dt_remap, akap, ptop,
                                    npz, dtype, dp_ref=dp_ref, pm=pm)
    carry = acoustic_carry(state, cfg, npz)
    consts = dict(phis=state["phis"])
    omega = compute_omega and cfg.hydrostatic
    for _ in range(cfg.n_split - 1 if omega else cfg.n_split):
        carry = substep(carry, consts)
    if not omega:
        return carry, None
    pem = pem_interfaces(carry["delp"], ptop)
    sa, sb, sc = substep.stages
    ab = sa(carry, consts)
    carry = sc(sb(ab, consts), consts)
    omga = (carry["pe"][1:] - pem[1:]) * (cfg.n_split / dt_remap)
    return carry, adv_pe(ab["ua"], ab["va"], pem, omga, grid, cfg.npx)


def _n_con(cfg, npz):
    """Heat-source application depth (dyn_core_nlm.F90:270-283)."""
    if cfg.convert_ke or cfg.vtdm4 > 1.0e-4:
        return npz
    if cfg.d2_bg_k1 < 1.0e-3:
        return 0
    return 1 if cfg.d2_bg_k2 < 1.0e-3 else 2


def _sponge_bands(cfg, npz):
    """Static per-k damping-coefficient bands (dyn_core_nlm.F90:536-630):
    a list of (k0, k1, params) with contiguous level ranges sharing one
    coefficient set."""
    base = dict(
        hord_mt=cfg.hord_mt, hord_vt=cfg.hord_vt, hord_tm=cfg.hord_tm,
        hord_dp=cfg.hord_dp,
        nord=cfg.nord, nord_v=min(2, cfg.nord), nord_t=min(2, cfg.nord),
        nord_w=min(2, cfg.nord),
        d2_divg=min(0.20, cfg.d2_bg),
        damp_v=(cfg.vtdm4 if cfg.do_vort_damp else 0.0),
        damp_w=(cfg.vtdm4 if cfg.do_vort_damp else 0.0),
        damp_t=(cfg.vtdm4 if cfg.do_vort_damp else 0.0),
        d_con=cfg.d_con,
    )
    if npz == 1 or cfg.n_sponge < 0:
        b = dict(base, d2_divg=cfg.d2_bg)
        return [(0, npz, b)]

    bands = []
    k_sponge2 = max(2, cfg.n_sponge - 1)
    k_sponge3 = max(3, cfg.n_sponge)
    specials = {}
    # k==1 (Fortran) -> index 0
    d2 = max(0.01, cfg.d2_bg, cfg.d2_bg_k1)
    p1 = dict(base, nord=0, d2_divg=d2, nord_w=0, damp_w=d2, d_con=0.0)
    if cfg.do_vort_damp:
        p1["nord_v"] = 0
        p1["damp_v"] = 0.5 * d2
        p1["damp_t"] = 0.5 * d2
    specials[0] = p1
    if cfg.d2_bg_k2 > 0.01:
        d2 = max(cfg.d2_bg, cfg.d2_bg_k2)
        p2 = dict(base, nord=0, d2_divg=d2, nord_w=0, damp_w=d2, d_con=0.0)
        if cfg.do_vort_damp:
            p2["nord_v"] = 0
            p2["damp_v"] = 0.5 * d2
            p2["damp_t"] = 0.5 * d2
        specials[k_sponge2 - 1] = p2
    if cfg.d2_bg_k2 > 0.05:
        d2 = max(cfg.d2_bg, 0.2 * cfg.d2_bg_k2)
        p3 = dict(base, nord=0, d2_divg=d2, nord_w=0, damp_w=d2, d_con=0.0)
        specials[k_sponge3 - 1] = p3

    k = 0
    while k < npz:
        if k in specials:
            bands.append((k, k + 1, specials[k]))
            k += 1
        else:
            k1 = k + 1
            while k1 < npz and k1 not in specials:
                k1 += 1
            bands.append((k, k1, base))
            k = k1
    return bands
