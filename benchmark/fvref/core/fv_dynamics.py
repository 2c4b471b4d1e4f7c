"""fv_dynamics: the k_split / remap level loop (fv_dynamics_nlm.F90:70-760).

Counterpart of fv3jedi_lm_tpu/core/fv_dynamics.py.  One call advances the
state one model step bdt:

  T -> theta_v -> [ dyn_core -> tracer_2d -> Lagrangian_to_Eulerian ]
  x k_split -> T

State layout: dict of (npz, 6, jy, jx) padded tensors (staggered dims per
field), tracers as a list.  The stages prep_stage, pre_acoustic_stage and
post_acoustic_stage are exposed for the staged tangent-linear and adjoint
sweeps (core/staged.py).  The options: the energy-conserving remap
(consv_te: the step-entry total energy te0_2d and the global correction
dtmp of the last remap), Rayleigh friction (tau > 0, after the last
remap), the omega diagnostic (compute_omega, nonlinear step only) and
the del-n tracer damping (nord_tr/trdm2).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import NG
from ..constants import CP as CP_AIR
from ..constants import GRAV, KAPPA, RGAS, ZVIR
from ..ops import fv_mapz
from ..ops.c2l import c2l_ord4
from ..ops.reductions import CONSV_MIN, g_sum
from ..ops.sw_core import F2P, SL, cells
from ..parallel import halo
from ..timing import scope
from . import freeze
from .dyn_core import acoustic_finish, del2_cubed, dyn_core
from .freeze import mix_primal
from .fv_pressure import compute_fv3_pressures
from .tracer2d import tracer_2d


def _ke(u, v, grid):
    """Kinetic energy per unit mass on the compute cells from the D-grid
    winds (compute_total_energy, fv_mapz_nlm.F90:1010-1032)."""
    T = grid["tile"]
    cs = cells(grid)
    u_b = u[..., SL(1, T.ny + 1), cs[2]]
    v_b = v[..., cs[1], SL(1, T.nx + 1)]
    return 0.25 * grid["rsin2"][cs] * (
        u_b[..., :-1, :] ** 2 + u_b[..., 1:, :] ** 2
        + v_b[..., :, :-1] ** 2 + v_b[..., :, 1:] ** 2
        - (u_b[..., :-1, :] + u_b[..., 1:, :])
        * (v_b[..., :, :-1] + v_b[..., :, 1:]) * grid["cosa_s"][cs])


def total_energy_hydro(u, v, tv, delp, pe, peln, hs, grid, npx):
    """Vertically integrated total energy per column, hydrostatic remap-T
    form (compute_total_energy, fv_mapz_nlm.F90:1010-1032, and the
    last-step recomputation, :640-659).  All inputs padded; tv is the
    virtual temperature on levels.  Returns the (6, n, n) compute-domain
    te_2d."""
    cs = cells(grid)
    tv_c = tv[cs]
    peln_c = peln[cs]
    hs_c = hs[cs]
    # gz at the model top: hs + sum_k rg*tv*(peln(k+1)-peln(k))
    gz_top = hs_c + (RGAS * tv_c * (peln_c[1:] - peln_c[:-1])).sum(0)
    te = pe[-1][cs] * hs_c - pe[0][cs] * gz_top
    return te + (delp[cs] * (CP_AIR * tv_c + _ke(u, v, grid))).sum(0)


def lagrangian_to_eulerian(state, vert, q, grid, cfg, ak, bk, akap, ptop,
                           last_step, mode="traj", faces=None):
    """Vertical remap back to the Eulerian hybrid coordinate
    (fv_mapz_nlm.F90:60-960, remap T in log p).  Nonhydrostatic, w is
    remapped with the surface ws as bottom condition and delz as specific
    volume, then the NH equation-of-state pkz (:298-302, 420-431, 500-506);
    hydrostatic, pkz follows from the new pk/peln.

    vert: dict(pk, pe, peln, pkz) from the final acoustic substep; ak/bk
    (npz+1,) tensors.  Only the defined lanes are remapped: the compute
    domain for cell fields, plus the one valid halo ring the staggered
    edge rows need.  mode="mixed" (split_kord) remaps the value with the
    trajectory kord and the derivative with the perturbation kord
    (fv_mapz_tlm.F90:571-830), joined by `freeze.mix_primal`.  On the last
    step, with consv_te and the step-entry te0_2d in `state`, the
    temperature takes the global total-energy correction (fv_mapz_nlm.
    F90:633-785; `faces`, the rank's FaceGroup on a face decomposition,
    takes its global sum across the ranks), and the omega of `vert` is
    remapped.  Returns (state, q, new vert)."""
    pe, peln, pkz = vert["pe"], vert["peln"], vert["pkz"]
    pt, delp = state["pt"], state["delp"]
    u, v = state["u"], state["v"]
    npz = delp.shape[0]
    T = grid["tile"]
    kord_tm = abs(cfg.kord_tm)
    p = F2P
    cs = cells(grid)
    csy, csx = cs[1:]

    def remap_mix(kord_t, kord_p, call):
        out = call(kord_t)
        if mode == "mixed" and cfg.split_kord and kord_p != kord_t:
            out = mix_primal(out, call(kord_p))
        return out

    pe_c = pe[cs]
    peln_c = peln[cs]
    ps_c = pe_c[-1]
    akx = ak.reshape((npz + 1,) + (1,) * (pe.ndim - 1))
    bkx = bk.reshape((npz + 1,) + (1,) * (pe.ndim - 1))
    pe2_c = akx + bkx * ps_c[None]
    pn2_c = torch.log(pe2_c)
    pk2_c = torch.exp(akap * pn2_c)

    # theta_v -> virtual temperature, remapped in log(p) (iv=1)
    pt_c = remap_mix(kord_tm, abs(cfg.kord_tm_pert), lambda kd: (
        fv_mapz.map1_ppm(peln_c, pt[cs] * pkz[cs], None,
                         pn2_c, 1, kd, q_min=fv_mapz.T_MIN)))

    # tracers in p (iv=0)
    if freeze.active() or mode == "mixed":
        # one remap per tracer, in the JAX package's tape order
        qs = [remap_mix(cfg.kord_tr, cfg.kord_tr_pert,
                        lambda kd, qq=qq: fv_mapz.map1_ppm(
                            pe_c, qq[cs], None, pe2_c, 0, kd))
              for qq in q]
    else:
        # the tracers a batch dimension next to k
        nq = len(q)
        qsrc = torch.stack([qq[cs] for qq in q], dim=1)
        qexp = (npz + 1, nq) + pe_c.shape[1:]
        qs = fv_mapz.map1_ppm(pe_c[:, None].expand(qexp), qsrc, None,
                              pe2_c[:, None].expand(qexp), 0,
                              cfg.kord_tr).unbind(1)
    q_new = []
    for qq, qc in zip(q, qs):
        qq = qq.clone()
        qq[cs] = qc
        q_new.append(qq)
    q = q_new

    # u on B rows 1..Y: pe averaged between adjacent cell rows
    rm = slice(p(0), p(T.ny) + 1)       # cell rows j-1, j=1..Y
    r0 = slice(p(1), p(T.ny + 1) + 1)   # cell rows j (= B rows 1..Y)
    cm = slice(p(0), p(T.nx) + 1)
    c0 = slice(p(1), p(T.nx + 1) + 1)
    ps_e = pe[-1][None]
    pe_u = 0.5 * (pe[..., rm, csx] + pe[..., r0, csx])
    pe3_u = akx + 0.5 * bkx * (ps_e[..., rm, csx] + ps_e[..., r0, csx])
    u_mid = remap_mix(cfg.kord_mt, cfg.kord_mt_pert, lambda kd: (
        fv_mapz.map1_ppm(pe_u, u[..., r0, csx], None, pe3_u, -1, kd)))
    u = u.clone()
    u[..., r0, csx] = u_mid
    pe_v = 0.5 * (pe[..., csy, cm] + pe[..., csy, c0])
    pe3_v = akx + 0.5 * bkx * (ps_e[..., csy, cm] + ps_e[..., csy, c0])
    v_mid = remap_mix(cfg.kord_mt, cfg.kord_mt_pert, lambda kd: (
        fv_mapz.map1_ppm(pe_v, v[..., csy, c0], None, pe3_v, -1, kd)))
    v = v.clone()
    v[..., csy, c0] = v_mid

    if cfg.hydrostatic:
        pkz_new_c = (pk2_c[1:] - pk2_c[:-1]) / (akap * (pn2_c[1:]
                                                         - pn2_c[:-1]))
    else:
        # NH: w with the surface ws bottom condition (iv=-2), delz as
        # specific volume, then the NH equation-of-state pkz
        rrg = -RGAS / GRAV
        w_c = remap_mix(cfg.kord_wz, cfg.kord_wz, lambda kd: fv_mapz.map1_ppm(
            pe_c, state["w"][cs], state["ws"][cs], pe2_c,
            -2, kd))
        w = state["w"].clone()
        w[cs] = w_c
        delz = state["delz"]
        sv_c = -delz[cs] / delp[cs]
        sv_c = remap_mix(kord_tm, abs(cfg.kord_tm_pert), lambda kd: (
            fv_mapz.map1_ppm(pe_c, sv_c, None, pe2_c, 1, kd)))
        delz_new_c = -sv_c * (pe2_c[1:] - pe2_c[:-1])
        delz = delz.clone()
        delz[cs] = delz_new_c
        state = dict(state, w=w, delz=delz)
        pkz_new_c = torch.exp(akap * torch.log(torch.clamp(
            rrg * (pe2_c[1:] - pe2_c[:-1]) / torch.clamp(delz_new_c, max=-1e-2)
            * torch.clamp(pt_c, min=1e-10), min=1e-30)))

    if last_step:
        dtmp = 0.0
        if cfg.consv_te > CONSV_MIN and "te0_2d" in state:
            # the total-energy-conserving correction (fv_mapz_nlm.F90:
            # 633-785): the energy on the new coordinate against the
            # step-entry te0_2d, the global deficit by the reproducible
            # g_sum, applied as pt += dtmp*pkz before the virtual-T
            # division
            hs_c = state["phis"][cs]
            delp_new_c = pe2_c[1:] - pe2_c[:-1]
            gz_top = hs_c + (RGAS * pt_c * (pn2_c[1:] - pn2_c[:-1])).sum(0)
            te_new = (pe2_c[-1] * hs_c - pe2_c[0] * gz_top
                      + (delp_new_c * (CP_AIR * pt_c + _ke(u, v, grid))
                         ).sum(0))
            zsum1 = (pkz_new_c * delp_new_c).sum(0)
            zsum0 = ptop * (pk2_c[0] - pk2_c[-1]) + zsum1
            area_c = grid["area"][cs]
            tpe = cfg.consv_te * g_sum(state["te0_2d"] - te_new, area_c,
                                       faces=faces)
            dtmp = tpe / (CP_AIR * g_sum(zsum0, area_c, faces=faces))
        # virtual T -> T (fv_mapz_nlm.F90:857-892)
        pt_c = (pt_c + dtmp * pkz_new_c) / (1.0 + ZVIR * qs[0])
    else:
        pt_c = pt_c / pkz_new_c

    pt = pt.clone()
    pt[cs] = pt_c
    delp = delp.clone()
    delp[cs] = pe2_c[1:] - pe2_c[:-1]
    ps = state["ps"].clone() if "ps" in state else torch.zeros_like(pe[-1])
    ps[cs] = ps_c

    state = dict(state, pt=pt, delp=delp, u=u, v=v, ps=ps)
    if last_step and "omga" in vert:
        om = torch.zeros_like(delp)
        om[cs] = _remap_omega(vert["omga"][cs], peln_c,
                                       pn2_c)
        state["omga"] = om
    vert = dict(pe=pe2_c, peln=pn2_c, pk=pk2_c, pkz=pkz_new_c)
    return state, q, vert


def _remap_omega(om_c, peln_c, pn2_c):
    """Omega from the Lagrangian interfaces to the new Eulerian mid-levels
    in log p (fv_mapz_nlm.F90:445-541, do_omega): omega sits at the lower
    interface of each Lagrangian layer (pe3(1)=0, pe3(k)=omga(k-1)); the
    targets are 0.5*(peln_new(k)+peln_new(k+1)).  The bracket search is
    one searchsorted over the columns; out-of-range targets extrapolate
    from the clipped end bracket."""
    km = om_c.shape[0]
    pe3 = torch.cat([torch.zeros_like(om_c[:1]), om_c])
    dp2 = 0.5 * (pn2_c[:-1] + pn2_c[1:])
    flat_pe = peln_c.reshape(km + 1, -1).T.contiguous()
    flat_o = pe3.reshape(km + 1, -1).T
    flat_dp = dp2.reshape(km, -1).T.contiguous()
    k = torch.clamp(torch.searchsorted(flat_pe, flat_dp, right=True) - 1,
                    0, km - 1)
    pl, pr = flat_pe.gather(1, k), flat_pe.gather(1, k + 1)
    ol, orr = flat_o.gather(1, k), flat_o.gather(1, k + 1)
    out = ol + (orr - ol) * (flat_dp - pl) / (pr - pl)
    return out.T.reshape(om_c.shape)


def prep_stage(state, q, grid, topo, cfg, ptop):
    """Entry marshalling: halo fills, T -> theta_v, zeroed scratch
    winds/capacitors (fv_dynamics_nlm.F90:397-430), and with consv_te
    (hydrostatic) the step-entry total energy te0_2d (:366-372).

    Hydrostatic, the entry pkz is that of compute_fv3_pressures.
    Nonhydrostatic, it is (rrg*delp/delz*Tv)**kappa, the exact inverse of
    the remap's exit conversion, so a state at rest round-trips exactly."""
    akap = KAPPA
    u = state["u"]
    lead = (state["delp"].shape[0], state["delp"].shape[1])
    jcy, jcx = state["delp"].shape[-2:]
    ny, nx = jcy - 2 * NG, jcx - 2 * NG

    delp = halo.fill_halo_center(state["delp"], topo)
    pt_in = halo.fill_halo_center(state["pt"], topo)
    q = [halo.fill_halo_center(qq, topo) for qq in q]
    sphum = q[0]

    if cfg.hydrostatic:
        pe, peln, _, pkz = compute_fv3_pressures(delp, akap, ptop)
        pt = pt_in * (1.0 + ZVIR * sphum) / pkz
        if cfg.consv_te > CONSV_MIN:
            state = dict(state, te0_2d=total_energy_hydro(
                state["u"], state["v"], pt_in * (1.0 + ZVIR * sphum), delp,
                pe, peln, state["phis"], grid, cfg.npx))
    else:
        rrg = -RGAS / GRAV
        delz = halo.fill_halo_center(state["delz"], topo)
        tv = pt_in * (1.0 + ZVIR * sphum)
        pkz_nh = torch.exp(akap * torch.log(torch.clamp(
            rrg * delp / torch.clamp(delz, max=-1e-2)
            * torch.clamp(tv, min=1e-10), min=1e-30)))
        pt = tv / pkz_nh
        state = dict(state, delz=delz)

    state = dict(
        state, delp=delp, pt=pt,
        uc=u.new_zeros(lead + (jcy, jcx + 1)),
        vc=u.new_zeros(lead + (jcy + 1, jcx)),
        divgd=u.new_zeros(lead + (jcy + 1, jcx + 1)),
        mfx=u.new_zeros(lead + (ny, nx + 1)),
        mfy=u.new_zeros(lead + (ny + 1, nx)),
        cx=u.new_zeros(lead + (jcy, nx + 1)),
        cy=u.new_zeros(lead + (ny + 1, jcx)),
        ps=u.new_zeros(lead[1:] + (jcy, jcx)),
    )
    return state, q


def pre_acoustic_stage(state, topo, cfg):
    """Start of one k_split sub-step: reset flux capacitors, refresh
    delp/pt (and NH delz) halos.  Returns (state', dp1)."""
    u = state["u"]
    lead = (state["delp"].shape[0], state["delp"].shape[1])
    jcy, jcx = state["delp"].shape[-2:]
    ny, nx = jcy - 2 * NG, jcx - 2 * NG
    state = dict(
        state,
        mfx=u.new_zeros(lead + (ny, nx + 1)),
        mfy=u.new_zeros(lead + (ny + 1, nx)),
        cx=u.new_zeros(lead + (jcy, nx + 1)),
        cy=u.new_zeros(lead + (ny + 1, jcx)),
        delp=halo.fill_halo_center(state["delp"], topo),
        pt=halo.fill_halo_center(state["pt"], topo),
    )
    if not cfg.hydrostatic:
        state["delz"] = halo.fill_halo_center(state["delz"], topo)
    return state, state["delp"]


def transport_tracers(q, dp1, state, grid, topo, cfg, mode="traj"):
    """tracer_2d with the step's accumulated fluxes and the del-n damping
    of nord_tr/trdm2.  mode="mixed" splits its linearization
    (hord_tr_pert, split_damp_tr, fv_tracer2d_tlm.F90:39-43) with
    `freeze.mix_primal`; the trajectory scheme then gives only the value,
    so it runs on detached inputs.  No tracers, or inline_q: no
    transport here."""
    if len(q) == 0 or cfg.inline_q:
        return q
    fluxes = (dp1, state["mfx"], state["mfy"], state["cx"], state["cy"])

    def tr(hord, nord, trdm, q, fluxes):
        return tracer_2d(q, *fluxes, grid, topo, cfg, cfg.npx, hord,
                         nord_tr=nord, trdm=trdm)

    mix_tr = mode == "mixed" and (
        (cfg.split_hord and cfg.hord_tr_pert != cfg.hord_tr)
        or (cfg.split_damp_tr and (cfg.nord_tr_pert != cfg.nord_tr
                                   or cfg.trdm2_pert != cfg.trdm2)))
    if not mix_tr:
        return tr(cfg.hord_tr, cfg.nord_tr, cfg.trdm2, q, fluxes)
    q_t = tr(cfg.hord_tr, cfg.nord_tr, cfg.trdm2, [x.detach() for x in q],
             tuple(f.detach() for f in fluxes))
    hord_p = cfg.hord_tr_pert if cfg.split_hord else cfg.hord_tr
    nord_p = cfg.nord_tr_pert if cfg.split_damp_tr else cfg.nord_tr
    trdm_p = cfg.trdm2_pert if cfg.split_damp_tr else cfg.trdm2
    return mix_primal(q_t, tr(hord_p, nord_p, trdm_p, q, fluxes))


def post_acoustic_stage(state, carry, q, dp1, grid, topo, cfg, ak, bk,
                        pm, ptop, mdt, last_step, mode="traj"):
    """End of one k_split sub-step: acoustic_finish + tracer transport +
    vertical remap (fv_dynamics_nlm.F90:534-633), then on the last one the
    Rayleigh friction.  ak/bk: (npz+1,) tensors; pm: the levels' reference
    pressures (numpy).

    mode="mixed" splits the linearization of the tracer transport and of
    each remap (split_kord) with `freeze.mix_primal`."""
    npz = state["delp"].shape[0]
    with scope("acoustic_finish"):
        state, vert = acoustic_finish(state, carry, grid, topo, cfg, mdt,
                                      npz)
    with scope("tracer_2d"):
        q = transport_tracers(q, dp1, state, grid, topo, cfg, mode)
    if npz > 4:
        with scope("remap"):
            state, q, vert = lagrangian_to_eulerian(
                state, vert, q, grid, cfg, ak, bk, KAPPA, ptop, last_step,
                mode=mode, faces=getattr(topo, "faces", None))
    if last_step:
        state = rayleigh(state, grid, topo, cfg, mdt * cfg.k_split, pm, ptop)
    return state, q


def _rf_levels(cfg, bdt, pm, ptop):
    """The Rayleigh rates rf of the contiguous band of top levels with
    reference pressure pm < rf_cutoff, and the band's depth kmax
    (fv_dynamics_nlm.F90:800-830)."""
    rf = np.zeros(len(pm))
    kmax = 0
    for k in range(len(pm)):
        if pm[k] < cfg.rf_cutoff:
            rf[k] = (abs(bdt) / (cfg.tau * 86400.0)
                     * np.sin(0.5 * np.pi * np.log(cfg.rf_cutoff / pm[k])
                              / np.log(cfg.rf_cutoff / ptop)) ** 2)
            kmax = k + 1
        else:
            break
    return rf, kmax


def rayleigh(state, grid, topo, cfg, bdt, pm, ptop):
    """Rayleigh friction of the step when tau > 0: Rayleigh_Super on the
    cube (grid_type < 4), Rayleigh_Friction otherwise.  pm: the levels'
    reference pressures (reference_pressure)."""
    if cfg.tau <= 0.0:
        return state
    if cfg.grid_type < 4:
        return rayleigh_super(state, grid, topo, cfg, bdt, pm, ptop)
    return rayleigh_friction(state, grid, topo, cfg, bdt, pm, ptop)


def _heat_den(pm, ptop, like):
    """cp - cp*kappa*ptop/pm, per level, as a (npz, 1, 1, 1) tensor."""
    pm_t = torch.as_tensor(pm.reshape(-1, 1, 1, 1), dtype=like.dtype,
                           device=like.device)
    return CP_AIR - (CP_AIR * KAPPA) * ptop / pm_t


def rayleigh_super(state, grid, topo, cfg, bdt, pm, ptop):
    """Rayleigh friction on the top sponge levels (Rayleigh_Super,
    fv_dynamics_nlm.F90:770-937, non-HIWPP branch, conserve=.true.).

    rf(k) = dt/(tau*86400) * sin(pi/2 * log(rfc/pm)/log(rfc/ptop))^2 on
    the contiguous band of levels with reference pressure pm < rf_cutoff;
    the winds are relaxed by 1/(1+rf) and the lost kinetic energy returns
    as heat (pt is the temperature here, at the end of the step).  The KE
    uses c2l_ord4, as the JAX package does."""
    npz = state["delp"].shape[0]
    rf, kmax = _rf_levels(cfg, bdt, pm, ptop)
    if kmax == 0:
        return state
    u = state["u"]
    u2f = torch.as_tensor(
        np.where(np.arange(npz) < kmax, 1.0 / (1.0 + rf), 1.0)
        .reshape(npz, 1, 1, 1), dtype=u.dtype, device=u.device)
    cs = cells(grid)
    ua, va = c2l_ord4(u, state["v"], grid, topo, cfg.npx)
    heat = (0.5 * (ua[cs] ** 2 + va[cs] ** 2)
            * (1.0 - u2f ** 2) / _heat_den(pm, ptop, u))
    pt = state["pt"].clone()
    pt[cs] += heat
    return dict(state, u=u * u2f, v=state["v"] * u2f, pt=pt)


def rayleigh_friction(state, grid, topo, cfg, bdt, pm, ptop):
    """Rayleigh_Friction (fv_dynamics_nlm.F90:940-1076, conserve=.true.,
    hydrostatic): velocity-dependent drag above rf_cutoff with frictional
    heating (the reference's branch for grid_type >= 4)."""
    npz = state["delp"].shape[0]
    rf, kmax = _rf_levels(cfg, bdt, pm, ptop)
    if kmax == 0:
        return state
    u0 = state["u"]
    u000 = 4900.0
    active = np.arange(npz) < kmax
    rfk = torch.as_tensor(np.where(active, rf, 0.0).reshape(npz, 1, 1, 1),
                          dtype=u0.dtype, device=u0.device)
    act = torch.as_tensor(active.reshape(npz, 1, 1, 1), device=u0.device)
    cs = cells(grid)
    ua, va = c2l_ord4(u0, state["v"], grid, topo, cfg.npx)
    u2f_c = ua ** 2 + va ** 2
    heat = (0.5 * u2f_c[cs] / _heat_den(pm, ptop, u0)
            * (1.0 - 1.0 / (1.0 + rfk * torch.sqrt(u2f_c[cs]
                                                    / u000)) ** 2))
    pt = state["pt"].clone()
    pt[cs] += torch.where(act, heat, 0.0)
    # the drag: u2f -> rf*sqrt(u2f/u000), halo-filled, staggered averages;
    # the square root on the compute lanes only (the halo is refilled, and
    # a root of the zero halo lanes would put NaN in its derivative)
    u2f = torch.zeros_like(u2f_c)
    u2f[cs] = rfk * torch.sqrt(u2f_c[cs] / u000)
    u2f = halo.fill_halo_center(u2f, topo)
    u_div = 1.0 + 0.5 * (u2f[..., 0:-1, :] + u2f[..., 1:, :])
    u = u0.clone()
    u[..., 1:-1, :] = torch.where(act, u0[..., 1:-1, :] / u_div,
                                  u0[..., 1:-1, :])
    v0 = state["v"]
    v_div = 1.0 + 0.5 * (u2f[..., :, 0:-1] + u2f[..., :, 1:])
    v = v0.clone()
    v[..., :, 1:-1] = torch.where(act, v0[..., :, 1:-1] / v_div,
                                  v0[..., :, 1:-1])
    return dict(state, u=u, v=v, pt=pt)


def fv_dynamics(state, q, grid, topo, cfg, bdt, ak, bk, ptop):
    """One nonlinear model step of bdt seconds.

    state: u, v, w, pt (TEMPERATURE in/out), delp, phis (+ delz when
    nonhydrostatic).  q: list of tracers, q[0] = specific humidity.  ak/bk:
    (npz+1,) numpy arrays in the working precision.  Returns (state, q),
    with omga (hydrostatic, compute_omega) after the nf_omega filter.
    The stages are those of post_acoustic_stage, called here one by one
    so that the tracers before transport are freed before the remap (the
    step's memory peak)."""
    dtype = state["u"].dtype
    device = state["u"].device
    ak_t = torch.as_tensor(ak, dtype=dtype, device=device)
    bk_t = torch.as_tensor(bk, dtype=dtype, device=device)
    dp_ref = reference_thickness(ak, bk)
    pm = reference_pressure(ak, bk)
    npz = state["delp"].shape[0]

    state, q = prep_stage(state, q, grid, topo, cfg, ptop)
    mdt = bdt / cfg.k_split
    for it in range(cfg.k_split):
        last = it == cfg.k_split - 1
        state, dp1 = pre_acoustic_stage(state, topo, cfg)
        with scope("dyn_core"):
            carry, omga = dyn_core(state, grid, topo, cfg, mdt, KAPPA, ptop,
                                   dp_ref, pm=pm,
                                   compute_omega=cfg.compute_omega and last)
        with scope("acoustic_finish"):
            state, vert = acoustic_finish(state, carry, grid, topo, cfg, mdt,
                                          npz)
        if omga is not None:
            vert["omga"] = omga
        with scope("tracer_2d"):
            q = transport_tracers(q, dp1, state, grid, topo, cfg)
        if npz > 4:
            with scope("remap"):
                state, q, vert = lagrangian_to_eulerian(
                    state, vert, q, grid, cfg, ak_t, bk_t, KAPPA, ptop, last,
                    faces=getattr(topo, "faces", None))
    if "omga" in state and cfg.nf_omega > 0:
        # omega filtered for the physics (fv_dynamics_nlm.F90:627-629)
        state["omga"] = del2_cubed(state["omga"], 0.18 * grid["da_min"],
                                   grid, topo, cfg.nf_omega, cfg.npx)
    state = rayleigh(state, grid, topo, cfg, bdt, pm, ptop)
    return state, q


def reference_thickness(ak, bk):
    """dp_ref(k) of the reference surface pressure 1e5 Pa
    (dyn_core_nlm.F90:216-219), float64 numpy."""
    pe_ref = np.asarray(ak, np.float64) + np.asarray(bk, np.float64) * 1e5
    return pe_ref[1:] - pe_ref[:-1]


def reference_pressure(ak, bk):
    """The layer-mean reference pressure pm(k) of the surface pressure
    1e5 Pa (Rayleigh_fast's pm), float64 numpy."""
    pe_ref = np.asarray(ak, np.float64) + np.asarray(bk, np.float64) * 1e5
    return ((pe_ref[1:] - pe_ref[:-1])
            / np.log(np.maximum(pe_ref[1:], 1e-10)
                     / np.maximum(pe_ref[:-1], 1e-10)))
