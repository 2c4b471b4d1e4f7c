"""fv_dynamics: the k_split / remap level loop (fv_dynamics_nlm.F90:70-760).

Counterpart of fv3jedi_lm_tpu/core/fv_dynamics.py.  One call advances the
state one model step bdt:

  T -> theta_v -> [ dyn_core -> tracer_2d -> Lagrangian_to_Eulerian ]
  x k_split -> T

State layout: dict of (npz, 6, jy, jx) padded tensors (staggered dims per
field), tracers as a list.  The stages prep_stage, pre_acoustic_stage and
post_acoustic_stage are exposed for the staged tangent-linear and adjoint
sweeps (core/staged.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import NG
from ..constants import GRAV, KAPPA, RGAS, ZVIR
from ..ops import fv_mapz
from ..ops.sw_core import F2P, SL
from ..parallel import halo
from ..timing import scope
from . import freeze
from .dyn_core import acoustic_finish, dyn_core
from .freeze import mix_primal
from .fv_pressure import compute_fv3_pressures
from .tracer2d import tracer_2d

#: consv_te threshold (fv3jedi_lm_tpu/ops/reductions.py CONSV_MIN)
CONSV_MIN = 0.001


def lagrangian_to_eulerian(state, vert, q, cfg, ak, bk, akap, last_step,
                           mode="traj"):
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
    (fv_mapz_tlm.F90:571-830), joined by `freeze.mix_primal`.  Returns
    (state, q, new vert)."""
    if last_step and cfg.consv_te > CONSV_MIN:
        raise NotImplementedError(
            "consv_te: ROADMAP Queue 1, remaining dynamics options")
    pe, peln, pkz = vert["pe"], vert["peln"], vert["pkz"]
    pt, delp = state["pt"], state["delp"]
    u, v = state["u"], state["v"]
    npz = delp.shape[0]
    npy = npx = cfg.npx
    n = npx - 1
    kord_tm = abs(cfg.kord_tm)
    p = F2P
    cs = SL(1, n)

    def remap_mix(kord_t, kord_p, call):
        out = call(kord_t)
        if mode == "mixed" and cfg.split_kord and kord_p != kord_t:
            out = mix_primal(out, call(kord_p))
        return out

    pe_c = pe[..., cs, cs]
    peln_c = peln[..., cs, cs]
    ps_c = pe_c[-1]
    akx = ak.reshape((npz + 1,) + (1,) * (pe.ndim - 1))
    bkx = bk.reshape((npz + 1,) + (1,) * (pe.ndim - 1))
    pe2_c = akx + bkx * ps_c[None]
    pn2_c = torch.log(pe2_c)
    pk2_c = torch.exp(akap * pn2_c)

    # theta_v -> virtual temperature, remapped in log(p) (iv=1)
    pt_c = remap_mix(kord_tm, abs(cfg.kord_tm_pert), lambda kd: (
        fv_mapz.map1_ppm(peln_c, pt[..., cs, cs] * pkz[..., cs, cs], None,
                         pn2_c, 1, kd, q_min=fv_mapz.T_MIN)))

    # tracers in p (iv=0)
    if freeze.active() or mode == "mixed":
        # one remap per tracer, in the JAX package's tape order
        qs = [remap_mix(cfg.kord_tr, cfg.kord_tr_pert,
                        lambda kd, qq=qq: fv_mapz.map1_ppm(
                            pe_c, qq[..., cs, cs], None, pe2_c, 0, kd))
              for qq in q]
    else:
        # the tracers a batch dimension next to k
        nq = len(q)
        qsrc = torch.stack([qq[..., cs, cs] for qq in q], dim=1)
        qexp = (npz + 1, nq) + pe_c.shape[1:]
        qs = fv_mapz.map1_ppm(pe_c[:, None].expand(qexp), qsrc, None,
                              pe2_c[:, None].expand(qexp), 0,
                              cfg.kord_tr).unbind(1)
    q_new = []
    for qq, qc in zip(q, qs):
        qq = qq.clone()
        qq[..., cs, cs] = qc
        q_new.append(qq)
    q = q_new

    # u on B rows 1..npy: pe averaged between adjacent cell rows
    rm = slice(p(0), p(npy - 1) + 1)   # cell rows j-1, j=1..npy
    r0 = slice(p(1), p(npy) + 1)       # cell rows j
    bsl = slice(p(1), p(npy) + 1)      # B rows 1..npy
    ps_e = pe[-1][None]
    pe_u = 0.5 * (pe[..., rm, cs] + pe[..., r0, cs])
    pe3_u = akx + 0.5 * bkx * (ps_e[..., rm, cs] + ps_e[..., r0, cs])
    u_mid = remap_mix(cfg.kord_mt, cfg.kord_mt_pert, lambda kd: (
        fv_mapz.map1_ppm(pe_u, u[..., bsl, cs], None, pe3_u, -1, kd)))
    u = u.clone()
    u[..., bsl, cs] = u_mid
    pe_v = 0.5 * (pe[..., cs, rm] + pe[..., cs, r0])
    pe3_v = akx + 0.5 * bkx * (ps_e[..., cs, rm] + ps_e[..., cs, r0])
    v_mid = remap_mix(cfg.kord_mt, cfg.kord_mt_pert, lambda kd: (
        fv_mapz.map1_ppm(pe_v, v[..., cs, bsl], None, pe3_v, -1, kd)))
    v = v.clone()
    v[..., cs, bsl] = v_mid

    if cfg.hydrostatic:
        pkz_new_c = (pk2_c[1:] - pk2_c[:-1]) / (akap * (pn2_c[1:]
                                                         - pn2_c[:-1]))
    else:
        # NH: w with the surface ws bottom condition (iv=-2), delz as
        # specific volume, then the NH equation-of-state pkz
        rrg = -RGAS / GRAV
        w_c = remap_mix(cfg.kord_wz, cfg.kord_wz, lambda kd: fv_mapz.map1_ppm(
            pe_c, state["w"][..., cs, cs], state["ws"][..., cs, cs], pe2_c,
            -2, kd))
        w = state["w"].clone()
        w[..., cs, cs] = w_c
        delz = state["delz"]
        sv_c = -delz[..., cs, cs] / delp[..., cs, cs]
        sv_c = remap_mix(kord_tm, abs(cfg.kord_tm_pert), lambda kd: (
            fv_mapz.map1_ppm(pe_c, sv_c, None, pe2_c, 1, kd)))
        delz_new_c = -sv_c * (pe2_c[1:] - pe2_c[:-1])
        delz = delz.clone()
        delz[..., cs, cs] = delz_new_c
        state = dict(state, w=w, delz=delz)
        pkz_new_c = torch.exp(akap * torch.log(torch.clamp(
            rrg * (pe2_c[1:] - pe2_c[:-1]) / torch.clamp(delz_new_c, max=-1e-2)
            * torch.clamp(pt_c, min=1e-10), min=1e-30)))

    if last_step:
        # virtual T -> T (consv_te = 0: no energy-fixer increment)
        dtmp = 0.0
        pt_c = (pt_c + dtmp * pkz_new_c) / (1.0 + ZVIR * qs[0])
    else:
        pt_c = pt_c / pkz_new_c

    pt = pt.clone()
    pt[..., cs, cs] = pt_c
    delp = delp.clone()
    delp[..., cs, cs] = pe2_c[1:] - pe2_c[:-1]
    ps = state["ps"].clone() if "ps" in state else torch.zeros_like(pe[-1])
    ps[..., cs, cs] = ps_c

    state = dict(state, pt=pt, delp=delp, u=u, v=v, ps=ps)
    vert = dict(pe=pe2_c, peln=pn2_c, pk=pk2_c, pkz=pkz_new_c)
    return state, q, vert


def prep_stage(state, q, topo, cfg, ptop):
    """Entry marshalling: halo fills, T -> theta_v, zeroed scratch
    winds/capacitors (fv_dynamics_nlm.F90:397-430).

    Hydrostatic, the entry pkz is that of compute_fv3_pressures.
    Nonhydrostatic, it is (rrg*delp/delz*Tv)**kappa, the exact inverse of
    the remap's exit conversion, so a state at rest round-trips exactly."""
    if cfg.consv_te > CONSV_MIN:
        raise NotImplementedError(
            "consv_te: ROADMAP Queue 1, remaining dynamics options")
    n = cfg.npx - 1
    akap = KAPPA
    u = state["u"]
    jc = n + 2 * NG
    jb = jc + 1
    lead = (state["delp"].shape[0], state["delp"].shape[1])

    delp = halo.fill_halo_center(state["delp"], topo)
    pt_in = halo.fill_halo_center(state["pt"], topo)
    q = [halo.fill_halo_center(qq, topo) for qq in q]
    sphum = q[0]

    if cfg.hydrostatic:
        pkz = compute_fv3_pressures(delp, akap, ptop)[3]
        pt = pt_in * (1.0 + ZVIR * sphum) / pkz
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
        uc=u.new_zeros(lead + (jc, jb)),
        vc=u.new_zeros(lead + (jb, jc)),
        divgd=u.new_zeros(lead + (jb, jb)),
        mfx=u.new_zeros(lead + (n, n + 1)),
        mfy=u.new_zeros(lead + (n + 1, n)),
        cx=u.new_zeros(lead + (jc, n + 1)),
        cy=u.new_zeros(lead + (n + 1, jc)),
        ps=u.new_zeros(lead[1:] + (jc, jc)),
    )
    return state, q


def pre_acoustic_stage(state, topo, cfg):
    """Start of one k_split sub-step: reset flux capacitors, refresh
    delp/pt (and NH delz) halos.  Returns (state', dp1)."""
    n = cfg.npx - 1
    jc = n + 2 * NG
    u = state["u"]
    lead = (state["delp"].shape[0], state["delp"].shape[1])
    state = dict(
        state,
        mfx=u.new_zeros(lead + (n, n + 1)),
        mfy=u.new_zeros(lead + (n + 1, n)),
        cx=u.new_zeros(lead + (jc, n + 1)),
        cy=u.new_zeros(lead + (n + 1, jc)),
        delp=halo.fill_halo_center(state["delp"], topo),
        pt=halo.fill_halo_center(state["pt"], topo),
    )
    if not cfg.hydrostatic:
        state["delz"] = halo.fill_halo_center(state["delz"], topo)
    return state, state["delp"]


def transport_tracers(q, dp1, state, grid, topo, cfg, mode="traj"):
    """tracer_2d with the step's accumulated fluxes.  mode="mixed" splits
    its linearization (hord_tr_pert, fv_tracer2d_tlm.F90:39-43) with
    `freeze.mix_primal`; the trajectory scheme then gives only the value,
    so it runs on detached inputs."""
    fluxes = (dp1, state["mfx"], state["mfy"], state["cx"], state["cy"])

    def tr(hord, trdm, q, fluxes):
        return tracer_2d(q, *fluxes, grid, topo, cfg, cfg.npx, hord,
                         trdm=trdm)

    mix_tr = mode == "mixed" and (
        (cfg.split_hord and cfg.hord_tr_pert != cfg.hord_tr)
        or (cfg.split_damp_tr and (cfg.nord_tr_pert != cfg.nord_tr
                                   or cfg.trdm2_pert != cfg.trdm2)))
    if not mix_tr:
        return tr(cfg.hord_tr, cfg.trdm2, q, fluxes)
    q_t = tr(cfg.hord_tr, cfg.trdm2, [x.detach() for x in q],
             tuple(f.detach() for f in fluxes))
    hord_p = cfg.hord_tr_pert if cfg.split_hord else cfg.hord_tr
    trdm_p = cfg.trdm2_pert if cfg.split_damp_tr else cfg.trdm2
    return mix_primal(q_t, tr(hord_p, trdm_p, q, fluxes))


def post_acoustic_stage(state, carry, q, dp1, grid, topo, cfg, ak, bk,
                        last_step, mode="traj"):
    """End of one k_split sub-step: acoustic_finish + tracer transport +
    vertical remap (fv_dynamics_nlm.F90:534-633).  ak/bk: (npz+1,) tensors.

    mode="mixed" splits the linearization of the tracer transport and of
    each remap (split_kord) with `freeze.mix_primal`."""
    npz = state["delp"].shape[0]
    with scope("acoustic_finish"):
        state, vert = acoustic_finish(state, carry, topo, cfg, npz)
    with scope("tracer_2d"):
        q = transport_tracers(q, dp1, state, grid, topo, cfg, mode)
    if npz > 4:
        with scope("remap"):
            state, q, vert = lagrangian_to_eulerian(
                state, vert, q, cfg, ak, bk, KAPPA, last_step, mode=mode)
    return state, q


def fv_dynamics(state, q, grid, topo, cfg, bdt, ak, bk, ptop):
    """One nonlinear model step of bdt seconds.

    state: u, v, w, pt (TEMPERATURE in/out), delp, phis (+ delz when
    nonhydrostatic).  q: list of tracers, q[0] = specific humidity.  ak/bk:
    (npz+1,) numpy arrays in the working precision.  Returns (state, q).
    The stages are those of post_acoustic_stage, called here one by one
    so that the tracers before transport are freed before the remap (the
    step's memory peak)."""
    _check_options(cfg, q)
    dtype = state["u"].dtype
    device = state["u"].device
    ak_t = torch.as_tensor(ak, dtype=dtype, device=device)
    bk_t = torch.as_tensor(bk, dtype=dtype, device=device)
    dp_ref = reference_thickness(ak, bk)
    npz = state["delp"].shape[0]

    state, q = prep_stage(state, q, topo, cfg, ptop)
    mdt = bdt / cfg.k_split
    for it in range(cfg.k_split):
        state, dp1 = pre_acoustic_stage(state, topo, cfg)
        with scope("dyn_core"):
            carry = dyn_core(state, grid, topo, cfg, mdt, KAPPA, ptop,
                             dp_ref)
        with scope("acoustic_finish"):
            state, vert = acoustic_finish(state, carry, topo, cfg, npz)
        with scope("tracer_2d"):
            q = transport_tracers(q, dp1, state, grid, topo, cfg)
        if npz > 4:
            with scope("remap"):
                state, q, vert = lagrangian_to_eulerian(
                    state, vert, q, cfg, ak_t, bk_t, KAPPA,
                    it == cfg.k_split - 1)
    return state, q


def reference_thickness(ak, bk):
    """dp_ref(k) of the reference surface pressure 1e5 Pa
    (dyn_core_nlm.F90:216-219), float64 numpy."""
    pe_ref = np.asarray(ak, np.float64) + np.asarray(bk, np.float64) * 1e5
    return pe_ref[1:] - pe_ref[:-1]


def _check_options(cfg, q):
    if cfg.tau > 0.0:
        raise NotImplementedError(
            "Rayleigh friction (tau > 0): ROADMAP Queue 1, remaining "
            "dynamics options")
    if len(q) == 0 or cfg.inline_q:
        raise NotImplementedError(
            "runs without tracers or with inline_q: not part of the "
            "linear model's configurations")
