"""Louis/Lock boundary-layer K-theory driver.

Counterpart of fv3jedi_lm_tpu/physics/bldriver.py (reference
bldriver.F90:23-1300): BL_DRIVER = PRELIMINARY -> LOUIS_DIFF -> LOCK_DIFF
(with the RADLW_DEP=1 cloud-top branch behind params['radlw_dep']) ->
TRIDIAG_SETUP -> ORODRAG.  `default_turb_params` is the port's own copy of
that module's NumPy-only table, identical to it (tests/test_torch_
standalone.py).

It runs on the trajectory only (the turbulence freezes the diffusion
coefficients), so nothing here is differentiated or recorded; the
`lax.scan`s of the parcel searches are Python loops over levels and the
arg-reductions pick the first occurrence, as JAX's `argmax` does.

Layout: vertical axis leading.  Layer fields (npz, *S), edge fields
(npz+1, *S), surface fields (*S), with S the spatial dims (6, ny, nx).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (CP, GRAV, KAPPA, KARMAN, P00, RGAS, VIREPS, ALHL,
                         ALHS, TICE)
from .qsat import dqsat

AKMAX = 1.0e4
QLCRIT = 1.0e-6
ABUOY = 0.23
ASHEAR = 25.0
WENTRMAX = 0.05
RAMP = 20.0


def default_turb_params(pref):
    """TURBPARAMS(22) + TURBPARAMSI(4) tables
    (fv3jedi_lm_turbulence_mod.F90:82-107); pref = ak + bk*p00 (npz+1,)."""
    return dict(
        louis=5.0, lambdam=160.0, lambdam2=1.0, lambdah=160.0, lambdah2=1.0,
        zkmenv=3000.0, zkhenv=3000.0, minthick=0.1, minshear=0.0030,
        c_b=2.5101471e-8, lambda_b=1500.0, akhmmax=500.0,
        prandtlsfc=1.0, prandtlrad=0.75, beta_rad=0.50, beta_surf=0.25,
        khradfac=0.85, khsfcfac=0.45, tpfac_surf=20.0, entrate_surf=1.5e-3,
        pceff_surf=0.5, louis_memory=-999.0,
        kpblmin=int(np.sum(np.asarray(pref) < 50000.0)),
        lock_on=1, pblht_option=1, radlw_dep=0,
    )


def _kidx(x):
    """Level index broadcastable against a (npz, *S) tensor."""
    npz = x.shape[0]
    return torch.arange(npz, device=x.device).reshape(
        (npz,) + (1,) * (x.dim() - 1))


def _first_true(cond):
    """jnp.argmax(cond, axis=0): the first True level, 0 where none."""
    npz = cond.shape[0]
    k = torch.where(cond, _kidx(cond), npz).amin(0)
    return torch.where(k == npz, 0, k)


def _last_true(cond):
    """(npz - 1) - jnp.argmax(cond[::-1], axis=0): the last True level,
    npz - 1 where none."""
    npz = cond.shape[0]
    k = torch.where(cond, _kidx(cond), -1).amax(0)
    return torch.where(k < 0, npz - 1, k)


def _take_k(a, idx):
    """a[idx] along the leading axis, idx shaped S -> result shaped S."""
    return torch.gather(a, 0, idx[None])[0]


def _preliminary(t, qv, phalf, th, qit, qlt, dt):
    """bldriver.F90:300-373: heights, virtual temperatures, RDZ, DMI."""
    npz = t.shape[0]
    pke = (phalf / P00) ** KAPPA
    dzc = (CP / GRAV) * th * (pke[1:] - pke[:-1])       # (npz, S)
    # zhalf[l] = sum_{m >= l} dzc[m]; zhalf[npz] = 0
    zhalf = torch.cat([torch.flip(torch.cumsum(torch.flip(dzc, [0]), 0), [0]),
                       torch.zeros_like(dzc[:1])], 0)
    zfull = 0.5 * (zhalf[:-1] + zhalf[1:])
    tv = t * (1.0 + VIREPS * qv - qit - qlt)
    pv = tv * (th / t)
    tve = 0.5 * (tv[:-1] + tv[1:])
    rdz = phalf[1:npz] / (RGAS * tve) / (zfull[:-1] - zfull[1:])
    dmi = (GRAV * dt) / (phalf[1:] - phalf[:-1])
    # running 1-2-1 smooth of the bottom levels of virtual theta (:364-369)
    if npz >= 7:
        b = npz - 1
        rows = list(pv.unbind(0))
        rows[b] = rows[b - 1] * 0.25 + rows[b] * 0.75
        for k in range(b - 1, b - 5, -1):
            rows[k] = rows[k - 1] * 0.25 + rows[k] * 0.50 + rows[k + 1] * 0.25
        pv = torch.stack(rows, 0)
    return zfull, zhalf, tv, pv, rdz, dmi


def _louis_diff(zpbl, zfull, zhalf, pv, u, v, p):
    """bldriver.F90:373-502: Louis stability-function diffusivities at the
    interior edges.  Returns (kh, km) with edge shape (npz+1, S)."""
    npz = zfull.shape[0]
    almfac = alhfac = 1.2
    pbl = torch.maximum(zpbl, zfull[npz - 1])

    zm1, z0 = zfull[:-1], zfull[1:]            # layers e-1, e at edge e=1..
    pvm1, pv0 = pv[:-1], pv[1:]
    dz = torch.clamp(zm1 - z0, min=p["minthick"])
    tm = 0.5 * (pvm1 + pv0)
    dtv = pvm1 - pv0
    du = torch.sqrt((u[:-1] - u[1:]) ** 2 + (v[:-1] - v[1:]) ** 2) / dz
    ri = GRAV * (dtv / dz) / (tm * torch.clamp(du, min=p["minshear"]) ** 2)

    ze = zhalf[1:npz]
    lam_m = torch.clamp(0.1 * pbl * torch.exp(-((ze / p["zkmenv"]) ** 2)),
                        min=p["lambdam2"])
    lam_h = torch.clamp(0.1 * pbl * torch.exp(-((ze / p["zkhenv"]) ** 2)),
                        min=p["lambdah2"])
    alm = almfac * (KARMAN * ze / (1.0 + KARMAN * (ze / lam_m))) ** 2
    alh = alhfac * (KARMAN * ze / (1.0 + KARMAN * (ze / lam_h))) ** 2

    louis = p["louis"]
    # unstable branch (ri < 0)
    ps_u = ((zm1 / z0) ** (1.0 / 3.0) - 1.0) ** 3
    ps_u = alh * torch.sqrt(torch.clamp(ps_u / (ze * dz ** 3), min=0.0))
    ps_u = ri / (1.0 + (3.0 * louis * louis) * ps_u
                 * torch.sqrt(torch.clamp(-ri, min=0.0)))
    kh_u = 1.0 - (louis * 3.0) * ps_u
    km_u = 1.0 - (louis * 2.0) * ps_u
    # stable branch (ri >= 0)
    ps_s = torch.sqrt(1.0 + louis * torch.clamp(ri, min=0.0))
    kh_s = 1.0 / (1.0 + (louis * 3.0) * ri * ps_s)
    km_s = ps_s / (ps_s + (louis * 2.0) * ri)

    unstable = ri < 0.0
    kh_i = torch.where(unstable, kh_u, kh_s)
    km_i = torch.where(unstable, km_u, km_s)
    km_i = torch.clamp(km_i * du * alm, max=p["akhmmax"])
    kh_i = torch.clamp(kh_i * du * alh, max=p["akhmmax"])

    z_edge = torch.zeros_like(zhalf[:1])
    kh = torch.cat([z_edge, kh_i, z_edge], 0)
    km = torch.cat([z_edge, km_i, z_edge], 0)
    return kh, km


def _mpbl_depth(t, q, u, v, zfull, pfull, b_star, u_star, p):
    """bldriver.F90:1091-1180: surface parcel ascent -> (ipbl, ztop).

    ipbl is the Python layer index of the mixed-layer top (Fortran
    ipbl-1); columns where the ascent never terminates keep ipbl=1 and
    ztop at the last level reached."""
    npz = t.shape[0]
    vscale = 0.25 / 100.0
    tep = t[-1] * (1.0 + p["tpfac_surf"] * b_star / GRAV)
    qp, z1 = q[-1], zfull[-1]
    t1, u1, v1 = t[-1], u[-1], v[-1]
    ztop = zfull[-1]
    ipbl = torch.ones(t.shape[1:], dtype=torch.int64, device=t.device)
    done = torch.zeros(t.shape[1:], dtype=torch.bool, device=t.device)
    for kp in range(npz - 2, 0, -1):
        t2, q2, u2, v2, z2, pp = (t[kp], q[kp], u[kp], v[kp], zfull[kp],
                                  pfull[kp])
        du = torch.sqrt((u2 - u1) ** 2 + (v2 - v1) ** 2) / (z2 - z1)
        du = torch.clamp(du, max=1.0e-8)           # as the reference (:1145)
        entrate_x = p["entrate_surf"] * (1.0 + du / vscale)
        entfr = torch.clamp(entrate_x * (z2 - z1), max=0.99)
        qp_n = qp + entfr * (q2 - qp)
        tep_n = tep - GRAV * (z2 - z1) / CP
        tep_n = tep_n + entfr * (t2 - tep_n)
        dqsp, qsp = dqsat(tep_n, pp)
        dqp = torch.clamp(qp_n - qsp, min=0.0) / (1.0 + (ALHL / CP) * dqsp)
        qp_n = qp_n - dqp
        tep_n = tep_n + p["pceff_surf"] * ALHL * dqp / CP
        trigger = (t2 >= tep_n) | (entfr >= 0.9899)
        newly = trigger & ~done
        ztop = torch.where(newly, 0.5 * (z2 + z1), ztop)
        ipbl = torch.where(newly, kp + 1, ipbl)
        tep = torch.where(done, tep, tep_n)
        qp = torch.where(done, qp, qp_n)
        z1 = torch.where(done, z1, z2)
        t1 = torch.where(done, t1, t2)
        u1 = torch.where(done, u1, u2)
        v1 = torch.where(done, v1, v2)
        done = done | trigger
    return ipbl, ztop


def _radml_depth(svp, kct, zt, slvcp, zfull, zhalf, critjump=0.3):
    """radml_depth (bldriver.F90:1180-1253): descend a cloud-top parcel of
    liquid static energy svp from layer kct until it is warmer than the
    environment (or a stable jump > critjump is crossed); returns
    (zradbase, zradml)."""
    npz = slvcp.shape[0]
    entrate = 0.2 / 200.0

    h1 = _take_k(zfull, kct)
    t1 = _take_k(slvcp, kct)
    # parcel already warmer than cloud top -> zb = h1, zml = 0 (:1211-1215)
    pre = t1 < svp
    svpar = svp
    zb = torch.where(pre, h1, 0.0)
    zml = torch.zeros_like(h1)
    done = pre
    for j in range(1, npz):
        t2, h2, zh_k = slvcp[j], zfull[j], zhalf[j]
        active = (j > kct) & ~done
        # exit 1: parcel warmer than env at this level (:1222-1231)
        hit = t2 < svpar
        interp = torch.abs(t1 - t2) > 0.2
        zb1 = torch.where(
            interp,
            torch.clamp(h2 + (h1 - h2) * (svpar - t2)
                        / torch.where(interp, t1 - t2, 1.0), min=0.0),
            h2)
        # exit 2: stable jump (:1234-1238), only for j > kct+1
        jump = ((t1 - t2) > critjump) & (j > kct + 1)
        take1 = active & hit
        take2 = active & ~hit & jump
        zb = torch.where(take1, zb1, torch.where(take2, zh_k, zb))
        zml = torch.where(take1 | take2, zt - zb, zml)
        # entrain and step down (:1241-1246)
        entfr = torch.clamp(entrate * (h1 - h2), max=1.0)
        svpar_new = svpar + entfr * (t2 - svpar)
        cont = active & ~hit & ~jump
        svpar = torch.where(cont, svpar_new, svpar)
        h1 = torch.where(cont, h2, h1)
        t1 = torch.where(cont, t2, t1)
        done = done | take1 | take2
    # fallthrough: zb = 0, zml = zt (:1250-1251)
    zb = torch.where(done, zb, 0.0)
    zml = torch.where(done, zml, zt)
    return zb, zml


def _lock_rad(t, qv, qc, hleff, slv, zfull, pf, phalf, zhalf, density,
              ipbl, zsml, conv, k_sfc, k_t_entr, k_m_entr, p, tdtlw):
    """Radiatively/buoyancy-reversal driven cloud-top mixing
    (bldriver.F90:852-1075, the RADLW_DEP=1 branch): the lowest
    stratocumulus top below zcldtopmax, its LW flux divergence and
    buoyancy-reversal mixing fraction, radml_depth for the mixed-layer
    base, and the cloud-top entrainment + interior K profiles.  Returns
    (k_t_entr, k_m_entr)."""
    npz = t.shape[0]
    kidx = _kidx(t)
    zcldtopmax = 3.0e3

    dqs_all, _ = dqsat(t, pf)

    # kmax: highest level below zcldtopmax (:853-859)
    kmax = _first_true(zhalf[:npz] < zcldtopmax)

    # cloud top: LOWEST boundary qc[k]>=crit, qc[k-1]<crit, stable (:862-871)
    cond = torch.cat([
        torch.zeros_like(qc[:1], dtype=torch.bool),
        (qc[1:] >= QLCRIT) & (qc[:-1] < QLCRIT)
        & ((slv[:-1] - slv[1:]) > 0.0)], 0)
    cond = cond & (kidx >= kmax[None])
    found = cond.any(0)
    kct = torch.where(found, _last_true(cond), 1)

    # thin diffusive veil: look one level down (:877-881)
    kct2 = torch.clamp(kct + 1, max=npz - 1)
    qct = _take_k(qc, kct)
    veil = (qct < 10.0 * QLCRIT) & (_take_k(qc, kct2) >= 10.0 * qct)
    kct = torch.where(veil, kct2, kct)

    # cloud bottom (:883-891); sentinel npz -> zhalf[npz] = 0 (surface)
    condb = torch.cat([
        torch.zeros_like(qc[:1], dtype=torch.bool),
        (qc[1:] < QLCRIT) & (qc[:-1] >= QLCRIT)], 0)
    condb = condb & (kidx >= kct[None])
    foundb = condb.any(0)
    kcb = torch.where(foundb, _last_true(condb), npz)
    active = found & (kct != kcb)

    # cloud-top LW flux divergence (:897-904)
    in_win = (kidx >= kct[None]) & (kidx <= torch.clamp(kct + 2,
                                                        max=npz - 1)[None])
    maxradf = torch.where(in_win, -tdtlw, -torch.inf).amax(0)
    maxradf = maxradf * CP * (
        (_take_k(phalf, kct + 1) - _take_k(phalf, kct)) / GRAV)
    maxradf = torch.clamp(maxradf, min=0.0)

    # buoyancy-reversal mixing fraction chis (:906-929)
    ktm = torch.clamp(kct - 1, min=0)
    hlf = _take_k(hleff, kct)
    slv_t = _take_k(slv, ktm)
    slv_c = _take_k(slv, kct)
    qc_t = _take_k(qc, ktm)
    qv_t = _take_k(qv, ktm)
    dqs_c = _take_k(dqs_all, kct)
    tmp1 = (slv_t - hlf * qc_t) - (slv_c - hlf * qct)
    tmp1 = dqs_c * tmp1 / CP
    tmp2 = (qv_t + qc_t) - (_take_k(qv, kct) + qct)
    chis = -qct * (1.0 + hlf * dqs_c / CP)
    denom = tmp2 - tmp1
    chis = torch.where(denom >= 0.0, 0.0,
                       chis / torch.where(denom >= 0.0, 1.0, denom))
    chis = torch.clamp(chis, max=1.0)

    slmix = (1.0 - chis) * (slv_c - hlf * qct) + chis * (slv_t - hlf * qc_t)
    svpcp = slmix / CP
    stab = slv_t - slv_c
    dsiems = (slv_c - slmix) / torch.where(stab == 0.0, 1.0, stab)
    dsiems = torch.clamp(dsiems, 0.0, 10.0)
    zradtop = _take_k(zhalf, kct)

    # radml_depth (:946-965)
    radperturb = torch.clamp(maxradf / 100.0, max=0.3)
    svp = svpcp - radperturb
    slvcp = slv / CP
    zb_s, zml_s = _radml_depth(svp, kct, zradtop, slvcp, zfull, zhalf)
    at_bot = kct >= npz - 1
    zradbase = torch.where(at_bot, 0.0, zb_s)
    zradml = torch.where(at_bot, zradtop, zml_s)
    zcloud = zradtop - _take_k(zhalf, kcb)

    go = active & (zradml > 0.0)

    # velocity scales (:971-996)
    zradml_s = torch.where(go, zradml, 1.0)
    vrad3 = GRAV * zradml * maxradf / _take_k(density, kct) / slv_c
    tmp1b = GRAV * torch.clamp((slv_t - slv_c) / CP, min=0.1) / (slv_c / CP)
    vbr3 = torch.clamp(tmp1b * zcloud, min=0.0) ** 3
    vbr3 = ABUOY * chis ** 2 * torch.clamp(dsiems, min=0.0) * torch.sqrt(vbr3)
    near_top = zradtop > zcldtopmax - 500.0
    ramp_f = (zcldtopmax - zradtop) / 500.0
    vrad3 = torch.clamp(torch.where(near_top, vrad3 * ramp_f, vrad3), min=0.0)
    vbr3 = torch.clamp(torch.where(near_top, vbr3 * ramp_f, vbr3), min=0.0)
    vrad = vrad3 ** (1.0 / 3.0)
    vbrv = vbr3 ** (1.0 / 3.0)

    tmp2b = (vrad ** 2 + vbrv ** 2) / zradml_s
    wentr_rad = torch.clamp(
        p["beta_rad"] * (vrad3 + vbr3) / zradml_s / (tmp1b + tmp2b),
        max=WENTRMAX)
    # height-dependent fudge factors (:1003-1014)
    wentr_rad = torch.where(zradtop < 500.0, 0.0, wentr_rad)
    wentr_rad = torch.where((zradtop > 500.0) & (zradtop <= 800.0),
                            wentr_rad * (zradtop - 500.0) / 300.0, wentr_rad)
    wentr_rad = torch.where(zradtop < 2400.0,
                            wentr_rad * (zradtop / 800.0), 3.0 * wentr_rad)

    zf_t = _take_k(zfull, ktm)
    zf_c = _take_k(zfull, kct)
    k_entr_rad = torch.clamp(wentr_rad * (zf_t - zf_c), max=AKMAX)

    at_kct = kidx == kct[None]
    add = go[None] & at_kct
    k_t_entr = k_t_entr + torch.where(add, k_entr_rad[None], 0.0)
    k_m_entr = k_m_entr + torch.where(add, k_entr_rad[None], 0.0)

    # surface top == radiative top: combined entrainment REPLACES the slot
    # (:1021-1048)
    vsurf3, vshear3 = p["_vsurf3"], p["_vshear3"]
    same = go & conv & (ipbl == kct)
    tmp2c = ((vbr3 + vrad3 + vsurf3 + vshear3) ** (2.0 / 3.0)) / zradml_s
    wentr2 = torch.clamp(
        torch.clamp(((p["beta_surf"] * (vsurf3 + vshear3)
                      + p["beta_rad"] * (vrad3 + vbr3)) / zradml_s)
                    / (tmp1b + tmp2c), min=0.0), max=WENTRMAX)
    k_entr2 = torch.clamp(wentr2 * (zf_t - zf_c), max=AKMAX)
    k_t_entr = torch.where(same[None] & at_kct, k_entr2[None], k_t_entr)
    k_m_entr = torch.where(same[None] & at_kct, k_entr2[None], k_m_entr)

    # interior radiative K profile (:1050-1058)
    ztmp = torch.clamp((zhalf[:npz] - zradbase[None]) / zradml_s[None],
                       min=0.0)
    k_int = (p["khradfac"] * KARMAN * (vrad + vbrv)[None] * ztmp
             * zradml_s[None] * ztmp
             * torch.sqrt(torch.clamp(1.0 - ztmp, min=0.0)))
    k_int = torch.clamp(k_int, max=AKMAX)
    in_int = go[None] & (kidx > kct[None]) & (ztmp > 0.0)
    k_t_entr = k_t_entr + torch.where(in_int, k_int, 0.0)
    k_m_entr = k_m_entr + torch.where(in_int, k_int * p["prandtlrad"], 0.0)

    # zradbase below the surface mixed layer: cancel the surface
    # entrainment at ipbl (:1060-1068)
    suppress = go & (zradbase < zsml) & conv & (ipbl > kct)
    cut = suppress[None] & (kidx == ipbl[None])
    k_t_entr = k_t_entr - torch.where(cut, k_sfc[None], 0.0)
    k_m_entr = k_m_entr - torch.where(cut, k_sfc[None], 0.0)
    return k_t_entr, k_m_entr


def _lock_diff(t, qv, qit, qlt, u, v, zfull, pfull, zhalf, frland,
               u_star, b_star, kh, km, p, tdtlw=None, phalf_e=None):
    """bldriver.F90:655-1085: Lock et al. mixed-layer entrainment
    diffusivities merged into (kh, km) — the surface-driven part always,
    plus the cloud-top radiative/buoyancy-reversal part when
    params['radlw_dep'] == 1."""
    npz = t.shape[0]
    kidx = _kidx(t)

    # liquid static energy (hleff blend, :745-770)
    hleff = torch.where(
        t <= TICE - RAMP, ALHS,
        torch.where(t < TICE,
                    ((t - TICE + RAMP) * ALHL + (TICE - t) * ALHS) / RAMP,
                    ALHL))
    qc = qit + qlt
    slv = CP * t * (1.0 + VIREPS * qv - qc) + GRAV * zfull - hleff * qc

    conv = b_star > 0.0
    ipbl, zsml = _mpbl_depth(t, qv, u, v, zfull, pfull, b_star, u_star, p)

    # interior stable-interface limit (:800-812): lowest interface below the
    # parcel top with d(slv)/CP > critjump caps the mixed layer
    critjump = 2.0
    dslv = (slv[:-1] - slv[1:]) / CP           # edge e=1..npz-1 at kidx 1..
    kcond = torch.cat([torch.zeros_like(dslv[:1], dtype=torch.bool),
                       dslv > critjump], 0)    # layer-k aligned (k>=1)
    kcond = kcond & (kidx >= ipbl[None] + 1)
    any_int = kcond.any(0)
    ipbl = torch.where(any_int, _last_true(kcond), ipbl)
    zsml = torch.where(any_int, _take_k(zhalf, ipbl), zsml)

    zsml_s = torch.where(conv, zsml, 1.0)
    ipm = torch.clamp(ipbl - 1, min=0)
    slv_t = _take_k(slv, ipm)
    slv_i = _take_k(slv, ipbl)
    zf_t = _take_k(zfull, ipm)
    zf_i = _take_k(zfull, ipbl)

    vsurf3 = torch.clamp(u_star * b_star * zsml_s, min=0.0)
    vshear3 = ASHEAR * u_star ** 3
    vsurf = vsurf3 ** (1.0 / 3.0)
    tmp1 = GRAV * torch.clamp((slv_t - slv_i) / CP, min=0.1) / (slv_i / CP)
    tmp2 = ((vsurf3 + vshear3) ** (2.0 / 3.0)) / zsml_s
    wentr = torch.clamp(torch.clamp(
        (p["beta_surf"] * (vsurf3 + vshear3) / zsml_s) / (tmp1 + tmp2),
        min=0.0), max=WENTRMAX)
    wentr = torch.where(zsml_s < 1600.0, wentr * (zsml_s / 800.0),
                        2.0 * wentr)
    k_entr = torch.clamp(wentr * (zf_t - zf_i), max=AKMAX)

    # diffusivity_pbl2 (:1255-1300) on the interior of the mixed layer
    kfacx = torch.where(frland < 0.5, p["khsfcfac"],
                        torch.full_like(frland, 2.0 * p["khsfcfac"]))
    vh = torch.clamp(vsurf * zsml_s, min=1e-30)
    ee = 1.0 - torch.sqrt(torch.clamp(k_entr, min=0.0)
                          / (kfacx * KARMAN * vh))
    ee = torch.clamp(ee, min=0.7)
    zm = zhalf[:npz]                            # slots s=0..npz-1
    in_ml = (zm <= zsml_s[None]) & (zm > 0.0) & (vh[None] > 0.0)
    k_troen = kfacx[None] * KARMAN * vsurf[None] * zm \
        * (1.0 - ee[None] * (zm / zsml_s[None])) ** 2
    k_troen = torch.where(in_ml, k_troen, 0.0)

    slot = kidx                                 # slot s aligned with zhalf[s]
    troen_slots = slot >= ipbl[None] + 1
    k_t_entr = torch.where(troen_slots, k_troen, 0.0)
    k_m_entr = torch.where(troen_slots, k_troen * p["prandtlsfc"], 0.0)
    at_ipbl = slot == ipbl[None]
    k_t_entr = k_t_entr + torch.where(at_ipbl, k_entr[None], 0.0)
    k_m_entr = k_m_entr + torch.where(at_ipbl, k_entr[None], 0.0)

    convk = conv[None]
    k_t_entr = torch.where(convk, k_t_entr, 0.0)
    k_m_entr = torch.where(convk, k_m_entr, 0.0)

    if p.get("radlw_dep", 0) == 1:
        density = pfull / (RGAS * t * (1.0 + VIREPS * qv - qc))
        if tdtlw is None:
            tdtlw = torch.zeros_like(t)
        k_sfc = torch.where(conv, k_entr, 0.0)
        p_rad = dict(p, _vsurf3=torch.where(conv, vsurf3, 0.0),
                     _vshear3=vshear3)
        k_t_entr, k_m_entr = _lock_rad(
            t, qv, qc, hleff, slv, zfull, pfull, phalf_e,
            zhalf, density, ipbl, torch.where(conv, zsml_s, 0.0), conv,
            k_sfc, k_t_entr, k_m_entr, p_rad, tdtlw)

    # merge: diff = max(k_entr, diff) on interior slots 1..npz-1 (:1078-1083)
    interior = slot >= 1
    kh_new = torch.cat([
        torch.where(interior, torch.maximum(k_t_entr, kh[:npz]), kh[:npz]),
        kh[npz:]], 0)
    km_new = torch.cat([
        torch.where(interior, torch.maximum(k_m_entr, km[:npz]), km[:npz]),
        km[npz:]], 0)
    return kh_new, km_new


def _tridiag_setup(zfull, rdz, dmi, phalf, tv, ct, cq, cm, kh, km, p, dt):
    """bldriver.F90:504-610: assemble the implicit-diffusion tridiagonals
    and re-diagnose ZPBL.  Returns (aks..ckv dict, zpbl)."""
    npz = zfull.shape[0]
    kidx = _kidx(zfull)

    # ZPBL: lowest layer L where diff_t crosses 2.0 going up (:564-574)
    cond = (kh[:npz] < 2.0) & (kh[1:npz + 1] >= 2.0) & (kidx >= 1)
    anyc = cond.any(0)
    zpbl = torch.where(anyc, _take_k(zfull, _last_true(cond)),
                       zfull[npz - 1])
    zpbl = torch.minimum(zpbl, zfull[p["kpblmin"] - 1])

    z = torch.zeros_like(zfull[:1])

    # scalars (heat): interior flux coefficients from kh edges 1..npz-1
    cks_raw = -kh[1:npz] * rdz                  # (npz-1, S)
    aks = torch.cat([z, cks_raw * dmi[1:]], 0)
    cks = torch.cat([cks_raw * dmi[:-1], -ct[None] * dmi[-1:]], 0)
    akq = aks
    ckq = torch.cat([cks_raw * dmi[:-1], -cq[None] * dmi[-1:]], 0)
    # winds
    ekv_raw = -km[1:npz] * rdz
    akv = torch.cat([z, ekv_raw * dmi[1:]], 0)
    ckv = torch.cat([ekv_raw * dmi[:-1], -cm[None] * dmi[-1:]], 0)

    bks = 1.0 - (aks + cks)
    bkq = 1.0 - (akq + ckq)
    bkv = 1.0 - (akv + ckv)
    return dict(aks=aks, bks=bks, cks=cks, akq=akq, bkq=bkq, ckq=ckq,
                akv=akv, bkv=bkv, ckv=ckv), zpbl


def _orodrag(bkv, u, v, zfull, varflt, phalf, p, dt):
    """bldriver.F90:612-655: Beljaars (2003) orographic form drag into the
    wind main diagonal."""
    lam = p["lambda_b"]
    act = zfull < 4.0 * lam
    fz = torch.where(act, zfull / lam, 1.0)
    fkv = varflt[None] * torch.exp(-fz * torch.sqrt(fz)) * fz ** (-1.2)
    fkv = (p["c_b"] / lam) * torch.clamp(torch.sqrt(u ** 2 + v ** 2),
                                         max=5.0) * fkv
    fkv = torch.where(act, fkv, 0.0)
    return bkv + dt * fkv


def bl_driver(u, v, th, q, phalf, qit, qlt, frland, frocean, varflt,
              zpbl, cm, ct, cq, ustar, bstar, params, dt, tdtlw=None):
    """BL_DRIVER (bldriver.F90:23-295): the LU-ready tridiagonal
    coefficient dict {aks..ckv} and the updated zpbl diagnostic.  All
    inputs are trajectory fields; th is p00^kappa * T / pkz."""
    pf = 0.5 * (phalf[:-1] + phalf[1:])
    pif = (pf / P00) ** (RGAS / CP)
    t = pif * th

    zfull, zhalf, tv, pv, rdz, dmi = _preliminary(t, q, phalf, th, qit, qlt,
                                                  dt)
    kh, km = _louis_diff(zpbl, zfull, zhalf, pv, u, v, params)
    if params["lock_on"]:
        kh, km = _lock_diff(t, q, qit, qlt, u, v, zfull, pf, zhalf, frland,
                            ustar, bstar, kh, km, params,
                            tdtlw=tdtlw, phalf_e=phalf)
    coeffs, zpbl_new = _tridiag_setup(zfull, rdz, dmi, phalf, tv, ct, cq, cm,
                                      kh, km, params, dt)
    coeffs["bkv"] = _orodrag(coeffs["bkv"], u, v, zfull, varflt, phalf,
                             params, dt)
    return coeffs, zpbl_new
