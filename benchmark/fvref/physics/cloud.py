"""GEOS PDF cloud scheme (cloud_driver) with its split perturbation
linearization.

Counterpart of fv3jedi_lm_tpu/physics/cloud.py (reference cloud.F90
cloud_driver:15-848 and its column-local sub-processes :851-2589),
whole-array over columns: 3-D fields are (npz, B) with B = 6*ny*nx, 2-D
fields (B,).  The tangent linear and adjoint are the jvp and vjp of this
one implementation with every discrete decision routed through the frozen
branch tape (core/freeze), plus `mix_primal` where the reference TLM
departs from the exact derivative: the `pdffrac` perturbation model
(cloud_tl.F90:1568-1597) and the driver-level SINK and TOTAL tangent
filters (cloud_tl.F90:797-840).  Only `precipandevap` couples levels; it
runs as a frozen-branch scan over the active levels.

Mode 2 gates the `pdffrac` perturbation model per (level, column) by the
8x8 ls_cloud Jacobian (cloud_tl.F90:406-481): 8 unit-tangent jvp probes
(`torch.func.jvp` of detached inputs), the value thresholds, and the
balanced-Gelfand spectral-radius estimate `spectral_radius` in place of
the reference's LAPACK eigenvalues, ported exactly as the JAX package
writes it so that its decisions are the JAX package's.

`cloud_params` is the port's own copy of that module's NumPy-only table
(tests/test_torch_standalone.py holds it equal).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (MAPL_ALHF, MAPL_ALHL, MAPL_ALHS, MAPL_CP,
                         MAPL_EPSILON, MAPL_GRAV, MAPL_PI, MAPL_RGAS,
                         MAPL_RVAP, MAPL_TICE)
from ..core.freeze import fbool, fmax, fmin, fscan, fwhere, mix_primal
from .qsat import dqsat

ALHL_CP = MAPL_ALHL / MAPL_CP
ALHS_CP = MAPL_ALHS / MAPL_CP
ALHF_CP = MAPL_ALHF / MAPL_CP
RHO_W = 1.0e3
K_COND = 2.4e-2
DIFFU = 2.2e-5


def cloud_params(nx: int) -> dict:
    """CLOUDPARAMS(57) with the LM's values (fv3jedi_lm_moist_mod.F90:
    151-211); resolution-dependent minrhcrit via imsize = im*4 (:192-196)."""
    imsize = nx * 4
    if imsize <= 200:
        minrhcrit = 0.80
    elif imsize <= 400:
        minrhcrit = 0.90
    elif imsize <= 800:
        minrhcrit = 0.93
    elif imsize <= 1600:
        minrhcrit = 0.95
    else:
        minrhcrit = 0.97
    return dict(
        cnv_beta=10.0, anv_beta=4.0, ls_beta=4.0, rh00=1.0,
        c_00=2.0e-3, lwcrit=8.0e-4, c_acc=2.0, c_ev_r=1.0, c_ev_s=1.0,
        cld_evp_eff=3.3e-4,
        ls_sdqv2=4.8, ls_sdqv3=4.8, ls_sdqvt1=230.0,
        anv_sdqv2=1.0, anv_sdqv3=1.0, anv_sdqvt1=230.0,
        anv_icefall_c=0.5, ls_icefall_c=0.5,
        revap_off_p=2000.0, cnvenvfc=0.8, wrhodep=0.5,
        t_ice_all=MAPL_TICE - 40.0, t_ice_max=MAPL_TICE, icefrpwr=4,
        cnvddrfc=0.0, anvddrfc=0.0, lsddrfc=0.0,
        minrhcrit=minrhcrit, maxrhcrit=1.0, turnrhcrit=750.0,
        maxrhcritland=minrhcrit + 0.01,
        min_rl=10.0e-6, min_ri=20.0e-6, max_rl=21.0e-6, max_ri=40.0e-6,
        ri_anv=30.0e-6, pdfflag=1,
    )


def ktop_index(npz: int) -> int:
    """Highest active level (KTOP=30 of L72, cloud.F90:143), 0-based."""
    return max(0, (30 * npz + 71) // 72 - 1)


def get_ice_fraction(te, t_ice_all, t_ice_max, icefrpwr):
    """get_ice_fraction (cloud.F90:1880-1904)."""
    f = fwhere(te <= t_ice_all, 1.0,
               fwhere(te <= t_ice_max,
                      1.0 - (te - t_ice_all) / (t_ice_max - t_ice_all),
                      0.0))
    f = fclip01(f)
    return f ** icefrpwr


def fclip01(x):
    return fmin(fmax(x, 0.0), 1.0)


def cloud_tidy(qv, te, qlc, qic, cf, qla, qia, af):
    """cloud_tidy (cloud.F90:851-919): evaporate too-small cloud fields."""
    def wipe_pair(m, qv, te, ql, qi):
        qv = torch.where(m, qv + ql + qi, qv)
        te = torch.where(m, te - ALHL_CP * ql - ALHS_CP * qi, te)
        return qv, te

    m = fbool(af < 1.0e-5)
    qv, te = wipe_pair(m, qv, te, qla, qia)
    af = torch.where(m, 0.0, af)
    qla = torch.where(m, 0.0, qla)
    qia = torch.where(m, 0.0, qia)

    m = fbool(qlc < 1.0e-8)
    qv = torch.where(m, qv + qlc, qv)
    te = torch.where(m, te - ALHL_CP * qlc, te)
    qlc = torch.where(m, 0.0, qlc)

    m = fbool(qic < 1.0e-8)
    qv = torch.where(m, qv + qic, qv)
    te = torch.where(m, te - ALHS_CP * qic, te)
    qic = torch.where(m, 0.0, qic)

    m = fbool(qla < 1.0e-8)
    qv = torch.where(m, qv + qla, qv)
    te = torch.where(m, te - ALHL_CP * qla, te)
    qla = torch.where(m, 0.0, qla)

    m = fbool(qia < 1.0e-8)
    qv = torch.where(m, qv + qia, qv)
    te = torch.where(m, te - ALHS_CP * qia, te)
    qia = torch.where(m, 0.0, qia)

    m = fbool((qla + qia) < 1.0e-8)
    qv, te = wipe_pair(m, qv, te, qla, qia)
    af = torch.where(m, 0.0, af)
    qla = torch.where(m, 0.0, qla)
    qia = torch.where(m, 0.0, qia)

    m = fbool((qlc + qic) < 1.0e-8)
    qv, te = wipe_pair(m, qv, te, qlc, qic)
    cf = torch.where(m, 0.0, cf)
    qlc = torch.where(m, 0.0, qlc)
    qic = torch.where(m, 0.0, qic)
    return qv, te, qlc, qic, cf, qla, qia, af


def meltfreeze(dt, te, ql, qi, pars):
    """meltfreeze (cloud.F90:921-965)."""
    taufrz = 1000.0
    fqi = get_ice_fraction(te, pars["t_ice_all"], pars["t_ice_max"],
                           pars["icefrpwr"])
    dqil = fwhere(te <= pars["t_ice_max"],
                  ql * (1.0 - torch.exp(-dt * fqi / taufrz)), 0.0)
    dqil = fmax(0.0, dqil)
    qi = qi + dqil
    ql = ql - dqil
    te = te + (MAPL_ALHS - MAPL_ALHL) * dqil / MAPL_CP

    dqil = fmin(0.0, fwhere(te > pars["t_ice_max"], -qi, 0.0))
    qi = qi + dqil
    ql = ql - dqil
    te = te + (MAPL_ALHS - MAPL_ALHL) * dqil / MAPL_CP
    return te, ql, qi


def convec_src(dt, mass, imass, te, qv, dcf, dmf, qla, qia, af, qs, pars):
    """convec_src (cloud.F90:967-1043): RAS detrainment -> anvil cloud."""
    minrhx = 0.001
    tend = dcf * imass
    fqi = get_ice_fraction(te, pars["t_ice_all"], pars["t_ice_max"],
                           pars["icefrpwr"])
    qla = qla + (1.0 - fqi) * tend * dt
    qia = qia + fqi * tend * dt
    te = te + (MAPL_ALHS - MAPL_ALHL) * fqi * tend * dt / MAPL_CP

    tend = dmf * imass
    af = fmin(af + tend * dt, 0.99)

    under = fbool(af < 1.0)
    qvx = torch.where(under,
                      (qv - qs * af) / torch.where(under, 1.0 - af, 1.0),
                      qs)
    fix = fbool(((qvx - minrhx * qs) < 0.0) & (af > 0.0))
    af = torch.where(fix, (qv - minrhx * qs) / (qs * (1.0 - minrhx)), af)

    dead = fbool(af < 0.0)
    qv = torch.where(dead, qv + qla + qia, qv)
    te = torch.where(dead, te - (MAPL_ALHL * qla + MAPL_ALHS * qia) / MAPL_CP,
                     te)
    af = torch.where(dead, 0.0, af)
    qla = torch.where(dead, 0.0, qla)
    qia = torch.where(dead, 0.0, qia)
    return te, qv, qla, qia, af


def pdf_width(ph, frland, pars):
    """pdf_width (cloud.F90:1045-1100): Slingo-Ritter critical RH.  ph and
    frland are trajectory-only, so alpha carries no derivative."""
    tempmaxrh = torch.where(frland > 0.05, pars["maxrhcritland"],
                            torch.full_like(frland, pars["maxrhcrit"]))
    minrh = pars["minrhcrit"]
    turn = pars["turnrhcrit"]
    a1_hi = minrh + (tempmaxrh - minrh) / 19.0 * (
        (torch.atan((2.0 * (ph - turn) / (1020.0 - turn) - 1.0)
                    * float(np.tan(20.0 * MAPL_PI / 21.0 - 0.5 * MAPL_PI)))
         + 0.5 * MAPL_PI) * 21.0 / MAPL_PI - 1.0)
    a1 = torch.where(ph <= turn, minrh, a1_hi)
    a1 = torch.clamp(a1, max=1.0)
    alpha = 1.0 - a1
    alpha = torch.clamp(alpha, max=0.25)
    # driver-level bound (cloud.F90:367): alpha >= 1 - RH00
    return torch.clamp(alpha, min=1.0 - pars["rh00"])


def _pdffrac_tophat(qt, sigmaqt1, qstar):
    """pdffrac flag 1/3/4 primal (cloud.F90:1352-1381)."""
    below = fbool(qt + sigmaqt1 < qstar)
    pos = fbool(sigmaqt1 > 0.0)
    denom = torch.where(pos, 2.0 * sigmaqt1, 1.0)
    frac = torch.where(pos, fmin(qt + sigmaqt1 - qstar, 2.0 * sigmaqt1)
                       / denom, 1.0)
    return torch.where(below, 0.0, frac)


def pdffrac_pert(qt, sigmaqt1, qstar, pert_mode):
    """Cloud fraction from the total-water PDF.  pert_mode True: primal the
    top-hat, derivative the reference's regularized linear ramp in RH
    (PDFFRAC_D flag 4, cloud_tl.F90:1568-1597); a bool mask applies that
    per element and the exact top-hat derivative elsewhere (the mode-2
    gate); False: the top-hat alone."""
    primal = _pdffrac_tophat(qt, sigmaqt1, qstar)
    if pert_mode is False:
        return primal
    q1 = 0.9335
    q2 = 1.0665
    rh = qt / qstar
    in_ramp = fbool((rh >= q1) & (rh < q2))
    ramp = 0.2 * torch.where(in_ramp, rh / ((q2 / q1 - 1.0) * q1), 0.0)
    mixed = mix_primal(primal, ramp)
    if pert_mode is True:
        return mixed
    return torch.where(pert_mode, mixed, primal)


def pdfcondensate_tophat(qt, sigmaqt1, qstar):
    """pdfcondensate flag 1 (cloud.F90:1448-1459)."""
    below = fbool(qt + sigmaqt1 < qstar)
    partial = fbool(qstar > qt - sigmaqt1)
    pos = fbool(sigmaqt1 > 0.0)
    denom = torch.where(pos, 4.0 * sigmaqt1, 1.0)
    cond_part = torch.where(
        pos, fmin(qt + sigmaqt1 - qstar, 2.0 * sigmaqt1) ** 2 / denom,
        qt - qstar)
    cond = torch.where(partial, cond_part, qt - qstar)
    return torch.where(below, 0.0, cond)


def ls_cloud(dt, alpha, ph, te, qv, qcl, qal, qci, qai, cf, af, pars,
             estblx, pert_mode):
    """ls_cloud (cloud.F90:1104-1350): PDF condensation/cloud fraction.
    Returns updated (te, qv, qcl, qal, qci, qai, cf, af)."""
    qc = qcl + qci
    qa = qal + qai

    dqsx, qsx = dqsat(te, ph * 100.0, estblx)

    under = fbool(af < 1.0)
    tmparr = torch.where(under, 1.0 / torch.where(under, 1.0 - af, 1.0), 0.0)
    qcx = qc * tmparr
    qvx = torch.where(under, (qv - qsx * af) * tmparr, qsx * 1.0e-4)
    haz = fbool(af > 0.0)
    qax = torch.where(haz, qa / torch.where(haz, af, 1.0), 0.0)
    qt = qcx + qvx

    # single iteration n=1 (cloud.F90:1196-1257)
    qvp = qvx
    qcp = qcx
    dqs = dqsx
    qsn = qsx
    tep = te
    fqi = get_ice_fraction(tep, pars["t_ice_all"], pars["t_ice_max"],
                           pars["icefrpwr"])
    sigmaqt1 = alpha * qsn

    cfn = pdffrac_pert(qt, sigmaqt1, qsn, pert_mode)
    qcn = pdfcondensate_tophat(qt, sigmaqt1, qsn)

    qao = torch.where(haz, qax, 0.0)
    alhx = (1.0 - fqi) * MAPL_ALHL + fqi * MAPL_ALHS
    # PDFSHAPE==1 implicit adjustment (cloud.F90:1244)
    qsn_s = torch.where(fbool(qsn != 0.0), qsn, 1.0)
    qcn = qcp + (qcn - qcp) / (
        1.0 - (cfn * (alpha - 1.0) - qcn / qsn_s) * dqs * alhx / MAPL_CP)
    # the iteration's temperature TEn is discarded by the reference
    # (cloud.F90:1330); the prognostic TE moves by the deltas below
    cfo = cfn
    qco = qcn

    # update grid means (cloud.F90:1266-1287)
    cf = torch.where(under, cfo * (1.0 - af), 0.0)
    qco_g = torch.where(under, qco * (1.0 - af), 0.0)
    qao_g = torch.where(under, qao * af, 0.0)
    qt_fill = qa + qc + qv
    qao_g = torch.where(under, qao_g, fmax(qt_fill - qsx, 0.0))
    qv_eff = qv  # qv updated below via deltas

    # partition new condensate (cloud.F90:1292-1323)
    qcx2 = qco_g - qc
    dqcl = (1.0 - fqi) * qcx2
    dqci = fqi * qcx2
    neg = fbool((qcl + dqcl) < 0.0)
    dqci = torch.where(neg, dqci + (qcl + dqcl), dqci)
    dqcl = torch.where(neg, -qcl, dqcl)
    neg = fbool((qci + dqci) < 0.0)
    dqcl = torch.where(neg, dqcl + (qci + dqci), dqcl)
    dqci = torch.where(neg, -qci, dqci)

    qax2 = qao_g - qa
    dqal = qax2
    dqai = torch.zeros_like(qax2)
    neg = fbool((qal + dqal) < 0.0)
    dqai = torch.where(neg, dqai + (qal + dqal), dqai)
    dqal = torch.where(neg, -qal, dqal)
    neg = fbool((qai + dqai) < 0.0)
    dqal = torch.where(neg, dqal + (qai + dqai), dqal)
    dqai = torch.where(neg, -qai, dqai)

    small_af = fbool(af < 1.0e-5)
    dqai = torch.where(small_af, -qai, dqai)
    dqal = torch.where(small_af, -qal, dqal)
    small_cf = fbool(cf < 1.0e-5)
    dqci = torch.where(small_cf, -qci, dqci)
    dqcl = torch.where(small_cf, -qcl, dqcl)

    qai = qai + dqai
    qal = qal + dqal
    qci = qci + dqci
    qcl = qcl + dqcl
    qv = qv_eff - (dqai + dqci + dqal + dqcl)
    te = te + (MAPL_ALHL * (dqai + dqci + dqal + dqcl)
               + MAPL_ALHF * (dqai + dqci)) / MAPL_CP

    # evaporate offending anvil if QAo went negative (cloud.F90:1340-1348)
    gone = fbool(qao_g <= 0.0)
    qv = torch.where(gone, qv + qai + qal, qv)
    te = torch.where(gone, te - ALHS_CP * qai - ALHL_CP * qal, te)
    qai = torch.where(gone, 0.0, qai)
    qal = torch.where(gone, 0.0, qal)
    af = torch.where(gone, 0.0, af)
    return te, qv, qcl, qal, qci, qai, cf, af


def _ldradius(pl, te, qcm, nn):
    """LDRADIUS (cloud.F90:1645-1659), guarded for qcm == 0 lanes."""
    arg = qcm * (100.0 * pl / (MAPL_RGAS * te)) / (
        nn * RHO_W * (4.0 / 3.0) * MAPL_PI)
    pos = fbool(arg > 0.0)
    return torch.where(pos, torch.where(pos, arg, 1.0) ** (1.0 / 3.0), 0.0)


def _evap_subl_cnv(dt, rhcr, pl, te, qv, ql, qi, f, qs, pars, ice):
    """evap_cnv / subl_cnv (cloud.F90:1523-1643): evaporation (liquid) or
    sublimation (ice) of convective cloud."""
    a_eff = pars["cld_evp_eff"]
    nn = (5.0e6 if ice else 50.0e6)
    es = 100.0 * pl * qs / (MAPL_EPSILON + (1.0 - MAPL_EPSILON) * qs)
    rhx = fmin(qv / qs, 1.0)
    k1 = MAPL_ALHL ** 2 * RHO_W / (K_COND * MAPL_RVAP * te ** 2)
    k2 = MAPL_RVAP * te * RHO_W / (DIFFU * (1000.0 / pl) * es)
    src = qi if ice else ql
    has = fbool((f > 0.0) & (src > 0.0))
    qcm = torch.where(has, src / torch.where(has, f, 1.0), 0.0)
    radius = _ldradius(pl, te, qcm, nn)
    dry = fbool((rhx < rhcr) & (radius > 0.0))
    rad_s = torch.where(dry, radius, 1.0)
    teff = torch.where(dry, (rhcr - rhx) / ((k1 + k2) * rad_s ** 2), 0.0)
    loss = fmin(a_eff * src * dt * teff, src)
    qc = ql + qi
    hasqc = fbool(qc > 0.0)
    f = torch.where(hasqc, f * (qc - loss) / torch.where(hasqc, qc, 1.0), f)
    qv = qv + loss
    if ice:
        qi = qi - loss
        te = te - ALHS_CP * loss
    else:
        ql = ql - loss
        te = te - ALHL_CP * loss
    return te, qv, ql, qi, f


def _cons_sundq3(te, rate2, rate3, te1):
    """cons_sundq3 (cloud.F90:1909-1949)."""
    te0 = 273.0
    te2 = 200.0
    jump1 = (rate2 - 1.0) / (te0 - te1) ** 0.333
    mid = fbool((te >= te1) & (te < te0))
    lo = fbool(te < te1)
    # |TE0-TE|>0 security: frozen, with a guarded power
    dpos = fbool(torch.abs(te0 - te) > 0.0)
    d = torch.where(dpos, te0 - te, 1.0)
    f2_mid = torch.where(dpos, 1.0 + jump1 * torch.abs(d) ** 0.3333, 1.0)
    f2 = torch.where(lo, rate2 + (rate3 - rate2) * (te1 - te) / (te1 - te2),
                     torch.where(mid, f2_mid, 1.0))
    f2 = fmin(f2, 27.0)
    return f2


def _autoconversion(dt, qc, qp, te, pl, f, sdqv2, sdqv3, sdqvt1, c_00,
                    lwcrit, rescale_f):
    """autoconversion_ls / _cnv (cloud.F90:1659-1888); rescale_f: the LS
    variant rescales the cloud fraction after conversion."""
    f2 = _cons_sundq3(te, sdqv2, sdqv3, sdqvt1)
    c00x = c_00 * f2 * 1.0
    iqccrx = f2 * 1.0 / lwcrit
    has = fbool((f > 0.0) & (qc > 0.0))
    qcm = torch.where(has, qc / torch.where(has, f, 1.0), 0.0)
    rate = c00x * (1.0 - torch.exp(-((qcm * iqccrx) ** 2)))

    # piecewise F3 ramps (cloud.F90:1699-1737), frozen decisions
    f3 = torch.ones_like(te)
    f3 = torch.where(fbool((pl >= 775.0) & (te <= 275.0)), 0.2, f3)
    f3 = torch.where(fbool((pl >= 825.0) & (te <= 282.0)), 0.2, f3)
    f3 = torch.where(fbool((pl >= 775.0) & (pl < 825.0)
                           & (te <= 282.0) & (te > 275.0)), 0.2, f3)
    f3 = torch.where(fbool((pl >= 825.0) & (te <= 275.0)), 0.2, f3)
    f3 = torch.where(fbool((pl <= 775.0) | (te > 282.0)), 1.0, f3)
    f3 = torch.where(fbool((pl >= 950.0) & (te >= 285.0)),
                     fmin(0.2 * te - 56.0, 2.0), f3)
    f3 = torch.where(fbool((pl >= 925.0) & (te >= 290.0)),
                     fmin(0.04 * pl - 36.0, 2.0), f3)
    f3 = torch.where(fbool((pl >= 925.0) & (pl < 950.0)
                           & (te > 285.0) & (te < 290.0)),
                     fmax(fmin(0.04 * pl + 0.2 * te - 94.0, 2.0), 1.0), f3)
    f3 = torch.where(fbool((pl >= 950.0) & (te >= 290.0)), 2.0, f3)
    f3 = fmax(f3, 0.1)
    rate = f3 * rate
    dqp = fmax(qc * (1.0 - torch.exp(-rate * dt)), 0.0)

    # warm-fog wipe-out (cloud.F90:1745-1760)
    dqfac = torch.zeros_like(te)
    dqfac = torch.where(fbool((pl >= 975.0) & (te >= 280.0)),
                        fmax(fmin(0.2 * te - 56.0, 1.0), 0.0), dqfac)
    dqfac = torch.where(fbool((pl >= 950.0) & (te >= 285.0)),
                        fmax(fmin(0.04 * pl - 38.0, 1.0), 0.0), dqfac)
    dqfac = torch.where(fbool((pl >= 950.0) & (pl < 975.0)
                              & (te > 280.0) & (te < 285.0)),
                        fmax(fmin(0.04 * pl + 0.2 * te - 95.0, 1.0), 0.0),
                        dqfac)
    dqfac = torch.where(fbool((pl >= 975.0) & (te >= 285.0)), 1.0, dqfac)
    dqp = fmax(dqp, dqfac * qc)

    qc = qc - dqp
    qp = qp + dqp
    if rescale_f:
        pos = fbool((qc + dqp) > 0.0)
        f = torch.where(pos, qc * f / torch.where(pos, qc + dqp, 1.0), f)
    return qc, qp, f


def _ice_settlefall(wxr, qi, pl, te, f, khu, khl, lv, dt, dz, qp, icefall_c,
                    anv: bool):
    """ice_settlefall_cnv / _ls (cloud.F90:2083-2211); lv = 0-based level
    row (Fortran k = lv+1)."""
    rho = 1000.0 * 100.0 * pl / (MAPL_RGAS * te)
    has = fbool((f > 0.0) & (qi > 0.0))
    xim = torch.where(has, qi / torch.where(has, f, 1.0) * rho, 0.0)
    xpos = fbool(xim > 0.0)
    xim_s = torch.where(xpos, xim, 1.0)
    if anv:
        lxim = torch.where(xpos, torch.log10(xim_s), 0.0)
        vf = 128.6 + 53.2 * lxim + 5.5 * lxim ** 2
    else:
        vf = torch.where(xpos, 109.0 * xim_s ** 0.16, 0.0)
    if wxr > 0.0:
        vf = vf * (100.0 / fmax(pl, 10.0)) ** wxr
    vf = vf / 100.0
    # Fortran: k-1 in [KHu, KHl] (both > 0) -> stratocumulus damping
    damp = fbool((khu > 0) & (khl > 0) & (lv >= khu) & (lv <= khl))
    vf = torch.where(damp, 0.01 * vf, vf)
    vf = icefall_c * vf
    qixp = fmax(fmin(qi * (vf * dt / dz), qi), 0.0)
    qp = qp + qixp
    qi = qi - qixp
    if not anv:
        pos = fbool((qi + qixp) > 0.0)
        f = torch.where(pos, qi * f / torch.where(pos, qi + qixp, 1.0), f)
    return qi, f, qp


def _cons_alhx(te, pars):
    """cons_alhx (cloud.F90:1984-2000)."""
    t_all = pars["t_ice_all"]
    t_max = pars["t_ice_max"]
    mid = fbool((te <= t_max) & (te >= t_all))
    return torch.where(fbool(te < t_all), MAPL_ALHS,
                       torch.where(mid,
                                   MAPL_ALHS + (MAPL_ALHL - MAPL_ALHS)
                                   * (te - t_all) / (t_max - t_all),
                                   MAPL_ALHL))


def _cons_microphys(te, pr, qsat, alhx3):
    """cons_microphys (cloud.F90:1954-1979)."""
    esat = 100.0 * pr * qsat / (MAPL_EPSILON + (1.0 - MAPL_EPSILON) * qsat)
    aa = alhx3 ** 2 / (K_COND * MAPL_RVAP * te ** 2)
    bb = MAPL_RVAP * te / (DIFFU * (1000.0 / pr) * esat)
    return aa, bb


_MP_RX = (0.0, 5.0, 20.0, 80.0, 320.0, 1280.0, 5120.0, 20480.0)
_MP_D3X = (0.019, 0.032, 0.043, 0.057, 0.076, 0.102, 0.137, 0.183)


def _marshpalm(rain, pr):
    """MARSHPALM (cloud.F90:2002-2081): Marshall-Palmer size/fall speed."""
    rain_day = rain * 3600.0 * 24.0
    diam3 = torch.zeros_like(rain)
    for i in range(7):
        inbin = fbool((rain_day <= _MP_RX[i + 1]) & (rain_day > _MP_RX[i]))
        slope = (_MP_D3X[i + 1] - _MP_D3X[i]) / (_MP_RX[i + 1] - _MP_RX[i])
        diam3 = torch.where(inbin,
                            _MP_D3X[i] + (rain_day - _MP_RX[i]) * slope,
                            diam3)
    diam3 = torch.where(fbool(rain_day >= _MP_RX[7]), _MP_D3X[7], diam3)
    ntotal = 0.019 * diam3
    diam3 = 0.664 * diam3
    w = (2483.8 * diam3 + 80.0) * torch.sqrt(1000.0 / pr)
    ve = fmax(0.99 * w / 100.0, 1.0)
    diam3 = diam3 / 100.0
    w = w / 100.0
    ntotal = ntotal * 1.0e6
    return diam3, ntotal, w, ve


def precipandevap(is_top, is_low, dt, frland, rhcr3, qpl, qpi, qcl, qci,
                  te, qv, mass, imass, pl, dze, qddf3, aa, bb, area,
                  pfl_above, pfi_above, evap_dd_above, subl_dd_above,
                  envfc, ddrfc, pars, estblx):
    """precipandevap (cloud.F90:2213-2457): accrete, evaporate/sublimate,
    melt/freeze and rain/snow-out one level.  is_top: static bool (k ==
    KTOP); is_low: per-level flag (k >= LM-1).  Returns (qcl, qci, te, qv,
    pfl, pfi, evap_dd, subl_dd)."""
    c_acc = pars["c_acc"]
    c_ev_r = pars["c_ev_r"]
    c_ev_s = pars["c_ev_s"]
    revap_off_p = pars["revap_off_p"]

    envfrac = envfc
    haz = fbool(area > 0.0)
    ifactor = fmax(torch.where(haz, 1.0 / torch.where(haz, area, 1.0), 1.0),
                   1.0)

    dqs, qs = dqsat(te, pl * 100.0, estblx)
    ddfract = ddrfc

    if is_top:
        pfl = qpl * mass
        pfi = qpi * mass
        evap_dd = torch.zeros_like(te)
        subl_dd = torch.zeros_like(te)
    else:
        qpl = qpl + pfl_above * imass
        qpi = qpi + pfi_above * imass

        accr = fmin(c_acc * (qpl * mass) * qcl, qcl)
        qpl = qpl + accr
        qcl = qcl - accr
        accr = fmin(c_acc * (qpi * mass) * qcl, qcl)
        qpi = qpi + accr
        qcl = qcl - accr
        te = te + ALHF_CP * accr

        rainrat0 = ifactor * qpl * mass / dt
        snowrat0 = ifactor * qpi * mass / dt
        diamrn, _, fallrn, vern = _marshpalm(rainrat0, pl)
        diamsn, _, fallsn, vesn = _marshpalm(snowrat0, pl)
        tinlayerrn = dze / (fallrn + 0.01)
        tinlayersn = dze / (fallsn + 0.01)

        # melting of frozen precip (cloud.F90:2316-2344)
        tau_frz = 5000.0
        warm = fbool((te > MAPL_TICE) & (te <= MAPL_TICE + 5.0))
        mltfrz = torch.where(warm,
                             fmin(qpi, tinlayersn * qpi * (te - MAPL_TICE)
                                  / tau_frz), 0.0)
        te = te - ALHF_CP * mltfrz
        qpl = qpl + mltfrz
        qpi = qpi - mltfrz

        hot = fbool(te > MAPL_TICE + 5.0)
        mltfrz = torch.where(hot, qpi, 0.0)
        te = te - ALHF_CP * mltfrz
        qpl = qpl + mltfrz
        qpi = qpi - mltfrz

        lowhot = fbool(is_low & (te > MAPL_TICE))
        mltfrz = torch.where(lowhot, qpi, 0.0)
        te = te - ALHF_CP * mltfrz
        qpl = qpl + mltfrz
        qpi = qpi - mltfrz

        # freezing of liquid precip (cloud.F90:2346-2352)
        cold = fbool(te <= MAPL_TICE)
        te = te + torch.where(cold, ALHF_CP * qpl, 0.0)
        qpi = torch.where(cold, qpl + qpi, qpi)
        qpl = torch.where(cold, 0.0, qpl)

        # micro evaporation/sublimation, single iteration (:2360-2430)
        qstko = fmax(qs, 1.0e-7)
        rh_box = qv / qstko
        sub = fbool(rh_box < rhcr3)
        efactor = torch.where(sub,
                              RHO_W * (aa + bb)
                              / torch.where(sub, rhcr3 - rh_box, 1.0),
                              9.99e9)
        landseaf = 1.0

        evok = fbool(sub & (diamrn > 0.0) & (pl > 100.0)
                     & (pl < revap_off_p))
        droprad = 0.5 * diamrn
        t_ed = efactor * droprad ** 2 * (1.0 + dqs * ALHL_CP)
        t_ed_s = torch.where(evok, t_ed, 1.0)
        evap = torch.where(evok,
                           qpl * (1.0 - torch.exp(-c_ev_r * vern * landseaf
                                                  * envfrac * tinlayerrn
                                                  / t_ed_s)), 0.0)

        subok = fbool(sub & (diamsn > 0.0) & (pl > 100.0)
                      & (pl < revap_off_p))
        flakrad = 0.5 * diamsn
        t_ed = efactor * flakrad ** 2 * (1.0 + dqs * ALHS_CP)
        t_ed_s = torch.where(subok, t_ed, 1.0)
        subl = torch.where(subok,
                           qpi * (1.0 - torch.exp(-c_ev_s * vesn * landseaf
                                                  * envfrac * tinlayersn
                                                  / t_ed_s)), 0.0)

        qpi = qpi - subl
        qpl = qpl - evap
        evap_dd = evap_dd_above + ddfract * evap * mass
        evap = evap - ddfract * evap
        subl_dd = subl_dd_above + ddfract * subl * mass
        subl = subl - ddfract * subl
        qv = qv + evap + subl
        te = te - evap * ALHL_CP - subl * ALHS_CP
        pfl = qpl * mass
        pfi = qpi * mass

    # downdraft re-evaporation at every level (cloud.F90:2437-2444)
    evap = qddf3 * evap_dd / mass
    subl = qddf3 * subl_dd / mass
    qv = qv + evap + subl
    te = te - evap * ALHL_CP - subl * ALHS_CP
    return qcl, qci, te, qv, pfl, pfi, evap_dd, subl_dd


def balance(jac, sweeps=4):
    """Osborne balancing (DGEEV's xGEBAL): a diagonal similarity
    D^-1 J D equalizing off-diagonal row/column 1-norms; eigenvalues are
    unchanged.  jac: (n, n, ...) batch; not differentiated."""
    n = jac.shape[0]
    b = jac.clone()
    offr = [torch.as_tensor(np.where(np.arange(n) != i)[0],
                            device=jac.device) for i in range(n)]
    for _ in range(sweeps):
        for i in range(n):
            r = torch.abs(b[i, offr[i]]).sum(0)
            c = torch.abs(b[offr[i], i]).sum(0)
            ok = fbool((r > 0.0) & (c > 0.0))
            s = torch.sqrt(torch.where(ok, c / torch.where(ok, r, 1.0), 1.0))
            s = torch.clamp(s, 1.0e-6, 1.0e6)
            b[i, :] *= s[None]
            b[:, i] *= (1.0 / s)[None]
            b[i, i] = jac[i, i]   # the diagonal is invariant, exactly
    return b


def spectral_radius(jac, squarings=7, power_iters=20, prebalance=True):
    """Upper bound on the spectral radius of a batch of small matrices
    (the JAX package's balanced Gelfand estimate, ported as written):
    Osborne balancing, `squarings` Frobenius-normalized matrix squarings
    with the scale tracked in log space, then a power iteration for
    sigma_max.  jac: (n, n, ...); returns the (...)-shaped estimate."""
    n = jac.shape[0]
    if prebalance:
        jac = balance(jac)
    tiny = torch.finfo(jac.dtype).tiny
    fro = torch.sqrt((jac * jac).sum((0, 1)) + tiny)
    b = jac / fro
    logr = torch.log(fro)
    for _ in range(squarings):
        b = torch.einsum("ab...,bc...->ac...", b, b)
        f = torch.sqrt((b * b).sum((0, 1)) + tiny)
        logr = 2.0 * logr + torch.log(f)
        b = b / f
    m = torch.einsum("ka...,kb...->ab...", b, b)
    v = torch.ones((n,) + tuple(m.shape[2:]), dtype=m.dtype, device=m.device)
    for _ in range(power_iters):
        mv = torch.einsum("ab...,b...->a...", m, v)
        v = mv / torch.sqrt((mv * mv).sum(0, keepdim=True) + tiny)
    sigma2 = (v * torch.einsum("ab...,b...->a...", m, v)).sum(0)
    logs = logr + 0.5 * torch.log(torch.clamp(sigma2, min=tiny))
    return torch.exp(logs / float(2 ** squarings))


def _jacobian_gate(dt, alpha, ph, state, pars, estblx):
    """The mode-2 gate (cloud_tl.F90:406-481): True where the pdffrac
    perturbation model applies.  8 unit-tangent jvp probes of ls_cloud at
    the detached `state` (t, q, qi_ls, qi_con, ql_ls, ql_con, cf_ls,
    cf_con) give the 8x8 Jacobian per (level, column)."""
    s0 = tuple(x.detach() for x in state)
    alpha_sg = alpha.detach()

    def f8(v):
        t_, q_, qils_, qicn_, qlls_, qlcn_, cfls_, cfcn_ = v
        te, qv, qcl, qal, qci, qai, cf, af = ls_cloud(
            dt, alpha_sg, ph, t_, q_, qlls_, qlcn_, qils_, qicn_,
            cfls_, cfcn_, pars, estblx, False)
        # the reference's variable order
        return (te, qv, qci, qai, qcl, qal, cf, af)

    ones = torch.ones_like(s0[0])
    zeros = torch.zeros_like(ones)
    cols = []
    for c in range(8):
        tang = tuple(ones if r == c else zeros for r in range(8))
        _, jv = torch.func.jvp(f8, (s0,), (tang,))
        cols.append(torch.stack(jv, 0))
    jac = torch.stack(cols, 1)               # (row, col, npz, B)

    rho = spectral_radius(jac)
    bad = ((rho > 1.001)
           | (jac[0, 0] < 0.6)
           | (jac[1, 0] > 0.75e-4)
           | (jac[4, 0] < -0.75e-4)
           | (jac[6, 0] < -1.10))
    return fbool(bad)


def cloud_driver(dt, th, q, ple, cnv_dqldt, cnv_mfd, cnv_prc3, cnv_updf,
                 qi_ls, ql_ls, qi_con, ql_con, cf_ls, cf_con,
                 frland, khu, khl, pars, estblx, do_phy_mst, pert_mode=True):
    """cloud_driver (cloud.F90:15-848), whole-array over columns.

    3-D inputs (npz, B), 2-D (B,); ple (npz+1, B) in Pa; khu/khl int (B,).
    Returns updated (th, q, qi_ls, ql_ls, qi_con, ql_con, cf_ls, cf_con).
    """
    npz = th.shape[0]
    dev = th.device
    kt = ktop_index(npz)
    lv = torch.arange(npz, device=dev)[:, None]
    act = lv >= kt                             # static active-row mask

    # pressure/thermodynamic setup (cloud.F90:210-262)
    p = ple * 0.01
    ph = 0.5 * (p[:-1] + p[1:])
    pi_e = (p / 1000.0) ** (MAPL_RGAS / MAPL_CP)
    pih = (ph / 1000.0) ** (MAPL_RGAS / MAPL_CP)
    t = th * pih
    _, qs = dqsat(t, ph * 100.0, estblx)
    mass = (p[1:] - p[:-1]) * 100.0 / MAPL_GRAV
    imass = 1.0 / mass
    dzet = th * (pi_e[1:] - pi_e[:-1]) * MAPL_CP / MAPL_GRAV
    zet_top = torch.flip(torch.cumsum(torch.flip(dzet, [0]), 0), [0])
    qddf3 = torch.where(fbool(zet_top < 3000.0),
                        -(zet_top - 3000.0) * zet_top * mass, 0.0)
    vmip = qddf3.sum(0, keepdim=True)
    qddf3 = qddf3 / vmip
    dm = (ple[1:] - ple[:-1]) / MAPL_GRAV

    # preall snapshots for the TOTAL tangent filter (cloud.F90:277-282)
    t_pa, qlls_pa, qlcn_pa = t, ql_ls, ql_con

    # ---- stage A: column-local processes, whole-array ----
    qrn_cu = cnv_prc3
    q2, t2, qlls2, qils2, cfls2, qlcn2, qicn2, cfcn2 = cloud_tidy(
        q, t, ql_ls, qi_ls, cf_ls, ql_con, qi_con, cf_con)
    t2, qlls2, qils2 = meltfreeze(dt, t2, qlls2, qils2, pars)
    t2, qlcn2, qicn2 = meltfreeze(dt, t2, qlcn2, qicn2, pars)
    t2, q2, qlcn2, qicn2, cfcn2 = convec_src(
        dt, mass, imass, t2, q2, cnv_dqldt, cnv_mfd, qlcn2, qicn2, cfcn2,
        qs, pars)

    alpha = pdf_width(ph, frland[None, :], pars)
    rhcrit = 1.0 - alpha

    ls_pert = pert_mode
    if pert_mode and do_phy_mst == 2:
        ls_pert = _jacobian_gate(
            dt, alpha, ph, (t2, q2, qils2, qicn2, qlls2, qlcn2, cfls2,
                            cfcn2), pars, estblx)

    t2, q2, qlls2, qlcn2, qils2, qicn2, cfls2, cfcn2 = ls_cloud(
        dt, alpha, ph, t2, q2, qlls2, qlcn2, qils2, qicn2, cfls2, cfcn2,
        pars, estblx, ls_pert)

    # presink snapshots for the SINK tangent filter (cloud.F90:400-408)
    q_ps = q2
    qils_ps, qicn_ps = qils2, qicn2
    qlls_ps, qlcn_ps = qlls2, qlcn2

    # total-cloud cleanup (cloud.F90:411-417)
    cf_tot = cfls2 + cfcn2
    over = fbool(cf_tot > 1.0)
    cf_s = torch.where(over, cf_tot, 1.0)
    cfls2 = torch.where(over, cfls2 / cf_s, cfls2)
    cfcn2 = torch.where(over, cfcn2 / cf_s, cfcn2)

    t2, q2, qlcn2, qicn2, cfcn2 = _evap_subl_cnv(
        dt, rhcrit, ph, t2, q2, qlcn2, qicn2, cfcn2, qs, pars, ice=False)
    t2, q2, qlcn2, qicn2, cfcn2 = _evap_subl_cnv(
        dt, rhcrit, ph, t2, q2, qlcn2, qicn2, cfcn2, qs, pars, ice=True)

    qrn_ls = torch.zeros_like(t2)
    qrn_an = torch.zeros_like(t2)
    qlls2, qrn_ls, cfls2 = _autoconversion(
        dt, qlls2, qrn_ls, t2, ph, cfls2, pars["ls_sdqv2"], pars["ls_sdqv3"],
        pars["ls_sdqvt1"], pars["c_00"], pars["lwcrit"], rescale_f=True)
    qlcn2, qrn_an, cfcn2 = _autoconversion(
        dt, qlcn2, qrn_an, t2, ph, cfcn2, pars["anv_sdqv2"],
        pars["anv_sdqv3"], pars["anv_sdqvt1"], pars["c_00"], pars["lwcrit"],
        rescale_f=False)

    qsn_an = torch.zeros_like(t2)
    qsn_ls = torch.zeros_like(t2)
    khu_b = khu[None, :]
    khl_b = khl[None, :]
    qicn2, cfcn2, qsn_an = _ice_settlefall(
        pars["wrhodep"], qicn2, ph, t2, cfcn2, khu_b, khl_b, lv, dt, dzet,
        qsn_an, pars["anv_icefall_c"], anv=True)
    qils2, cfls2, qsn_ls = _ice_settlefall(
        pars["wrhodep"], qils2, ph, t2, cfls2, khu_b, khl_b, lv, dt, dzet,
        qsn_ls, pars["ls_icefall_c"], anv=False)

    # freeze-out of convective rain (cloud.F90:523-530)
    cold = fbool(t2 < MAPL_TICE)
    qsn_cu = torch.where(cold, qrn_cu, 0.0)
    t2 = t2 + torch.where(cold, qsn_cu * (MAPL_ALHS - MAPL_ALHL) / MAPL_CP,
                          0.0)
    qrn_cu = torch.where(cold, 0.0, qrn_cu)

    # mask everything produced by stage A to the active rows
    def msk(new, old):
        return torch.where(act, new, old)

    t2 = msk(t2, t)
    q2 = msk(q2, q)
    qlls2 = msk(qlls2, ql_ls)
    qils2 = msk(qils2, qi_ls)
    qlcn2 = msk(qlcn2, ql_con)
    qicn2 = msk(qicn2, qi_con)
    cfls2 = msk(cfls2, cf_ls)
    cfcn2 = msk(cfcn2, cf_con)
    qrn_cu = msk(qrn_cu, 0.0)
    qsn_cu = msk(qsn_cu, 0.0)
    qrn_an = msk(qrn_an, 0.0)
    qsn_an = msk(qsn_an, 0.0)
    qrn_ls = msk(qrn_ls, 0.0)
    qsn_ls = msk(qsn_ls, 0.0)

    # ---- precip-area accumulations (cloud.F90:532-560), cumulative in k
    def area1(qrn, qsn, wgt, beta):
        tot = torch.cumsum((qrn + qsn) * mass, 0)
        ar = torch.cumsum(wgt * (qrn + qsn) * mass, 0)
        pos = fbool(tot > 0.0)
        a1 = torch.where(pos, fmax(ar / torch.where(pos, tot, 1.0), 1.0e-6),
                         0.0)
        return beta * a1

    area_cu = area1(qrn_cu, qsn_cu, cnv_updf, pars["cnv_beta"])
    area_an = area1(qrn_an, qsn_an, cfcn2, pars["anv_beta"])
    area_ls = area1(qrn_ls, qsn_ls, cfls2, pars["ls_beta"])

    # micro-physical constants per level (cloud.F90:563-580)
    alhx3 = _cons_alhx(t2, pars)
    _, qs2 = dqsat(t2, ph * 100.0, estblx)
    aa, bb = _cons_microphys(t2, ph, qs2, alhx3)

    qlt = qlls2 + qlcn2
    qit = qils2 + qicn2

    # ---- precipandevap scan over active levels (three precip types) ----
    def level_step(is_top, carry, x):
        (pfl_cu, pfi_cu, edd_cu, sdd_cu,
         pfl_an, pfi_an, edd_an, sdd_an,
         pfl_ls, pfi_ls, edd_ls, sdd_ls) = carry
        (te, qv, qlt_k, qit_k, qrn_cu_k, qsn_cu_k, qrn_an_k, qsn_an_k,
         qrn_ls_k, qsn_ls_k, a_cu, a_an, a_ls, mass_k, imass_k, ph_k,
         dze_k, qddf3_k, aa_k, bb_k, rhc_k, is_low) = x
        qlt_k, qit_k, te, qv, pfl_cu, pfi_cu, edd_cu, sdd_cu = precipandevap(
            is_top, is_low, dt, frland, rhc_k, qrn_cu_k, qsn_cu_k,
            qlt_k, qit_k, te, qv, mass_k, imass_k, ph_k, dze_k, qddf3_k,
            aa_k, bb_k, a_cu, pfl_cu, pfi_cu, edd_cu, sdd_cu,
            pars["cnvenvfc"], pars["cnvddrfc"], pars, estblx)
        qlt_k, qit_k, te, qv, pfl_an, pfi_an, edd_an, sdd_an = precipandevap(
            is_top, is_low, dt, frland, rhc_k, qrn_an_k, qsn_an_k,
            qlt_k, qit_k, te, qv, mass_k, imass_k, ph_k, dze_k, qddf3_k,
            aa_k, bb_k, a_an, pfl_an, pfi_an, edd_an, sdd_an,
            1.0, pars["anvddrfc"], pars, estblx)
        qlt_k, qit_k, te, qv, pfl_ls, pfi_ls, edd_ls, sdd_ls = precipandevap(
            is_top, is_low, dt, frland, rhc_k, qrn_ls_k, qsn_ls_k,
            qlt_k, qit_k, te, qv, mass_k, imass_k, ph_k, dze_k, qddf3_k,
            aa_k, bb_k, a_ls, pfl_ls, pfi_ls, edd_ls, sdd_ls,
            1.0, pars["lsddrfc"], pars, estblx)
        new_carry = (pfl_cu, pfi_cu, edd_cu, sdd_cu,
                     pfl_an, pfi_an, edd_an, sdd_an,
                     pfl_ls, pfi_ls, edd_ls, sdd_ls)
        return new_carry, (te, qv, qlt_k, qit_k)

    is_low_row = (lv >= npz - 2).expand(t2.shape)
    xs_full = (t2, q2, qlt, qit, qrn_cu, qsn_cu, qrn_an, qsn_an,
               qrn_ls, qsn_ls, area_cu, area_an, area_ls, mass, imass, ph,
               dzet, qddf3, aa, bb, rhcrit.expand(t2.shape), is_low_row)

    x_top = tuple(v[kt] for v in xs_full)
    zb = torch.zeros_like(t2[0])
    carry0 = (zb,) * 12
    carry, y_top = level_step(True, carry0, x_top)

    xs_rest = tuple(v[kt + 1:] for v in xs_full)
    carry, ys = fscan(lambda c, x: level_step(False, c, x), carry, xs_rest)

    def put(full, top, rest):
        return torch.cat([full[:kt], top[None], rest], 0)

    t3 = put(t2, y_top[0], ys[0])
    q3 = put(q2, y_top[1], ys[1])
    qlt3 = put(qlt, y_top[2], ys[2])
    qit3 = put(qit, y_top[3], ys[3])

    # back-split total cloud water/ice (cloud.F90:739-757).  Divided by
    # the sum rather than multiplied by its reciprocal: the derivative of
    # 1/s overflows float32 where s is below 1e-19 (ice sums that small
    # occur at c96L72), that of a/s does not.
    def backsplit(a, b, tot_new):
        s = a + b
        pos = fbool(s > 0.0)
        s1 = torch.where(pos, s, 1.0)
        return (torch.where(pos, a * tot_new / s1, 0.0),
                torch.where(pos, b * tot_new / s1, 0.0))

    qlls3, qlcn3 = backsplit(qlls2, qlcn2, qlt3)
    qils3, qicn3 = backsplit(qils2, qicn2, qit3)

    # ---- SINK + TOTAL tangent filters (cloud_tl.F90:797-840, pert only)
    if pert_mode:
        sink_qi = 0.65 if do_phy_mst == 1 else 0.9
        sink_ql = 0.65 if do_phy_mst == 1 else 0.9
        tot_t = 0.25
        tot_ql = 0.75 if do_phy_mst == 1 else 0.5
        rows = np.arange(npz)[:, None]
        hi = torch.as_tensor(rows + 1 < round(50 * npz / 72), device=dev)
        mid = torch.as_tensor(abs(rows + 1 - round(62 * npz / 72))
                              <= max(1, round(2 * npz / 72)), device=dev)

        def blend(cur, pre, w, rowmask):
            mixed = mix_primal(cur, w * cur + (1.0 - w) * pre)
            return torch.where(rowmask, mixed, cur)

        qils3 = blend(qils3, qils_ps, sink_qi, hi)
        qicn3 = blend(qicn3, qicn_ps, sink_qi, hi)
        q3 = blend(q3, q_ps, sink_qi, hi)
        qlls3 = blend(qlls3, qlls_ps, sink_ql, mid)
        qlcn3 = blend(qlcn3, qlcn_ps, sink_ql, mid)

        t3 = mix_primal(t3, tot_t * t3 + (1.0 - tot_t) * t_pa)
        qlls3 = mix_primal(qlls3, tot_ql * qlls3 + (1.0 - tot_ql) * qlls_pa)
        qlcn3 = mix_primal(qlcn3, tot_ql * qlcn3 + (1.0 - tot_ql) * qlcn_pa)
        # TOTfilt_qi = 1.0 in both modes -> qi tangents unchanged

    # merge the active rows (levels above KTOP never enter the k loop)
    t3 = msk(t3, t)
    q3 = msk(q3, q)
    qlls3 = msk(qlls3, ql_ls)
    qils3 = msk(qils3, qi_ls)
    qlcn3 = msk(qlcn3, ql_con)
    qicn3 = msk(qicn3, qi_con)

    # ---- RH-excess cleanup, all levels (cloud.F90:761-772) ----
    rhexcess = 1.1
    dqsdt, qs3 = dqsat(t3, ph * 100.0, estblx)
    over = fbool(q3 > rhexcess * qs3)
    dqs = torch.where(over, (q3 - rhexcess * qs3)
                      / (1.0 + rhexcess * dqsdt * MAPL_ALHL / MAPL_CP), 0.0)
    q3 = q3 - dqs
    t3 = t3 + ALHL_CP * dqs

    # ---- negative-moisture TPW borrow, per column (cloud.F90:775-797) ----
    tpw = (q3 * dm).sum(0, keepdim=True)
    negm = fbool(q3 < 0.0)
    negtpw = torch.where(negm, q3 * dm, 0.0).sum(0, keepdim=True)
    q3 = torch.where(negm, 0.0, q3 * (1.0 + negtpw / (tpw - negtpw)))

    th_out = t3 / pih
    return th_out, q3, qils3, qlls3, qicn3, qlcn3, cfls2, cfcn2
