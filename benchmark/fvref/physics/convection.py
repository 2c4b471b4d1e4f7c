"""RAS (Relaxed Arakawa-Schubert) convection, whole-array form.

Counterpart of fv3jedi_lm_tpu/physics/convection.py (reference
convection.F90: RASE:10-660, RASE0:834-1357, ACRITN:662, SUNDQ3_ICE:694).
Every column of the cube runs at once, columns the trailing axis: arrays
are (K0, B) / (K0+1, B).  The cloud-type loop DO IC=K,ICMIN+1,-1 is a
`freeze.fscan` over IC, so each trajectory-dependent branch inside it is
recorded to and replayed from the tape; its CYCLE exits are per-column
accept masks; the in-cloud condensate recurrence is an inner level
`fscan`, whose per-level tape entries the outer one stacks per cloud type,
as the JAX package's.  `default_rasparams` and the ACRITN tables are the
port's own copies of that module's NumPy-only part (tests/test_torch_
standalone.py holds them bitwise).

`jnp.maximum` against a constant is `torch.maximum` (`cmax`), whose
derivative splits evenly at a tie as JAX's does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..constants import (MAPL_ALHL, MAPL_CP, MAPL_GRAV, MAPL_KAPPA,
                         MAPL_VIREPS)
from ..core import freeze
from ..core.freeze import fbool, fint, fmax, fmin, fscan, fwhere
from .qsat import dqsat

ONEPKAP = 1.0 + 2.0 / 7.0
DAYLEN = 86400.0
RHMAX = 0.9999
CBL_QPERT = 0.0
CBL_TPERT = 1.0
CBL_TPERT_MXOCN = 2.0
CBL_TPERT_MXLND = 4.0

#: ACRITN tables (convection.F90:662-692)
ACRIT_PH = np.array([150.0, 200.0, 250.0, 300.0, 350.0, 400.0, 450.0, 500.0,
                     550.0, 600.0, 650.0, 700.0, 750.0, 800.0, 850.0])
ACRIT_A = np.array([1.6851, 1.1686, 0.7663, 0.5255, 0.4100, 0.3677,
                    0.3151, 0.2216, 0.1521, 0.1082, 0.0750, 0.0664,
                    0.0553, 0.0445, 0.0633])


def default_rasparams(npx: int) -> np.ndarray:
    """RASPARAMS(1:25) (fv3jedi_lm_moist_mod.F90:122-149); imsize = 4*im."""
    p = np.zeros(25)
    p[0] = 1.000
    p[1] = 0.05
    p[3] = 8.0e-4
    p[4] = 1800.0
    p[5] = 43200.0
    p[6] = -300.0
    p[7] = 4.0
    p[9] = 200.0
    p[10] = 7.5e-4
    p[11] = 1.0
    p[12] = -1.0
    p[13] = 1.3
    p[14] = 1.3
    p[15] = 263.0
    p[16] = 0.5
    p[17] = 1.0
    p[19] = 0.1
    p[20] = 0.8
    p[21] = 1.0
    imsize = (npx - 1) * 4
    p[22] = (4000.0 if imsize <= 200 else 2000.0 if imsize <= 400
             else 700.0 if imsize <= 800 else 450.0)
    p[23] = 0.5
    p[24] = 0.65
    return p


_CONSTS = {}


def _const(c, like):
    """The scalar `c` as a 0-dim tensor in `like`'s dtype on its device
    (cached: no host-to-device copy per call)."""
    key = (float(c), like.dtype, like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(float(c), dtype=like.dtype,
                                        device=like.device)
    return t


def cmax(x, c):
    """jnp.maximum(x, c) for a constant c."""
    return torch.maximum(x, _const(c, x))


_ARRS = {}


def _const_arr(arr, like):
    """The numpy table `arr` as a tensor in `like`'s dtype on its device
    (cached)."""
    key = (id(arr), like.dtype, like.device)
    t = _ARRS.get(key)
    if t is None:
        t = _ARRS[key] = torch.as_tensor(arr, dtype=like.dtype,
                                         device=like.device)
    return t


def sundq3_ice(temp, rate2, rate3, te1):
    """Ice-phase autoconversion factors (convection.F90:694-703)."""
    te0 = 273.0
    te2 = 200.0
    jump1 = (rate2 - 1.0) / (te0 - te1) ** 0.333
    # the power's derivative blows up at 0: feed it a positive argument
    dtp = cmax(te0 - temp, 1.0e-12)
    f2_mid = 1.0 + jump1 * dtp ** 0.3333
    f2_low = rate2 + (rate3 - rate2) * (te1 - temp) / (te1 - te2)
    f2 = fwhere(temp >= te0, torch.ones_like(temp),
                fwhere(temp >= te1, f2_mid, f2_low))
    f2 = fmin(f2, 27.0)
    return f2, torch.ones_like(temp)


def acritn(pl, plb, acritfac):
    """Critical cloud work function (convection.F90:662-692); pl/plb are
    pressures in hPa, never differentiated."""
    # int32, as the JAX package stores it on the tape
    iwk = torch.floor(pl * 0.02 - 0.999999999).to(torch.int32)
    iwk = fint(iwk)
    ph = _const_arr(ACRIT_PH, pl)
    a = _const_arr(ACRIT_A, pl)
    lo = torch.clamp(iwk - 2, 0, 13)           # A(IWK-1) 0-based
    a_lo = a[lo]
    interp = a_lo + (pl - ph[lo]) * 0.02 * (a[lo + 1] - a_lo)
    acr = torch.where(iwk > 15, float(ACRIT_A[14]),
                      torch.where(iwk > 1, interp, float(ACRIT_A[0])))
    return acritfac * acr * (plb - pl)


def _revcs(x):
    """revcs(x)[l] = sum_{l'>=l} x[l'] along the level axis."""
    return torch.flip(torch.cumsum(torch.flip(x, [0]), 0), [0])


def safediv(a, b, eps=1.0e-6):
    """a / b with |b| clamped away from zero, sign preserved (vjp-safe:
    call sites only use lanes where |b| is O(eps) or larger)."""
    mag = cmax(torch.abs(b), eps)
    return a / torch.where(b < 0, -mag, mag)


def _at(arr, idx):
    """Per-column gather: arr (L, B), idx (B,) -> (B,)."""
    return torch.gather(arr, 0, idx[None, :])[0]


def _down(x):
    """x shifted one level down: row l holds x[l-1], row 0 x[0]."""
    return torch.cat([x[:1], x[:-1]], 0)


def _up(x, last):
    """x shifted one level up: row l holds x[l+1], the last row `last`."""
    return torch.cat([x[1:], last], 0)


def _condensate_scan(ic, carry, m_add, dq, du, dv, sub, eta, c00, ccx,
                     dtl, winds):
    """The in-cloud condensate recurrence of one cloud type
    (convection.F90:437-489), a reversed scan over the levels: the carry
    (wlq, uht, vht) gains the masked entrainment terms `dq`/`du`/`dv` on
    the rows `m_add` (L in [IC, K-1]), and at each level the condensate
    cll0 = max(wlq - sub, 0) loses closs = min(cll0 * rate * dtl, cll0)
    to rain.  Returns the final carry and the rain rows rnn (K0, B).

    The levels above IC leave the carry unchanged and rain nothing, so
    only the levels K0-1 .. IC run one by one.  The tape entry is the JAX
    package's inner `fscan` entry, the two decisions of every level
    stacked over all K0 levels: recording, those of the levels above IC
    are computed at once from the final carry; replaying, they are
    skipped.  uht/vht are carried only with `winds` (they feed the
    cumulus friction alone)."""
    wlq, uht, vht = carry
    k0 = eta.shape[0]
    mode = freeze.mode()
    if mode == "rep":
        e_cll, e_loss = freeze.take_entry()
    # safediv(cll0, eta)'s divisor, a function of eta alone
    mag = cmax(torch.abs(eta), 1.0e-6)
    sd_eta = torch.where(eta < 0, -mag, mag)
    add_q = torch.where(m_add, dq, 0.0)
    if winds:
        add_u = torch.where(m_add, du, 0.0)
        add_v = torch.where(m_add, dv, 0.0)
    d_cll = [None] * k0
    d_loss = [None] * k0
    rnn = [None] * k0

    def loss(cll0, lv):
        cli = cll0 / sd_eta[lv]
        rate = c00[lv] * (1.0 - torch.exp(-(cli / ccx[lv]) ** 2))
        return cll0 * rate * dtl[lv]

    for lv in range(k0 - 1, ic - 1, -1):
        wlq = wlq + add_q[lv]
        if winds:
            uht = uht + add_u[lv]
            vht = vht + add_v[lv]
        cll0 = wlq - sub[lv]
        d_cll[lv] = e_cll[lv] if mode == "rep" else cll0 >= 0.0
        cll0 = torch.where(d_cll[lv], cll0, 0.0)
        arg = loss(cll0, lv)
        d_loss[lv] = e_loss[lv] if mode == "rep" else arg <= cll0
        rnn[lv] = torch.where(m_add[lv], torch.where(d_loss[lv], arg, cll0),
                              0.0)
        wlq = wlq - rnn[lv]
    if mode == "rec":
        # the levels above IC (ic >= 1: IC is below ICMIN's top level)
        cll0 = (wlq - sub[ic - 1])[None, :].expand(ic, -1)
        dc = cll0 >= 0.0
        cll0 = torch.where(dc, cll0, 0.0)
        dl = loss(cll0, slice(0, ic)) <= cll0
        d_cll[:ic] = list(dc.unbind(0))
        d_loss[:ic] = list(dl.unbind(0))
        freeze.record_entry([torch.stack(d_cll, 0), torch.stack(d_loss, 0)])
    zero = torch.zeros_like(wlq)
    rnn = torch.stack([zero] * ic + rnn[ic:], 0)
    return (wlq, uht, vht), rnn


def _recomputed(body):
    """`body(c, ic)` of the cloud-type scan under activation
    checkpointing: autograd keeps each cloud type's input carry and runs
    the body again, with the same stretch of the tape replayed, when the
    backward pass reaches it.  Without it the adjoint's graph holds every
    intermediate of every cloud type, more than one card holds at c96L72
    in float32."""
    def run(c, ic):
        again = freeze.rewinder()

        def recompute(c):
            with again():
                return body(c, ic)[0]

        return checkpoint(recompute, c, use_reentrant=False), None
    return run


def rase(dt, icmin, sige, kcbl, wgt0, wgt1, frland, ts,
         tho, qho, uho, vho, co_auto, ple, rasparams, seedras, estblx=None,
         with_winds=True):
    """RASE (convection.F90:10-660) / RASE0 (with_winds=False, :834-1357).

    Shapes: tho/qho/uho/vho/wgt0/wgt1 (K0, B); ple (K0+1, B) in hPa;
    sige (K0+1,) numpy; kcbl int (B,) 1-based Fortran cloud-base level
    (0 = no convection); ts/frland/co_auto/seedras (B,).
    Returns (tho, qho, uho, vho, clw, flxd, cnv_prc3, cnv_updfrc).
    """
    k0, b = tho.shape
    dev = tho.device
    fricfac = float(rasparams[0])
    cli_crit = float(rasparams[3])
    rasal1 = float(rasparams[4])
    rasal2 = float(rasparams[5])
    friclambda = float(rasparams[10])
    sdqv2, sdqv3, sdqvt1 = (float(rasparams[13]), float(rasparams[14]),
                            float(rasparams[15]))
    acritfac = float(rasparams[16])
    pblfrac = float(rasparams[19])
    autorampb = float(rasparams[20])
    rhmn = float(rasparams[23])
    maxdallowed = float(rasparams[22])
    rhmx = float(rasparams[24])

    grav, cp, alhl = MAPL_GRAV, MAPL_CP, MAPL_ALHL
    cpi, alhi, gravi = 1.0 / cp, 1.0 / alhl, 1.0 / grav
    cpbg = cp * gravi
    ddt = DAYLEN / dt
    lbcp = alhl * cpi

    lv = torch.arange(k0, device=dev)[:, None]   # level index (0 = top)
    kcbl = kcbl.to(torch.int64)
    act0 = kcbl > 0
    # inactive columns (kcbl == 0) get a well-formed substitute cloud base:
    # their outputs are masked by act0, but the strapped geometry at
    # kcbl=0 is degenerate and its infs would poison the vjp
    k_i = torch.clamp(torch.where(act0, kcbl, k0) - 1, 0, k0 - 1)
    kcbl = torch.where(act0, kcbl, k0)
    ic_lo = icmin - 1                       # Python index of ICMIN

    # --- pressures, heights, CBL perturbation (convection.F90:184-231) ----
    pke = (ple / 1000.0) ** MAPL_KAPPA                      # (K0+1, B)
    pf = 0.5 * (ple[:-1] + ple[1:])
    pkf = (pf / 1000.0) ** MAPL_KAPPA
    tempf = tho * pkf
    thv = tho * (1.0 + MAPL_VIREPS * qho)
    czle = (cp / grav) * (pke[1:] - pke[:-1]) * thv         # full-layer dz
    czlo = (cp / grav) * (pke[1:] - pkf) * thv              # half-layer dz
    zle = _revcs(czle)                                       # ZLE(L)
    zlo = _up(zle, torch.zeros_like(zle[:1])) + czlo

    tpert = fmax(CBL_TPERT * (ts - (tempf[-1] + grav * zlo[-1] * cpi)), 0.0)
    tpert = torch.where(frland < 0.1, fmin(tpert, CBL_TPERT_MXOCN),
                        fmin(tpert, CBL_TPERT_MXLND))
    qpert = torch.zeros_like(tpert)          # CBL_QPERT = 0

    dqs, qss = dqsat(tempf, pf * 100.0, estblx)

    # --- strapped sub-cloud superlayer (convection.F90:232-268) -----------
    dple = ple[1:] - ple[:-1]
    below = lv >= k_i
    wdp = torch.where(below, wgt0 * dple, 0.0)
    prcbl = _at(ple, k_i) + wdp.sum(0)
    put = torch.arange(k0 + 1, device=dev)[:, None] == kcbl[None, :]
    prs = torch.where(put, prcbl[None, :], ple)
    prj = torch.where(put, (prcbl[None, :] / 1000.0) ** MAPL_KAPPA, pke)

    pol = 0.5 * (prs[:-1] + prs[1:])
    # the layers below the cloud base can have zero thickness under the
    # strapped pressure; they are masked everywhere, so the divisions are
    # clamped (vjp-safe, see safediv)
    dprs = prs[1:] - prs[:-1]
    prh = safediv(prs[1:] * prj[1:] - prs[:-1] * prj[:-1], ONEPKAP * dprs)
    pki = safediv(torch.ones_like(prh), prh)
    dpt = prh - prj[:-1]
    dpb = prj[1:] - prh
    pri = safediv(0.01 * torch.ones_like(prh), dprs)

    wbase = _at(prs[1:], k_i) - _at(prs, k_i)               # PRS(K+1)-PRS(K)
    wght = safediv(wdp, wbase)
    poi_k = (wght * tho).sum(0)
    qoi_k = (wght * qho).sum(0)
    uoi_k = (wght * uho).sum(0)
    voi_k = (wght * vho).sum(0)

    at_k = lv == k_i
    poi = torch.where(at_k, poi_k[None, :], tho)
    qoi = torch.where(at_k, qoi_k[None, :], qho)
    uoi = torch.where(at_k, uoi_k[None, :], uho)
    voi = torch.where(at_k, voi_k[None, :], vho)

    dq_k, qs_k = dqsat(poi_k * _at(prh, k_i), _at(pol, k_i) * 100.0, estblx)
    qst = torch.where(at_k, qs_k[None, :], qss)
    dqq = torch.where(at_k, dq_k[None, :], dqs)

    rndu = torch.clamp(seedras.to(tho.dtype) / 1.0e6, min=1.0e-6)
    mxdiam = maxdallowed * rndu ** (-0.5)
    lambda_min = 0.2 / mxdiam               # (B,)
    lambda_max = 0.2 / 200.0

    bet = dqq * pki
    gam = pki / (1.0 + lbcp * dqq)
    gam_m = _down(gam)                                       # GAM(L-1)
    dpb_m = _down(dpb)
    dqq_m = _down(dqq)
    ght = gam_m * dpb_m + gam * dpt                          # GHT(L), L>=IC+1
    gm1 = 0.5 * lbcp * (dqq_m / (alhl * (1.0 + lbcp * dqq_m))
                        + dqq / (alhl * (1.0 + lbcp * dqq)))

    poi_sv_k, qoi_sv_k, uoi_sv_k, voi_sv_k = poi_k, qoi_k, uoi_k, voi_k

    # --- cloud-type loop DO IC=K,ICMIN+1,-1 (convection.F90:316-580) ------
    zeros_kb = torch.zeros_like(tho)
    carry0 = dict(poi=poi, qoi=qoi, uoi=uoi, voi=voi, qst=qst,
                  cll=zeros_kb, rmf=zeros_kb, rmfd=zeros_kb, rmfc=zeros_kb,
                  rns=zeros_kb, updfrc=zeros_kb)
    ics = torch.arange(k0 - 1, ic_lo, -1)   # Python ic indices, K0-1 .. icmin
    prj_t, prj_b = prj[:-1], prj[1:]
    dprj = prj_b - prj_t
    prh_m = _down(prh)
    dprh = prh - prh_m
    tem_s = safediv(prj_t - prh_m, dprh, eps=1.0e-10)
    prs_k = _at(prs, k_i)
    gam_km = _at(gam, torch.clamp(k_i - 1, min=0))
    dpb_km = _at(dpb, torch.clamp(k_i - 1, min=0))
    in_k = lv <= k_i
    one_plus_lbcp_dqq = 1.0 + lbcp * dqq

    def cloud_type(c, ic):
        ic = int(ic)
        poi, qoi, uoi, voi, qst = (c["poi"], c["qoi"], c["uoi"], c["voi"],
                                   c["qst"])
        active = act0 & (ic <= k_i)
        in_cld = (lv >= ic) & in_k          # L in [IC, K]
        above = (lv > ic) & in_k            # L in [IC+1, K]
        mid = (lv > ic) & (lv < k_i)        # L in [IC+1, K-1]
        lo_cld = (lv >= ic) & (lv < k_i)    # L in [IC, K-1]
        at_ic = lv == ic

        trg = fmin(1.0, (_at(qoi, k_i) / _at(qst, k_i) - rhmn)
                   / (rhmx - rhmn))
        # SIGE is 0-based over edges (0:K0); Fortran SIGE(IC) = sige[ic+1]
        f4 = min(1.0, max(0.0, (autorampb - float(sige[ic + 1])) / 0.2))
        go = active & fbool(trg > 1.0e-5)

        # sounding recompute with CBL perturbation (convection.F90:337-356)
        poi_c = torch.where(at_k, poi + tpert[None, :], poi)
        qoi_c = torch.where(at_k, qoi + qpert[None, :], qoi)
        qol = fmax(0.0, fmin(qst * RHMAX, qoi_c))
        tem_z = torch.where(in_k, poi_c * dprj * cpbg, 0.0)
        zet = _revcs(tem_z)                  # ZET(L); ZET(K+1)=0
        zet1 = _up(zet, torch.zeros_like(zet[:1]))
        ssl = cp * prj_b * poi_c + grav * zet1
        hol = ssl + qol * alhl
        hst = ssl + qst * alhl
        zol = zet1 + (prj_b - prh) * poi_c * cpbg

        ssl_m = _down(ssl)
        qol_m = _down(qol)
        sht = ssl_m + tem_s * (ssl - ssl_m)  # SHT(L), valid L in [IC+1,K]
        qht = 0.5 * (qol + qol_m)

        hol_k = _at(hol, k_i)
        hst_ic = hst[ic]
        hol_ic = hol[ic]
        zol_ic = zol[ic]
        zet_ic1 = zet1[ic]
        go = go & fbool(hol_k > hst_ic)

        # lambda (MS-A18, convection.F90:367-394)
        dzet = zet - zet1
        tem_l = (hst_ic - hol_ic) * (zol_ic - zet_ic1) + torch.where(
            mid, (hst_ic[None, :] - hol) * dzet, 0.0).sum(0)
        go = go & fbool(tem_l > 0.0)
        alm = safediv(hol_k - hst_ic, tem_l)
        go = go & fbool(alm <= lambda_max)
        # zero lambda on rejected lanes so that nothing downstream can
        # reach inf there
        alm = torch.where(go, alm, 0.0)
        toki = fwhere(alm < lambda_min, (alm / lambda_min) ** 2,
                      torch.ones_like(alm))

        # eta (MS-A2)
        zet_k = _at(zet, k_i)
        eta = torch.where(above, 1.0 + alm[None, :] * (zet - zet_k[None, :]),
                          1.0)
        eta_ic = 1.0 + alm * (zol_ic - zet_k)
        eta = torch.where(at_ic, eta_ic[None, :], eta)
        eta1 = _up(eta, torch.ones_like(eta[:1]))
        # deta valid on [IC, K-1]: ETA(L)-ETA(L+1) with ETA(K)=1
        deta = torch.where(lo_cld, eta - eta1, 0.0)

        # work function (MS-A22, convection.F90:396-412)
        deta_hol = deta * hol
        hcc = hol_k[None, :] + _revcs(torch.where(mid, deta_hol, 0.0))
        hcc = torch.where(at_k, hol_k[None, :], hcc)           # HCC(K)=HOL(K)
        hcc1 = _up(hcc, hcc[-1:])
        eht = eta1 * dpb + eta * dpt
        wfn = torch.where(
            mid, (hcc1 * dpb + hcc * dpt - eht * hst) * gam, 0.0).sum(0)
        hcc_ic1 = hcc[min(ic + 1, k0 - 1)]
        eta_ic1 = eta1[ic]
        gam_ic = gam[ic]
        dpb_ic = dpb[ic]
        wfn = wfn + (hcc_ic1 - hst_ic * eta_ic1) * gam_ic * dpb_ic

        # in-cloud moist static energy / vertical velocity (:414-427)
        ycld = hol_k[None, :] + _revcs(torch.where(lo_cld, deta_hol, 0.0))
        hcld = safediv(ycld, eta)
        tem_b = (hcld - hst) * dzet / one_plus_lbcp_dqq
        denom_b = cp * prj_b * poi
        bk2 = _revcs(torch.where(lo_cld, grav * fmax(tem_b, 0.0) / denom_b,
                                 0.0))
        # sqrt-at-zero derivative guard; the result is clamped to >= 1
        cvw = fmax(torch.sqrt(2.0 * cmax(fmax(bk2, 0.0), 1.0e-20)), 1.0)

        # alpha / acceptance (:429-436)
        zet_ic = zet[ic]
        rasal = fwhere(zet_ic < 2000.0, torch.full_like(zet_ic, rasal1),
                       rasal1 + (rasal2 - rasal1) * (zet_ic - 2000.0) / 8000.0)
        rasal = dt / fmin(rasal, 1.0e5)
        acr = acritn(pol[ic], prs_k, acritfac)
        go = go & fbool(wfn > acr)

        # in-cloud condensate recurrence (:437-489), sequential in L
        te_a = poi * prh
        f2, f3 = sundq3_ice(te_a, sdqv2, sdqv3, sdqvt1)
        c00_x = co_auto[None, :] * f2 * f3 * f4
        cli_crit_x = cli_crit / (f2 * f3)
        dt_lyr = dzet / cvw

        wlq0 = _at(qol, k_i)
        uht0 = _at(uoi, k_i)
        vht0 = _at(voi, k_i)
        qst_ic = qst[ic]
        eta_ic_v = eta[ic]
        cll_top = qst_ic * eta_ic_v

        (wlq, uht, vht), rnn = _condensate_scan(
            ic, (wlq0, uht0, vht0), lo_cld, deta * qol, deta * uoi,
            deta * voi, torch.where(
                mid, 0.5 * (qst + _down(qst)) * eta + gm1 * (
                    hcc - 0.5 * (hst + _down(hst)) * eta), cll_top[None, :]),
            eta, c00_x, cli_crit_x, dt_lyr, with_winds and fricfac > 0.0)

        wlq = wlq - cll_top

        # gammas and kernel (:491-516)
        sht1 = _up(sht, sht[-1:])
        qht1 = _up(qht, qht[-1:])
        ssl_sht1 = eta1 * (ssl - sht1)
        gms_mid = (eta * (sht - ssl) + ssl_sht1) * pri
        gms_k = (sht - ssl) * pri
        gms_ic = ssl_sht1 * pri
        gms = torch.where(at_k, gms_k, torch.where(at_ic, gms_ic, gms_mid))
        qht_qol = qht - qol
        qol_qht1 = eta1 * (qol - qht1)
        gmh_k = gms + qht_qol * pri * alhl
        gmh_mid = gms + (eta * qht_qol + qol_qht1) * alhl * pri
        gmh_ic = gms + (qol_qht1 * alhl + eta * (hst - hol)) * pri
        gmh = torch.where(at_k, gmh_k, torch.where(at_ic, gmh_ic, gmh_mid))

        gmh_kv = _at(gmh, k_i)
        akm0 = gmh_kv * gam_km * dpb_km
        tx2_c = gmh_kv[None, :] + _revcs(torch.where(mid, deta * gmh, 0.0))
        akm = akm0 + torch.where(mid, -gms * eht * pki + tx2_c * ght,
                                 0.0).sum(0)
        akm = akm - gms[ic] * eta_ic1 * dpb_ic * pki[ic]

        go = go & fbool(akm < 0.0) & fbool(wlq >= 0.0)

        # cloud-base mass flux (:518-531)
        wfn2 = -safediv(wfn - acr, akm)
        wfn2 = fmin(rasal * trg * toki * wfn2, wbase * (100.0 * pblfrac))
        wfn2 = torch.where(go, wfn2, 0.0)
        tem = wfn2 * gravi

        gmask = go[None, :]
        g_ic = gmask & at_ic
        g_above = gmask & above
        upd = gmask & in_cld
        c = dict(c)
        c["cll"] = c["cll"] + torch.where(g_ic, wlq * tem, 0.0)
        c["rmf"] = c["rmf"] + torch.where(g_ic, tem, 0.0)
        c["rmfd"] = c["rmfd"] + torch.where(g_ic, tem * eta_ic_v, 0.0)
        rmfp = tem[None, :] * eta
        c["rmfc"] = c["rmfc"] + torch.where(g_above, rmfp, 0.0)
        updfrp = fwhere(cvw > 0.0,
                        rmfp * (ddt / DAYLEN) * 1000.0 / (cvw * prs[:-1]),
                        torch.zeros_like(rmfp))
        c["updfrc"] = c["updfrc"] + torch.where(g_above, updfrp, 0.0)

        # theta/q increments for this cloud type (:533-543)
        c["rns"] = c["rns"] + torch.where(upd, rnn * tem[None, :], 0.0)
        gmh_w = gmh * wfn2[None, :]
        gms_w = gms * wfn2[None, :]
        qoi = qoi + torch.where(upd, (gmh_w - gms_w) * alhi, 0.0)
        poi = poi + torch.where(upd, gms_w * pki * cpi, 0.0)
        qst = qst + torch.where(upd, gms_w * bet * cpi, 0.0)

        # cumulus friction (:545-570)
        if with_winds and fricfac > 0.0:
            wfn3 = wfn2 * 0.5 * fricfac * torch.exp(-alm / friclambda)
            uoi_m, voi_m = _down(uoi), _down(voi)
            uoi_p, voi_p = _up(uoi, uoi[-1:]), _up(voi, voi[-1:])
            ucu_k = uoi_m - uoi
            vcu_k = voi_m - voi
            ucu_mid = (uoi_m - uoi) * eta + (uoi - uoi_p) * eta1
            vcu_mid = (voi_m - voi) * eta + (voi - voi_p) * eta1
            deta_ic = eta - eta1
            uht_t = 2.0 * (uht - uoi * deta_ic) - (uoi + uoi_p) * eta1
            vht_t = 2.0 * (vht - voi * deta_ic) - (voi + voi_p) * eta1
            ucu = torch.where(at_k, ucu_k,
                              torch.where(at_ic, uht_t, ucu_mid)) * pri
            vcu = torch.where(at_k, vcu_k,
                              torch.where(at_ic, vht_t, vcu_mid)) * pri
            uoi = uoi + torch.where(upd, wfn3[None, :] * ucu, 0.0)
            voi = voi + torch.where(upd, wfn3[None, :] * vcu, 0.0)

        c.update(poi=poi, qoi=qoi, uoi=uoi, voi=voi, qst=qst)
        return c, None

    body = cloud_type
    if (torch.is_grad_enabled() and freeze.mode() != "rec"
            and any(x.requires_grad for x in (tho, qho, uho, vho))):
        body = _recomputed(cloud_type)
    c, _ = fscan(body, carry0, ics)
    poi, qoi, uoi, voi = c["poi"], c["qoi"], c["uoi"], c["voi"]

    # --- writeback + de-strapping (convection.F90:582-641) ----------------
    in_ks = (lv >= ic_lo) & in_k
    sum_rmf = torch.where(in_ks, c["rmf"], 0.0).sum(0)
    did = act0 & fbool(sum_rmf > 0.0)
    dmask = did[None, :]

    core = dmask & (lv >= ic_lo) & (lv < k_i)      # L in [ICMIN, K-1]
    cnv_prc3 = torch.where(dmask & in_ks, c["rns"] * pri * grav, 0.0)
    tho_out = torch.where(core, poi, tho)
    qho_out = torch.where(core, qoi, qho)
    uho_out = torch.where(core, uoi, uho)
    vho_out = torch.where(core, voi, vho)
    cnv_updfrc = torch.where(core, c["updfrc"], 0.0)

    wsum = torch.where(below, wgt1 * dple, 0.0).sum(0)
    wght1 = wgt1 * safediv(wbase, wsum)
    strap = dmask & below
    tho_out = tho_out + torch.where(strap, wght1 * (_at(poi, k_i) - poi_sv_k),
                                    0.0)
    qho_out = qho_out + torch.where(strap, wght1 * (_at(qoi, k_i) - qoi_sv_k),
                                    0.0)
    uho_out = uho_out + torch.where(strap, wght1 * (_at(uoi, k_i) - uoi_sv_k),
                                    0.0)
    vho_out = vho_out + torch.where(strap, wght1 * (_at(voi, k_i) - voi_sv_k),
                                    0.0)

    flxd = torch.where(core, c["rmfd"] * ddt / DAYLEN, 0.0)
    clw = torch.where(core, c["cll"] * ddt / DAYLEN, 0.0)

    return tho_out, qho_out, uho_out, vho_out, clw, flxd, cnv_prc3, cnv_updfrc
