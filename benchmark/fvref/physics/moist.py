"""Moist physics driver: RAS convection + PDF cloud scheme.

Counterpart of fv3jedi_lm_tpu/physics/moist.py (reference
fv3jedi_lm_moist_mod.F90: set_ltraj:649-975, step_nl:282, step_tl:394,
step_ad:507).  Every column of the cube runs at once as (npz, B) tensors;
the tangent linear is `torch.func.jvp` of the whole-array scheme at the
cached trajectory with the branch tape replayed, the adjoint the vjp of
the same scheme by autograd, at the same stored values and decisions.

The combined step composes as the reference's:

* convection (rase) runs gated by the DOCONVEC filters and advances the
  (theta, qv, u, v) perturbations (step_tl:455-477);
* the cloud scheme linearizes at the UNGATED RASE0 trajectory stored by
  set_ltraj while receiving the gated convection tangents (step_tl:
  483-500), with freeze.mix_primal;
* the nonlinear writeback takes t/qv/u/v from convection and qi/ql/cfcn
  from the cloud scheme (step_nl:383-390);
* qi/ql perturbations split into (large-scale, convective) x (ice, liquid)
  parts by the trajectory fractions before the cloud scheme and recombine
  after (step_tl:434-440, 510-515); cfcn is a pert field and the 5th
  advected tracer.

`set_ltraj` computes, per column, the pressures and theta, SEEDRAS, the
strapping weights, CO_AUTO, a RASE0 trajectory pass, DOCONVEC (deep
enough, not a single spike, and the two-column Jacobian filter: the jvp
of RASE0 seeded at the cloud base in theta and in qv), the splitting
fractions, and the branch tape of the whole moist step.  The RASE0 pass
and the two Jacobian probes run as ONE forward-mode pass of RASE0 over
the columns twice over (the scheme is column-local): the first copy
carries the theta seed and gives the trajectory pass as its primal, the
second the qv seed.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..constants import MAPL_KAPPA, MAPL_P00, MAPL_TICE
from ..core import freeze
from ..autodiff import vjp
from .cloud import cloud_driver, cloud_params
from .convection import default_rasparams, rase

PMIN_DET = 3000.0
AUTOC_CN_OCN = 2.5e-3
AUTOC_CN_LAND = AUTOC_CN_OCN

#: Jacobian-filter thresholds (fv3jedi_lm_moist_mod.F90:955-960)
JFILT = (1.0e-4, 0.25, 1.0e-7, 2.5e-4)

_ATEN = torch.ops.aten
_T = torch.Tensor
#: tensor-and-number arithmetic, routed to the overloads that take the
#: number as a Scalar (the same kernels, bit for bit)
_SCALAR_OPS = {
    _T.__mul__: _ATEN.mul.Scalar, _T.__rmul__: _ATEN.mul.Scalar,
    _T.mul: _ATEN.mul.Scalar, torch.mul: _ATEN.mul.Scalar,
    _T.__add__: _ATEN.add.Scalar, _T.__radd__: _ATEN.add.Scalar,
    _T.add: _ATEN.add.Scalar, torch.add: _ATEN.add.Scalar,
    _T.__sub__: _ATEN.sub.Scalar, _T.sub: _ATEN.sub.Scalar,
    _T.__rsub__: _ATEN.rsub.Scalar,
    _T.__truediv__: _ATEN.div.Scalar, _T.div: _ATEN.div.Scalar,
    _T.__rtruediv__: lambda x, c: _ATEN.mul.Scalar(_ATEN.reciprocal(x), c),
}


class _ScalarOperands(TorchFunctionMode):
    """Forward-mode AD at about the cost of its plain operations.  An
    operand without a tangent (a Python number, a trajectory tensor) gets
    an "efficient zero" tangent, and arithmetic on those runs a Python
    reference implementation: 10-20 times a plain operation's host time
    for each `x * 2.0`.  Within this mode tensor-and-number arithmetic
    takes the Scalar overloads, whose tangent formulas need no tangent of
    the number; `_jvp` gives the trajectory tensors real zero tangents."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        op = _SCALAR_OPS.get(func)
        if (op is not None and not kwargs and len(args) == 2
                and type(args[1]) in (float, int)):
            return op(args[0], args[1])
        return func(*args, **(kwargs or {}))


def _jvp(fn, primals, tangents, consts, tape=None):
    """(outputs, output tangents) of fn(*primals, consts) by
    torch.func.jvp, with `tape` replayed: the floating-point tensors of
    the dict `consts` ride as primals with zero tangents, and the
    arithmetic with numbers takes its Scalar overloads (_ScalarOperands);
    the values are those of the plain jvp, bit for bit."""
    fl = {k: v for k, v in consts.items() if v.is_floating_point()}
    rest = {k: v for k, v in consts.items() if k not in fl}

    def f(*args):
        return fn(*args[:-1], dict(rest, **args[-1]))

    zeros = {k: torch.zeros_like(v) for k, v in fl.items()}
    with (freeze.replaying(tape) if tape is not None else nullcontext()), \
            _ScalarOperands():
        return torch.func.jvp(f, tuple(primals) + (fl,),
                              tuple(tangents) + (zeros,))


def ice_fraction(temp):
    """IceFraction (cloud.F90 get_ice_fraction with the LM's defaults:
    T_ICE_ALL = TICE - 40, T_ICE_MAX = TICE, ICEFRPWR = 4)."""
    t_ice_all = MAPL_TICE - 40.0
    t_ice_max = MAPL_TICE
    f = torch.clamp((t_ice_max - temp) / (t_ice_max - t_ice_all), 0.0, 1.0)
    return f ** 4


def _cols(x):
    """(npz, 6, ny, nx) -> (npz, B); (6, ny, nx) -> (B,)."""
    if x.dim() == 4:
        return x.reshape(x.shape[0], -1)
    return x.reshape(-1)


class Moist:
    """The moist physics linearization of one LinearModel."""

    def __init__(self, dyn, ak, bk, dt, do_phy_mst=1):
        self.dyn = dyn
        self.dt = float(dt)
        self.do_phy_mst = int(do_phy_mst)
        self.rasparams = default_rasparams(dyn.npx)
        self.cloudparams = cloud_params(dyn.nx)
        ak = np.asarray(ak, np.float64)
        bk = np.asarray(bk, np.float64)
        pref = ak + bk * MAPL_P00
        self.icmin = max(1, int(np.sum(pref < PMIN_DET)))
        self.sige = pref / pref[-1]
        self._ptop = float(ak[0])

    # -- trajectory --------------------------------------------------------

    def set_ltraj(self, prog, sfc):
        """The per-step linearization data and branch tape (ltraj, tape).

        prog: post-dynamics compute-domain dict (u, v, t, delp, qv, ...);
        sfc: 2-D surface fields (ts, frland, kcbl, khl, khu) and optional
        3-D qls/qcn cloud trajectory fields."""
        return self.linearize(prog, sfc)[0]

    @torch.no_grad()
    def linearize(self, prog, sfc):
        """((ltraj, tape), the nonlinear moist step of `prog`): the step is
        the one the tape was recorded on, so `apply_nl` need not run it
        again."""
        ltraj = self._ltraj(prog, sfc)
        with freeze.recording() as tape:
            y = self._moist_step(ltraj, self._x0(ltraj))
        return (ltraj, list(tape)), self._writeback(ltraj, prog, y)

    def _ltraj(self, prog, sfc):
        npz = self.dyn.npz
        dt = self.dt
        t = _cols(prog["t"])
        delp = _cols(prog["delp"])
        qv = _cols(prog["qv"])
        ny, nx = prog["t"].shape[-2:]
        u = _cols(prog["u"][..., :ny, :])
        v = _cols(prog["v"][..., :, :nx])

        ple = (torch.cat([torch.zeros_like(delp[:1]),
                          torch.cumsum(delp, 0)], 0) + self._ptop)
        # GEOS form (set_ltraj:716-719): pk on half levels via PLO
        cnv_ple = 0.01 * ple
        plo = 0.5 * (cnv_ple[:-1] + cnv_ple[1:])
        pk_geos = (plo / 1000.0) ** MAPL_KAPPA
        pk_fv = self._pk_fv(ple)
        ptt = MAPL_P00 ** MAPL_KAPPA * t / pk_fv
        temp = ptt * pk_geos

        ts = _cols(sfc["ts"])
        frland = _cols(sfc["frland"])
        kcbl = torch.clamp(torch.round(_cols(sfc["kcbl"])).to(torch.int64),
                           0, npz)
        khu = torch.round(_cols(sfc["khu"])).to(torch.int64)
        khl = torch.round(_cols(sfc["khl"])).to(torch.int64)

        t100 = 100.0 * temp[-1]
        seedras = (1.0e6 * (t100 - torch.floor(t100))).to(torch.int32)
        lv1 = torch.arange(1, npz + 1, device=t.device)[:, None]
        wgt0 = (lv1 >= kcbl[None, :]).to(t.dtype)
        wgt1 = wgt0
        co_auto = torch.where(frland < 0.1, AUTOC_CN_OCN,
                              torch.full_like(frland, AUTOC_CN_LAND))

        # the RASE0 trajectory pass (:779-796) and the two Jacobian-filter
        # probes (:879-975) in one forward-mode pass over the columns twice
        lv = torch.arange(npz, device=t.device)[:, None]
        k_i = torch.clamp(kcbl - 1, 0, npz - 1)
        onehot_t = (lv == k_i[None, :]).to(t.dtype)
        kq = torch.where(kcbl == npz, k_i, torch.clamp(kcbl, 0, npz - 1))
        onehot_q = (lv == kq[None, :]).to(t.dtype)
        zq = torch.zeros_like(qv)

        def two(x):
            return torch.cat([x, x], -1)

        def rase0(th, q, c):
            zu = torch.zeros_like(th)
            return rase(dt, self.icmin, self.sige, c["kcbl"], c["wgt0"],
                        c["wgt1"], c["frland"], c["ts"], th, q, zu, zu,
                        c["co_auto"], c["cnv_ple"], self.rasparams,
                        c["seedras"], with_winds=False)

        b = t.shape[-1]
        consts = dict(kcbl=kcbl, wgt0=wgt0, wgt1=wgt1, frland=frland, ts=ts,
                      co_auto=co_auto, cnv_ple=cnv_ple, seedras=seedras)
        out, tan = _jvp(
            rase0, (two(ptt), two(qv)),
            (torch.cat([onehot_t, zq], -1), torch.cat([zq, onehot_q], -1)),
            {k: two(v) for k, v in consts.items()})
        ptt_c, qvt_c, _, _, clw_c, flxd_c, prc3_c, updf_c = (
            x[..., :b] for x in out)
        dth1, dth2 = tan[0][:, :b], tan[0][:, b:]
        dqv1, dqv2 = tan[1][:, :b], tan[1][:, b:]

        # DOCONVEC heating-rate filter (:798-846)
        heat = (ptt_c - ptt) / dt
        aheat = torch.abs(heat)
        hmax = aheat.amax(0)
        sig = aheat > 0.01 * hmax[None, :]
        ctop = torch.where(sig, lv, npz - 1).amin(0) + 1      # Fortran level
        depth_ok = (kcbl - ctop) >= (1 if self.do_phy_mst == 1 else 10)
        band = (lv + 1 >= ctop[None, :]) & (lv + 1 <= kcbl[None, :] - 1)
        nb = torch.clamp(kcbl - ctop, min=1)
        band_heat = torch.where(band, aheat, 0.0)
        sum_heat = (band_heat.sum(0) - band_heat.amax(0)) / nb
        below = lv + 1 <= kcbl[None, :] - 1
        hmax_b = torch.where(below, aheat, 0.0).amax(0)
        spike_ok = sum_heat / torch.where(hmax_b > 0.0, hmax_b, 1.0) > 0.125
        doconvec = (ctop != npz) & depth_ok & spike_ok & (kcbl > 0)

        # two-column Jacobian filter (:879-975)
        h1 = torch.abs(dth1 - onehot_t).amax(0) / dt
        m1 = torch.abs(dqv1).amax(0) / dt
        h2 = torch.abs(dth2).amax(0) / dt
        m2 = torch.abs(dqv2 - onehot_q).amax(0) / dt
        jac_ok = ((h1 <= JFILT[0]) & (h2 <= JFILT[1])
                  & (m1 <= JFILT[2]) & (m2 <= JFILT[3]))
        doconvec = doconvec & jac_ok

        # cloud-splitting fractions (:848-877)
        zero3 = torch.zeros_like(t)
        qls = _cols(sfc["qls"]) if "qls" in sfc else zero3
        qcn = _cols(sfc["qcn"]) if "qcn" in sfc else zero3
        fqi = ice_fraction(temp)
        qilst = qls * fqi
        qllst = qls * (1.0 - fqi)
        qicnt = qcn * fqi
        qlcnt = qcn * (1.0 - fqi)

        def frac(a, b):
            s = a + b
            pos = s > 0.0
            s1 = torch.where(pos, s, 1.0)
            return (torch.where(pos, a / s1, 0.0),
                    torch.where(pos, b / s1, 0.0))

        ilsf, icnf = frac(qilst, qicnt)
        llsf, lcnf = frac(qllst, qlcnt)

        cfcnt = _cols(prog["cfcn"]) if "cfcn" in prog else zero3

        return dict(ptt=ptt, qvt=qv, ut=u, vt=v, pk_fv=pk_fv,
                    cnv_ple=cnv_ple, ple=ple, ts=ts, frland=frland,
                    kcbl=kcbl, khu=khu, khl=khl,
                    wgt0=wgt0, wgt1=wgt1, co_auto=co_auto, seedras=seedras,
                    doconvec=doconvec, ilsf=ilsf, icnf=icnf, llsf=llsf,
                    lcnf=lcnf,
                    # the cloud scheme's linearization point: the UNGATED
                    # RASE0 trajectory (set_ltraj:731-775)
                    ptt_c=ptt_c, qvt_c=qvt_c, clw_c=clw_c, flxd_c=flxd_c,
                    prc3_c=prc3_c, updf_c=updf_c,
                    qilst=qilst, qllst=qllst, qicnt=qicnt, qlcnt=qlcnt,
                    cfcnt=cfcnt)

    def _x0(self, ltraj):
        """The linearization point of the moist step in scheme variables."""
        return dict(ptt=ltraj["ptt"], qvt=ltraj["qvt"], ut=ltraj["ut"],
                    vt=ltraj["vt"], qils=ltraj["qilst"], qlls=ltraj["qllst"],
                    qicn=ltraj["qicnt"], qlcn=ltraj["qlcnt"],
                    cfcn=ltraj["cfcnt"])

    def _pk_fv(self, ple):
        """FV pk = d(p^kappa)/dlogp layer mean used for T<->theta."""
        pek = ple ** MAPL_KAPPA
        peln = torch.log(ple)
        return (pek[1:] - pek[:-1]) / (MAPL_KAPPA * (peln[1:] - peln[:-1]))

    # -- the differentiated moist step (convection + cloud) -----------------

    def _moist_step(self, ltraj, x):
        """One moist physics application on column scheme variables
        x = {ptt, qvt, ut, vt, qils, qlls, qicn, qlcn, cfcn}: convection
        where DOCONVEC, then the cloud scheme linearized at the stored
        ungated RASE0 trajectory with the convection's tangents; ptt/qvt
        take their primal from convection and their derivative from the
        cloud scheme."""
        mix = freeze.mix_primal
        kcbl_eff = torch.where(ltraj["doconvec"], ltraj["kcbl"], 0)
        tho, qho, uho, vho, clw, flxd, prc3, updf = rase(
            self.dt, self.icmin, self.sige, kcbl_eff, ltraj["wgt0"],
            ltraj["wgt1"], ltraj["frland"], ltraj["ts"],
            x["ptt"], x["qvt"], x["ut"], x["vt"], ltraj["co_auto"],
            ltraj["cnv_ple"], self.rasparams, ltraj["seedras"])

        th2, q2, qils2, qlls2, qicn2, qlcn2, _, cfcn2 = cloud_driver(
            self.dt,
            mix(ltraj["ptt_c"], tho), mix(ltraj["qvt_c"], qho),
            ltraj["ple"],
            mix(ltraj["clw_c"], clw), mix(ltraj["flxd_c"], flxd),
            mix(ltraj["prc3_c"], prc3), mix(ltraj["updf_c"], updf),
            x["qils"], x["qlls"], x["qicn"], x["qlcn"],
            torch.zeros_like(x["qils"]), x["cfcn"],
            ltraj["frland"], ltraj["khu"], ltraj["khl"],
            self.cloudparams, None, self.do_phy_mst)

        return dict(ptt=mix(tho, th2), qvt=mix(qho, q2), ut=uho, vt=vho,
                    qi=qils2 + qicn2, ql=qlls2 + qlcn2, cfcn=cfcn2)

    # -- marshalling ---------------------------------------------------------

    def _marshal_in(self, ltraj, pert):
        """Compute-domain pert dict -> column scheme pert (step_tl:428-440):
        theta scaling, qi/ql split by the trajectory fractions."""
        ny, nx = pert["t"].shape[-2:]
        p00k = MAPL_P00 ** MAPL_KAPPA
        qi = _cols(pert["qi"])
        ql = _cols(pert["ql"])
        return dict(
            ptt=_cols(pert["t"]) * p00k / ltraj["pk_fv"],
            qvt=_cols(pert["qv"]),
            ut=_cols(pert["u"][..., :ny, :]),
            vt=_cols(pert["v"][..., :, :nx]),
            qils=qi * ltraj["ilsf"], qicn=qi * ltraj["icnf"],
            qlls=ql * ltraj["llsf"], qlcn=ql * ltraj["lcnf"],
            cfcn=_cols(pert["cfcn"]))

    def _writeback(self, ltraj, prog, y):
        """Column scheme fields `y` -> the compute-domain dict `prog` with
        t, qv, the winds' (ny, nx) block, qi, ql and (where `prog` has it)
        cfcn replaced (step_nl:383-390, step_tl:510-520); fields the scheme
        does not touch pass through."""
        ny, nx = prog["t"].shape[-2:]
        p00k = MAPL_P00 ** MAPL_KAPPA
        out = dict(prog)
        out["t"] = (y["ptt"] * ltraj["pk_fv"] / p00k).reshape(prog["t"].shape)
        out["qv"] = y["qvt"].reshape(prog["qv"].shape)
        u, v = prog["u"], prog["v"]
        out["u"] = torch.cat([y["ut"].reshape(u[..., :ny, :].shape),
                              u[..., ny:, :]], -2)
        out["v"] = torch.cat([y["vt"].reshape(v[..., :, :nx].shape),
                              v[..., :, nx:]], -1)
        out["qi"] = y["qi"].reshape(prog["qi"].shape)
        out["ql"] = y["ql"].reshape(prog["ql"].shape)
        if "cfcn" in prog:
            out["cfcn"] = y["cfcn"].reshape(prog["cfcn"].shape)
        return out

    # -- public NL / TL / AD ------------------------------------------------

    @torch.no_grad()
    def apply_nl(self, ltraj, tape, prog):
        """Nonlinear moist step on the trajectory prog dict (step_nl
        writeback, fv3jedi_lm_moist_mod.F90:383-390)."""
        with freeze.replaying(tape):
            y = self._moist_step(ltraj, self._x0(ltraj))
        return self._writeback(ltraj, prog, y)

    def apply_tl(self, ltraj, tape, pert):
        """The tangent-linear moist operator: the jvp of the moist step at
        the stored trajectory with the tape replayed, between the
        marshalling and its writeback."""
        x0 = self._x0(ltraj)
        dx = self._marshal_in(ltraj, pert)
        dy = _jvp(lambda x, c: self._moist_step(c, x), (x0,),
                  ({k: dx[k] for k in x0},), ltraj, tape=tape)[1]
        return self._writeback(ltraj, pert, dy)

    def apply_ad(self, ltraj, tape, pert_ad):
        """Exact transpose of apply_tl: the writeback and the marshalling
        transposed by autograd (both are linear), the moist step by the vjp
        of its autograd graph at the stored trajectory, tape replayed."""
        zeros = {k: torch.zeros_like(v) for k, v in pert_ad.items()}
        y0 = {k: torch.zeros_like(ltraj["ptt"])
              for k in ("ptt", "qvt", "ut", "vt", "qi", "ql", "cfcn")}
        pb_pass, yb = vjp(lambda p, y: self._writeback(ltraj, p, y),
                          (zeros, y0), pert_ad)
        xb = vjp(lambda x: self._moist_step(ltraj, x), (self._x0(ltraj),),
                 yb, tape=tape)[0]
        pb_in = vjp(lambda p: self._marshal_in(ltraj, p), (zeros,), xb)[0]
        return {k: pb_pass[k] + pb_in[k] for k in pert_ad}
