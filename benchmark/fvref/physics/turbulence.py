"""Turbulence (boundary-layer diffusion): the frozen-K linearization.

Counterpart of fv3jedi_lm_tpu/physics/turbulence.py (reference
fv3jedi_lm_turbulence_mod.F90):

* `set_ltraj` (:376-540): BL_DRIVER on the trajectory builds the implicit
  diffusion tridiagonals, which are LU-factored (`vtrilu`); these frozen
  coefficients are the linearization.
* `apply` (:151-282): the frozen-coefficient solves, theta transform, LU
  solve per field, inverse transform — linear in the fields, used for the
  nonlinear step and the tangent linear alike.
* `apply_transpose` (:286-350): the vjp of the linear `apply`.

The `lax.scan`s of the LU factorisation and the sweeps are Python loops
over levels.  Layout: vertical axis leading, fields (npz, 6, ny, nx).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import KAPPA, P00
from ..autodiff import vjp
from .bldriver import bl_driver, default_turb_params


def compute_pressures(delp, ptop):
    """compute_pressures (fv3jedi_lm_utils_mod.F90:323-391): edge pressure,
    mid-point pressure and layer-mean p^kappa from delp."""
    pe = torch.cat([torch.full_like(delp[:1], ptop),
                    ptop + torch.cumsum(delp, 0)], 0)
    pm = 0.5 * (pe[1:] + pe[:-1])
    lpe = torch.log(pe)
    pek = pe ** KAPPA
    pk = (pek[1:] - pek[:-1]) / (KAPPA * (lpe[1:] - lpe[:-1]))
    return pe, pm, pk


def ice_fraction(temp):
    """IceFraction (fv3jedi_lm_utils_mod.F90:267-319)."""
    t_ice_all, t_ice_max = 233.16, 273.16
    f = torch.clamp(1.0 - (temp - t_ice_all) / (t_ice_max - t_ice_all),
                    0.0, 1.0)
    return f ** 4


def vtrilu(a, b, c):
    """vtrilupert (fv3jedi_lm_turbulence_mod.F90:583-600): LU of the
    tridiagonal (a sub, b main, c super); b returns the INVERSE main
    diagonal of U and a the L multipliers."""
    a_out = [a[0]]
    b_out = [1.0 / b[0]]
    for k in range(1, a.shape[0]):
        a_new = a[k] * b_out[-1]
        b_out.append(1.0 / (b[k] - c[k - 1] * a_new))
        a_out.append(a_new)
    return torch.stack(a_out, 0), torch.stack(b_out, 0), c


def vtrisolve(a, b, c, y, ygswitch):
    """vtrisolvepert phase 1 (fv3jedi_lm_turbulence_mod.F90:605-640): solve
    the LU-factored system.  ygswitch=1 for winds/T/qv (zero surface
    gradient), 0 for tracers (surface fix, :654-657).  Linear in y."""
    lm = y.shape[0]
    # down sweep: y(l) -= a(l) * y(l-1)
    ys = [y[0]]
    for k in range(1, lm):
        ys.append(y[k] - a[k] * ys[-1])

    if ygswitch == 1:
        yb = ys[-1] * b[-1]
    else:
        yb = ys[-1] * b[-2] / (b[-2] - a[-1] * (1.0 + c[-2] * b[-2]))

    # up sweep: y(l) = b(l) * (y(l) - c(l) * y(l+1))
    out = [None] * lm
    out[-1] = yb
    for k in range(lm - 2, -1, -1):
        out[k] = b[k] * (ys[k] - c[k] * out[k + 1])
    return torch.stack(out, 0)


class Turbulence:
    """Frozen-K boundary-layer diffusion operator for one LinearModel."""

    def __init__(self, cfg, ak, bk):
        pref = np.asarray(ak) + np.asarray(bk) * P00
        self.params = default_turb_params(pref)
        self.cfg = cfg
        self.ptop = float(ak[0])

    @torch.no_grad()
    def set_ltraj(self, traj, dt, do_phy_mst=0):
        """Local trajectory (fv3jedi_lm_turbulence_mod.F90:376-540): the
        LU-factored diffusion tridiagonals + layer-mean p^kappa."""
        delp = traj["delp"]
        pe, _, pk = compute_pressures(delp, self.ptop)
        t = traj["t"]
        th = P00 ** KAPPA * t / pk

        if do_phy_mst == 0:
            qit, qlt = traj["qi"], traj["ql"]
        else:
            fqi = ice_fraction(t)
            qtot = traj["qls"] + traj["qcn"]
            qit = qtot * fqi
            qlt = qtot * (1.0 - fqi)

        # physics sees cell-centered winds: the (ny, nx) D-wind block
        # (fv3jedi_lm_utils_mod.F90:169-176)
        ny, nx = delp.shape[-2:]
        u_c = traj["u"][..., :ny, :]
        v_c = traj["v"][..., :, :nx]

        coeffs, zpbl = bl_driver(
            u_c, v_c, th, traj["qv"], pe, qit, qlt,
            traj["frland"], traj["frocean"], traj["varflt"],
            traj["zpbl"], traj["cm"], traj["ct"], traj["cq"],
            traj["ustar"], traj["bstar"], self.params, dt,
            # LW heating-rate trajectory for the radlw_dep=1 cloud-top
            # branch
            tdtlw=traj.get("tdtlw"),
        )
        akv, bkv, ckv = vtrilu(coeffs["akv"], coeffs["bkv"], coeffs["ckv"])
        aks, bks, cks = vtrilu(coeffs["aks"], coeffs["bks"], coeffs["cks"])
        akq, bkq, ckq = vtrilu(coeffs["akq"], coeffs["bkq"], coeffs["ckq"])
        return dict(akv=akv, bkv=bkv, ckv=ckv, aks=aks, bks=bks, cks=cks,
                    akq=akq, bkq=bkq, ckq=ckq, pk=pk, zpbl=zpbl)

    def apply(self, ltraj, fields):
        """One frozen-coefficient diffusion step on a pert or traj field
        dict (u, v, t, qv, qi, ql, o3 on the (n,n) physics block); linear
        in `fields` (fv3jedi_lm_turbulence_mod.F90:151-282)."""
        pk = ltraj["pk"]
        out = dict(fields)
        kv = (ltraj["akv"], ltraj["bkv"], ltraj["ckv"])
        kq = (ltraj["akq"], ltraj["bkq"], ltraj["ckq"])
        # t2pt
        pt = P00 ** KAPPA * fields["t"] / pk
        out["u"] = vtrisolve(*kv, fields["u"], 1)
        out["v"] = vtrisolve(*kv, fields["v"], 1)
        pt = vtrisolve(ltraj["aks"], ltraj["bks"], ltraj["cks"], pt, 1)
        out["qv"] = vtrisolve(*kq, fields["qv"], 1)
        out["qi"] = vtrisolve(*kq, fields["qi"], 0)
        out["ql"] = vtrisolve(*kq, fields["ql"], 0)
        out["o3"] = vtrisolve(*kq, fields["o3"], 0)
        # pt2t
        out["t"] = pk * pt / P00 ** KAPPA
        return out

    def apply_transpose(self, ltraj, fields):
        """Exact transpose of `apply` — the reference's vtrisolvepert
        phase 2 (fv3jedi_lm_turbulence_mod.F90:286-350, :642-674)."""
        return vjp(lambda f: self.apply(ltraj, f), (fields,), fields)[0]
