"""2-D finite-volume transport (fv_tp_2d) and del-n damping fluxes.

Counterpart of fv3jedi_lm_tpu/ops/transport.py (model/tp_core_nlm.F90:
78-210 `fv_tp_2d`, :1015-1166 `deln_flux`).

Conventions (ny x nx cells of the model's tile, the whole face on one
process, ng = halo width, jcy = ny+2ng, jcx = nx+2ng):
  q      (..., nf, jcy, jcx)   padded, halo-filled scalar
  crx    (..., nf, jcy, nx+1)  courant numbers at x-edges (all rows)
  xfx    (..., nf, jcy, nx+1)  area flux at x-edges
  cry    (..., nf, ny+1, jcx)  courant at y-edges (all columns)
  yfx    (..., nf, ny+1, jcx)
  ra_x   (..., nf, jcy, nx)
  ra_y   (..., nf, ny, jcx)
returns (fx, fy): (..., nf, ny, nx+1) and (..., nf, ny+1, nx).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import NG
from ..parallel import halo
from . import ppm


def fv_tp_2d(q, crx, cry, hord, xfx, yfx, grid, topo, ra_x, ra_y,
             mfx=None, mfy=None, mass=None, nord=None, damp_c=None,
             damp_k=None):
    """2-D PPM transport; optional del-n damping, selected either by the
    scalar `nord`/`damp_c` or by the per-level
    `damp_k=(damp4_0_k, damp4_n_k, nord_n, nord0_mask)` (the sponge bands
    of dyn_core_nlm.F90:536-630).  `hord` may be a per-level blend
    `(main, sponge, ksp)` (see ppm.xppm).  The inner (cross) passes of
    hord 10 use scheme 8 (the reference's ord_in)."""
    ny, nx = q.shape[-2] - 2 * NG, q.shape[-1] - 2 * NG
    T = grid["tile"]
    if isinstance(hord, tuple):
        hm, hs, ksp = hord
        ord_in = (8 if hm == 10 else hm, 8 if hs == 10 else hs, ksp)
    else:
        ord_in = 8 if hord == 10 else hord
    ord_ou = hord
    dxa = grid["dxa"]
    dya = grid["dya"]
    area = grid["area"]

    q_y = halo.copy_corners(q, topo, 2)
    fy2 = ppm.yppm(q_y, cry, ord_in, dya, T)                 # (..., ny+1, jcx)
    fyy = yfx * fy2
    q_i = (q[..., NG:NG + ny, :] * area[..., NG:NG + ny, :]
           + fyy[..., :-1, :] - fyy[..., 1:, :]) / ra_y
    fx = ppm.xppm(q_i, crx[..., NG:NG + ny, :], ord_ou,
                  dxa[..., NG:NG + ny, :], tile=T)

    q_x = halo.copy_corners(q, topo, 1)
    fx2 = ppm.xppm(q_x, crx, ord_in, dxa, tile=T)            # (..., jcy, nx+1)
    fx1 = xfx * fx2
    q_j = (q[..., :, NG:NG + nx] * area[..., :, NG:NG + nx]
           + fx1[..., :, :-1] - fx1[..., :, 1:]) / ra_x
    fy = ppm.yppm(q_j, cry[..., :, NG:NG + nx], ord_ou,
                  dya[..., :, NG:NG + nx], T)

    if mfx is not None and mfy is not None:
        fx = 0.5 * (fx + fx2[..., NG:NG + ny, :]) * mfx
        fy = 0.5 * (fy + fy2[..., :, NG:NG + nx]) * mfy
        if damp_k is not None:
            fx, fy = _deln_flux_masked(damp_k, q_x, fx, fy, grid, topo, mass)
        elif nord is not None and damp_c is not None and mass is not None:
            if damp_c > 1.0e-4:
                damp = (damp_c * grid["da_min"]) ** (nord + 1)
                fx, fy = deln_flux(nord, damp, q_x, fx, fy, grid, topo,
                                   mass=mass)
    else:
        fx = 0.5 * (fx + fx2[..., NG:NG + ny, :]) * xfx[..., NG:NG + ny, :]
        fy = 0.5 * (fy + fy2[..., :, NG:NG + nx]) * yfx[..., :, NG:NG + nx]
        if damp_k is not None:
            fx, fy = _deln_flux_masked(damp_k, q_x, fx, fy, grid, topo, None)
        elif nord is not None and damp_c is not None:
            if damp_c > 1.0e-4:
                damp = (damp_c * grid["da_min"]) ** (nord + 1)
                fx, fy = deln_flux(nord, damp, q_x, fx, fy, grid, topo)
    return fx, fy


def mask_band(mask0):
    """Static sponge-band split point from a static (npz,1,1,1) numpy mask:
    returns (k0, mixed) — mask0 is all-False from level k0 on, and `mixed`
    says whether levels [0, k0) still need a per-level select."""
    m = np.asarray(mask0).reshape(-1)
    if not m.any():
        return 0, False
    k0 = int(np.nonzero(m)[0].max()) + 1
    return k0, not bool(m[:k0].all())


def _deln_flux_masked(damp_k, q_x, fx, fy, grid, topo, mass):
    """Per-level damping order/coefficient selection: the level batch is
    split statically at the band edge."""
    damp4_0, damp4_n, nord_n, mask0 = damp_k
    if nord_n == 0:
        return deln_flux(0, damp4_0, q_x, fx, fy, grid, topo, mass=mass)
    k0, mixed = mask_band(mask0)
    if k0 == 0:
        return deln_flux(nord_n, damp4_n, q_x, fx, fy, grid, topo, mass=mass)
    mA = None if mass is None else mass[:k0]
    fxA, fyA = deln_flux(0, damp4_0[:k0], q_x[:k0], fx[:k0], fy[:k0],
                         grid, topo, mass=mA)
    if mixed:
        fxn, fyn = deln_flux(nord_n, damp4_n[:k0], q_x[:k0], fx[:k0],
                             fy[:k0], grid, topo, mass=mA)
        m0 = torch.as_tensor(mask0[:k0], device=fx.device)
        fxA = torch.where(m0, fxA, fxn)
        fyA = torch.where(m0, fyA, fyn)
    if k0 == q_x.shape[0]:
        return fxA, fyA
    mB = None if mass is None else mass[k0:]
    fxB, fyB = deln_flux(nord_n, damp4_n[k0:], q_x[k0:], fx[k0:], fy[k0:],
                         grid, topo, mass=mB)
    return torch.cat([fxA, fxB], dim=0), torch.cat([fyA, fyB], dim=0)


def _dx_flux(d2, del6_v, sign):
    """fx2(e) = del6_v(e) * sign * (d2(e) - d2(e-1)) at all x-edges [1, IC)."""
    ic = d2.shape[-1]
    out = d2.new_zeros(d2.shape[:-1] + (ic + 1,))
    out[..., 1:ic] = sign * del6_v[..., 1:ic] * (d2[..., 1:ic]
                                                  - d2[..., 0:ic - 1])
    return out


def _dy_flux(d2, del6_u, sign):
    ic = d2.shape[-2]
    out = d2.new_zeros(d2.shape[:-2] + (ic + 1,) + d2.shape[-1:])
    out[..., 1:ic, :] = sign * del6_u[..., 1:ic, :] * (d2[..., 1:ic, :]
                                                        - d2[..., 0:ic - 1, :])
    return out


def deln_flux(nord, damp, q, fx, fy, grid, topo, mass=None):
    """Del-n diffusive fluxes added to (fx, fy) (tp_core_nlm.F90:1015-1166).

    q must already be corner-copied in x.  fx: (..., ny, nx+1);
    fy: (..., ny+1, nx)."""
    ny, nx = q.shape[-2] - 2 * NG, q.shape[-1] - 2 * NG
    del6_u = grid["del6_u"]
    del6_v = grid["del6_v"]
    rarea = grid["rarea"]

    d2 = q if mass is not None else damp * q

    if nord > 0:
        d2 = halo.copy_corners(d2, topo, 1)
    fx2 = _dx_flux(d2, del6_v, -1.0)   # del6_v*(d2(i-1)-d2(i))
    if nord > 0:
        d2 = halo.copy_corners(d2, topo, 2)
    fy2 = _dy_flux(d2, del6_u, -1.0)

    for _ in range(nord):
        d2 = (fx2[..., :, :-1] - fx2[..., :, 1:]
              + fy2[..., :-1, :] - fy2[..., 1:, :]) * rarea
        d2 = halo.copy_corners(d2, topo, 1)
        fx2 = _dx_flux(d2, del6_v, +1.0)   # sign flips after first pass
        d2 = halo.copy_corners(d2, topo, 2)
        fy2 = _dy_flux(d2, del6_u, +1.0)

    fx2_c = fx2[..., NG:NG + ny, NG:NG + nx + 1]
    fy2_c = fy2[..., NG:NG + ny + 1, NG:NG + nx]
    if mass is not None:
        damp2 = 0.5 * damp
        mxl = mass[..., NG:NG + ny, NG - 1:NG + nx]
        mxr = mass[..., NG:NG + ny, NG:NG + nx + 1]
        fx = fx + damp2 * (mxl + mxr) * fx2_c
        myl = mass[..., NG - 1:NG + ny, NG:NG + nx]
        myr = mass[..., NG:NG + ny + 1, NG:NG + nx]
        fy = fy + damp2 * (myl + myr) * fy2_c
    else:
        fx = fx + fx2_c
        fy = fy + fy2_c
    return fx, fy
