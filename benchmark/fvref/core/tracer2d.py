"""Large-time-step tracer transport (fv_tracer2d_nlm.F90:275-516).

Counterpart of fv3jedi_lm_tpu/core/tracer2d.py: uses the dyn_core-
accumulated courant numbers (cx, cy) and mass fluxes (mfx, mfy) with a
static split count (q_split >= 1).  The tracers ride as one leading batch
dimension through fv_tp_2d (the JAX package's vmap over tracers), except
under a frozen-branch tape, where each tracer is transported on its own so
that its decisions are recorded in the JAX package's tape order.
"""

from __future__ import annotations

import torch

from ..ops.sw_core import F2P, SL, cells, tile_of
from ..ops.transport import fv_tp_2d
from ..parallel import halo
from . import freeze
from .freeze import fbool


def tracer_2d(q, dp1, mfx, mfy, cx, cy, grid, topo, cfg, npx, hord_tr,
              nord_tr=0, trdm=0.0):
    """Advect tracers q (list of (npz,nf,jcy,jcx) tensors) over one mdt.

    dp1: delp BEFORE dyn_core; mfx/mfy/cx/cy: accumulated fluxes/courant;
    nord_tr/trdm: the del-n damping of the first sub-cycle
    (fv_tracer2d_nlm.F90, damp_c = trdm2).  Returns the updated tracer
    list."""
    T, X, Y = tile_of(grid, npx)
    p = F2P
    nsplt = max(1, cfg.q_split)
    sin_sg = grid["sin_sg"]
    dxa, dya = grid["dxa"], grid["dya"]
    dx, dy = grid["dx"], grid["dy"]
    area, rarea = grid["area"], grid["rarea"]

    # area fluxes from the accumulated courant numbers (:355-375)
    selx = fbool(cx > 0.0)
    cm, c0 = SL(0, T.nx), SL(1, X)
    xfx = cx * dy[..., :, SL(1, X)] * torch.where(
        selx, dxa[..., :, cm] * sin_sg[2][..., :, cm],
        dxa[..., :, c0] * sin_sg[0][..., :, c0])
    sely = fbool(cy > 0.0)
    rm, r0 = SL(0, T.ny), SL(1, Y)
    yfx = cy * dx[..., SL(1, Y), :] * torch.where(
        sely, dya[..., rm, :] * sin_sg[3][..., rm, :],
        dya[..., r0, :] * sin_sg[1][..., r0, :])

    frac = 1.0 / nsplt
    if nsplt != 1:
        cx, xfx, mfx = cx * frac, xfx * frac, mfx * frac
        cy, yfx, mfy = cy * frac, yfx * frac, mfy * frac

    cs = cells(grid)
    qs = torch.stack(q, dim=0)          # tracers as a leading batch dim
    for it in range(nsplt):
        dp2 = dp1.clone()
        dp2[cs] += (((mfx[..., :, :-1] - mfx[..., :, 1:])
                     + (mfy[..., :-1, :] - mfy[..., 1:, :])) * rarea[cs])
        ra_x = area[..., :, cs[2]] + (xfx[..., :, :-1] - xfx[..., :, 1:])
        ra_y = area[..., cs[1], :] + (yfx[..., :-1, :] - yfx[..., 1:, :])
        qs = halo.fill_halo_center(qs, topo)

        if it == 0 and trdm > 1.0e-4:
            damp = dict(mass=dp1, nord=nord_tr, damp_c=trdm)
        else:
            damp = {}

        def tp(qq):
            return fv_tp_2d(qq, cx, cy, hord_tr, xfx, yfx, grid, topo, ra_x,
                            ra_y, mfx=mfx, mfy=mfy, **damp)

        if freeze.active():
            fxl, fyl = zip(*[tp(qq) for qq in qs.unbind(0)])
            fx, fy = torch.stack(fxl), torch.stack(fyl)
        else:
            fx, fy = tp(qs)
        q_c = (qs[cs] * dp1[cs]
               + ((fx[..., :, :-1] - fx[..., :, 1:])
                  + (fy[..., :-1, :] - fy[..., 1:, :])) * rarea[cs]
               ) / dp2[cs]
        qs = qs.clone()
        qs[cs] = q_c
        dp1 = dp2
    return list(qs.unbind(0))
