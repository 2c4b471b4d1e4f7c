"""Pressure-variable transforms (model_tlmadm/fv_pressure.F90:22-69).

Counterpart of fv3jedi_lm_tpu/core/fv_pressure.py.  Vertical axis
leading: delp (npz, ...); interface outputs (npz+1, ...).
"""

from __future__ import annotations

import torch


def compute_fv3_pressures(delp, kappa, ptop):
    """Returns (pe, peln, pk, pkz)."""
    pe = torch.cat(
        [torch.full_like(delp[:1], ptop),
         ptop + torch.cumsum(delp, dim=0)], dim=0)
    peln = torch.log(pe)
    pk = torch.exp(kappa * peln)
    pkz = (pk[1:] - pk[:-1]) / (kappa * (peln[1:] - peln[:-1]))
    return pe, peln, pk, pkz
