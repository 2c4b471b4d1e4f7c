"""Convert GridMetrics (numpy) to a dict of tensors on one device.

Counterpart of fv3jedi_lm_tpu/grid/device.py: the same metric names, the
same padded-aligned edge-factor arrays for the a2b ops, and the scalar
minimum/maximum cell areas as Python floats.
"""

from __future__ import annotations

import numpy as np
import torch

from .metrics import GridMetrics
from .tile import Tile

_NAMES = (
    "dx", "dy", "dxa", "dya", "dxc", "dyc", "area", "area_c",
    "rarea", "rarea_c", "rdx", "rdy", "rdxa", "rdya", "rdxc", "rdyc",
    "sin_sg", "cos_sg", "cosa_u", "sina_u", "rsin_u", "cosa_v", "sina_v",
    "rsin_v", "cosa_s", "rsin2", "cosa", "sina", "rsina",
    "divg_u", "divg_v", "del6_u", "del6_v", "fC", "f0",
    "a11", "a12", "a21", "a22", "vlon", "vlat", "ec1", "ec2",
    "en1", "en2",
    "corner_ext_coef",
)


def to_device(g: GridMetrics, dtype: torch.dtype,
              device: torch.device) -> dict:
    n = g.npx - 1
    ng = g.ng
    jb = n + 1 + 2 * ng

    def pad_edge(e):  # (6, npx+1) 1-based -> (6, jb) aligned to B positions
        out = np.zeros((6, jb))
        for jf in range(1, g.npx + 1):
            out[:, jf - 1 + ng] = e[:, jf]
        return out

    def t(arr):
        return torch.as_tensor(np.asarray(arr, np.float64), dtype=dtype,
                               device=device)

    d = {name: t(getattr(g, name)) for name in _NAMES}
    for side in ("w", "e", "s", "n"):
        d[f"edge_{side}"] = t(pad_edge(getattr(g, f"edge_{side}")))
    d["da_min"] = float(g.da_min)
    d["da_max"] = float(g.da_max)
    d["da_min_c"] = float(g.da_min_c)
    d["da_max_c"] = float(g.da_max_c)
    # the whole face: every edge and corner treatment applies
    d["tile"] = Tile(n, 0, 0, n, n)
    return d
