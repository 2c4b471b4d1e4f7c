"""Saturation vapor pressure lookup table (ESTBLX) and d(qsat)/dT.

Counterpart of fv3jedi_lm_tpu/physics/qsat.py (reference qsat_util.F90:
19-106, bldriver.F90:1304-1520).  `_esat_liquid`, `_esat_ice`,
`build_estblx` and `ESTBLX` are the port's own copies of that module's
NumPy-only part, identical to it bit for bit (tests/test_torch_standalone.py
holds them so); `dqsat` is the torch version of its `dqsat`.

The 18301-entry table over 150..333 K at 0.01 K resolution is built once in
float64 numpy at import; it is trajectory-side data and never
differentiated.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import H2OMW, AIRMW
from ..core.freeze import fbool, fclip, fint

DEGSUBS = 100
TMINTBL = 150.0
TMAXTBL = 333.0
TABLESIZE = round(TMAXTBL - TMINTBL) * DEGSUBS + 1
ZEROC = 273.16
ESFAC = H2OMW / AIRMW
MAX_MIXING_RATIO = 1.0


def _esat_liquid(t):
    """QSATLQU0 (qsat_util.F90:60-104): Starr polynomial, liquid."""
    tmin = ZEROC - 40.0
    ti = np.clip(t, tmin, TMAXTBL)
    tt = ti - ZEROC
    b = [6.107799961e+0, 4.436518521e-1, 1.428945805e-2, 2.650648471e-4,
         3.031240396e-6, 2.034080948e-8, 6.136820929e-11]
    b = [x * 100.0 for x in b]
    ex = (tt * (tt * (tt * (tt * (tt * (tt * b[6] + b[5]) + b[4]) + b[3])
                      + b[2]) + b[1]) + b[0])
    return ex


def _esat_ice(t):
    """QSATICE0 (qsat_util.F90:106-...): Starr polynomial blends, ice."""
    tminice = ZEROC - 95.0
    ti = np.clip(t, tminice, ZEROC)
    tt = ti - ZEROC
    bi = [6.109177956e+0, 5.034698970e-1, 1.886013408e-2, 4.176223716e-4,
          5.824720280e-6, 4.838803174e-8, 1.838826904e-10]
    s1 = [0.298152339e+1, 0.191372282e+0, 0.517609116e-2, 0.754129933e-4,
          0.623439266e-6, 0.276961083e-8, 0.516000335e-11]
    s2 = [0.535098336e+1, 0.401390832e+0, 0.129690326e-1, 0.230325039e-3,
          0.236279781e-5, 0.132243858e-7, 0.314296723e-10]
    bi = [x * 100.0 for x in bi]
    s1 = [x * 100.0 for x in s1]
    s2 = [x * 100.0 for x in s2]

    def poly(c, x):
        return (x * (x * (x * (x * (x * (x * c[6] + c[5]) + c[4]) + c[3])
                          + c[2]) + c[1]) + c[0])

    e_s1 = poly(s1, tt)
    e_s2 = poly(s2, tt)
    e_bi = poly(bi, tt)
    w12 = (-65.0 - tt) / 10.0      # TSTARR1=-75 .. TSTARR2=-65
    w34 = (-40.0 - tt) / 10.0      # TSTARR3=-50 .. TSTARR4=-40
    ex = np.where(
        tt < -75.0, e_s1,
        np.where(tt < -65.0, w12 * e_s1 + (1.0 - w12) * e_s2,
                 np.where(tt < -50.0, e_s2,
                          np.where(tt < -40.0, w34 * e_s2 + (1.0 - w34) * e_bi,
                                   e_bi))))
    return ex


def build_estblx() -> np.ndarray:
    """ESINIT (qsat_util.F90:19-57): blended liquid/ice table."""
    t = TMINTBL + np.arange(TABLESIZE) / DEGSUBS
    este = np.where(t > ZEROC, _esat_liquid(t), _esat_ice(t))
    estw = _esat_liquid(t)
    tc = t - ZEROC
    tmix = -20.0
    blend = (tc / tmix) * (este - estw) + estw
    return np.where((tc >= tmix) & (tc < 0.0), blend, este)


ESTBLX = build_estblx()

_TABLES = {}


def _table(estblx, like):
    """The table as a tensor in `like`'s dtype on its device (cached for
    the module's own table)."""
    if estblx is not None:
        return torch.as_tensor(np.asarray(estblx), dtype=like.dtype,
                               device=like.device)
    key = (like.dtype, like.device)
    if key not in _TABLES:
        _TABLES[key] = torch.as_tensor(ESTBLX, dtype=like.dtype,
                                       device=like.device)
    return _TABLES[key]


def dqsat(temp, plo_pa, estblx=None):
    """DQSAT_BAC / DQSAT_sub_sca (cloud.F90:2459-2525, bldriver.F90:
    1466-1520), vectorized: temp in K, plo_pa in Pa; returns (dqsi, qssi).
    Differentiable in temp through the piecewise-linear table; the table
    index and the saturation branch are frozen decisions."""
    tbl = _table(estblx, temp)
    pp = plo_pa
    ti = fclip(temp, TMINTBL, TMAXTBL - 0.001)
    tt = (ti - TMINTBL) * DEGSUBS + 1.0
    # the table has 18301 entries
    it = fint(torch.floor(tt).to(torch.int64), maxval=65535)
    t_hi = tbl[it]
    t_lo = tbl[it - 1]
    dqq = t_hi - t_lo                               # ESTBLX(IT+1)-ESTBLX(IT)
    qq = (tt - it.to(tt.dtype)) * dqq + t_lo
    sat = fbool(pp <= qq)
    dd = 1.0 / torch.where(sat, 1.0, pp - (1.0 - ESFAC) * qq)
    qsat = torch.where(sat, MAX_MIXING_RATIO, ESFAC * qq * dd)
    dqsi = torch.where(sat, 0.0, (ESFAC * DEGSUBS) * dqq * pp * dd * dd)
    return dqsi, qsat
