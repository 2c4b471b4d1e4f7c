"""Hybrid sigma-pressure vertical coordinate (ak/bk): reference `set_eta`.

The port's own copy of fv3jedi_lm_tpu/grid/eta.py, identical to it
but for this paragraph: its imports resolve within
fv3jedi_lm_tpu_torch, so the port never imports the JAX package.

In the reference, the LM *receives* ak/bk from the host (FV3-JEDI) through
`create(dt, npx, npy, npz, ptop, ak, bk)` (src/fv3jedi_lm_mod.F90:44) and
falls back to `set_eta` during fv_init (tools/fv_eta_nlm.F90:33, :1223).
This module re-derives `set_eta`'s compiled configuration (no HIWPP /
MOUNTAIN_WAVES / NO_UKMO_HB / GFSL60 defines, cmake/fv3jedilm_compiler_
flags.cmake:8):

* `var_hi`  — stretched-dz builder (fv_eta_nlm.F90:1811-1986) used for the
  mid/low level counts, including the default case — a 72-level request
  resolves to `var_hi(72, ptop=1, s_rate=1.03)` (fv_eta_nlm.F90:221-245);
* `var_gfs` — NGGPS/GFS variant (fv_eta_nlm.F90:1647-1809) used for the
  L91/L95/L127 cases (fv_eta_nlm.F90:1424-1436);
* `sm1_edge` — the one-pass dz smoother var_hi applies (:2924-2957);
* the L48 data table (fv_eta_nlm.F90:607-644, case(48) ks=28 :1260-1266).

A generic smooth synthetic builder is kept for non-standard level counts
(tests use tiny npz the reference has no tables for).
"""

from __future__ import annotations

import numpy as np

from ..constants import GRAV, RGAS as RDGAS

P00 = 1.0e5

# L48 table, tools/fv_eta_nlm.F90:607-644 (case(48): ks=28, :1260-1266)
_A48 = np.array([
    1.00000, 2.69722, 5.17136, 8.89455, 14.24790, 22.07157,
    33.61283, 50.48096, 74.79993, 109.40055, 158.00460, 225.44108,
    317.89560, 443.19350, 611.11558, 833.74392, 1125.83405, 1505.20759,
    1993.15829, 2614.86254, 3399.78420, 4382.06240, 5600.87014, 7100.73115,
    8931.78242, 11149.97021, 13817.16841, 17001.20930, 20775.81856,
    23967.33875, 25527.64563, 25671.22552, 24609.29622, 22640.51220,
    20147.13482, 17477.63530, 14859.86462, 12414.92533, 10201.44191,
    8241.50255, 6534.43202, 5066.17865, 3815.60705, 2758.60264,
    1870.64631, 1128.33931, 510.47983, 0.00000, 0.00000,
])
_B48 = np.array([
    0.0] * 29 + [
    0.01253, 0.04887, 0.10724, 0.18455, 0.27461, 0.36914, 0.46103,
    0.54623, 0.62305, 0.69099, 0.75016, 0.80110, 0.84453, 0.88127,
    0.91217, 0.93803, 0.95958, 0.97747, 0.99223, 1.00000,
])


def _sm1_edge(ze: np.ndarray, ntimes: int) -> np.ndarray:
    """dz smoother (fv_eta_nlm.F90:2924-2957); ze length km+1, 0-based."""
    km = ze.size - 1
    df = 0.25
    dz = ze[1:] - ze[:-1]           # dz(k) = ze(k+1) - ze(k), k=1..km
    for n in range(1, ntimes + 1):
        k1 = 2 + (ntimes - n)       # Fortran level
        k2 = km - 1
        flux = np.zeros(km + 2)     # flux(1..km+1) -> [1..km+1]
        for k in range(k1 + 1, k2 + 1):
            flux[k] = df * (dz[k - 1] - dz[k - 2])
        for k in range(k1, k2 + 1):
            dz[k - 1] = dz[k - 1] - flux[k] + flux[k + 1]
    out = ze.copy()
    for k in range(km - 1, -1, -1):
        out[k] = out[k + 1] - dz[k]
    return out


def _hybrid_from_pe1(pe1: np.ndarray, pint: float):
    """pe1 -> (ak, bk, ks): UKMO hybrid blend (fv_eta_nlm.F90:1916-1963,
    the compiled branch — NO_UKMO_HB is not defined)."""
    km = pe1.size - 1
    ks = 0
    for k in range(2, km + 1):      # Fortran do k=2,km
        if pint < pe1[k - 1]:
            ks = k - 1
            break
    eta = pe1 / pe1[km]
    ep = eta[ks]                    # eta(ks+1)
    es = eta[km - 1]                # eta(km)
    alpha = (ep ** 2 - 2.0 * ep * es) / (es - ep) ** 2
    beta = 2.0 * ep * es ** 2 / (es - ep) ** 2
    gama = -((ep * es) ** 2) / (es - ep) ** 2
    ak = np.zeros(km + 1)
    bk = np.zeros(km + 1)
    ak[: ks + 1] = eta[: ks + 1] * 1.0e5
    for k in range(ks + 1, km):     # Fortran ks+2..km
        ak[k] = (alpha * eta[k] + beta + gama / eta[k]) * 1.0e5
        bk[k] = (pe1[k] - ak[k]) / pe1[km]
    ak[km] = 0.0
    bk[km] = 1.0
    return ak, bk, ks


def _pe1_from_sfac(s_fac: np.ndarray, ptop: float, smooth: bool):
    """Shared tail of var_hi/var_gfs: stretch factors -> interface pressures."""
    km = s_fac.size
    t0 = 270.0
    peln_top = np.log(ptop)
    peln_bot = np.log(P00)
    ztop = RDGAS / GRAV * t0 * (peln_bot - peln_top)
    dz = s_fac * (ztop / s_fac.sum())
    ze = np.zeros(km + 1)
    ze[:km] = np.cumsum(dz[::-1])[::-1]
    dz = dz * (ztop / ze[0])
    ze[:km] = np.cumsum(dz[::-1])[::-1]
    if smooth:
        ze = _sm1_edge(ze, 1)
    dz = ze[:-1] - ze[1:]
    dlnp = GRAV * dz / (RDGAS * t0)
    peln = np.empty(km + 1)
    peln[0] = peln_top
    peln[1:km] = peln_top + np.cumsum(dlnp[: km - 1])
    pe1 = np.exp(peln)
    pe1[0] = ptop
    pe1[km] = P00
    return pe1


def var_hi(km: int, ptop: float, s_rate: float, pint: float = 100.0e2):
    """Stretched hybrid coordinate (fv_eta_nlm.F90:1811-1986, non-HIWPP)."""
    k_inc = 15
    s0 = 0.10
    s_inc = (1.0 - s0) / k_inc
    s = np.empty(km)
    s[km - 1] = s0
    for k in range(km - 2, km - k_inc - 2, -1):     # Fortran km-1..km-k_inc
        s[k] = s[k + 1] + s_inc
    s[km - k_inc - 2] = 0.5 * (s[km - k_inc - 1] + s_rate)
    for k in range(km - k_inc - 3, 7, -1):          # Fortran km-k_inc-2..9
        s[k] = s_rate * s[k + 1]
    s[7] = 0.5 * (1.1 + s_rate) * s[8]
    s[6] = 1.10 * s[7]
    s[5] = 1.15 * s[6]
    s[4] = 1.20 * s[5]
    s[3] = 1.30 * s[4]
    s[2] = 1.40 * s[3]
    s[1] = 1.45 * s[2]
    s[0] = 1.50 * s[1]
    pe1 = _pe1_from_sfac(s, ptop, smooth=True)
    return _hybrid_from_pe1(pe1, pint)


def var_gfs(km: int, ptop: float, s_rate: float, pint: float = 100.0e2):
    """NGGPS/GFS stretched coordinate (fv_eta_nlm.F90:1647-1809)."""
    k_inc = 25
    s0 = 0.13
    s_inc = (1.0 - s0) / k_inc
    s = np.empty(km)
    s[km - 1] = s0
    for k in range(km - 2, km - k_inc - 2, -1):
        s[k] = s[k + 1] + s_inc
    for k in range(km - k_inc - 2, 7, -1):          # Fortran km-k_inc-1..9
        s[k] = s_rate * s[k + 1]
    s[7] = 0.5 * (1.1 + s_rate) * s[8]
    s[6] = 1.10 * s[7]
    s[5] = 1.15 * s[6]
    s[4] = 1.20 * s[5]
    s[3] = 1.26 * s[4]
    s[2] = 1.33 * s[3]
    s[1] = 1.41 * s[2]
    s[0] = 1.60 * s[1]
    pe1 = _pe1_from_sfac(s, ptop, smooth=False)
    return _hybrid_from_pe1(pe1, pint)


#: standard set_eta outcomes: km -> (builder, ptop) for the compiled branch
_SET_ETA_CASES = {
    41: (lambda: var_hi(41, 100.0, 1.035), 100.0),
    48: (lambda: (_A48.copy(), _B48.copy(), 28), 1.0),
    51: (lambda: var_hi(51, 100.0, 1.03), 100.0),
    55: (lambda: var_hi(55, 10.0, 1.035), 10.0),
    63: (lambda: var_hi(63, 1.0, 1.035), 1.0),
    91: (lambda: var_gfs(91, 40.0, 1.029), 40.0),
    95: (lambda: var_gfs(95, 20.0, 1.028), 20.0),
    127: (lambda: var_gfs(127, 1.0, 1.028, pint=75.0e2), 1.0),
}


def set_eta(km: int):
    """ak/bk/ks for a standard level count (tools/fv_eta_nlm.F90:33,1223).

    Returns (ak, bk, ks).  Level counts without an entry use the "easy"
    set_eta default: ptop = 1 Pa, stretch 1.03 via var_hi — this is the
    reference's own resolution of km=72 (fv_eta_nlm.F90:221-245).
    """
    if km in _SET_ETA_CASES:
        return _SET_ETA_CASES[km][0]()
    if km > 79:
        return var_gfs(km, 1.0, 1.028)
    return var_hi(km, 1.0, 1.03)


def _table_ptop(km: int) -> float:
    if km in _SET_ETA_CASES:
        return _SET_ETA_CASES[km][1]
    return 1.0


def subsample_ak_bk(npz: int, km_src: int = 72):
    """Reduced-level coordinate that preserves a REAL table's pressure
    distribution: picks npz+1 interfaces of the set_eta(km_src) coordinate
    (always keeping top and bottom).  For tiny-test configurations that need
    a physically plausible troposphere/stratosphere split rather than a
    synthetic profile."""
    ak, bk, _ = set_eta(km_src)
    idx = np.unique(np.round(np.linspace(0, km_src, npz + 1)).astype(int))
    assert idx.size == npz + 1, "npz too large for source table"
    return ak[idx], bk[idx]


def default_ak_bk(npz: int, ptop: float = 1.0, p_ref: float = 1.0e5,
                  ks_frac: float = 0.3):
    """ak/bk for standalone runs/tests.

    Standard level counts whose requested ptop matches the set_eta table's
    (e.g. npz=72 with the default ptop=1 Pa) get the REAL reference
    coordinate from `set_eta`; anything else falls back to a generic smooth
    hybrid builder (pure-pressure top, terrain-following bottom) so tiny
    test configurations (npz 5-16) remain usable.
    """
    if npz >= 40 and abs(ptop - _table_ptop(npz)) < 1.0e-9:
        ak, bk, _ = set_eta(npz)
        return ak, bk
    kp = np.arange(npz + 1) / npz
    # reference pressure profile: exponential-ish in sigma
    pe_ref = ptop * (p_ref / ptop) ** kp
    ks = int(npz * ks_frac)
    p_ks = pe_ref[ks]
    bk = np.zeros(npz + 1)
    # smooth ramp of bk below level ks (Simmons-Burridge style)
    s = (pe_ref - p_ks) / (p_ref - p_ks)
    bk[ks:] = s[ks:] ** 1.6
    bk[-1] = 1.0
    ak = pe_ref - bk * p_ref
    ak[-1] = 0.0
    ak[0] = ptop
    return ak, bk
