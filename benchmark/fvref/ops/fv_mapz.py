"""Vertical remapping (Lagrangian -> Eulerian), every kord.

Counterpart of fv3jedi_lm_tpu/ops/fv_mapz.py (fv_mapz_nlm.F90).  The remap
is expressed through the cumulative mass function of the piecewise-
parabolic reconstruction, evaluated at each target interface:

    q2(k) = (M(pe2(k+1)) - M(pe2(k))) / (pe2(k+1) - pe2(k))

with the source layer of each target interface found by one
`torch.searchsorted` over a (ncol, k) contiguous layout.  The vertical
edge reconstruction (cs_profile) is a per-column tridiagonal solve, written
as Python loops over k, then the kord-specific limiters as selects (the
Huynh family, kord 9 and 10); |kord| > 16 is the perfectly linear scheme
of the perturbation remap (kord 17).  `mapn_tracer` remaps several
tracers on one shared geometry, with the `fillz` borrowing pass.

Vertical axis is LEADING everywhere in this module.
"""

from __future__ import annotations

import torch

from ..core.freeze import fbool, fclip, fint, fmax, fmin, fscan, fwhere

R3 = 1.0 / 3.0
R12 = 1.0 / 12.0
T_MIN = 184.0  # map_scalar t_min (GEOS uses a 184 K floor)


# ----------------------------------------------------------------------
# cs_profile: edge-value tridiagonal + limiters
# ----------------------------------------------------------------------

def _edge_tridiag(a1, delp):
    """Edge values by the cubic-spline-like tridiagonal (cs_profile else
    branch, fv_mapz_nlm.F90:2158-2186).  a1, delp: (km, ...); returns the
    (km+1, ...) edges."""
    km = a1.shape[0]
    grat1 = delp[1] / delp[0]
    bet1 = grat1 * (grat1 + 0.5)
    q = [None] * km
    gam = [None] * km
    q[0] = ((grat1 + grat1) * (grat1 + 1.0) * a1[0] + a1[1]) / bet1
    gam[0] = (1.0 + grat1 * (grat1 + 1.5)) / bet1
    d4 = None
    for k in range(1, km):
        d4 = delp[k - 1] / delp[k]
        bet = 2.0 + d4 + d4 - gam[k - 1]
        q[k] = (3.0 * (a1[k - 1] + d4 * a1[k]) - q[k - 1]) / bet
        gam[k] = d4 / bet

    a_bot = 1.0 + d4 * (d4 + 1.5)
    q_next = (2.0 * d4 * (d4 + 1.0) * a1[-1] + a1[-2] - a_bot * q[-1]) / (
        d4 * (d4 + 0.5) - a_bot * gam[-1])
    edges = [None] * (km + 1)
    edges[km] = q_next
    for k in range(km - 1, -1, -1):
        q_next = q[k] - gam[k] * q_next
        edges[k] = q_next
    return torch.stack(edges)


def _edge_tridiag_w(a1, delp, qs):
    """iv == -2 variant with the bottom boundary value qs
    (fv_mapz_nlm.F90:2135-2156)."""
    km = a1.shape[0]
    q = [None] * km
    gam = [None] * (km - 1)     # gam(k) for Fortran k = 2..km
    q[0] = 1.5 * a1[0]
    gam[0] = torch.full_like(a1[0], 0.5)
    for k in range(1, km - 1):
        grat = delp[k - 1] / delp[k]
        bet = 2.0 + grat + grat - gam[k - 1]
        q[k] = (3.0 * (a1[k - 1] + a1[k]) - q[k - 1]) / bet
        gam[k] = grat / bet
    grat = delp[-2] / delp[-1]
    q[km - 1] = (3.0 * (a1[-2] + a1[-1]) - grat * qs - q[km - 2]) / (
        2.0 + grat + grat - gam[km - 2])
    for k in range(km - 2, -1, -1):
        q[k] = q[k] - gam[k] * q[k + 1]
    return torch.stack(q + [qs])


def _cs_limiters(a1, a2, a3, a4, extm, iv):
    """cs_limiters (fv_mapz_nlm.F90:2467-2542), vectorized."""
    if iv == 0:
        nonpos = fbool(a1 <= 0.0)
        da1 = a3 - a2
        cond = torch.abs(da1) < -a4
        f_min = a1 + 0.25 * da1**2 / fwhere(a4 == 0, 1.0, a4) + a4 * R12
        neg_min = fbool(cond & (f_min < 0.0))
        c_mid = fbool((a1 < a3) & (a1 < a2))
        c_right = fbool(a3 > a2)
        a4_mid = torch.zeros_like(a4)
        a4_r = 3.0 * (a2 - a1)
        a3_r = a2 - a4_r
        a4_l = 3.0 * (a3 - a1)
        a2_l = a3 - a4_l
        a2n = torch.where(c_mid, a1, torch.where(c_right, a2, a2_l))
        a3n = torch.where(c_mid, a1, torch.where(c_right, a3_r, a3))
        a4n = torch.where(c_mid, a4_mid, torch.where(c_right, a4_r, a4_l))
        a2f = torch.where(neg_min, a2n, a2)
        a3f = torch.where(neg_min, a3n, a3)
        a4f = torch.where(neg_min, a4n, a4)
        return (torch.where(nonpos, a1, a2f), torch.where(nonpos, a1, a3f),
                torch.where(nonpos, 0.0, a4f))
    if iv == 1:
        mono = fbool((a1 - a2) * (a1 - a3) >= 0.0)
    else:  # iv == 2: standard PPM constraint keyed on extm
        mono = extm
    da1 = a3 - a2
    da2 = da1**2
    a6da = a4 * da1
    a4_r = 3.0 * (a2 - a1)
    a3_r = a2 - a4_r
    a4_l = 3.0 * (a3 - a1)
    a2_l = a3 - a4_l
    under = fbool(a6da < -da2)
    over = fbool(a6da > da2)
    a2n = torch.where(under, a2, torch.where(over, a2_l, a2))
    a3n = torch.where(under, a3_r, a3)
    a4n = torch.where(under, a4_r, torch.where(over, a4_l, a4))
    return (torch.where(mono, a1, a2n), torch.where(mono, a1, a3n),
            torch.where(mono, 0.0, a4n))


def _large_scale(q, a1, gam, iv):
    """The large-scale constraints on the edge values q (km+1, ...)
    (fv_mapz_nlm.F90:2205-2248), as a new tensor."""
    km = a1.shape[0]
    q1 = fclip(q[1], fmin(a1[0], a1[1]), fmax(a1[0], a1[1]))
    parts = [q[:1], q1[None]]
    if km > 3:   # interior k=3..km-1 (idx 2..km-2)
        qi = q[2:km - 1]
        a_km1 = a1[1:km - 2]
        a_k = a1[2:km - 1]
        g_m1 = gam[1:km - 2]
        g_p1 = gam[3:km]
        smooth = fbool(g_m1 * g_p1 > 0.0)
        q_cl = fclip(qi, fmin(a_km1, a_k), fmax(a_km1, a_k))
        has_max = fbool(g_m1 > 0.0)
        q_max = fmax(qi, fmin(a_km1, a_k))
        q_min = fmin(qi, fmax(a_km1, a_k))
        if iv == 0:
            q_min = fmax(0.0, q_min)
        parts.append(torch.where(smooth, q_cl,
                                 torch.where(has_max, q_max, q_min)))
    qb = fclip(q[km - 1], fmin(a1[km - 2], a1[km - 1]),
               fmax(a1[km - 2], a1[km - 1]))
    return torch.cat(parts + [qb[None], q[km:]])


def _huynh(a1i, a2i, a3i, gam, km):
    """The interior (k=3..km-2) Huynh constraints (fv_mapz_nlm.F90:
    2266-2436): the constrained (a2, a3) of the interior."""
    sl = slice(2, km - 2)
    g_k = gam[sl]
    g_m1 = gam[1:km - 3]
    g_p1 = gam[3:km - 1]
    g_p2 = gam[4:km]
    pmp_1 = a1i - 2.0 * g_p1
    lac_1 = pmp_1 + 1.5 * g_p2
    a2n = fclip(a2i, fmin(fmin(a1i, pmp_1), lac_1),
                fmax(fmax(a1i, pmp_1), lac_1))
    pmp_2 = a1i + 2.0 * g_k
    lac_2 = pmp_2 - 1.5 * g_m1
    a3n = fclip(a3i, fmin(fmin(a1i, pmp_2), lac_2),
                fmax(fmax(a1i, pmp_2), lac_2))
    return a2n, a3n


def _interior(a1i, a2i, a3i, gam, extm, km, ak):
    """New (a2, a3, a4) of the interior levels k=3..km-2 by kord: the
    Huynh constraints, and for kord 9 and 10 the wave and monotonicity
    switches on the extrema."""
    a2h, a3h = _huynh(a1i, a2i, a3i, gam, km)
    if ak not in (9, 10):
        return a2h, a3h, 3.0 * (2.0 * a1i - (a2h + a3h))
    exi = extm[2:km - 2]
    ex_nb = extm[1:km - 3] | extm[3:km - 1]
    wave = exi & ex_nb
    a4_0 = 6.0 * a1i - 3.0 * (a2i + a3i)
    steep = torch.abs(a4_0) > torch.abs(a2i - a3i)
    nonmono = fbool(steep if ak == 9 else (~exi) & steep)
    a2n = torch.where(wave, a1i, torch.where(nonmono, a2h, a2i))
    a3n = torch.where(wave, a1i, torch.where(nonmono, a3h, a3i))
    a4n = torch.where(wave, 0.0, 6.0 * a1i - 3.0 * (a2n + a3n))
    return a2n, a3n, a4n


def cs_profile(qs, a1, delp, iv, kord):
    """Vertical PPM edge reconstruction (fv_mapz_nlm.F90:2113-2464) for
    every kord: the Huynh family, kord 9 and 10, and the perfectly linear
    |kord| > 16 of the perturbation remap; iv 2, 1, 0, -1 and -2.

    a1/delp: (km, ...) cell means / thicknesses; qs: (...) bottom value
    (used for iv == -2).  Returns (a2, a3, a4) each (km, ...).  Nothing is
    written in place (the reverse sweep differentiates through it): the
    per-level fixes build new tensors from per-level lists, and the
    helpers' temporaries die with them (the tracer remap sets the
    nonlinear step's memory peak)."""
    if iv not in (2, 1, 0, -1, -2):
        raise ValueError(f"cs_profile iv={iv}: the modes are 2, 1, 0, -1, -2")
    km = a1.shape[0]
    if iv == -2:
        q = _edge_tridiag_w(a1, delp, qs)
    else:
        q = _edge_tridiag(a1, delp)

    if abs(kord) > 16:
        a2 = q[:-1]
        a3 = q[1:]
        return a2, a3, 3.0 * (2.0 * a1 - (a2 + a3))

    # gam(k) = a1(k)-a1(k-1), k=2..km stored at index k-1
    gam = torch.cat([torch.zeros_like(a1[:1]), a1[1:] - a1[:-1]])
    q = _large_scale(q, a1, gam, iv)
    a2 = list(q[:-1].unbind(0))
    a3 = list(q[1:].unbind(0))

    # extremum detection (:2250-2261)
    extm_mid = gam[1:-1] * gam[2:] < 0.0
    extm_top = (a2[0] - a1[0]) * (a3[0] - a1[0]) > 0.0
    extm_bot = (a2[-1] - a1[-1]) * (a3[-1] - a1[-1]) > 0.0
    extm = fbool(torch.cat([extm_top[None], extm_mid, extm_bot[None]]))

    # ---- subgrid constraints (:2266-2464) ----
    if iv == 0:
        a2[0] = fmax(0.0, a2[0])
    elif iv == -1:
        a2[0] = fwhere(a2[0] * a1[0] <= 0.0, 0.0, a2[0])
    elif iv == 2:
        a2[0] = a1[0]
        a3[0] = a1[0]

    a4 = list((3.0 * (2.0 * a1 - (torch.stack(a2) + torch.stack(a3))))
              .unbind(0))

    def limit(k, lim):
        a2[k], a3[k], a4[k] = _cs_limiters(a1[k], a2[k], a3[k], a4[k],
                                           extm[k], lim)

    if iv != 2:
        limit(0, 1)
    limit(1, 2)

    # interior k=3..km-2 (idx 2..km-3); its edges are still those of q
    if km > 4:
        sl = slice(2, km - 2)
        a2n, a3n, a4n = _interior(a1[sl], q[2:km - 2], q[3:km - 1], gam,
                                  extm, km, abs(kord))
        if iv == 0:
            a2n, a3n, a4n = _cs_limiters(a1[sl], a2n, a3n, a4n, extm[sl], 0)
        a2[sl] = a2n.unbind(0)
        a3[sl] = a3n.unbind(0)
        a4[sl] = a4n.unbind(0)

    # bottom two layers (:2437-2463)
    if iv == 0:
        a3[km - 1] = fmax(0.0, a3[km - 1])
    elif iv == -1:
        a3[km - 1] = fwhere(a3[km - 1] * a1[km - 1] <= 0.0, 0.0, a3[km - 1])
    for k, lim in ((km - 2, 2), (km - 1, 1)):
        a4[k] = 3.0 * (2.0 * a1[k] - (a2[k] + a3[k]))
        limit(k, lim)
    return torch.stack(a2), torch.stack(a3), torch.stack(a4)


# ----------------------------------------------------------------------
# remap evaluation via the cumulative-integral form
# ----------------------------------------------------------------------

def _locate(pe1_int, p):
    """Index l (0-based) of the source layer containing pressure p, one
    searchsorted over all columns.  pe1_int: (km-1, ncol) interior source
    interfaces; p: (kn+1, ncol).  Returns (kn+1, ncol) in [0, km-1]."""
    idx = torch.searchsorted(pe1_int.T.contiguous(), p.T.contiguous(),
                             right=True)
    return idx.T


def remap_column(pe1, pe2, a1, a2, a3, a4):
    """Integrate the PPM reconstruction of (a1,a2,a3,a4) on source
    interfaces pe1 onto target cells bounded by pe2.  All (k, ncol)."""
    km = a1.shape[0]
    dp1 = pe1[1:] - pe1[:-1]
    cums = torch.cat([torch.zeros_like(a1[:1]),
                      torch.cumsum(a1 * dp1, dim=0)])

    idx = fint(_locate(pe1[1:-1], pe2), maxval=km)       # (kn+1, ncol)
    pe1_l = torch.gather(pe1, 0, idx)
    dp_l = torch.gather(dp1, 0, idx)
    c_l = torch.gather(cums, 0, idx)
    a2_l = torch.gather(a2, 0, idx)
    a3_l = torch.gather(a3, 0, idx)
    a4_l = torch.gather(a4, 0, idx)
    xi = fclip((pe2 - pe1_l) / dp_l, 0.0, 1.0)
    # f(s) = aL + s*(aR-aL+a6) - a6 s^2 ;  F(xi) = int_0^xi f ds
    b = a3_l - a2_l + a4_l
    f_int = a2_l * xi + 0.5 * b * xi**2 - a4_l * R3 * xi**3
    m = c_l + dp_l * f_int
    return (m[1:] - m[:-1]) / (pe2[1:] - pe2[:-1])


def map1_ppm(pe1, q1, qs, pe2, iv, kord, q_min=None):
    """Remap q1 from coordinate pe1 to pe2 (map1_ppm / map_scalar).

    pe1/pe2: (km+1, ...); q1: (km, ...); qs: (...) bottom value (iv==-2);
    q_min: optional floor applied to the result."""
    shp = q1.shape
    km = shp[0]
    q1f = q1.reshape(km, -1)
    pe1f = pe1.reshape(km + 1, -1)
    pe2f = pe2.reshape(km + 1, -1)
    qsf = qs.reshape(-1) if qs is not None else torch.zeros_like(q1f[0])

    a2, a3, a4 = cs_profile(qsf, q1f, pe1f[1:] - pe1f[:-1], iv, kord)
    out = remap_column(pe1f, pe2f, q1f, a2, a3, a4)
    if q_min is not None:
        out = fmax(out, q_min)
    return out.reshape(shp)


def map1_q2(pe1, q1, pe2, kord, q_min=0.0):
    """Single-tracer remap (map1_q2, fv_mapz_nlm.F90:1541-1633): the iv=0
    positive-definite scalar remap with a floor."""
    return map1_ppm(pe1, q1, None, pe2, 0, kord, q_min=q_min)


def fillz(q, dp):
    """Vertical borrowing fix for negative tracers (fillz, fv_fill_nlm.F90:
    32-135, non-DEV_GFS_PHYS branch).

    q/dp: (km, ...).  The top layer pushes its deficit down; interior
    layers borrow from above, then below (sequential in k: a frozen-branch
    `fscan`); the bottom layer borrows from above; columns that needed an
    interior or bottom fix get the final non-local renormalization over
    k=2..km."""
    km = q.shape[0]
    if km < 3:
        return fmax(q, 0.0)

    # top layer (:68-74)
    neg0 = fbool(q[0] < 0.0)
    q1n = torch.where(neg0, q[1] + q[0] * dp[0] / dp[1], q[1])
    q0n = torch.where(neg0, 0.0, q[0])

    # interior k=2..km-1 Fortran (:76-96), a sequential downward window
    def body(c, x):
        qm1, q0, zfix = c
        q1o, dpm1, dp0, dpp1 = x
        neg = fbool(q0 < 0.0)
        up = fbool(qm1 > 0.0)
        dq = fmin(qm1 * dpm1, -q0 * dp0)
        do_up = neg & up
        qm1 = torch.where(do_up, qm1 - dq / dpm1, qm1)
        q0 = torch.where(do_up, q0 + dq / dp0, q0)
        still = fbool(q0 < 0.0)
        dn = fbool(q1o > 0.0)
        dq2 = fmin(q1o * dpp1, -q0 * dp0)
        do_dn = neg & still & dn
        q1o = torch.where(do_dn, q1o - dq2 / dpp1, q1o)
        q0 = torch.where(do_dn, q0 + dq2 / dp0, q0)
        return (q0, q1o, zfix | neg), qm1

    xs = (q[2:], dp[0:km - 2], dp[1:km - 1], dp[2:])
    (q_km2, q_km1, zfix), fixed = fscan(
        body, (q0n, q1n, torch.zeros_like(q0n, dtype=torch.bool)), xs)

    # bottom layer (:98-110)
    negb = fbool(q_km1 < 0.0) & fbool(q_km2 > 0.0)
    dup = fmin(q_km2 * dp[km - 2], -q_km1 * dp[km - 1])
    q_km2 = torch.where(negb, q_km2 - dup / dp[km - 2], q_km2)
    q_km1 = torch.where(negb, q_km1 + dup / dp[km - 1], q_km1)
    zfix = zfix | negb
    q = torch.cat([fixed, q_km2[None], q_km1[None]])

    # final non-local renormalization over k=2..km (:111-133)
    dm = q[1:] * dp[1:]
    sum0 = dm.sum(0)
    sum1 = fmax(dm, 0.0).sum(0)
    do_fix = zfix & fbool(sum0 > 0.0)
    fac = sum0 / torch.where(do_fix, torch.where(sum1 == 0.0, 1.0, sum1),
                             1.0)
    q_fixed = fmax(0.0, fac[None] * dm / dp[1:])
    q_lower = torch.where(do_fix[None], q_fixed, q[1:])
    return torch.cat([q[:1], q_lower])


def mapn_tracer(pe1, q_stack, pe2, kord, q_min=0.0, fill=False):
    """Multi-tracer remap (mapn_tracer, fv_mapz_nlm.F90:1425-1539): the
    geometry of the coordinate change (source-layer indices, positions
    within them) is computed once and shared by all tracers; only the PPM
    profile fits differ.  q_stack: (nq, km, ...); kord one int or one per
    tracer.  `fill` runs the fillz pass, all tracers at once (the linear
    model itself never sets it, fv3jedi_lm_dynamics_mod.F90:148)."""
    nq, km = q_stack.shape[0], q_stack.shape[1]
    shp = q_stack.shape[1:]
    q1f = q_stack.reshape(nq, km, -1)
    pe1f = pe1.reshape(km + 1, -1)
    pe2f = pe2.reshape(km + 1, -1)
    dp1 = pe1f[1:] - pe1f[:-1]
    kords = [kord] * nq if isinstance(kord, int) else list(kord)

    idx = fint(_locate(pe1f[1:-1], pe2f), maxval=km)
    pe1_l = torch.gather(pe1f, 0, idx)
    dp_l = torch.gather(dp1, 0, idx)
    xi = fclip((pe2f - pe1_l) / dp_l, 0.0, 1.0)
    dp2 = pe2f[1:] - pe2f[:-1]

    outs = []
    for iq in range(nq):
        a1 = q1f[iq]
        a2, a3, a4 = cs_profile(torch.zeros_like(a1[0]), a1, dp1, 0,
                                kords[iq])
        cums = torch.cat([torch.zeros_like(a1[:1]),
                          torch.cumsum(a1 * dp1, dim=0)])
        a2_l = torch.gather(a2, 0, idx)
        a3_l = torch.gather(a3, 0, idx)
        a4_l = torch.gather(a4, 0, idx)
        c_l = torch.gather(cums, 0, idx)
        b = a3_l - a2_l + a4_l
        f_int = a2_l * xi + 0.5 * b * xi ** 2 - a4_l * R3 * xi ** 3
        m = c_l + dp_l * f_int
        outs.append((m[1:] - m[:-1]) / dp2)
    out = torch.stack(outs)
    if fill:
        # the tracers as a batch next to the columns, k leading
        out = fillz(out.transpose(0, 1), dp2[:, None]).transpose(0, 1)
    return fmax(out, q_min).reshape((nq,) + shp)
