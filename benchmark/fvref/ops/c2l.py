"""D-grid -> A-grid lat-lon wind diagnostics (fv_grid_utils_nlm.F90:
2313-2500).

Counterpart of fv3jedi_lm_tpu/ops/c2l.py.  c2l_ord4: 4-point Lagrange
interpolation of the D winds to cell centers with flux-weighted 2-point
averages in the edge rows and columns, then the rotation to east/north
components by the a11..a22 matrix.
"""

from __future__ import annotations

from ..parallel import halo
from .sw_core import F2P, SL, tile_of

C1 = 1.125
C2 = -0.125


def c2l_ord4(u, v, grid, topo, npx, do_halo=True):
    """(ua, va) on the compute domain, zero in the halo; the flux-weighted
    edge rows and columns where the tile owns that face edge."""
    T, X, Y = tile_of(grid, npx)
    p = F2P
    dx = grid["dx"]
    dy = grid["dy"]
    if do_halo:
        u, v = halo.fill_halo_dgrid(u, v, topo)

    jcy, jcx = u.shape[-2] - 1, u.shape[-1]
    utmp = u.new_zeros(u.shape[:-2] + (jcy, jcx))
    vtmp = u.new_zeros(u.shape[:-2] + (jcy, jcx))
    # the cells between the face's edge rows and columns: 2..n-1
    ciy = SL(2 if T.south else 1, Y - 2 if T.north else Y - 1)
    cix = SL(2 if T.west else 1, X - 2 if T.east else X - 1)

    def sh(s, d):
        return slice(s.start + d, s.stop + d)

    utmp[..., ciy, cix] = (
        C2 * (u[..., sh(ciy, -1), cix] + u[..., sh(ciy, 2), cix])
        + C1 * (u[..., ciy, cix] + u[..., sh(ciy, 1), cix]))
    vtmp[..., ciy, cix] = (
        C2 * (v[..., ciy, sh(cix, -1)] + v[..., ciy, sh(cix, 2)])
        + C1 * (v[..., ciy, cix] + v[..., ciy, sh(cix, 1)]))

    csy, csx = SL(1, T.ny), SL(1, T.nx)
    c0 = slice(p(1), p(T.nx) + 1)
    c1 = slice(p(2), p(X) + 1)
    rows = [(p(1), p(1), p(2))] * T.south + [(p(Y - 1), p(Y - 1), p(Y))] * T.north
    for jr, ja, jb in rows:
        # south row j=1, north row j=npy-1
        vtmp[..., jr, csx] = (2.0 * (v[..., jr, c0] * dy[..., jr, c0]
                                     + v[..., jr, c1] * dy[..., jr, c1])
                              / (dy[..., jr, c0] + dy[..., jr, c1]))
        utmp[..., jr, csx] = (2.0 * (u[..., ja, csx] * dx[..., ja, csx]
                                     + u[..., jb, csx] * dx[..., jb, csx])
                              / (dx[..., ja, csx] + dx[..., jb, csx]))
    r0 = slice(p(1), p(T.ny) + 1)
    r1 = slice(p(2), p(Y) + 1)
    cols = [(p(1), p(1), p(2))] * T.west + [(p(X - 1), p(X - 1), p(X))] * T.east
    for ic, ia, ib in cols:
        # west col i=1, east col i=npx-1
        utmp[..., csy, ic] = (2.0 * (u[..., r0, ic] * dx[..., r0, ic]
                                     + u[..., r1, ic] * dx[..., r1, ic])
                              / (dx[..., r0, ic] + dx[..., r1, ic]))
        vtmp[..., csy, ic] = (2.0 * (v[..., csy, ia] * dy[..., csy, ia]
                                     + v[..., csy, ib] * dy[..., csy, ib])
                              / (dy[..., csy, ia] + dy[..., csy, ib]))

    ua = grid["a11"] * utmp + grid["a12"] * vtmp
    va = grid["a21"] * utmp + grid["a22"] * vtmp
    ua_c = ua.new_zeros(ua.shape)
    va_c = va.new_zeros(va.shape)
    ua_c[..., csy, csx] = ua[..., csy, csx]
    va_c[..., csy, csx] = va[..., csy, csx]
    return ua_c, va_c
