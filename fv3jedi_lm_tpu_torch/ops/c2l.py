"""D-grid -> A-grid lat-lon wind diagnostics (fv_grid_utils_nlm.F90:
2313-2500).

Counterpart of fv3jedi_lm_tpu/ops/c2l.py.  c2l_ord4: 4-point Lagrange
interpolation of the D winds to cell centers with flux-weighted 2-point
averages in the edge rows and columns, then the rotation to east/north
components by the a11..a22 matrix.
"""

from __future__ import annotations

from ..parallel import halo
from .sw_core import F2P, SL

C1 = 1.125
C2 = -0.125


def c2l_ord4(u, v, grid, topo, npx, do_halo=True):
    """(ua, va) on the compute domain, zero in the halo."""
    n = npx - 1
    npy = npx
    p = F2P
    dx = grid["dx"]
    dy = grid["dy"]
    if do_halo:
        u, v = halo.fill_halo_dgrid(u, v, topo)

    jc = u.shape[-1]
    utmp = u.new_zeros(u.shape[:-2] + (jc, jc))
    vtmp = u.new_zeros(u.shape[:-2] + (jc, jc))
    # interior cells 2..n-1
    ci = SL(2, npx - 2)
    utmp[..., ci, ci] = (
        C2 * (u[..., p(1):p(npy - 3) + 1, ci] + u[..., p(4):p(npy) + 1, ci])
        + C1 * (u[..., p(2):p(npy - 2) + 1, ci]
                + u[..., p(3):p(npy - 1) + 1, ci]))
    vtmp[..., ci, ci] = (
        C2 * (v[..., ci, p(1):p(npx - 3) + 1] + v[..., ci, p(4):p(npx) + 1])
        + C1 * (v[..., ci, p(2):p(npx - 2) + 1]
                + v[..., ci, p(3):p(npx - 1) + 1]))

    cs = SL(1, n)
    c0 = slice(p(1), p(n) + 1)
    c1 = slice(p(2), p(npx) + 1)
    for jr, ja, jb in ((p(1), p(1), p(2)), (p(npy - 1), p(npy - 1), p(npy))):
        # south row j=1, north row j=npy-1
        vtmp[..., jr, cs] = (2.0 * (v[..., jr, c0] * dy[..., jr, c0]
                                    + v[..., jr, c1] * dy[..., jr, c1])
                             / (dy[..., jr, c0] + dy[..., jr, c1]))
        utmp[..., jr, cs] = (2.0 * (u[..., ja, cs] * dx[..., ja, cs]
                                    + u[..., jb, cs] * dx[..., jb, cs])
                             / (dx[..., ja, cs] + dx[..., jb, cs]))
    for ic, ia, ib in ((p(1), p(1), p(2)), (p(npx - 1), p(npx - 1), p(npx))):
        # west col i=1, east col i=npx-1
        utmp[..., cs, ic] = (2.0 * (u[..., c0, ic] * dx[..., c0, ic]
                                    + u[..., c1, ic] * dx[..., c1, ic])
                             / (dx[..., c0, ic] + dx[..., c1, ic]))
        vtmp[..., cs, ic] = (2.0 * (v[..., cs, ia] * dy[..., cs, ia]
                                    + v[..., cs, ib] * dy[..., cs, ib])
                             / (dy[..., cs, ia] + dy[..., cs, ib]))

    ua = grid["a11"] * utmp + grid["a12"] * vtmp
    va = grid["a21"] * utmp + grid["a22"] * vtmp
    ua_c = ua.new_zeros(ua.shape)
    va_c = va.new_zeros(va.shape)
    ua_c[..., cs, cs] = ua[..., cs, cs]
    va_c[..., cs, cs] = va[..., cs, cs]
    return ua_c, va_c
