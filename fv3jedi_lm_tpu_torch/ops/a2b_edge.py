"""A-grid (cell mean) to B-grid (corner) interpolation, orders 4 and 2.

Counterpart of fv3jedi_lm_tpu/ops/a2b_edge.py (model/a2b_edge_nlm.F90):
`a2b_ord4`, quasi-4th-order interpolation with one-sided cubic edge
treatment and 3-way great-circle corner extrapolation; `a2b_ord2`, the
4-cell average with 3-cell corner means and edge-factor blends (d_ext and
omega).

qin: (..., 6, jc, jc) padded, halo-filled.  Returns a B-grid tensor
(..., 6, jb, jb); values valid on the compute corners [ng : ng+n+1]^2.
"""

from __future__ import annotations

from .. import NG

B1 = 7.0 / 12.0
B2 = -1.0 / 12.0
A1 = 0.5625
A2 = -0.0625
C1 = 2.0 / 3.0
C2 = -1.0 / 6.0
R3 = 1.0 / 3.0


def _corner_values(qin, grid):
    """3-way extrapolated corner values (sw, se, ne, nw)."""
    n = qin.shape[-1] - 2 * NG
    npx = n + 1

    def p(i):
        return i - 1 + NG

    cec = grid["corner_ext_coef"]  # (6, 4, 3)

    def ext(ci, k, c1, c2):
        q1 = qin[..., p(c1[1]), p(c1[0])]
        q2 = qin[..., p(c2[1]), p(c2[0])]
        return q1 + cec[:, ci, k] * (q1 - q2)

    sw = R3 * (ext(0, 0, (1, 1), (2, 2)) + ext(0, 1, (0, 1), (-1, 2))
               + ext(0, 2, (1, 0), (2, -1)))
    se = R3 * (ext(1, 0, (npx - 1, 1), (npx - 2, 2))
               + ext(1, 1, (npx - 1, 0), (npx - 2, -1))
               + ext(1, 2, (npx, 1), (npx + 1, 2)))
    ne = R3 * (ext(2, 0, (npx - 1, npx - 1), (npx - 2, npx - 2))
               + ext(2, 1, (npx, npx - 1), (npx + 1, npx - 2))
               + ext(2, 2, (npx - 1, npx), (npx - 2, npx + 1)))
    nw = R3 * (ext(3, 0, (1, npx - 1), (2, npx - 2))
               + ext(3, 1, (0, npx - 1), (-1, npx - 2))
               + ext(3, 2, (1, npx), (2, npx + 1)))
    return sw, se, ne, nw


def _edge_lines(q, d, ic, ew, ee):
    """Interface values along the last axis (width ic+1): interior PPM form
    plus the one-sided cubic face-edge values (a2b_edge_nlm.F90:160-170)."""
    qx = q.new_zeros(q.shape[:-1] + (ic + 1,))
    qx[..., 2:ic - 1] = (B2 * (q[..., 0:ic - 3] + q[..., 3:ic])
                         + B1 * (q[..., 1:ic - 2] + q[..., 2:ic - 1]))
    g_in = d[..., ew + 1] / d[..., ew]
    g_ou = d[..., ew - 2] / d[..., ew - 1]
    qx[..., ew] = 0.5 * (
        ((2.0 + g_in) * q[..., ew] - q[..., ew + 1]) / (1.0 + g_in)
        + ((2.0 + g_ou) * q[..., ew - 1] - q[..., ew - 2]) / (1.0 + g_ou))
    qx[..., ew + 1] = (
        (3.0 * (g_in * q[..., ew] + q[..., ew + 1])
         - (g_in * qx[..., ew] + qx[..., ew + 2])) / (2.0 + 2.0 * g_in))
    g_in = d[..., ee - 2] / d[..., ee - 1]
    g_ou = d[..., ee + 1] / d[..., ee]
    qx[..., ee] = 0.5 * (
        ((2.0 + g_in) * q[..., ee - 1] - q[..., ee - 2]) / (1.0 + g_in)
        + ((2.0 + g_ou) * q[..., ee] - q[..., ee + 1]) / (1.0 + g_ou))
    qx[..., ee - 1] = (
        (3.0 * (q[..., ee - 2] + g_in * q[..., ee - 1])
         - (g_in * qx[..., ee] + qx[..., ee - 2])) / (2.0 + 2.0 * g_in))
    return qx


def a2b_ord4(qin, grid):
    ic = qin.shape[-1]
    n = ic - 2 * NG
    jb = ic + 1
    dxa = grid["dxa"]
    dya = grid["dya"]
    ew = NG          # west edge B index
    ee = NG + n

    qout = qin.new_zeros(qin.shape[:-2] + (jb, jb))

    # ---- corner values ----
    sw, se, ne, nw = _corner_values(qin, grid)
    qout[..., ew, ew] = sw
    qout[..., ew, ee] = se
    qout[..., ee, ee] = ne
    qout[..., ee, ew] = nw

    # ---- interface values in x and in y ----
    qx = _edge_lines(qin, dxa, ic, ew, ee)
    qy = _edge_lines(qin.transpose(-1, -2), dya.transpose(-1, -2), ic, ew,
                     ee).transpose(-1, -2)   # (..., jb(y), jc(x))

    # ---- edge-line qout values via edge factors ----
    inn = slice(NG + 1, NG + n)
    lo = slice(NG, NG + n - 1)

    def blend(f, q2):
        return f[:, inn] * q2[..., lo] + (1.0 - f[:, inn]) * q2[..., inn]

    q2w = (qin[..., :, ew - 1] * dxa[..., :, ew]
           + qin[..., :, ew] * dxa[..., :, ew - 1]) / (
        dxa[..., :, ew - 1] + dxa[..., :, ew])
    qout[..., inn, ew] = blend(grid["edge_w"], q2w)
    q2e = (qin[..., :, ee - 1] * dxa[..., :, ee]
           + qin[..., :, ee] * dxa[..., :, ee - 1]) / (
        dxa[..., :, ee - 1] + dxa[..., :, ee])
    qout[..., inn, ee] = blend(grid["edge_e"], q2e)
    q1s = (qin[..., ew - 1, :] * dya[..., ew, :]
           + qin[..., ew, :] * dya[..., ew - 1, :]) / (
        dya[..., ew - 1, :] + dya[..., ew, :])
    qout[..., ew, inn] = blend(grid["edge_s"], q1s)
    q1n = (qin[..., ee - 1, :] * dya[..., ee, :]
           + qin[..., ee, :] * dya[..., ee - 1, :]) / (
        dya[..., ee - 1, :] + dya[..., ee, :])
    qout[..., ee, inn] = blend(grid["edge_n"], q1n)

    # ---- qxx: interpolate qx rows to B rows ----
    qxx = qin.new_zeros(qin.shape[:-2] + (jb, jb))
    qxx[..., 2:ic - 1, :] = (A2 * (qx[..., 0:ic - 3, :] + qx[..., 3:ic, :])
                             + A1 * (qx[..., 1:ic - 2, :]
                                     + qx[..., 2:ic - 1, :]))
    qxx[..., ew + 1, :] = (C1 * (qx[..., ew, :] + qx[..., ew + 1, :])
                           + C2 * (qout[..., ew, :] + qxx[..., ew + 2, :]))
    qxx[..., ee - 1, :] = (C1 * (qx[..., ee - 2, :] + qx[..., ee - 1, :])
                           + C2 * (qout[..., ee, :] + qxx[..., ee - 2, :]))

    qyy = qin.new_zeros(qin.shape[:-2] + (jb, jb))
    qyy[..., :, 2:ic - 1] = (A2 * (qy[..., :, 0:ic - 3] + qy[..., :, 3:ic])
                             + A1 * (qy[..., :, 1:ic - 2]
                                     + qy[..., :, 2:ic - 1]))
    qyy[..., :, ew + 1] = (C1 * (qy[..., :, ew] + qy[..., :, ew + 1])
                           + C2 * (qout[..., :, ew] + qyy[..., :, ew + 2]))
    qyy[..., :, ee - 1] = (C1 * (qy[..., :, ee - 2] + qy[..., :, ee - 1])
                           + C2 * (qout[..., :, ee] + qyy[..., :, ee - 2]))

    qout[..., inn, inn] = 0.5 * (qxx[..., inn, inn] + qyy[..., inn, inn])
    return qout


def a2b_ord2(qin, grid):
    """Second-order A-to-B interpolation (a2b_edge_nlm.F90 a2b_ord2)."""
    ic = qin.shape[-1]
    n = ic - 2 * NG
    jb = ic + 1
    ew = NG
    ee = NG + n
    npx = n + 1

    def p(i):
        return i - 1 + NG

    qout = qin.new_zeros(qin.shape[:-2] + (jb, jb))
    # interior 4-cell average
    qout[..., 1:ic, 1:ic] = 0.25 * (
        qin[..., 0:ic - 1, 0:ic - 1] + qin[..., 0:ic - 1, 1:ic]
        + qin[..., 1:ic, 0:ic - 1] + qin[..., 1:ic, 1:ic])
    # corner 3-cell means
    qout[..., ew, ew] = R3 * (qin[..., p(1), p(1)] + qin[..., p(0), p(1)]
                              + qin[..., p(1), p(0)])
    qout[..., ew, ee] = R3 * (qin[..., p(1), p(npx - 1)]
                              + qin[..., p(0), p(npx - 1)]
                              + qin[..., p(1), p(npx)])
    qout[..., ee, ee] = R3 * (qin[..., p(npx - 1), p(npx - 1)]
                              + qin[..., p(npx - 1), p(npx)]
                              + qin[..., p(npx), p(npx - 1)])
    qout[..., ee, ew] = R3 * (qin[..., p(npx - 1), p(1)]
                              + qin[..., p(npx - 1), p(0)]
                              + qin[..., p(npx), p(1)])
    # edges with the edge factors
    inn = slice(NG + 1, NG + n)
    lo = slice(NG, NG + n - 1)

    def blend(f, q2):
        return f[:, inn] * q2[..., lo] + (1.0 - f[:, inn]) * q2[..., inn]

    qout[..., inn, ew] = blend(grid["edge_w"],
                               0.5 * (qin[..., :, ew - 1] + qin[..., :, ew]))
    qout[..., inn, ee] = blend(grid["edge_e"],
                               0.5 * (qin[..., :, ee - 1] + qin[..., :, ee]))
    qout[..., ew, inn] = blend(grid["edge_s"],
                               0.5 * (qin[..., ew - 1, :] + qin[..., ew, :]))
    qout[..., ee, inn] = blend(grid["edge_n"],
                               0.5 * (qin[..., ee - 1, :] + qin[..., ee, :]))
    return qout
