"""A-grid (cell mean) to B-grid (corner) interpolation, orders 4 and 2.

Counterpart of fv3jedi_lm_tpu/ops/a2b_edge.py (model/a2b_edge_nlm.F90):
`a2b_ord4`, quasi-4th-order interpolation with one-sided cubic edge
treatment and 3-way great-circle corner extrapolation; `a2b_ord2`, the
4-cell average with 3-cell corner means and edge-factor blends (d_ext and
omega).

qin: (..., nf, jcy, jcx) padded, halo-filled, on the model's tile
(grid["tile"]: the whole face on one process); the edge and corner
treatments act on the face edges and cube corners the tile owns.
Returns a B-grid tensor (..., nf, jcy+1, jcx+1); values valid on the
tile's compute corners.
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
    """3-way extrapolated values at the cube corners the tile owns:
    {(j, i) padded B index: value} for sw, se, ne, nw."""
    T = grid["tile"]
    X, Y = T.nx + 1, T.ny + 1

    def p(i):
        return i - 1 + NG

    cec = grid["corner_ext_coef"]  # (6, 4, 3)

    def ext(ci, k, c1, c2):
        q1 = qin[..., p(c1[1]), p(c1[0])]
        q2 = qin[..., p(c2[1]), p(c2[0])]
        return q1 + cec[:, ci, k] * (q1 - q2)

    out = {}
    if T.south and T.west:
        out[p(1), p(1)] = R3 * (ext(0, 0, (1, 1), (2, 2))
                                + ext(0, 1, (0, 1), (-1, 2))
                                + ext(0, 2, (1, 0), (2, -1)))
    if T.south and T.east:
        out[p(1), p(X)] = R3 * (ext(1, 0, (X - 1, 1), (X - 2, 2))
                                + ext(1, 1, (X - 1, 0), (X - 2, -1))
                                + ext(1, 2, (X, 1), (X + 1, 2)))
    if T.north and T.east:
        out[p(Y), p(X)] = R3 * (ext(2, 0, (X - 1, Y - 1), (X - 2, Y - 2))
                                + ext(2, 1, (X, Y - 1), (X + 1, Y - 2))
                                + ext(2, 2, (X - 1, Y), (X - 2, Y + 1)))
    if T.north and T.west:
        out[p(Y), p(1)] = R3 * (ext(3, 0, (1, Y - 1), (2, Y - 2))
                                + ext(3, 1, (0, Y - 1), (-1, Y - 2))
                                + ext(3, 2, (1, Y), (2, Y + 1)))
    return out


def _edge_lines(q, d, ic, ew, ee):
    """Interface values along the last axis (width ic+1): interior PPM form
    plus the one-sided cubic face-edge values (a2b_edge_nlm.F90:160-170)
    at the west edge ew and the east edge ee, each where the tile owns it
    (None where not)."""
    qx = q.new_zeros(q.shape[:-1] + (ic + 1,))
    qx[..., 2:ic - 1] = (B2 * (q[..., 0:ic - 3] + q[..., 3:ic])
                         + B1 * (q[..., 1:ic - 2] + q[..., 2:ic - 1]))
    if ew is not None:
        g_in = d[..., ew + 1] / d[..., ew]
        g_ou = d[..., ew - 2] / d[..., ew - 1]
        qx[..., ew] = 0.5 * (
            ((2.0 + g_in) * q[..., ew] - q[..., ew + 1]) / (1.0 + g_in)
            + ((2.0 + g_ou) * q[..., ew - 1] - q[..., ew - 2]) / (1.0 + g_ou))
        qx[..., ew + 1] = (
            (3.0 * (g_in * q[..., ew] + q[..., ew + 1])
             - (g_in * qx[..., ew] + qx[..., ew + 2])) / (2.0 + 2.0 * g_in))
    if ee is not None:
        g_in = d[..., ee - 2] / d[..., ee - 1]
        g_ou = d[..., ee + 1] / d[..., ee]
        qx[..., ee] = 0.5 * (
            ((2.0 + g_in) * q[..., ee - 1] - q[..., ee - 2]) / (1.0 + g_in)
            + ((2.0 + g_ou) * q[..., ee] - q[..., ee + 1]) / (1.0 + g_ou))
        qx[..., ee - 1] = (
            (3.0 * (q[..., ee - 2] + g_in * q[..., ee - 1])
             - (g_in * qx[..., ee] + qx[..., ee - 2])) / (2.0 + 2.0 * g_in))
    return qx


def _inner(T, icy, icx):
    """The B rows and columns that take the interior formula: those of
    the tile (B 2..npx-1 on the owned edges), out into the halo as far as
    the 4-point stencils reach where the tile has no face edge."""
    rows = slice(NG + 1 if T.south else 2, NG + T.ny if T.north else icy - 1)
    cols = slice(NG + 1 if T.west else 2, NG + T.nx if T.east else icx - 1)
    return rows, cols


def _edge_span(T, own_lo, own_hi, ic, n):
    """The B lines along a face edge that take the edge-factor blend:
    B 2..npx-1 of the face, out into the halo where the tile does not own
    the end, as far as the blend's cells reach."""
    return slice(NG + 1 if own_lo else 1, NG + n if own_hi else ic)


def a2b_ord4(qin, grid):
    T = grid["tile"]
    icy, icx = qin.shape[-2:]
    jby, jbx = icy + 1, icx + 1
    dxa = grid["dxa"]
    dya = grid["dya"]
    ew = NG                   # west/south edge B index
    ee_x = NG + T.nx          # east edge B index
    ee_y = NG + T.ny          # north edge B index

    qout = qin.new_zeros(qin.shape[:-2] + (jby, jbx))

    # ---- corner values ----
    for (j, i), val in _corner_values(qin, grid).items():
        qout[..., j, i] = val

    # ---- interface values in x and in y ----
    qx = _edge_lines(qin, dxa, icx, ew if T.west else None,
                     ee_x if T.east else None)
    qy = _edge_lines(qin.transpose(-1, -2), dya.transpose(-1, -2), icy,
                     ew if T.south else None, ee_y if T.north else None
                     ).transpose(-1, -2)   # (..., jb(y), jc(x))

    # ---- edge-line qout values via edge factors ----
    def blend(f, q2, inn):
        lo = slice(inn.start - 1, inn.stop - 1)
        return f[:, inn] * q2[..., lo] + (1.0 - f[:, inn]) * q2[..., inn]

    ry = _edge_span(T, T.south, T.north, icy, T.ny)
    rx = _edge_span(T, T.west, T.east, icx, T.nx)
    if T.west:
        q2w = (qin[..., :, ew - 1] * dxa[..., :, ew]
               + qin[..., :, ew] * dxa[..., :, ew - 1]) / (
            dxa[..., :, ew - 1] + dxa[..., :, ew])
        qout[..., ry, ew] = blend(grid["edge_w"], q2w, ry)
    if T.east:
        q2e = (qin[..., :, ee_x - 1] * dxa[..., :, ee_x]
               + qin[..., :, ee_x] * dxa[..., :, ee_x - 1]) / (
            dxa[..., :, ee_x - 1] + dxa[..., :, ee_x])
        qout[..., ry, ee_x] = blend(grid["edge_e"], q2e, ry)
    if T.south:
        q1s = (qin[..., ew - 1, :] * dya[..., ew, :]
               + qin[..., ew, :] * dya[..., ew - 1, :]) / (
            dya[..., ew - 1, :] + dya[..., ew, :])
        qout[..., ew, rx] = blend(grid["edge_s"], q1s, rx)
    if T.north:
        q1n = (qin[..., ee_y - 1, :] * dya[..., ee_y, :]
               + qin[..., ee_y, :] * dya[..., ee_y - 1, :]) / (
            dya[..., ee_y - 1, :] + dya[..., ee_y, :])
        qout[..., ee_y, rx] = blend(grid["edge_n"], q1n, rx)

    # ---- qxx: interpolate qx rows to B rows ----
    qxx = qin.new_zeros(qin.shape[:-2] + (jby, jbx))
    qxx[..., 2:icy - 1, :] = (A2 * (qx[..., 0:icy - 3, :] + qx[..., 3:icy, :])
                              + A1 * (qx[..., 1:icy - 2, :]
                                      + qx[..., 2:icy - 1, :]))
    if T.south:
        qxx[..., ew + 1, :] = (C1 * (qx[..., ew, :] + qx[..., ew + 1, :])
                               + C2 * (qout[..., ew, :] + qxx[..., ew + 2, :]))
    if T.north:
        qxx[..., ee_y - 1, :] = (C1 * (qx[..., ee_y - 2, :]
                                       + qx[..., ee_y - 1, :])
                                 + C2 * (qout[..., ee_y, :]
                                         + qxx[..., ee_y - 2, :]))

    qyy = qin.new_zeros(qin.shape[:-2] + (jby, jbx))
    qyy[..., :, 2:icx - 1] = (A2 * (qy[..., :, 0:icx - 3] + qy[..., :, 3:icx])
                              + A1 * (qy[..., :, 1:icx - 2]
                                      + qy[..., :, 2:icx - 1]))
    if T.west:
        qyy[..., :, ew + 1] = (C1 * (qy[..., :, ew] + qy[..., :, ew + 1])
                               + C2 * (qout[..., :, ew] + qyy[..., :, ew + 2]))
    if T.east:
        qyy[..., :, ee_x - 1] = (C1 * (qy[..., :, ee_x - 2]
                                       + qy[..., :, ee_x - 1])
                                 + C2 * (qout[..., :, ee_x]
                                         + qyy[..., :, ee_x - 2]))

    rows, cols = _inner(T, icy, icx)
    qout[..., rows, cols] = 0.5 * (qxx[..., rows, cols]
                                   + qyy[..., rows, cols])
    return qout


def a2b_ord2(qin, grid):
    """Second-order A-to-B interpolation (a2b_edge_nlm.F90 a2b_ord2)."""
    T = grid["tile"]
    icy, icx = qin.shape[-2:]
    ew = NG
    ee_x = NG + T.nx
    ee_y = NG + T.ny
    X, Y = T.nx + 1, T.ny + 1

    def p(i):
        return i - 1 + NG

    qout = qin.new_zeros(qin.shape[:-2] + (icy + 1, icx + 1))
    # interior 4-cell average
    qout[..., 1:icy, 1:icx] = 0.25 * (
        qin[..., 0:icy - 1, 0:icx - 1] + qin[..., 0:icy - 1, 1:icx]
        + qin[..., 1:icy, 0:icx - 1] + qin[..., 1:icy, 1:icx])
    # corner 3-cell means
    if T.south and T.west:
        qout[..., ew, ew] = R3 * (qin[..., p(1), p(1)] + qin[..., p(0), p(1)]
                                  + qin[..., p(1), p(0)])
    if T.south and T.east:
        qout[..., ew, ee_x] = R3 * (qin[..., p(1), p(X - 1)]
                                    + qin[..., p(0), p(X - 1)]
                                    + qin[..., p(1), p(X)])
    if T.north and T.east:
        qout[..., ee_y, ee_x] = R3 * (qin[..., p(Y - 1), p(X - 1)]
                                      + qin[..., p(Y - 1), p(X)]
                                      + qin[..., p(Y), p(X - 1)])
    if T.north and T.west:
        qout[..., ee_y, ew] = R3 * (qin[..., p(Y - 1), p(1)]
                                    + qin[..., p(Y - 1), p(0)]
                                    + qin[..., p(Y), p(1)])
    # edges with the edge factors
    def blend(f, q2, inn):
        lo = slice(inn.start - 1, inn.stop - 1)
        return f[:, inn] * q2[..., lo] + (1.0 - f[:, inn]) * q2[..., inn]

    ry = _edge_span(T, T.south, T.north, icy, T.ny)
    rx = _edge_span(T, T.west, T.east, icx, T.nx)
    if T.west:
        qout[..., ry, ew] = blend(
            grid["edge_w"], 0.5 * (qin[..., :, ew - 1] + qin[..., :, ew]), ry)
    if T.east:
        qout[..., ry, ee_x] = blend(
            grid["edge_e"], 0.5 * (qin[..., :, ee_x - 1] + qin[..., :, ee_x]),
            ry)
    if T.south:
        qout[..., ew, rx] = blend(
            grid["edge_s"], 0.5 * (qin[..., ew - 1, :] + qin[..., ew, :]), rx)
    if T.north:
        qout[..., ee_y, rx] = blend(
            grid["edge_n"], 0.5 * (qin[..., ee_y - 1, :] + qin[..., ee_y, :]),
            rx)
    return qout
