"""Gnomonic cubed-sphere grid generation.

The port's own copy of fv3jedi_lm_tpu/grid/gnomonic.py, identical to it
but for this paragraph: its imports resolve within
fv3jedi_lm_tpu_torch, so the port never imports the JAX package.

Re-derivation of the reference's equal-edge gnomonic grid (`gnomonic_ed`,
src/dynamics/atmos_cubed_sphere/model/fv_grid_utils_nlm.F90:1240-1350) and the
6-face mirroring (`mirror_grid`, tools/fv_grid_tools_nlm.F90), written as
vectorized numpy.  Face 1 is centered on (lon=pi-pi/shift? no shift here),
and faces 2..6 are produced by the same rotation sequence as mirror_grid so
the face-to-face topology matches the reference mosaic exactly.
"""

from __future__ import annotations

import numpy as np

from . import sphere


def _gnomonic_ed(im: int) -> np.ndarray:
    """Equal-edge gnomonic grid on face 1; returns lon/lat (im+1, im+1, 2).

    Grid lines are great circles; edge points are equally spaced in angle
    along the 4 face edges.
    """
    rsq3 = 1.0 / np.sqrt(3.0)
    alpha = np.arcsin(rsq3)

    lam = np.zeros((im + 1, im + 1))  # [i, j] like the reference
    the = np.zeros((im + 1, im + 1))

    j = np.arange(im + 1)
    # West and east edges: constant lon, theta equally spaced
    lam[0, :] = 0.75 * np.pi
    lam[im, :] = 1.25 * np.pi
    the[0, :] = -alpha + (2.0 * alpha / im) * j
    the[im, :] = the[0, :]

    # South edge by mirroring the west edge across the diagonal plane
    # through corner (0,0) and corner (im,im) (reference mirror_latlon).
    p1 = np.array([lam[0, 0], the[0, 0]])
    p2 = np.array([lam[im, im], the[im, im]])
    for i in range(1, im):
        p0 = np.array([lam[0, i], the[0, i]])
        m = sphere.mirror_point(p1, p2, p0)
        lam[i, 0], the[i, 0] = m[0], m[1]
        lam[i, im] = lam[i, 0]
        the[i, im] = -the[i, 0]

    # Map the boundary points onto the cube face x=-rsq3, then fill the
    # interior by copying cube-face coordinates along rows/columns
    # (intersections of great circles through the edge points).
    pp = np.zeros((im + 1, im + 1, 3))
    # 4 corners + edges in xyz
    bnd = sphere.latlon2xyz(np.stack([lam, the], axis=-1))
    # project west edge (i=0) and south edge (j=0) to the cube plane x=-rsq3
    pp[0, :, 1] = -bnd[0, :, 1] * rsq3 / bnd[0, :, 0]
    pp[0, :, 2] = -bnd[0, :, 2] * rsq3 / bnd[0, :, 0]
    pp[:, 0, 1] = -bnd[:, 0, 1] * rsq3 / bnd[:, 0, 0]
    pp[:, 0, 2] = -bnd[:, 0, 2] * rsq3 / bnd[:, 0, 0]
    pp[:, :, 0] = -rsq3
    # interior: y from the south edge column, z from the west edge row
    pp[1:, 1:, 1] = pp[1:, 0:1, 1]
    pp[1:, 1:, 2] = pp[0:1, 1:, 2]

    ll = sphere.xyz2latlon(pp)
    lam, the = ll[..., 0], ll[..., 1]

    # symm_ed symmetrization + shift lon by -pi (gnomonic_grids:  lon - pi)
    lam = lam - np.pi
    return np.stack([lam, the], axis=-1)


def _rot_z(p: np.ndarray, deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return np.stack([np.cos(a) * x + np.sin(a) * y, -np.sin(a) * x + np.cos(a) * y, z], axis=-1)


def _rot_x(p: np.ndarray, deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return np.stack([x, np.cos(a) * y + np.sin(a) * z, -np.sin(a) * y + np.cos(a) * z], axis=-1)


def _rot_y(p: np.ndarray, deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return np.stack([np.cos(a) * x - np.sin(a) * z, y, np.sin(a) * x + np.cos(a) * z], axis=-1)


def cube_corners_xyz(npx: int) -> np.ndarray:
    """Corner-point unit vectors for all 6 faces: (6, npx, npx, 3), [f, j, i].

    Face 1 from gnomonic_ed; faces 2-6 by the reference mirror_grid rotation
    sequence (tools/fv_grid_tools_nlm.F90 mirror_grid: rot_3d about z/x/y).
    """
    im = npx - 1
    ll1 = _gnomonic_ed(im)  # [i, j, 2]
    p1 = sphere.latlon2xyz(ll1)  # [i, j, 3]
    # switch to [j, i, 3] ordering for the rest of the code
    p1 = np.swapaxes(p1, 0, 1)

    # mirror_grid rotates in a LEFT-handed frame (z = -sin(lat): RIGHT_HAND
    # is not defined in the reference build), which in right-handed xyz means
    # negating the x- and y-axis rotation angles.
    faces = [p1]
    faces.append(_rot_z(p1, -90.0))                      # face 2
    faces.append(_rot_x(_rot_z(p1, -90.0), -90.0))       # face 3
    faces.append(_rot_x(_rot_z(p1, -180.0), -90.0))      # face 4
    faces.append(_rot_y(_rot_z(p1, 90.0), -90.0))        # face 5
    faces.append(_rot_y(p1, -90.0))                      # face 6
    out = np.stack(faces, axis=0)
    # renormalize (rotations preserve norm, but be safe)
    return sphere.normalize(out)
