"""Vectorized spherical-geometry primitives (numpy, float64).

The port's own copy of fv3jedi_lm_tpu/grid/sphere.py, identical to it
but for this paragraph: its imports resolve within
fv3jedi_lm_tpu_torch, so the port never imports the JAX package.

These reproduce the reference's spherical helpers exactly (same formulas,
whole-array form): great_circle_dist, mid points, spherical angles, areas
(src/dynamics/atmos_cubed_sphere/model/fv_grid_utils_nlm.F90: latlon2xyz,
cart_to_latlon, great_circle_dist, mid_pt3_cart, spherical_angle, cos_angle,
get_area, cell_center2).  Used only at grid-construction time; runtime code
consumes the precomputed metric arrays.
"""

from __future__ import annotations

import numpy as np


def latlon2xyz(lonlat: np.ndarray) -> np.ndarray:
    """(..., 2) lon/lat [rad] -> (..., 3) unit vectors."""
    lon = lonlat[..., 0]
    lat = lonlat[..., 1]
    cl = np.cos(lat)
    return np.stack([cl * np.cos(lon), cl * np.sin(lon), np.sin(lat)], axis=-1)


def xyz2latlon(p: np.ndarray) -> np.ndarray:
    """(..., 3) -> (..., 2) lon in [0, 2pi), lat in [-pi/2, pi/2]."""
    p = p / np.linalg.norm(p, axis=-1, keepdims=True)
    lon = np.where(
        np.abs(p[..., 0]) + np.abs(p[..., 1]) < 1e-10,
        0.0,
        np.arctan2(p[..., 1], p[..., 0]),
    )
    lon = np.where(lon < 0.0, lon + 2.0 * np.pi, lon)
    lat = np.arcsin(np.clip(p[..., 2], -1.0, 1.0))
    return np.stack([lon, lat], axis=-1)


def great_circle_dist(q1: np.ndarray, q2: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """Haversine distance between lon/lat points (..., 2), as the reference."""
    dlat = 0.5 * (q1[..., 1] - q2[..., 1])
    dlon = 0.5 * (q1[..., 0] - q2[..., 0])
    s = np.sqrt(
        np.sin(dlat) ** 2 + np.cos(q1[..., 1]) * np.cos(q2[..., 1]) * np.sin(dlon) ** 2
    )
    return 2.0 * np.arcsin(np.clip(s, -1.0, 1.0)) * radius


def normalize(p: np.ndarray) -> np.ndarray:
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


def mid_pt_cart(p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Normalized midpoint of two unit vectors (..., 3)."""
    return normalize(p1 + p2)


def mid_pt_sphere(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Midpoint in lon/lat space via cartesian average (..., 2)."""
    return xyz2latlon(mid_pt_cart(latlon2xyz(q1), latlon2xyz(q2)))


def cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.cross(a, b)


def spherical_angle(e1: np.ndarray, e2: np.ndarray, e3: np.ndarray) -> np.ndarray:
    """Angle at e1 of the spherical triangle (e2, e1, e3); inputs (..., 3)."""
    p = np.cross(e1, e2)
    q = np.cross(e1, e3)
    ddd = np.sum(p * p, axis=-1) * np.sum(q * q, axis=-1)
    num = np.sum(p * q, axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        c = num / np.sqrt(np.maximum(ddd, 1e-300))
    ang = np.where(
        ddd <= 0.0,
        0.0,
        np.where(
            np.abs(c) > 1.0,
            np.where(c < 0.0, np.pi, 0.0),
            np.arccos(np.clip(c, -1.0, 1.0)),
        ),
    )
    return ang


def cos_angle(p1: np.ndarray, p2: np.ndarray, p3: np.ndarray) -> np.ndarray:
    """cos of the angle at p1 between directions to p2 and p3; inputs (..., 3)."""
    p = np.cross(p1, p2)
    q = np.cross(p1, p3)
    ddd = np.sqrt(np.sum(p * p, axis=-1) * np.sum(q * q, axis=-1))
    with np.errstate(invalid="ignore", divide="ignore"):
        c = np.sum(p * q, axis=-1) / np.maximum(ddd, 1e-300)
    return np.where(ddd > 0.0, c, 1.0)


def get_area(p1, p4, p2, p3, radius: float = 1.0) -> np.ndarray:
    """Spherical quadrilateral area by spherical excess.

    Argument order matches the reference get_area(p1, p4, p2, p3):
    p1=lower-left, p2=lower-right, p3=upper-right, p4=upper-left (lon/lat).
    """
    e1 = latlon2xyz(p1)
    e2 = latlon2xyz(p2)
    e3 = latlon2xyz(p3)
    e4 = latlon2xyz(p4)
    ang1 = spherical_angle(e1, e2, e4)
    ang2 = spherical_angle(e2, e3, e1)
    ang3 = spherical_angle(e3, e4, e2)
    ang4 = spherical_angle(e4, e3, e1)
    return (ang1 + ang2 + ang3 + ang4 - 2.0 * np.pi) * radius**2


def cell_center(p1, p2, p3, p4) -> np.ndarray:
    """Normalized cartesian mean of 4 corner lon/lat points -> lon/lat."""
    ec = latlon2xyz(p1) + latlon2xyz(p2) + latlon2xyz(p3) + latlon2xyz(p4)
    return xyz2latlon(normalize(ec))


def mirror_point(p1: np.ndarray, p2: np.ndarray, p0: np.ndarray) -> np.ndarray:
    """Mirror lon/lat p0 across the plane through p1, p2 and the origin."""
    n = normalize(np.cross(latlon2xyz(p1), latlon2xyz(p2)))
    e0 = latlon2xyz(p0)
    pdot = np.sum(e0 * n, axis=-1, keepdims=True)
    return xyz2latlon(e0 - 2.0 * pdot * n)
