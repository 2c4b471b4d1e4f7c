"""Grid metric terms for the cubed-sphere FV core.

The port's own copy of fv3jedi_lm_tpu/grid/metrics.py, identical to it
but for this paragraph: its imports resolve within
fv3jedi_lm_tpu_torch, so the port never imports the JAX package.

Re-derivation (numpy, float64) of the metric arrays of `fv_grid_type`
(reference model/fv_arrays_nlm.F90:115-234), computed as in
`init_grid` (tools/fv_grid_tools_nlm.F90:417-1000) and `grid_utils_init`
(model/fv_grid_utils_nlm.F90:78-860), but over all 6 faces at once with
halos filled by exact cube-topology index maps instead of MPI updates.

All arrays live on the padded per-face layout (6, jdim, idim); see
topology.CubeTopology for stagger conventions.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from .. import NG
from . import sphere
from .topology import CubeTopology, get_topology

#: Sentinel for undefined (ghost corner / face-edge) metric lanes, the
#: reference's big_number (fv_grid_utils_nlm.F90:49).  The compute path is
#: structurally masked so sentinel lanes are never *read* — any magnitude
#: works (tests run both 1e8 and 1e30); 1e8 is the default because 1e30
#: overflows f32 when squared on the TPU bench path.
BIG = 1.0e30
TINY = 1.0e-8
RADIUS = 6371.0e3  # reference src/utils/fv3jedi_lm_const_mod.F90


def _np_gather_global(q: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return q.reshape(-1, *q.shape[3:])[idx.ravel()].reshape(idx.shape + q.shape[3:])


def _np_gather_local(q: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Per-face local gather over last two dims of (6, J, I)."""
    out = np.empty_like(q)
    for f in range(q.shape[0]):
        out[f] = q[f].reshape(-1)[idx.ravel()].reshape(idx.shape)
    return out


def _np_vector_pair(u, v, mu, mv):
    a = _np_gather_global(u, mu["idx_same"])
    b = _np_gather_global(v, mu["idx_other"])
    un = np.where(mu["from_other"], b, a) * mu["sign"]
    c = _np_gather_global(v, mv["idx_same"])
    d = _np_gather_global(u, mv["idx_other"])
    vn = np.where(mv["from_other"], d, c) * mv["sign"]
    return un, vn


def _np_local_pair(x, y, mx, my):
    xn = np.empty_like(x)
    yn = np.empty_like(y)
    for f in range(x.shape[0]):
        a = x[f].reshape(-1)[mx["idx_same"].ravel()].reshape(mx["idx_same"].shape)
        b = y[f].reshape(-1)[mx["idx_other"].ravel()].reshape(mx["idx_other"].shape)
        xn[f] = np.where(mx["from_other"], b, a) * mx["sign"]
        c = y[f].reshape(-1)[my["idx_same"].ravel()].reshape(my["idx_same"].shape)
        d = x[f].reshape(-1)[my["idx_other"].ravel()].reshape(my["idx_other"].shape)
        yn[f] = np.where(my["from_other"], d, c) * my["sign"]
    return xn, yn


@dataclasses.dataclass
class GridMetrics:
    """All precomputed grid arrays (numpy f64; cast on device as needed)."""

    npx: int
    ng: int
    topo: Any  # CubeTopology (not a pytree leaf)

    # corner (B-grid) lon/lat and xyz, extended: (6, n+1+2ng, n+1+2ng, .)
    grid: np.ndarray = None
    grid_xyz: np.ndarray = None
    # cell centers
    agrid: np.ndarray = None
    agrid_xyz: np.ndarray = None

    # distances
    dx: np.ndarray = None    # u-pos (6, n+1+2ng, n+2ng)
    dy: np.ndarray = None    # v-pos (6, n+2ng, n+1+2ng)
    dxa: np.ndarray = None   # center
    dya: np.ndarray = None
    dxc: np.ndarray = None   # uc-pos (6, n+2ng, n+1+2ng)
    dyc: np.ndarray = None   # vc-pos (6, n+1+2ng, n+2ng)

    area: np.ndarray = None     # center
    area_c: np.ndarray = None   # corner
    rarea: np.ndarray = None
    rarea_c: np.ndarray = None
    rdx: np.ndarray = None
    rdy: np.ndarray = None
    rdxa: np.ndarray = None
    rdya: np.ndarray = None
    rdxc: np.ndarray = None
    rdyc: np.ndarray = None

    # angles (supergrid): component order [comp 1..9] first
    sin_sg: np.ndarray = None   # (9, 6, jc, ic)
    cos_sg: np.ndarray = None
    cosa_u: np.ndarray = None   # uc-pos
    sina_u: np.ndarray = None
    rsin_u: np.ndarray = None
    cosa_v: np.ndarray = None   # vc-pos
    sina_v: np.ndarray = None
    rsin_v: np.ndarray = None
    cosa_s: np.ndarray = None   # center
    rsin2: np.ndarray = None
    cosa: np.ndarray = None     # corner
    sina: np.ndarray = None
    rsina: np.ndarray = None

    # damping weights
    divg_u: np.ndarray = None   # vc-pos
    divg_v: np.ndarray = None   # uc-pos
    del6_u: np.ndarray = None
    del6_v: np.ndarray = None

    da_min: float = 0.0
    da_max: float = 0.0
    da_min_c: float = 0.0
    da_max_c: float = 0.0

    # face-edge interpolation factors (same for every face by symmetry,
    # but stored per-face for generality): a2b scalar factors
    edge_s: np.ndarray = None   # (6, npx)
    edge_n: np.ndarray = None
    edge_w: np.ndarray = None   # (6, npy)
    edge_e: np.ndarray = None
    # a2c vector factors (indexed like a center row/col with halo)
    edge_vect_s: np.ndarray = None  # (6, n+2ng)
    edge_vect_n: np.ndarray = None
    edge_vect_w: np.ndarray = None
    edge_vect_e: np.ndarray = None

    # Coriolis
    fC: np.ndarray = None  # corner
    f0: np.ndarray = None  # center

    # a2b_ord4 3-way corner extrapolation coefficients x1/(x2-x1)
    # (a2b_edge_nlm.F90 extrap_corner), order [sw, se, ne, nw] x 3 pairs
    corner_ext_coef: np.ndarray = None  # (6, 4, 3)

    # cubed-to-latlon (c2l_ord2 weights a11..a22; unit vectors for ord4)
    a11: np.ndarray = None
    a12: np.ndarray = None
    a21: np.ndarray = None
    a22: np.ndarray = None
    vlon: np.ndarray = None  # (3, 6, jc, ic)
    vlat: np.ndarray = None
    # local unit vectors at cell centers (ec1 = x-dir, ec2 = y-dir)
    ec1: np.ndarray = None
    ec2: np.ndarray = None
    # edge-normal unit vectors for adv_pe (fv_grid_utils_nlm.F90:680-693)
    en1: np.ndarray = None
    en2: np.ndarray = None


def build_grid(npx: int, ng: int = NG, radius: float = RADIUS,
               big: float = BIG) -> GridMetrics:
    BIG = big  # noqa: N806 — sentinel magnitude, see module docstring
    topo = get_topology(npx, ng)
    n = npx - 1
    g = GridMetrics(npx=npx, ng=ng, topo=topo)

    jc = n + 2 * ng        # center dims
    jb = n + 1 + 2 * ng    # corner dims

    # ---------------- corner grid, extended ----------------
    xyz = np.zeros((6, jb, jb, 3))
    xyz[:, ng:ng + n + 1, ng:ng + n + 1, :] = topo.corners_int
    for k in range(3):
        xyz[..., k] = _np_gather_global(xyz[..., k], topo.halo_map_corner())
    # corner regions: reference fills grid lon AND lat with XDir BGRID fill
    ll = sphere.xyz2latlon(xyz)
    bmap = topo.fill_corners_bgrid_map(1)
    ll[..., 0] = _np_gather_local(ll[..., 0], bmap)
    ll[..., 1] = _np_gather_local(ll[..., 1], bmap)
    corner_mask = topo.corner_region_mask(0.0, 0.0)
    xyz_f = sphere.latlon2xyz(ll)
    xyz = np.where(corner_mask[None, :, :, None], xyz_f, xyz)
    g.grid = ll
    g.grid_xyz = xyz

    # ---------------- cell centers ----------------
    ecp = xyz[:, :-1, :-1] + xyz[:, :-1, 1:] + xyz[:, 1:, :-1] + xyz[:, 1:, 1:]
    axyz = sphere.normalize(ecp)
    all_ll = sphere.xyz2latlon(axyz)
    # corner regions: AGRID fill, XDir for lon, YDir for lat (init_grid:712-713)
    all_ll[..., 0] = _np_gather_local(all_ll[..., 0], topo.fill_corners_agrid_scalar_map(1))
    all_ll[..., 1] = _np_gather_local(all_ll[..., 1], topo.fill_corners_agrid_scalar_map(2))
    amask = topo.corner_region_mask(0.5, 0.5)
    axyz = np.where(amask[None, :, :, None], sphere.latlon2xyz(all_ll), axyz)
    g.agrid = all_ll
    g.agrid_xyz = axyz

    ll_c = g.grid  # corner lon/lat
    ll_a = g.agrid

    # ---------------- dx, dy ----------------
    # dx(i,j): dist between corners (j, i) and (j, i+1) -> u-pos (6, jb, jc)
    dx = sphere.great_circle_dist(ll_c[:, :, :-1], ll_c[:, :, 1:], radius)
    dy = sphere.great_circle_dist(ll_c[:, :-1, :], ll_c[:, 1:, :], radius)
    # corner fill: fill_corners(dx, dy, DGRID) sign +1
    dx, dy = _np_local_pair(dx, dy, *topo.fill_corners_dgrid_maps(vector=False))
    g.dx, g.dy = dx, dy

    # ---------------- dxa, dya ----------------
    mid_w = sphere.mid_pt_sphere(ll_c[:, :-1, :-1], ll_c[:, 1:, :-1])  # west edge midpoints
    mid_e = sphere.mid_pt_sphere(ll_c[:, :-1, 1:], ll_c[:, 1:, 1:])
    dxa = sphere.great_circle_dist(mid_w, mid_e, radius)
    mid_s = sphere.mid_pt_sphere(ll_c[:, :-1, :-1], ll_c[:, :-1, 1:])
    mid_n = sphere.mid_pt_sphere(ll_c[:, 1:, :-1], ll_c[:, 1:, 1:])
    dya = sphere.great_circle_dist(mid_s, mid_n, radius)
    dxa, dya = _np_local_pair(dxa, dya, *topo.fill_corners_agrid_maps(vector=False))
    g.dxa, g.dya = dxa, dya

    # ---------------- dxc, dyc ----------------
    # dxc at uc-pos (6, jc, jb): dist(agrid(i-1,j), agrid(i,j)); edge cols special
    dxc = np.zeros((6, jc, jb))
    dxc[:, :, 1:-1] = sphere.great_circle_dist(ll_a[:, :, :-1], ll_a[:, :, 1:], radius)
    dxc[:, :, 0] = dxc[:, :, 1]
    dxc[:, :, -1] = dxc[:, :, -2]
    # edge specials at face edges (i=0 and i=n positions -> padded ng, ng+n)
    iw, ie_ = ng, ng + n
    mid = sphere.mid_pt_sphere(ll_c[:, :-1, iw], ll_c[:, 1:, iw])
    dxc[:, :, iw] = 2.0 * sphere.great_circle_dist(mid, ll_a[:, :, iw], radius)
    mid = sphere.mid_pt_sphere(ll_c[:, :-1, ie_], ll_c[:, 1:, ie_])
    dxc[:, :, ie_] = 2.0 * sphere.great_circle_dist(ll_a[:, :, ie_ - 1], mid, radius)

    dyc = np.zeros((6, jb, jc))
    dyc[:, 1:-1, :] = sphere.great_circle_dist(ll_a[:, :-1, :], ll_a[:, 1:, :], radius)
    dyc[:, 0, :] = dyc[:, 1, :]
    dyc[:, -1, :] = dyc[:, -2, :]
    js_, je_ = ng, ng + n
    mid = sphere.mid_pt_sphere(ll_c[:, js_, :-1], ll_c[:, js_, 1:])
    dyc[:, js_, :] = 2.0 * sphere.great_circle_dist(mid, ll_a[:, js_, :], radius)
    mid = sphere.mid_pt_sphere(ll_c[:, je_, :-1], ll_c[:, je_, 1:])
    dyc[:, je_, :] = 2.0 * sphere.great_circle_dist(ll_a[:, je_ - 1, :], mid, radius)

    # cross-face exchange (SCALAR_PAIR CGRID: x=dxc at uc-pos, y=dyc at vc-pos)
    m = topo.halo_map_cgrid()
    mx = dict(m["x"], sign=np.abs(m["x"]["sign"]))
    my = dict(m["y"], sign=np.abs(m["y"]["sign"]))
    dxc, dyc = _np_vector_pair(dxc, dyc, mx, my)
    dxc, dyc = _np_local_pair(dxc, dyc, *topo.fill_corners_cgrid_maps(vector=False))
    g.dxc, g.dyc = dxc, dyc

    # ---------------- areas ----------------
    p_ll = ll_c[:, :-1, :-1]
    p_ul = ll_c[:, 1:, :-1]
    p_lr = ll_c[:, :-1, 1:]
    p_ur = ll_c[:, 1:, 1:]
    area = sphere.get_area(p_ll, p_ul, p_lr, p_ur, radius)
    area = np.where(amask[None], -BIG, area)  # fill_ghost(area, -big_number)
    g.area = area

    # area_c on corners from surrounding cell centers; edge/corner specials
    area_c = np.full((6, jb, jb), BIG)
    a_ll = ll_a[:, :-1, :-1]
    a_ul = ll_a[:, 1:, :-1]
    a_lr = ll_a[:, :-1, 1:]
    a_ur = ll_a[:, 1:, 1:]
    area_c[:, 1:-1, 1:-1] = sphere.get_area(a_ll, a_ul, a_lr, a_ur, radius)
    # edge specials (init_grid:767-840): half-cells x2 along face edges
    i = iw
    p1 = sphere.mid_pt_sphere(ll_c[:, :-1, i], ll_c[:, 1:, i])   # (jb-1) mids below corner j
    # area_c(1,j) = 2*get_area(p1(j-1), p4=p1(j), p2=agrid(1,j-1), p3=agrid(1,j))
    area_c[:, 1:-1, i] = 2.0 * sphere.get_area(
        p1[:, :-1], p1[:, 1:], ll_a[:, :-1, i], ll_a[:, 1:, i], radius
    )
    i = ie_
    p2 = sphere.mid_pt_sphere(ll_c[:, :-1, i], ll_c[:, 1:, i])
    area_c[:, 1:-1, i] = 2.0 * sphere.get_area(
        ll_a[:, :-1, i - 1], ll_a[:, 1:, i - 1], p2[:, :-1], p2[:, 1:], radius
    )
    j = js_
    p1s = sphere.mid_pt_sphere(ll_c[:, j, :-1], ll_c[:, j, 1:])
    area_c[:, j, 1:-1] = 2.0 * sphere.get_area(
        p1s[:, :-1], ll_a[:, j, :-1], p1s[:, 1:], ll_a[:, j, 1:], radius
    )
    j = je_
    p4n = sphere.mid_pt_sphere(ll_c[:, j, :-1], ll_c[:, j, 1:])
    area_c[:, j, 1:-1] = 2.0 * sphere.get_area(
        ll_a[:, j - 1, :-1], p4n[:, :-1], ll_a[:, j - 1, 1:], p4n[:, 1:], radius
    )
    # 4 cube-corner triples (init_grid:842-876)
    for (ci, cj) in ((iw, js_), (ie_, js_), (ie_, je_), (iw, je_)):
        if (ci, cj) == (iw, js_):
            p1_ = ll_c[:, cj, ci]
            p2_ = sphere.mid_pt_sphere(ll_c[:, cj, ci], ll_c[:, cj, ci + 1])
            p3_ = ll_a[:, cj, ci]
            p4_ = sphere.mid_pt_sphere(ll_c[:, cj, ci], ll_c[:, cj + 1, ci])
        elif (ci, cj) == (ie_, js_):
            p1_ = sphere.mid_pt_sphere(ll_c[:, cj, ci - 1], ll_c[:, cj, ci])
            p2_ = ll_c[:, cj, ci]
            p3_ = sphere.mid_pt_sphere(ll_c[:, cj, ci], ll_c[:, cj + 1, ci])
            p4_ = ll_a[:, cj, ci - 1]
        elif (ci, cj) == (ie_, je_):
            p1_ = ll_a[:, cj - 1, ci - 1]
            p2_ = sphere.mid_pt_sphere(ll_c[:, cj - 1, ci], ll_c[:, cj, ci])
            p3_ = ll_c[:, cj, ci]
            p4_ = sphere.mid_pt_sphere(ll_c[:, cj, ci - 1], ll_c[:, cj, ci])
        else:
            p1_ = sphere.mid_pt_sphere(ll_c[:, cj - 1, ci], ll_c[:, cj, ci])
            p2_ = ll_a[:, cj - 1, ci]
            p3_ = sphere.mid_pt_sphere(ll_c[:, cj, ci], ll_c[:, cj, ci + 1])
            p4_ = ll_c[:, cj, ci]
        area_c[:, cj, ci] = 3.0 * sphere.get_area(p1_, p4_, p2_, p3_, radius)
    area_c = _np_gather_global(area_c, topo.halo_map_corner())
    area_c = _np_gather_local(area_c, topo.fill_corners_bgrid_map(1))
    g.area_c = area_c

    with np.errstate(divide="ignore", invalid="ignore"):
        g.rarea = 1.0 / g.area
        g.rarea_c = 1.0 / g.area_c
        g.rdx = 1.0 / g.dx
        g.rdy = 1.0 / g.dy
        g.rdxa = 1.0 / g.dxa
        g.rdya = 1.0 / g.dya
        g.rdxc = 1.0 / g.dxc
        g.rdyc = 1.0 / g.dyc

    g.da_min = float(area[:, ng:ng + n, ng:ng + n].min())
    g.da_max = float(area[:, ng:ng + n, ng:ng + n].max())
    g.da_min_c = float(area_c[:, ng:ng + n + 1, ng:ng + n + 1].min())
    g.da_max_c = float(area_c[:, ng:ng + n + 1, ng:ng + n + 1].max())

    # ---------------- center unit vectors ec1/ec2 + supergrid angles ----
    # ec1: unit vector at cell center pointing in +x; ec2: +y
    # (reference get_center_vect, non-OLD_VECT branch uses great-circle
    # construction; the OLD_VECT difference is negligible for angles --
    # use edge-midpoint difference construction, then orthonormalize to
    # the sphere tangent plane.)
    pdiff1 = (xyz[:, :-1, 1:] + xyz[:, 1:, 1:]) - (xyz[:, :-1, :-1] + xyz[:, 1:, :-1])
    pdiff2 = (xyz[:, 1:, :-1] + xyz[:, 1:, 1:]) - (xyz[:, :-1, :-1] + xyz[:, :-1, 1:])
    ec1 = sphere.normalize(pdiff1 - np.sum(pdiff1 * axyz, -1, keepdims=True) * axyz)
    ec2 = sphere.normalize(pdiff2 - np.sum(pdiff2 * axyz, -1, keepdims=True) * axyz)
    g.ec1, g.ec2 = np.moveaxis(ec1, -1, 0), np.moveaxis(ec2, -1, 0)

    # edge-normal unit vectors for the omega advective term (adv_pe):
    # en1 at u positions = normalize(grid3(i,j) x grid3(i+1,j)),
    # en2 at v positions = normalize(grid3(i,j+1) x grid3(i,j))
    # (fv_grid_utils_nlm.F90:680-693)
    with np.errstate(invalid="ignore", divide="ignore"):
        en1 = sphere.normalize(sphere.cross(xyz[:, :, :-1], xyz[:, :, 1:]))
        en2 = sphere.normalize(sphere.cross(xyz[:, 1:, :], xyz[:, :-1, :]))
    # ghost/corner lanes have degenerate corner pairs -> zero them (they
    # are never read by adv_pe's compute-domain slices)
    en1 = np.where(np.isfinite(en1), en1, 0.0)
    en2 = np.where(np.isfinite(en2), en2, 0.0)
    g.en1, g.en2 = np.moveaxis(en1, -1, 0), np.moveaxis(en2, -1, 0)

    #     9---4---8
    #     |       |
    #     1   5   3
    #     |       |
    #     6---2---7   (supergrid components, grid_utils_init:300-345)
    cs = np.full((9, 6, jc, jc), BIG)
    c_ll = xyz[:, :-1, :-1]
    c_lr = xyz[:, :-1, 1:]
    c_ul = xyz[:, 1:, :-1]
    c_ur = xyz[:, 1:, 1:]
    cs[5] = sphere.cos_angle(c_ll, c_lr, c_ul)            # comp 6, SW corner
    cs[6] = -sphere.cos_angle(c_lr, c_ll, c_ur)           # comp 7, SE
    cs[7] = sphere.cos_angle(c_ur, c_lr, c_ul)            # comp 8, NE
    cs[8] = -sphere.cos_angle(c_ul, c_ll, c_ur)           # comp 9, NW
    m1 = sphere.mid_pt_cart(c_ll, c_ul)                   # west edge mid
    cs[0] = sphere.cos_angle(m1, axyz, c_ul)              # comp 1
    m2 = sphere.mid_pt_cart(c_ll, c_lr)                   # south edge mid
    cs[1] = sphere.cos_angle(m2, c_lr, axyz)              # comp 2
    m3 = sphere.mid_pt_cart(c_lr, c_ur)                   # east edge mid
    cs[2] = sphere.cos_angle(m3, axyz, c_lr)              # comp 3
    m4 = sphere.mid_pt_cart(c_ul, c_ur)                   # north edge mid
    cs[3] = sphere.cos_angle(m4, c_ul, axyz)              # comp 4
    cs[4] = np.sum(ec1 * ec2, axis=-1)                    # comp 5, center
    sn = np.minimum(1.0, np.sqrt(np.maximum(0.0, 1.0 - cs**2)))

    # fill_ghost corner regions (tiny/big), then transport-corner overrides
    cs = np.where(amask[None, None], BIG, cs)
    sn = np.where(amask[None, None], TINY, sn)

    # corner-strip overrides, grid_utils_init:570-625 (Fortran 1-based):
    # indexes converted with p(i) = i-1+ng
    p = lambda i: i - 1 + ng
    for f in range(6):
        for i in range(0, -3, -1):  # i = 0,-1,-2
            # sw: sin_sg(0,i,3)=sin_sg(i,1,2); sin_sg(i,0,4)=sin_sg(1,i,1)
            sn[2, f, p(i), p(0)] = sn[1, f, p(1), p(i)]
            sn[3, f, p(0), p(i)] = sn[0, f, p(i), p(1)]
            cs[2, f, p(i), p(0)] = cs[1, f, p(1), p(i)]
            cs[3, f, p(0), p(i)] = cs[0, f, p(i), p(1)]
        for i in range(npx, npx + 3):  # nw: sin_sg(0,i,3)=sin_sg(npy-i,npy-1,4)
            sn[2, f, p(i), p(0)] = sn[3, f, p(npx - 1), p(npx - i)]
            cs[2, f, p(i), p(0)] = cs[3, f, p(npx - 1), p(npx - i)]
        for i in range(0, -3, -1):  # nw: sin_sg(i,npy,2)=sin_sg(1,npy-i,1)
            sn[1, f, p(npx), p(i)] = sn[0, f, p(npx - i), p(1)]
            cs[1, f, p(npx), p(i)] = cs[0, f, p(npx - i), p(1)]
        for j in range(0, -3, -1):  # se: sin_sg(npx,j,1)=sin_sg(npx-j,1,2)
            sn[0, f, p(j), p(npx)] = sn[1, f, p(1), p(npx - j)]
            cs[0, f, p(j), p(npx)] = cs[1, f, p(1), p(npx - j)]
        for i in range(npx, npx + 3):  # se: sin_sg(i,0,4)=sin_sg(npx-1,npx-i,3)
            sn[3, f, p(0), p(i)] = sn[2, f, p(npx - i), p(npx - 1)]
            cs[3, f, p(0), p(i)] = cs[2, f, p(npx - i), p(npx - 1)]
        for i in range(0, 3):  # ne: sin_sg(npx,npy+i,1)=sin_sg(npx+i,npy-1,4)
            sn[0, f, p(npx + i), p(npx)] = sn[3, f, p(npx - 1), p(npx + i)]
            cs[0, f, p(npx + i), p(npx)] = cs[3, f, p(npx - 1), p(npx + i)]
            # ne: sin_sg(npx+i,npy,2)=sin_sg(npx-1,npy+i,3)
            sn[1, f, p(npx), p(npx + i)] = sn[2, f, p(npx + i), p(npx - 1)]
            cs[1, f, p(npx), p(npx + i)] = cs[2, f, p(npx + i), p(npx - 1)]
    g.sin_sg, g.cos_sg = sn, cs

    # ---------------- derived angle arrays ----------------
    # cosa/sina at B-grid corners: 0.5*(cos_sg(i-1,j-1,8)+cos_sg(i,j,6))
    cosa = np.full((6, jb, jb), BIG)
    sina = np.full((6, jb, jb), BIG)
    cosa[:, 1:-1, 1:-1] = 0.5 * (cs[7, :, :-1, :-1] + cs[5, :, 1:, 1:])
    sina[:, 1:-1, 1:-1] = 0.5 * (sn[7, :, :-1, :-1] + sn[5, :, 1:, 1:])
    g.cosa, g.sina = cosa, sina

    cosa_u = np.full((6, jc, jb), BIG)
    sina_u = np.full((6, jc, jb), BIG)
    cosa_u[:, :, 1:-1] = 0.5 * (cs[2, :, :, :-1] + cs[0, :, :, 1:])
    sina_u[:, :, 1:-1] = 0.5 * (sn[2, :, :, :-1] + sn[0, :, :, 1:])
    rsin_u = 1.0 / np.maximum(TINY, sina_u**2)
    # edges: rsin_u = 1/sina_u (grid_utils_init:530-537)
    for i in (iw, ie_):
        rsin_u[:, :, i] = 1.0 / np.sign(sina_u[:, :, i]) / np.maximum(
            TINY, np.abs(sina_u[:, :, i])
        )
    g.cosa_u, g.sina_u, g.rsin_u = cosa_u, sina_u, rsin_u

    cosa_v = np.full((6, jb, jc), BIG)
    sina_v = np.full((6, jb, jc), BIG)
    cosa_v[:, 1:-1, :] = 0.5 * (cs[3, :, :-1, :] + cs[1, :, 1:, :])
    sina_v[:, 1:-1, :] = 0.5 * (sn[3, :, :-1, :] + sn[1, :, 1:, :])
    rsin_v = 1.0 / np.maximum(TINY, sina_v**2)
    for j in (js_, je_):
        rsin_v[:, j, :] = 1.0 / np.sign(sina_v[:, j, :]) / np.maximum(
            TINY, np.abs(sina_v[:, j, :])
        )
    g.cosa_v, g.sina_v, g.rsin_v = cosa_v, sina_v, rsin_v

    cosa_s = cs[4].copy()
    rsin2 = 1.0 / np.maximum(TINY, sn[4] ** 2)
    cosa_s = np.where(amask[None], BIG, cosa_s)
    g.cosa_s, g.rsin2 = cosa_s, rsin2

    # rsina at corners; big_number on face-edge lines (grid_utils_init:516-528)
    rsina = 1.0 / np.maximum(TINY, sina**2)
    rsina[:, :, iw] = BIG
    rsina[:, :, ie_] = BIG
    rsina[:, js_, :] = BIG
    rsina[:, je_, :] = BIG
    g.rsina = rsina

    # ---------------- divergence/del6 damping weights ----------------
    divg_u = sina_v * dyc / dx       # at vc-pos (6, jb, jc)
    del6_u = sina_v * dx / dyc
    for j in (js_, je_):  # edge rows use supergrid sines
        w = 0.5 * (sn[1, :, np.minimum(j, jc - 1), :] + sn[3, :, j - 1, :])
        divg_u[:, j, :] = w * dyc[:, j, :] / dx[:, j, :]
        del6_u[:, j, :] = w * dx[:, j, :] / dyc[:, j, :]
    divg_v = sina_u * dxc / dy       # at uc-pos (6, jc, jb)
    del6_v = sina_u * dy / dxc
    for i in (iw, ie_):
        w = 0.5 * (sn[0, :, :, np.minimum(i, jc - 1)] + sn[2, :, :, i - 1])
        divg_v[:, :, i] = w * dxc[:, :, i] / dy[:, :, i]
        del6_v[:, :, i] = w * dy[:, :, i] / dxc[:, :, i]
    # cross-face exchange as CGRID scalar pair (x at uc-pos = divg_v)
    divg_v, divg_u = _np_vector_pair(divg_v, divg_u, mx, my)
    del6_v, del6_u = _np_vector_pair(del6_v, del6_u, mx, my)
    g.divg_u, g.divg_v, g.del6_u, g.del6_v = divg_u, divg_v, del6_u, del6_v

    # ---------------- face-edge interpolation factors ----------------
    # a2b scalar factors (edge_factors, grid_utils_init ref fv_grid_utils:1500+)
    # stored 1-based like reference: edge_w[j] valid for j=2..npy-1
    edge_w = np.full((6, npx + 1), BIG)
    edge_e = np.full((6, npx + 1), BIG)
    edge_s = np.full((6, npx + 1), BIG)
    edge_n = np.full((6, npx + 1), BIG)
    for f in range(6):
        for (earr, const_i, axis) in ((edge_w, iw, "w"), (edge_e, ie_, "e")):
            i = const_i
            mids = sphere.mid_pt_sphere(ll_a[f, :, i - 1], ll_a[f, :, i])  # (jc, 2)
            for jf in range(2, npx):  # Fortran j = 2..npy-1
                jj = p(jf)
                d1 = sphere.great_circle_dist(mids[jj - 1], ll_c[f, jj, i])
                d2 = sphere.great_circle_dist(mids[jj], ll_c[f, jj, i])
                earr[f, jf] = d2 / (d1 + d2)
        for (earr, const_j) in ((edge_s, js_), (edge_n, je_)):
            j = const_j
            mids = sphere.mid_pt_sphere(ll_a[f, j - 1, :], ll_a[f, j, :])
            for if_ in range(2, npx):
                ii = p(if_)
                d1 = sphere.great_circle_dist(mids[ii - 1], ll_c[f, j, ii])
                d2 = sphere.great_circle_dist(mids[ii], ll_c[f, j, ii])
                earr[f, if_] = d2 / (d1 + d2)
    g.edge_w, g.edge_e, g.edge_s, g.edge_n = edge_w, edge_e, edge_s, edge_n

    # ---------------- a2b corner extrapolation coefficients ----------------
    # pair cell indices per corner, Fortran convention (a2b_edge_nlm.F90:108-135)
    npy = npx
    corner_pairs = {
        0: (ll_c[:, p(1), p(1)],      # sw, p0 = grid(1,1)
            [((1, 1), (2, 2)), ((0, 1), (-1, 2)), ((1, 0), (2, -1))]),
        1: (ll_c[:, p(1), p(npx)],    # se
            [((npx - 1, 1), (npx - 2, 2)), ((npx - 1, 0), (npx - 2, -1)),
             ((npx, 1), (npx + 1, 2))]),
        2: (ll_c[:, p(npy), p(npx)],  # ne
            [((npx - 1, npy - 1), (npx - 2, npy - 2)),
             ((npx, npy - 1), (npx + 1, npy - 2)),
             ((npx - 1, npy), (npx - 2, npy + 1))]),
        3: (ll_c[:, p(npy), p(1)],    # nw
            [((1, npy - 1), (2, npy - 2)), ((0, npy - 1), (-1, npy - 2)),
             ((1, npy), (2, npy + 1))]),
    }
    cec = np.zeros((6, 4, 3))
    for ci, (p0, pairs) in corner_pairs.items():
        for k, ((i1, j1), (i2, j2)) in enumerate(pairs):
            a1p = ll_a[:, p(j1), p(i1)]
            a2p = ll_a[:, p(j2), p(i2)]
            x1 = sphere.great_circle_dist(a1p, p0)
            x2 = sphere.great_circle_dist(a2p, p0)
            cec[:, ci, k] = x1 / (x2 - x1)
    g.corner_ext_coef = cec

    # ---------------- Coriolis ----------------
    from ..constants import OMEGA

    g.fC = 2.0 * OMEGA * np.sin(ll[..., 1])
    g.f0 = 2.0 * OMEGA * np.sin(all_ll[..., 1])

    # ---------------- cubed-to-latlon weights ----------------
    # vlon/vlat: local east/north unit vectors at cell centers
    lon_a, lat_a = all_ll[..., 0], all_ll[..., 1]
    vlon = np.stack([-np.sin(lon_a), np.cos(lon_a), np.zeros_like(lon_a)], axis=0)
    vlat = np.stack(
        [-np.sin(lat_a) * np.cos(lon_a), -np.sin(lat_a) * np.sin(lon_a), np.cos(lat_a)],
        axis=0,
    )
    g.vlon, g.vlat = vlon, vlat
    # z11..z22 = 0.5*sin_sg(5)*[ec . vlon/vlat]; a11.. = inverse/rsin2-scaled
    z11 = 0.5 * sn[4] * np.sum(g.ec1 * vlon, axis=0)
    z12 = 0.5 * sn[4] * np.sum(g.ec1 * vlat, axis=0)
    z21 = 0.5 * sn[4] * np.sum(g.ec2 * vlon, axis=0)
    z22 = 0.5 * sn[4] * np.sum(g.ec2 * vlat, axis=0)
    det = z11 * z22 - z12 * z21
    with np.errstate(divide="ignore", invalid="ignore"):
        g.a11 = 0.25 * z22 / det
        g.a12 = -0.25 * z12 / det
        g.a21 = -0.25 * z21 / det
        g.a22 = 0.25 * z11 / det

    # No metric array may hold a non-finite value: Inf/NaN in never-read
    # sentinel lanes still poisons whole-array ops through 0*NaN (forward)
    # and the where-vjp rule (backward).  Undefined lanes become 0.
    for f in dataclasses.fields(g):
        v = getattr(g, f.name)
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            setattr(g, f.name, np.nan_to_num(v, nan=0.0, posinf=0.0,
                                             neginf=0.0))
    return g
