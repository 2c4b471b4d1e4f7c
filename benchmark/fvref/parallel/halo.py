"""Halo exchange as rectangle gathers over the NumPy topology maps.

Counterpart of fv3jedi_lm_tpu/parallel/halo.py.  Each `CubeTopology` map
is NumPy and almost all identity; it is decomposed once into axis-aligned
rectangles covering the non-identity region (the same decomposition as the
JAX package), and the exchange is `out = q` with each rectangle replaced by
an `index_select` from the input.  The index tensors are built once per
(map, device).  Only copies and sign flips happen, so the result is
bitwise equal to the JAX package's.

Field layout: 3-D fields (npz, 6, jdim, idim); 2-D fields (6, jdim, idim);
on a decomposition (npz, nf, jdim, idim) and (nf, jdim, idim), a rank's
faces and tile (parallel/faces.py), every halo point outside the tile
exchanged point to point (parallel/exchange.py) and the per-face corner
fills cut to the tile.
"""

from __future__ import annotations

import numpy as np
import torch

from . import exchange

#: rectangle decompositions with their device index tensors, keyed by id()
#: of the (topology-cached, immortal) map arrays and the device
_DEV_CACHE: dict = {}
#: the all-positive-sign variants of vector maps, kept alive for their ids
_DEC_CACHE: dict = {}


def _runs(ix: np.ndarray):
    """Contiguous runs [(start, stop), ...] of a sorted index vector."""
    if ix.size == 0:
        return []
    brk = np.flatnonzero(np.diff(ix) > 1)
    starts = np.concatenate(([0], brk + 1))
    stops = np.concatenate((brk + 1, [ix.size]))
    return [(int(ix[a]), int(ix[b - 1]) + 1) for a, b in zip(starts, stops)]


def _rects(mask: np.ndarray):
    """Cover the True region of a 2-D mask with axis-aligned rectangles."""
    out = []
    for r0, r1 in _runs(np.flatnonzero(mask.any(axis=1))):
        for c0, c1 in _runs(np.flatnonzero(mask[r0:r1].any(axis=0))):
            out.append((r0, r1, c0, c1))
    return out


def _dec_scalar(idx: np.ndarray, device):
    """Non-identity rectangles of a same-shape scalar map, with their
    source indices as a long tensor on `device`."""
    key = (id(idx), str(device))
    hit = _DEV_CACHE.get(key)
    if hit is not None:
        return hit
    ident = np.arange(idx.size, dtype=np.int64).reshape(idx.shape)
    diff = idx.astype(np.int64) != ident
    mask2d = diff.reshape((-1,) + idx.shape[-2:]).any(axis=0)
    dec = []
    for (r0, r1, c0, c1) in _rects(mask2d):
        sub = np.ascontiguousarray(idx[..., r0:r1, c0:c1])
        dec.append((r0, r1, c0, c1, sub.shape,
                    torch.as_tensor(sub.ravel().astype(np.int64),
                                    device=device)))
    _DEV_CACHE[key] = dec
    return dec


def _apply_scalar(q: torch.Tensor, idx: np.ndarray, nflat: int):
    """out = q with rectangles replaced by values gathered from q.

    nflat = number of trailing axes of q flattened for the gather
    (3 for global maps over (6, J, I), 2 for per-face local maps)."""
    dec = _dec_scalar(idx, q.device)
    if not dec:
        return q
    lead = q.shape[:-nflat]
    flat = q.reshape(lead + (-1,))
    out = q.clone()
    for (r0, r1, c0, c1, shp, sub) in dec:
        out[..., r0:r1, c0:c1] = flat.index_select(-1, sub).reshape(
            lead + shp)
    return out


def _dec_vector(m: dict, device, dtype):
    """Decompose one component of a vector map: non-identity OR cross-
    component OR sign-flipped positions."""
    key = (id(m["idx_same"]), id(m["sign"]), str(device), dtype)
    hit = _DEV_CACHE.get(key)
    if hit is not None:
        return hit
    idx = m["idx_same"]
    ident = np.arange(idx.size, dtype=np.int64).reshape(idx.shape)
    from_other = np.asarray(m["from_other"])
    sign = np.asarray(m["sign"])
    diff = (idx.astype(np.int64) != ident) | from_other | (sign != 1)
    mask2d = diff.reshape((-1,) + idx.shape[-2:]).any(axis=0)

    def lt(a):
        return torch.as_tensor(
            np.ascontiguousarray(a).ravel().astype(np.int64), device=device)

    dec = []
    for (r0, r1, c0, c1) in _rects(mask2d):
        s = (Ellipsis, slice(r0, r1), slice(c0, c1))
        dec.append((r0, r1, c0, c1, idx[s].shape,
                    lt(idx[s]), lt(m["idx_other"][s]),
                    torch.as_tensor(np.ascontiguousarray(from_other[s]),
                                    device=device),
                    torch.as_tensor(np.ascontiguousarray(sign[s]),
                                    dtype=dtype, device=device)))
    _DEV_CACHE[key] = dec
    return dec


def _apply_vec_one(x, y, m, nflat):
    """New x-component: gather-from-self / gather-from-other / sign, applied
    only on the map's non-identity rectangles."""
    dec = _dec_vector(m, x.device, x.dtype)
    if not dec:
        return x
    lead = x.shape[:-nflat]
    xf = x.reshape(lead + (-1,))
    yf = y.reshape(y.shape[:-nflat] + (-1,))
    out = x.clone()
    for (r0, r1, c0, c1, shp, i_s, i_o, fo, sg) in dec:
        a = xf.index_select(-1, i_s).reshape(lead + shp)
        b = yf.index_select(-1, i_o).reshape(lead + shp)
        out[..., r0:r1, c0:c1] = torch.where(fo, b, a) * sg
    return out


def _apply_vector_map(u, v, mu, mv, nflat=3):
    return _apply_vec_one(u, v, mu, nflat), _apply_vec_one(v, u, mv, nflat)


# ----------------------------------------------------------------------
# Cross-face halo updates: the gathers above on one process; on a face
# decomposition (`topo` a parallel/faces.FaceTopology, which carries its
# FaceGroup) the point-to-point exchange of parallel/exchange.py over the
# same maps.  Every rank issues every update, whatever its plan holds.
# ----------------------------------------------------------------------

def _scalar(q, topo, idx):
    if getattr(topo, "faces", None) is None:
        return _apply_scalar(q, idx, 3)
    return exchange.exchange_scalar(q, topo, idx)


def _pair(x, y, topo, mx, my, shared=False):
    if getattr(topo, "faces", None) is None:
        return _apply_vector_map(x, y, mx, my)
    return exchange.exchange_pair(x, y, topo, mx, my, shared)


def fill_halo_center(q, topo):
    """Scalar halo update, cell centers (mpp_update_domains, CENTER)."""
    return _scalar(q, topo, topo.halo_map_center())


def fill_halo_corner(q, topo):
    """Scalar halo update at B-grid corners (position=CORNER)."""
    return _scalar(q, topo, topo.halo_map_corner())


def fill_halo_dgrid(u, v, topo):
    """D-grid wind pair halo update (gridtype=DGRID_NE)."""
    m = topo.halo_map_dgrid()
    return _pair(u, v, topo, m["x"], m["y"])


def fill_halo_cgrid(uc, vc, topo):
    """C-grid wind pair halo update (gridtype=CGRID_NE)."""
    m = topo.halo_map_cgrid()
    return _pair(uc, vc, topo, m["x"], m["y"])


def _abs_sign_maps(m):
    """SCALAR_PAIR variant of a vector map (all signs +1), cached."""
    key = ("abs", id(m["x"]["idx_same"]), id(m["y"]["idx_same"]))
    hit = _DEC_CACHE.get(key)
    if hit is None:
        mx = dict(m["x"], sign=np.abs(np.asarray(m["x"]["sign"])))
        my = dict(m["y"], sign=np.abs(np.asarray(m["y"]["sign"])))
        hit = (mx, my)
        _DEC_CACHE[key] = hit
    return hit


def fill_halo_cgrid_scalar_pair(x, y, topo):
    """C-grid pair update without vector sign semantics (SCALAR_PAIR)."""
    mx, my = _abs_sign_maps(topo.halo_map_cgrid())
    return _pair(x, y, topo, mx, my)


def fill_halo_dgrid_scalar_pair(x, y, topo):
    mx, my = _abs_sign_maps(topo.halo_map_dgrid())
    return _pair(x, y, topo, mx, my)


def fix_shared_edges_dgrid(u, v, topo):
    """Enforce single ownership of shared face-edge wind values
    (mpp_get_boundary(u, v, DGRID_NE) + overwrite of the north u row /
    east v column); on a decomposition into tiles the same holds for the
    lines two tiles of a face share: the south (west) tile takes the
    north (east) tile's."""
    m = topo.edge_fix_maps_dgrid()
    return _pair(u, v, topo, m["u"], m["v"], shared="fix")


def share_tile_lines(u, v, topo):
    """The D-grid lines two tiles of a face share (u's north row, v's east
    column of the south and west tile), taken from the tile across them:
    the in-face half of fix_shared_edges_dgrid (mpp_get_boundary), which
    leaves the cube edges as they are.  Nothing on one process or with
    whole faces."""
    if getattr(topo, "faces", None) is None or topo.tile.whole:
        return u, v
    mx, my = _identity_dgrid(topo.n, topo.ng)
    return exchange.exchange_pair(u, v, topo, mx, my, shared="lines")


def _identity_dgrid(n, ng):
    """Identity vector maps over the cube's padded D-grid pair, cached
    (the exchange plans are keyed by their identity)."""
    key = ("ident_d", n, ng)
    hit = _DEC_CACHE.get(key)
    if hit is None:
        jc = n + 2 * ng

        def ident(jdim, idim):
            size = 6 * jdim * idim
            return dict(idx_same=np.arange(size).reshape(6, jdim, idim),
                        idx_other=np.zeros((6, jdim, idim), np.int64),
                        from_other=np.zeros((6, jdim, idim), bool),
                        sign=np.ones((6, jdim, idim)))

        hit = (ident(jc + 1, jc), ident(jc, jc + 1))
        _DEC_CACHE[key] = hit
    return hit


# ----------------------------------------------------------------------
# Local corner-region fills (per-face maps over the trailing (J, I) dims)
# ----------------------------------------------------------------------

def copy_corners(q, topo, dir_: int):
    """tp_core copy_corners: rotate edge halo data into corner regions."""
    return _apply_scalar(q, topo.copy_corners_map(dir_), 2)


def fill_corners_scalar(q, topo, grid: str, dir_: int):
    """fill_corners for a scalar field; grid in {'agrid','bgrid'}."""
    if grid == "bgrid":
        return _apply_scalar(q, topo.fill_corners_bgrid_map(dir_), 2)
    return _apply_scalar(q, topo.fill_corners_agrid_scalar_map(dir_), 2)


def fill_corners_vector(x, y, topo, grid: str, vector: bool = True):
    """fill_corners for a staggered pair; grid in {'dgrid','cgrid','agrid'}."""
    if grid == "dgrid":
        mx, my = topo.fill_corners_dgrid_maps(vector)
    elif grid == "cgrid":
        mx, my = topo.fill_corners_cgrid_maps(vector)
    else:
        mx, my = topo.fill_corners_agrid_maps(vector)
    return _apply_vector_map(x, y, mx, my, nflat=2)
