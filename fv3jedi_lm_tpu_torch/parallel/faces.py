"""The decomposition of the cube over ranks: the process group, the
transport of the halo strips, and the carrying of grids and states onto
the ranks and back.

The ranks are laid out as the JAX package's device mesh lays them out,
('face', 'y', 'x') = `layout(n)`: a block of 6 / f consecutive faces per
face index and a y x x split of each face into tiles, rank (fb * y + ty)
* x + tx on tile (ty, tx) of the faces of block fb.  Six ranks are the
reference's minimal layout of one rank per face (tools/fv_mp_nlm_mod.F90:
285-600); eight are (2, 2, 2): three faces a rank, a quarter of each.  A
rank computes on its own (npz, nf, jy, jx) fields, padded by NG around
its tile; every halo point outside its tile arrives from the rank that
owns it by a point-to-point send, whether it lies in the same face (the
neighbouring tile's cells) or across a cube edge (the cross-face maps).
This module holds the rank's side of that:

* `layout`, `Tile` — the factorisation and the part of a face one rank
  computes, with the face edges it owns.
* `FaceGroup` — this rank's faces and tile, its process group and
  backend, and the transport that follows from the backend: NCCL sends
  device tensors; gloo sends CPU tensors only, so with gloo a CUDA rank
  copies its strips to pinned host memory and back.  One host has one
  card here and NCCL refuses two ranks on one card, so on the card the
  ranks share it with gloo.  The transport is chosen from the backend,
  never by catching a failure.  The NCCL transport (rank r on card r,
  device tensors sent as they are) is written but has never run: it
  needs a host with a card per rank.  It counts its exchanges, the bytes
  it sends and the host seconds spent inside them.
* `FaceTopology` — the cube topology as one rank sees it: the same NumPy
  maps, the per-face corner maps cut to its tile, the `FaceGroup` (the
  halo layer dispatches on it) and the exchange plans built from them.
* `slice_grid`, `split_faces`, `join_faces` — a whole-cube grid or state
  to one rank's faces and tile and back.
* `run_faces` — spawn the ranks, run a function on each, return the
  results in rank order; past `timeout` every rank is killed and an error
  raised, so a lost rank never hangs the caller.
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .. import NG
from ..grid.tile import Tile

#: the faces of the cube
NFACES = 6
#: the ranks of the default decomposition: one per cube face
WORLD = 6


def layout(n: int) -> tuple:
    """The (face, y, x) factorisation of `n` ranks, as the JAX package's
    mesh lays them out: f is the first of (6, 3, 2, 1) that divides both
    n and 6, and (y, x) the most nearly square split of n / f, y <= x."""
    f = next(ff for ff in (6, 3, 2, 1) if n % ff == 0 and 6 % ff == 0)
    per = n // f
    y = next(yy for yy in range(int(per ** 0.5), 0, -1) if per % yy == 0)
    return f, y, per // y


def _face_axis(ndim: int) -> int:
    """The face axis of a field of `ndim` dims: 1 for (k, 6, jy, jx)
    (3-D fields, the grid's (3|9, 6, jy, jx) vectors), else 0 ((6, jy,
    jx), (6, jb), (6, 4, 3))."""
    return 1 if ndim == 4 else 0


@dataclass(eq=False)
class FaceGroup:
    """This rank's part of a decomposition of `world` ranks laid out as
    `layout(world)` = (f, y, x) in the default process group, which
    `run_faces` (or the caller) has initialised: rank (fb * y + ty) * x
    + tx holds the block fb of 6 / f consecutive faces and, of each, the
    tile (ty, tx) of a y x x split.  Six ranks are one face each.
    `device` is where the rank computes.  With "nccl" the strips go from
    card to card without staging; that branch is untested (no host here
    has a card per rank)."""

    rank: int
    backend: str
    device: torch.device
    world: int = WORLD
    #: exchanges issued, bytes sent by them, host seconds inside them
    exchanges: int = 0
    bytes_sent: int = 0
    seconds: float = 0.0

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl backend sends CUDA tensors only")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} of {self.world}")
        # gloo sends CPU tensors only: a CUDA rank stages through host memory
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.layout = layout(self.world)
        f, y, x = self.layout
        self.nf = NFACES // f
        self.fb, rest = divmod(self.rank, y * x)
        self.ty, self.tx = divmod(rest, x)

    @property
    def face(self) -> int:
        """The first face this rank holds."""
        return self.fb * self.nf

    def rank_of(self, fb: int, ty: int, tx: int) -> int:
        _, y, x = self.layout
        return (fb * y + ty) * x + tx

    def tile(self, n: int, rank: int = None) -> Tile:
        """The tile of `rank` (this rank's by default) on faces of n x n
        cells; n must divide by the layout's y and x."""
        _, y, x = self.layout
        if n % y or n % x:
            raise ValueError(f"a face of {n} cells does not split into "
                             f"{y} x {x} tiles (layout {self.layout})")
        rank = self.rank if rank is None else rank
        ty, tx = divmod(rank % (y * x), x)
        return Tile(n, ty * (n // y), tx * (n // x), n // y, n // x)

    def reset_counters(self):
        self.exchanges = self.bytes_sent = 0
        self.seconds = 0.0

    def exchange(self, sends: dict, recv_shapes: dict, dtype) -> dict:
        """One point-to-point exchange: `sends` {peer rank: tensor on this
        rank's device}, `recv_shapes` {peer rank: shape}; returns {peer
        rank: received tensor on this rank's device}.  Every send and
        receive goes in one `batch_isend_irecv`."""
        t0 = time.perf_counter()
        out_peers = sorted(sends)
        in_peers = sorted(recv_shapes)
        sizes_in = [int(np.prod(recv_shapes[p])) for p in in_peers]
        if self.staged:
            flat = (torch.cat([sends[p].reshape(-1) for p in out_peers])
                    if out_peers else torch.empty(0, dtype=dtype,
                                                  device=self.device))
            host_out = torch.empty(flat.numel(), dtype=dtype,
                                   pin_memory=True)
            host_out.copy_(flat, non_blocking=True)
            host_in = torch.empty(sum(sizes_in), dtype=dtype, pin_memory=True)
            torch.cuda.current_stream(self.device).synchronize()
            bufs_out = host_out.split([sends[p].numel() for p in out_peers])
            bufs_in = host_in.split(sizes_in)
        else:
            bufs_out = [sends[p].contiguous() for p in out_peers]
            bufs_in = [torch.empty(s, dtype=dtype, device=self.device)
                       for s in sizes_in]
        ops = ([dist.P2POp(dist.isend, b, p) for p, b in zip(out_peers,
                                                            bufs_out)]
               + [dist.P2POp(dist.irecv, b, p) for p, b in zip(in_peers,
                                                              bufs_in)])
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if self.staged:
            bufs_in = host_in.to(self.device, non_blocking=True).split(
                sizes_in)
        self.exchanges += 1
        self.bytes_sent += sum(b.numel() for b in bufs_out) * dtype.itemsize
        self.seconds += time.perf_counter() - t0
        return {p: b.reshape(recv_shapes[p]) for p, b in zip(in_peers,
                                                             bufs_in)}

    def all_gather(self, x) -> list:
        """Every rank's `x` (detached, of one shape on every rank) in rank
        order, on this rank's device."""
        src = x.detach().cpu() if self.staged else x.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src)
        return [p.to(x.device) for p in parts]

    def gather_cube(self, x):
        """The whole cube's (..., 6, n, n) compute-domain field from every
        rank's (..., nf, ny, nx) tiles, assembled in face order."""
        f, y, x_ = self.layout
        parts = self.all_gather(x)
        rows = []
        for fb in range(f):
            rows.append(torch.cat([
                torch.cat([parts[self.rank_of(fb, ty, tx)]
                           for tx in range(x_)], -1)
                for ty in range(y)], -2))
        return torch.cat(rows, -3)

    def all_sum(self, *values: float):
        """The sums over the ranks of host floats, in float64, in one
        all_reduce: a float for one value, else a tuple."""
        t = torch.tensor(values, dtype=torch.float64,
                         device=self.device if self.backend == "nccl"
                         else "cpu")
        dist.all_reduce(t)
        out = tuple(float(v) for v in t.tolist())
        return out[0] if len(out) == 1 else out

    def barrier(self):
        dist.barrier()


class FaceTopology:
    """The cube topology on one rank of a decomposition: every NumPy map
    of the whole-cube `topo` (read as they are by the exchange plans),
    the per-face corner maps cut to the rank's tile, the `FaceGroup`, the
    `Tile`, and the exchange plans built per map on first use."""

    def __init__(self, topo, faces: FaceGroup):
        self._topo = topo
        self.faces = faces
        self.tile = faces.tile(topo.n)
        self.plans = {}

    def __getattr__(self, name):
        if name == "_topo":
            raise AttributeError(name)
        return getattr(self._topo, name)

    def _window(self, key, maps):
        """A per-face (J, I) corner map (or a vector pair of them) cut to
        this rank's tile window, sources renumbered within the window; a
        window with no corner region gets identity maps.  Kept for the
        life of the process, as the topology's own maps are (the halo
        layer caches by their identity)."""
        key = (key, id(self._topo), self.tile)
        hit = _CUT_CACHE.get(key)
        if hit is None:
            hit = (_cut_map(maps, self.tile, self.n) if isinstance(
                maps, np.ndarray) else tuple(
                    _cut_pair(m, o, self.tile, self.n)
                    for m, o in zip(maps, maps[::-1])))
            _CUT_CACHE[key] = hit
        return hit

    def copy_corners_map(self, dir_):
        return self._window(("cc", dir_), self._topo.copy_corners_map(dir_))

    def fill_corners_bgrid_map(self, dir_):
        return self._window(("fb", dir_),
                            self._topo.fill_corners_bgrid_map(dir_))

    def fill_corners_agrid_scalar_map(self, dir_):
        return self._window(("fa", dir_),
                            self._topo.fill_corners_agrid_scalar_map(dir_))

    def fill_corners_dgrid_maps(self, vector=True):
        return self._window(("fd", vector),
                            self._topo.fill_corners_dgrid_maps(vector))

    def fill_corners_cgrid_maps(self, vector=True):
        return self._window(("fc", vector),
                            self._topo.fill_corners_cgrid_maps(vector))

    def fill_corners_agrid_maps(self, vector=True):
        return self._window(("fv", vector),
                            self._topo.fill_corners_agrid_maps(vector))


#: corner maps cut to tiles, by (map, topology, tile)
_CUT_CACHE: dict = {}


def _win(tile, shape, n):
    """The rows and columns of a face's padded (J, I) array that `tile`'s
    window covers (its cells, the staggered line, NG halo each side)."""
    J, I = shape
    jt = tile.ny + (J - n)
    it = tile.nx + (I - n)
    return slice(tile.j0, tile.j0 + jt), slice(tile.i0, tile.i0 + it)


def _renumber(src, shape, tile, n, where):
    """Flat indices `src` of a face's (J, I) array as flat indices of the
    tile's window (raises if one lies outside it)."""
    J, I = shape
    rs, cs = _win(tile, shape, n)
    j, i = np.divmod(src.astype(np.int64), I)
    j, i = j - rs.start, i - cs.start
    jt, it = rs.stop - rs.start, cs.stop - cs.start
    bad = where & ((j < 0) | (j >= jt) | (i < 0) | (i >= it))
    if bad.any():
        raise ValueError("a corner fill reads outside the tile's window")
    return np.where(where, j * it + i, 0)


def _cut_map(m, tile, n):
    """A per-face scalar map cut to the tile's window."""
    if tile.whole:
        return m
    rs, cs = _win(tile, m.shape, n)
    sub = np.asarray(m)[rs, cs].astype(np.int64)
    J, I = m.shape
    ident = np.arange(m.size).reshape(m.shape)[rs, cs]
    moved = sub != ident
    local = np.arange(sub.size).reshape(sub.shape)
    return np.where(moved, _renumber(sub, (J, I), tile, n, moved),
                    local).astype(np.int32)


def _cut_pair(m, other, tile, n):
    """One component of a per-face vector map cut to the tile's window;
    `other` is the other component's map (for its shape)."""
    if tile.whole:
        return m
    shape = m["idx_same"].shape
    rs, cs = _win(tile, shape, n)
    same = np.asarray(m["idx_same"])[rs, cs].astype(np.int64)
    ident = np.arange(int(np.prod(shape))).reshape(shape)[rs, cs]
    fo = np.asarray(m["from_other"])[rs, cs]
    moved = (same != ident) & ~fo
    local = np.arange(same.size).reshape(same.shape)
    oth = np.asarray(m["idx_other"])[rs, cs].astype(np.int64)
    return dict(
        idx_same=np.where(moved, _renumber(same, shape, tile, n, moved),
                          local).astype(np.int32),
        idx_other=_renumber(oth, other["idx_same"].shape, tile, n,
                            fo).astype(np.int32),
        from_other=np.ascontiguousarray(fo),
        sign=np.ascontiguousarray(np.asarray(m["sign"])[rs, cs]))


_EDGE_Y = ("edge_w", "edge_e")      # (6, jb) along a face's rows
_EDGE_X = ("edge_s", "edge_n")      # (6, jb) along a face's columns
_PER_FACE = ("corner_ext_coef",)    # (6, 4, 3)


def window_index(shape, faces, n, tile=None, kind="field"):
    """The index of one rank's block of faces and tile window in a field
    of `shape` (see `_cut`)."""
    tile = tile or faces.tile(n)
    ndim = len(shape)
    ax = _face_axis(ndim) if kind == "field" else 0
    sl = [slice(None)] * ndim
    sl[ax] = slice(faces.face, faces.face + faces.nf)
    if kind == "field":
        J, I = shape[-2:]
        py = 2 * NG if J - n >= 2 * NG else 0
        px = 2 * NG if I - n >= 2 * NG else 0
        rs, cs = _win(tile, (J - py, I - px), n)
        sl[-2] = slice(rs.start, rs.stop + py)
        sl[-1] = slice(cs.start, cs.stop + px)
    elif kind in ("rows", "cols"):
        off = tile.j0 if kind == "rows" else tile.i0
        m = tile.ny if kind == "rows" else tile.nx
        sl[1] = slice(off, off + m + shape[1] - n)
    return tuple(sl)


def _cut(v, faces, tile, n, kind="field"):
    """One field's (numpy or torch) block of faces and tile window:
    `kind` "field" for (..., 6, J, I) with J, I in n + {0, 1} (compute
    domain) or n + 2 NG + {0, 1} (padded), "rows"/"cols" for a (6, J)
    edge line along the rows/columns, "face" for the face block only."""
    return v[window_index(v.shape, faces, n, tile, kind)]


def slice_grid(grid: dict, faces: FaceGroup, tile: Tile = None) -> dict:
    """The grid dict of one rank: every tensor entry cut to its faces and
    its tile's padded window (copied, so the rest is freed), the edge
    factors to the tile's rows or columns; the scalar entries (da_min,
    ...) stay global, as the reference's mp_reduce_min/max make them."""
    n = grid["area"].shape[-1] - 2 * NG
    tile = tile or faces.tile(n)
    out = {}
    for k, v in grid.items():
        if isinstance(v, torch.Tensor):
            kind = ("rows" if k in _EDGE_Y else "cols" if k in _EDGE_X
                    else "face" if k in _PER_FACE else "field")
            ax = _face_axis(v.dim()) if kind == "field" else 0
            if v.shape[ax] != NFACES:
                raise ValueError(f"grid entry {k} of shape {tuple(v.shape)} "
                                 "has no face axis of 6")
            v = _cut(v, faces, tile, n, kind).clone()
        out[k] = v
    out["tile"] = tile
    return out


def split_faces(state: dict, faces: FaceGroup, n: int = None) -> dict:
    """One rank's part of a whole-cube state dict of tensors or arrays
    (3-D fields (npz, 6, ...), 2-D fields (6, ...)) on faces of `n`
    cells (by default the fewest columns of a field: the dict is of
    compute-domain fields): its faces, and of each its tile, the shared
    staggered lines included; a padded field (NG halo) keeps the halo
    around the tile."""
    if n is None:
        n = min(v.shape[-1] for v in state.values())
    tile = faces.tile(n)
    out = {}
    for k, v in state.items():
        v = _cut(v, faces, tile, n)
        out[k] = v.clone() if isinstance(v, torch.Tensor) else \
            np.ascontiguousarray(v)
    return out


def join_faces(parts: list) -> dict:
    """The whole-cube state from every rank's part (dicts of tensors or
    arrays of compute-domain fields, in rank order); a line two tiles
    share is taken from either (they hold it bitwise equal).  A field
    with a row (column) more than the part's fewest is staggered along
    y (x)."""
    f, y, x = layout(len(parts))
    nf = NFACES // f
    cy = min(v.shape[-2] for v in parts[0].values())
    cx = min(v.shape[-1] for v in parts[0].values())
    out = {}
    for k, v0 in parts[0].items():
        ax = _face_axis(v0.ndim)
        ny, nx = v0.shape[-2:]
        shape = list(v0.shape)
        shape[ax] = NFACES
        shape[-2] = cy * y + ny - cy
        shape[-1] = cx * x + nx - cx
        whole = (v0.new_empty(shape) if isinstance(v0, torch.Tensor)
                 else np.empty(shape, v0.dtype))
        for r, p in enumerate(parts):
            fb, rest = divmod(r, y * x)
            ty, tx = divmod(rest, x)
            sl = [slice(None)] * v0.ndim
            sl[ax] = slice(fb * nf, fb * nf + nf)
            sl[-2] = slice(ty * cy, ty * cy + ny)
            sl[-1] = slice(tx * cx, tx * cx + nx)
            whole[tuple(sl)] = p[k]
        out[k] = whole
    return out


def _child(tmp, rank, world, backend, device, timeout, results):
    """One rank: initialise the process group, run fn(FaceGroup, *args)
    (from tmp/call.pkl), write its pickled result to tmp/<rank>.pkl and
    report to the parent (or report the traceback)."""
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        device = torch.device(device)
        if device.type == "cpu":
            torch.set_num_threads(1)
        elif backend == "nccl":
            device = torch.device("cuda", rank)
        else:
            # gloo: every rank on the one card
            device = torch.device("cuda", device.index or 0)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        # the ranks share this host: gloo connects them over loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
            world_size=world, rank=rank, timeout=timedelta(seconds=timeout))
        try:
            out = fn(FaceGroup(rank, backend, device, world), *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        results.put((rank, None))
    except Exception:   # the rank's boundary: report, the parent raises
        results.put((rank, traceback.format_exc()))


def run_faces(fn, *args, backend: str = "gloo", device="cuda",
              timeout: float = 300.0, ranks: int = WORLD) -> list:
    """fn(faces, *args) on `ranks` spawned ranks laid out as
    `layout(ranks)` (six: rank r on face r); the results (pickled: keep
    them on the host) in rank order.  `device` is
    "cpu" (one thread a rank) or "cuda" (with gloo all ranks share one
    card; with nccl rank r takes card r).  The ranks meet by a `file://`
    rendezvous in a temporary directory, which also carries the call and
    the results (a spawned rank reads its arguments only once it has
    imported the parent's main module, so arguments sent down its pipe
    would start the ranks one after another).  A rank's exception is
    raised here with its traceback; past `timeout` seconds every rank
    still running is killed and TimeoutError raised.  fn must be
    importable by name (a spawned rank imports it afresh)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        results = ctx.Queue()
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(tmp, r, ranks, backend, str(device),
                                   timeout, results))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        try:
            done = set()
            while len(done) < ranks:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"run_faces({fn.__name__}): ranks "
                        f"{sorted(set(range(ranks)) - done)} still running "
                        f"after {timeout} s; killed")
                try:
                    rank, error = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"run_faces({fn.__name__}): rank {dead[0]} "
                            f"exited with code {procs[dead[0]].exitcode} "
                            "without a result")
                    continue
                if error is not None:
                    raise RuntimeError(f"run_faces({fn.__name__}): rank "
                                       f"{rank} failed:\n{error}")
                done.add(rank)
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
            out = []
            for r in range(ranks):
                with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(5.0)
