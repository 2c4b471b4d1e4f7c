"""One cube face per rank: the process group, the transport of the halo
strips, and the carrying of grids and states onto the ranks and back.

The reference's minimal distributed layout is six tiles of one rank each
(tools/fv_mp_nlm_mod.F90:285-600): rank r owns face r, computes on its
own (npz, 1, jy, jx) fields, and every cross-face halo arrives from the
neighbouring face's rank by a point-to-point send.  This module holds the
rank's side of that:

* `FaceGroup` — this rank's face, its process group and backend, and the
  transport that follows from the backend: NCCL sends device tensors;
  gloo sends CPU tensors only, so with gloo a CUDA rank copies its strips
  to pinned host memory and back.  One host has one card here and NCCL
  refuses two ranks on one card, so on the card the six ranks share it
  with gloo.  The transport is chosen from the backend, never by catching
  a failure.  The NCCL transport (rank r on card r, device tensors sent
  as they are) is written but has never run: it needs a host with six
  cards.  It counts its exchanges, the bytes it sends and the host
  seconds spent inside them.
* `FaceTopology` — the cube topology as one face's rank sees it: the same
  NumPy maps, plus the `FaceGroup` (the halo layer dispatches on it) and
  the per-rank exchange plans built from those maps.
* `slice_grid`, `split_faces`, `join_faces` — a whole-cube grid or state
  to one face and back.
* `run_faces` — spawn the six ranks, run a function on each, return the
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

#: the ranks of a face decomposition: one per cube face
WORLD = 6


def _face_axis(ndim: int) -> int:
    """The face axis of a field of `ndim` dims: 1 for (k, 6, jy, jx)
    (3-D fields, the grid's (3|9, 6, jy, jx) vectors), else 0 ((6, jy,
    jx), (6, jb), (6, 4, 3))."""
    return 1 if ndim == 4 else 0


@dataclass(eq=False)
class FaceGroup:
    """This rank's face of a six-rank decomposition (rank r = face r) in
    the default process group, which `run_faces` (or the caller) has
    initialised.  `device` is where the rank computes.  With "nccl" the
    strips go from card to card without staging; that branch is untested
    (no host here has six cards)."""

    rank: int
    backend: str
    device: torch.device
    #: exchanges issued, bytes sent by them, host seconds inside them
    exchanges: int = 0
    bytes_sent: int = 0
    seconds: float = 0.0

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl backend sends CUDA tensors only")
        # gloo sends CPU tensors only: a CUDA rank stages through host memory
        self.staged = self.backend == "gloo" and self.device.type == "cuda"

    @property
    def face(self) -> int:
        return self.rank

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

    def all_gather(self, x, axis: int):
        """The six ranks' `x` joined along `axis` in face order."""
        src = x.detach().cpu() if self.staged else x.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(WORLD)]
        dist.all_gather(parts, src)
        return torch.cat(parts, axis).to(x.device)

    def all_sum(self, value: float) -> float:
        """The sum over the ranks of a host float, in float64."""
        t = torch.tensor([value], dtype=torch.float64,
                         device=self.device if self.backend == "nccl"
                         else "cpu")
        dist.all_reduce(t)
        return float(t.item())

    def barrier(self):
        dist.barrier()


class FaceTopology:
    """The cube topology on one face's rank: every NumPy map of the
    whole-cube `topo` (read as they are; the per-face corner maps apply
    unchanged), the `FaceGroup`, and the exchange plans built per map on
    first use."""

    def __init__(self, topo, faces: FaceGroup):
        self._topo = topo
        self.faces = faces
        self.plans = {}

    def __getattr__(self, name):
        if name == "_topo":
            raise AttributeError(name)
        return getattr(self._topo, name)


def slice_grid(grid: dict, face: int) -> dict:
    """The grid dict of one face: every tensor entry, each with a face
    axis of 6, cut to [face:face+1] (copied, so the other faces' memory is
    freed); the scalar entries (da_min, ...) stay global, as the
    reference's mp_reduce_min/max make them."""
    out = {}
    for k, v in grid.items():
        if isinstance(v, torch.Tensor):
            ax = _face_axis(v.dim())
            if v.shape[ax] != WORLD:
                raise ValueError(f"grid entry {k} of shape {tuple(v.shape)} "
                                 "has no face axis of 6")
            v = v.narrow(ax, face, 1).clone()
        out[k] = v
    return out


def split_faces(state: dict, face: int) -> dict:
    """One face of a whole-cube state dict of tensors or arrays (3-D
    fields (npz, 6, ...), 2-D fields (6, ...))."""
    out = {}
    for k, v in state.items():
        ax = _face_axis(v.ndim)
        sl = (slice(None),) * ax + (slice(face, face + 1),)
        out[k] = v[sl].clone() if isinstance(v, torch.Tensor) else \
            np.ascontiguousarray(v[sl])
    return out


def join_faces(parts: list) -> dict:
    """The whole-cube state from the six ranks' face states (dicts of
    tensors or arrays, in face order)."""
    out = {}
    for k, v in parts[0].items():
        ax = _face_axis(v.ndim)
        if isinstance(v, torch.Tensor):
            out[k] = torch.cat([p[k] for p in parts], ax)
        else:
            out[k] = np.concatenate([p[k] for p in parts], ax)
    return out


def _child(tmp, rank, backend, device, timeout, results):
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
            world_size=WORLD, rank=rank, timeout=timedelta(seconds=timeout))
        try:
            out = fn(FaceGroup(rank, backend, device), *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        results.put((rank, None))
    except Exception:   # the rank's boundary: report, the parent raises
        results.put((rank, traceback.format_exc()))


def run_faces(fn, *args, backend: str = "gloo", device="cuda",
              timeout: float = 300.0) -> list:
    """fn(faces, *args) on six spawned ranks, rank r on face r; the
    results (pickled: keep them on the host) in rank order.  `device` is
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
                             args=(tmp, r, backend, str(device), timeout,
                                   results))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        try:
            done = set()
            while len(done) < WORLD:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"run_faces({fn.__name__}): ranks "
                        f"{sorted(set(range(WORLD)) - done)} still running "
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
            for r in range(WORLD):
                with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(5.0)
