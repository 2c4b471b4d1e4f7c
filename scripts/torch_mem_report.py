"""Bytes of the port's cached linearization, stage by stage.

    python scripts/torch_mem_report.py [--npx 97] [--npz 72] [--phys]
        [--nh] [--options] [--device cuda|cpu] [--dtype float32]

The port's analogue of scripts/mem_report.py (the reference's adStack
byte counters, adStack.c:28-31, and tapenade_iter's checkpoint memory
report, tapenade_iter.F90:520-850).  At chip_smoke.TLAD_FULL_KW with the
given npx/npz (c96L72 hydrostatic float32 by default; `--nh`
nonhydrostatic; `--options` the window's configuration,
chip_smoke.WINDOW_KW with chip_smoke.PRODUCTION_OPTIONS), on chip_smoke._bench_case's trajectory (with `--phys` the
turbulence and moist mode 1 on chip_smoke._phys_full_case's convective
sounding), it fills the trajectory cache with one step_tl + step_ad and
prints the exact bytes that cache holds for each stage (a tensor two
stages share counted once, for the first listed): the checkpoints
(prep: the state entering each pre stage; substep: each acoustic
substep's pruned input carry; post: each remap's input carry), the
branch tapes split into bit-packed boolean decisions (with the number
of decisions they hold, the bytes they took unpacked) and integer
decisions (substep stages a, b and c, post), the moist pack (its ltraj
and its tape) and the turbulence coefficients.  On the card it also
prints torch.cuda.memory_stats()'s peak of allocated bytes in each sweep
(the trajectory's forward, its record, the physics linearizations,
step_tl, step_ad).  Every count comes from the tensors themselves
(fv3jedi_lm_tpu_torch.debug), not from a model of them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from fv3jedi_lm_tpu_torch import debug  # noqa: E402
from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig  # noqa: E402
from fv3jedi_lm_tpu_torch.core import freeze  # noqa: E402
from fv3jedi_lm_tpu_torch.lm import LinearModel  # noqa: E402


def _gib(n):
    return f"{n:14d} B {n / 2**30:9.4f} GiB"


class _Peaks:
    """Peak allocated device bytes of named calls (nothing on the CPU)."""

    def __init__(self, cuda):
        self.cuda = cuda
        self.peaks = {}

    def wrap(self, name, fn):
        def run(*args, **kw):
            if not self.cuda:
                return fn(*args, **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.peaks[name] = torch.cuda.memory_stats()[
                "allocated_bytes.all.peak"]
            return out
        return run


def _decisions(tapes, seen):
    """Boolean decisions a list of tapes holds (packed or raw), an entry
    the list holds twice counted once (`seen`: the ids met)."""
    n = 0
    for e, _ in freeze.leaves(tapes):
        if id(e) not in seen:
            seen.add(id(e))
            n += (e.decisions if isinstance(e, freeze.Packed)
                  else e.numel() if e.dtype == torch.bool else 0)
    return n


def report(npx, npz, phys, nh, options, device, dtype):
    base = (dict(chip_smoke.WINDOW_KW, **chip_smoke.PRODUCTION_OPTIONS)
            if options else chip_smoke.TLAD_FULL_KW)
    kw = dict(base, npx=npx, npy=npx, npz=npz, dtype=dtype,
              hydrostatic=not nh)
    cfg = LMConfig(dyn=DynConfig(**kw), dt=chip_smoke.FULL_DT,
                   do_phy_trb=phys, do_phy_mst=1 if phys else 0)
    lm = LinearModel.create(cfg, device=device)
    if phys:
        traj, pert = chip_smoke._phys_full_case(lm)
    else:
        traj, pert = chip_smoke._bench_case(lm)
    peaks = _Peaks(lm.device.type == "cuda")
    stepper = lm._staged()
    stepper.forward = peaks.wrap("forward", stepper.forward)
    stepper.record = peaks.wrap("record", stepper.record)
    if phys:
        lm._physics_nl = peaks.wrap("physics linearizations",
                                    lm._physics_nl)
    t0 = time.perf_counter()
    tl = peaks.wrap("step_tl", lm.step_tl)(traj, pert)
    peaks.wrap("step_ad", lm.step_ad)(traj, tl)
    seconds = time.perf_counter() - t0
    del stepper.forward, stepper.record
    if phys:
        del lm._physics_nl

    (_, (cks, tapes, mpack, ltraj)), = lm._traj_cache.values()
    seen = set()        # a tensor two stages share counts for the first
    ckb = lambda tree: debug.tree_bytes(tree, seen)
    counted = set()
    tpb = lambda tree: (debug.tape_bytes(tree, seen)
                        + (_decisions(tree, counted),))
    none = (0, 0, 0)
    rows = [("prep (pre stage inputs)", len(cks["pre_in"]),
             ckb(cks["pre_in"]), none)]
    n_sub = sum(len(c) for c in cks["carries"])
    rows.append(("substep input carries", n_sub, ckb(cks["carries"]),
                 none))
    rows.append(("post (remap input carries)", len(cks["carry_fin"]),
                 ckb(cks["carry_fin"]), tpb(tapes["post"])))
    for i, name in enumerate(("a", "b", "c")):
        stage = [t3[i] for sub in tapes["sub"] for t3 in sub]
        rows.append((f"substep stage {name}", len(stage), 0, tpb(stage)))
    if mpack is not None:
        rows.append(("moist pack (ltraj, tape)", 1, ckb(mpack[0]),
                     tpb(mpack[1])))
    if ltraj is not None:
        rows.append(("turbulence ltraj", 1, ckb(ltraj), none))

    what = (f"c{cfg.dyn.nx}L{npz} {'NH' if nh else 'hydrostatic'} {dtype} "
            f"n_split={cfg.dyn.n_split} k_split={cfg.dyn.k_split}"
            f"{' with the production options' if options else ''}"
            f"{' + turbulence + moist mode 1' if phys else ''} on "
            f"{lm.device}")
    if lm.device.type == "cuda":
        what += f" ({' '.join(chip_smoke._card()[1:])})"
    print(f"# torch_mem_report: {what}; one step_tl + step_ad "
          f"{seconds:.3f} s")
    print(f"{'stage':<28}{'count':>6}  {'checkpoints':>29}  "
          f"{'bool tapes (packed)':>29}  {'decisions':>14}  "
          f"{'integer tapes':>29}")
    tot = [0, 0, 0, 0]
    for name, count, ck, (nb, ni, nd) in rows:
        print(f"{name:<28}{count:>6}  {_gib(ck)}  {_gib(nb)}  {nd:>14d}  "
              f"{_gib(ni)}")
        tot = [tot[0] + ck, tot[1] + nb, tot[2] + ni, tot[3] + nd]
    print(f"{'total':<28}{'':>6}  {_gib(tot[0])}  {_gib(tot[1])}  "
          f"{tot[3]:>14d}  {_gib(tot[2])}")
    c, = debug.cache_bytes(lm)
    if c.total != sum(tot[:3]):
        raise AssertionError(f"the stages' bytes {sum(tot[:3])} are not "
                             f"the cache's {c.total}")
    tapes_now = tot[1] + tot[2]
    tapes_raw = tot[3] + tot[2]
    print(f"cached trajectory: {_gib(c.total)}, tapes {_gib(tapes_now)} "
          f"({100 * tapes_now / c.total:.1f} % of it); the same decisions "
          f"unpacked would take {_gib(tapes_raw)} of tapes (packed / "
          f"unpacked {tapes_now / max(tapes_raw, 1):.4f})")
    for name, peak in peaks.peaks.items():
        print(f"peak allocated in {name:<24}{_gib(peak)}")
    return rows, peaks.peaks


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--npx", type=int, default=97)
    ap.add_argument("--npz", type=int, default=72)
    ap.add_argument("--phys", action="store_true")
    ap.add_argument("--nh", action="store_true")
    ap.add_argument("--options", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32")
    a = ap.parse_args()
    report(a.npx, a.npz, a.phys, a.nh, a.options, a.device, a.dtype)


if __name__ == "__main__":
    main()
