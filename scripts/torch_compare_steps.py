"""The port's c96L72 NH step on the GPU, for one or more checkouts in turn.

Usage (on a CUDA host):
    python scripts/torch_compare_steps.py ROOT [ROOT ...] [--nt N] [--memory]
        [--pair]

For each ROOT (a checkout of the repo) in the order given, a fresh process
imports that checkout's `fv3jedi_lm_tpu_torch` and `chip_smoke`, and runs
`LinearModel.step_nl` N times (default 3) at chip_smoke.py's c96L72
NH float32 configuration from its bump-and-humidity state, timing each
step to a `torch.cuda.synchronize()`; it prints the step seconds and the
peak device memory, one line per ROOT.  Pass the roots as parent, change,
change, parent to compare two commits on one card.

With --pair, each ROOT times the main path instead: a first c96L72
hydrostatic step_tl + step_ad pair (chip_smoke.TLAD_FULL_KW on
chip_smoke._bench_case's trajectory and perturbation, which also makes
the trajectory's checkpoints and tapes), then N pairs, each to a
`torch.cuda.synchronize()`, and the peak device memory.

With --memory, one more step runs under the CUDA caching allocator's
history, and the live bytes of that step at its peak are printed grouped
by the port's innermost frames (where the peak is allocated).
"""

from __future__ import annotations

import subprocess
import sys

_CHILD = r"""
import collections, sys, time
root, nt, memory = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1"
sys.path.insert(0, root)
import torch
import chip_smoke as cs
from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
from fv3jedi_lm_tpu_torch.lm import LinearModel

if sys.argv[4] == "1":
    lm = LinearModel.create(LMConfig(dyn=DynConfig(**cs.TLAD_FULL_KW),
                                     dt=cs.FULL_DT))
    traj, pert = cs._bench_case(lm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(nt + 1):
        t0 = time.perf_counter()
        lm.step_ad(traj, lm.step_tl(traj, pert))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{root}: first pair {times[0]:.4f} s, then pairs "
          + ", ".join(f"{t:.4f}" for t in times[1:])
          + f" s; peak {peak:.3f} GiB", flush=True)
    sys.exit(0)

lm = LinearModel.create(LMConfig(dyn=DynConfig(**cs.FULL_KW), dt=cs.FULL_DT))
tr = lm.rest_traj()
tr["t"] = tr["t"] + cs._bump(lm)
tr = cs._moisten(lm, tr)
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
times = []
for _ in range(nt):
    t0 = time.perf_counter()
    tr = lm.step_nl(tr)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
peak = torch.cuda.max_memory_allocated() / 2**30
print(f"{root}: step_nl s " + ", ".join(f"{t:.4f}" for t in times)
      + f"; peak {peak:.3f} GiB", flush=True)
if memory:
    torch.cuda.memory._record_memory_history(max_entries=3000000,
                                             stacks="python")
    lm.step_nl(tr)
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    live, cur, best = {}, 0, (0, {})
    for e in snap["device_traces"][0]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
            if cur > best[0]:
                best = (cur, dict(live))
        elif e["action"] == "free_completed":
            f = live.pop(e["addr"], None)
            if f is not None:
                cur -= f["size"]
    groups = collections.Counter()
    for e in best[1].values():
        fr = [f for f in e["frames"]
              if "fv3jedi_lm_tpu_torch" in f["filename"]]
        key = " <- ".join(f"{f['filename'].split('/')[-1]}:{f['line']} "
                          f"{f['name']}" for f in fr[:3]) or "?"
        groups[key] += e["size"]
    print(f"{root}: the step's live allocations at its peak "
          f"{best[0] / 2**30:.3f} GiB", flush=True)
    for k, v in groups.most_common(12):
        print(f"  {v / 2**20:9.1f} MiB  {k}", flush=True)
"""


def main(argv):
    nt, memory, pair, roots = 3, False, False, []
    it = iter(argv)
    for a in it:
        if a == "--nt":
            nt = int(next(it))
        elif a == "--memory":
            memory = True
        elif a == "--pair":
            pair = True
        else:
            roots.append(a)
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        r = subprocess.run([sys.executable, "-c", _CHILD, root, str(nt),
                            "1" if memory else "0", "1" if pair else "0"])
        if r.returncode != 0:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
