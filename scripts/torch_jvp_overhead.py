"""Host cost of forward-mode AD in PyTorch, per operation and for the moist
physics' tangent linear.

    python scripts/torch_jvp_overhead.py [--device cuda|cpu]

Prints, for tensors of 100 elements, the time of one `torch.func.jvp` of
`x * y` (y a constant tensor), `x * 2.0`, `exp(x)` and of the plain
operations; then, at the c8L12 float64 physics configuration of
chip_smoke.py (tests/test_moist.py's trajectory), the time of the moist
step replayed without a derivative, of its tangent linear by a plain
`torch.func.jvp`, and of `Moist.apply_tl`'s jvp, which routes arithmetic
with numbers to the Scalar overloads and gives the trajectory tensors zero
tangents (physics/moist.py `_jvp`).  Each time is the median of repeated
calls, each ending in a device synchronisation.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))


def _median_s(fn, sync, reps):
    fn()
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    import chip_smoke
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.core import freeze
    from fv3jedi_lm_tpu_torch.lm import LinearModel
    from fv3jedi_lm_tpu_torch.physics.moist import _jvp

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)
    print(f"torch {torch.__version__}", flush=True)

    x = torch.rand(100, device=dev)
    y = torch.rand(100, device=dev)
    for name, f in (("x * y", lambda a: a * y), ("x * 2.0", lambda a: a * 2.0),
                    ("exp(x)", torch.exp)):
        jv = _median_s(lambda: torch.func.jvp(f, (x,), (x,)), sync, 300)
        pl = _median_s(lambda: f(x), sync, 300)
        print(f"[op] {name}: jvp {1e6 * jv:.1f} us, plain {1e6 * pl:.1f} us",
              flush=True)

    cfg = LMConfig(dyn=DynConfig(**chip_smoke.PHYS_SMALL_KW), dt=450.0,
                   do_phy_mst=1)
    lm = LinearModel.create(cfg, device=dev, ak=chip_smoke.PHYS_AK,
                            bk=chip_smoke.PHYS_BK)
    tr = chip_smoke.phys_small_traj(lm)
    ltraj, tape = lm._ckpts(tr)[2]
    m = lm._moist
    x0 = m._x0(ltraj)
    dx = m._marshal_in(ltraj, chip_smoke.rand_pert(lm, 1))
    dx = {k: dx[k] for k in x0}

    def plain():
        with torch.no_grad(), freeze.replaying(tape):
            m._moist_step(ltraj, x0)

    def jvp_plain():
        with freeze.replaying(tape):
            torch.func.jvp(lambda a: m._moist_step(ltraj, a), (x0,), (dx,))

    def jvp_routed():
        _jvp(lambda a, c: m._moist_step(c, a), (x0,), (dx,), ltraj,
             tape=tape)

    for name, fn in (("replayed, no derivative", plain),
                     ("tangent linear, plain torch.func.jvp", jvp_plain),
                     ("tangent linear, Moist.apply_tl's _jvp", jvp_routed)):
        print(f"[moist c8L12] {name}: {_median_s(fn, sync, 5):.4f} s",
              flush=True)


if __name__ == "__main__":
    main()
