"""Growth of the port's tangent linear over a few steps.

    python scripts/torch_tl_growth.py [--npx 25] [--steps 3] [--device cpu]
        [--dtype float32] [--production-sponge] [--options]

From `chip_smoke._bench_case`'s trajectory and perturbation (rest plus
2 K of white noise on t, a 1e-3 white-noise perturbation, seed 0), at
chip_smoke.TLAD_FULL_KW with `npx` in place of 97 (c96L72's other
settings), prints max|u| of the TL after each step: p_{n+1} = M(x_n) p_n
with x_{n+1} the nonlinear step.  `--production-sponge` takes the
perturbation sponge of chip_smoke.WINDOW_KW (d2_bg_k1/k2/ks_pert 0.2,
0.12, 0.06) in place of the DynConfig defaults (4, 2, 2); `--options`
adds chip_smoke.PRODUCTION_OPTIONS.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig  # noqa: E402
from fv3jedi_lm_tpu_torch.lm import LinearModel  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--npx", type=int, default=25)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--production-sponge", action="store_true")
    ap.add_argument("--options", action="store_true")
    a = ap.parse_args()
    base = chip_smoke.WINDOW_KW if a.production_sponge else \
        chip_smoke.TLAD_FULL_KW
    kw = dict(base, npx=a.npx, npy=a.npx, dtype=a.dtype)
    if a.options:
        kw.update(chip_smoke.PRODUCTION_OPTIONS)
    lm = LinearModel.create(LMConfig(dyn=DynConfig(**kw), dt=900.0),
                            device=a.device)
    tr, p = chip_smoke._bench_case(lm)
    tr = {k: v.to(lm.dtype) for k, v in tr.items()}
    p = {k: v.to(lm.dtype) for k, v in p.items()}
    d = lm.cfg.dyn
    print(f"c{a.npx - 1}L{d.npz} {a.dtype} {a.device} pert sponge "
          f"{d.d2_bg_k1_pert}/{d.d2_bg_k2_pert}/{d.d2_bg_ks_pert} "
          f"options {a.options}: max|p u| "
          f"{float(p['u'].abs().max()):.3e}", flush=True)
    for n in range(a.steps):
        p = lm.step_tl(tr, p)
        tr = lm.step_nl(tr)
        print(f"  after step {n + 1}: max|TL u| "
              f"{float(p['u'].abs().max()):.3e}", flush=True)


if __name__ == "__main__":
    main()
