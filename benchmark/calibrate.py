"""The readings the limits of `correct` are set from, at a cell's own
size, in one process:

    python3 benchmark/calibrate.py --workload <name> --seeds <n> ... \
        [--control-seeds <n> ...] [--out <file>]

* For each of `--seeds`: the program's judged pair of a run with that
  seed (the same inputs and pair index as `run.py`), judged by the
  reference: the lower readings.  Beside it, what three faults would read
  on the same tensors: the TL returning its input unchanged, the AD
  returning its input unchanged, and one level of the TL's t doubled.
* For each of `--control-seeds`: each control of `control.py` in the
  program's place (its own trajectory step, linearization, TL and AD),
  judged by the float32 reference: the upper readings.

Prints one JSON line a seed and writes them all to `--out`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", nargs="*", default=None,
                    help="the controls to read (default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE.parent))
    sys.path.insert(0, str(HERE))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import compare
    import generator
    from control import CONTROLS, ReferenceProgram
    import harness
    import reference

    bench = harness.load_benchmark(HERE.parent)
    cell = harness.find(bench["workloads"], args.workload, "workload")
    conf = harness.load_config(HERE, cell["config"])
    traffic = harness.load_traffic(HERE, cell["traffic"])
    dev = args.device
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    nl_steps = int(conf["trajectory"].get("nl_steps", 0))
    ref = reference.Reference(conf, dev)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.seeds:
        prog = harness.Program(conf, dev)
        for seed in args.seeds:
            t0 = time.perf_counter()
            check = generator.checked_pair(traffic, seed)
            trajs = harness.stepped_trajectories(prog, conf, traffic, seed,
                                                 dev)
            perts = generator.perturbations(conf, traffic, seed,
                                            prog.dtype, dev)
            traj = trajs[check % len(trajs)]
            tl = prog.step_tl(traj, perts[(check + 1) % len(perts)])
            ad = prog.step_ad(traj, tl)
            prog.lm._traj_cache.clear()
            del perts
            got = {}
            gaps = harness.reference_gaps(
                conf, traffic, seed, dev, check, dict(tl=tl, ad=ad),
                trajs if nl_steps else None, log, ref=ref, out=got)
            keys = ref.prog_3d
            bent = dict(tl, t=tl["t"].clone())
            bent["t"][tl["t"].shape[0] // 2] *= 2.0
            faults = dict(
                tl_unchanged=compare.worst_gap(got["pert"], got["tl"], keys),
                ad_unchanged=compare.worst_gap(tl, got["ad"], keys),
                tl_level_doubled=compare.worst_gap(bent, got["tl"], keys))
            emit(dict(kind="program", seed=seed, check=check, gaps=gaps,
                      faults=faults, s=time.perf_counter() - t0))
            del tl, ad, bent, got, trajs
        prog.close()
        del prog
    kinds = CONTROLS if args.controls is None else args.controls
    for kind in kinds if args.control_seeds else ():
        ctl = ReferenceProgram(conf, dev, kind)
        for seed in args.control_seeds:
            t0 = time.perf_counter()
            check = generator.checked_pair(traffic, seed)
            trajs = harness.stepped_trajectories(ctl, conf, traffic, seed,
                                                 dev)
            perts = generator.perturbations(conf, traffic, seed, ctl.dtype,
                                            dev)
            traj = trajs[check % len(trajs)]
            tl = ctl.step_tl(traj, perts[(check + 1) % len(perts)])
            ad = ctl.step_ad(traj, tl)
            ctl.close()
            del perts
            gaps = harness.reference_gaps(
                conf, traffic, seed, dev, check, dict(tl=tl, ad=ad),
                trajs if nl_steps else None, log, ref=ref)
            emit(dict(kind="control_" + kind, seed=seed, check=check,
                      gaps=gaps, s=time.perf_counter() - t0))
            del tl, ad, trajs
        del ctl
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(workload=args.workload, rows=rows,
                           device=torch.cuda.get_device_name(0)
                           if dev == "cuda" else "cpu"), f, indent=1)


if __name__ == "__main__":
    main()
