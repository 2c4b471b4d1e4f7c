"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the result as the last line of
standard output, one JSON object, and each compared number beside its
limit as the last lines of standard error.  Exits 2 without a result when
the checkout has no program, 3 when the host has no card (or fewer than
the cell asks for), 4 when JAX or the JAX package was loaded, 1 on any
other failure.  BENCHMARK.json and `harness.py` say what a run does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment():
    """Every build and kernel cache at a fixed path inside the checkout;
    one CPU thread for the host's own operations (the card does the
    work; the host's cores are shared)."""
    os.environ["OMP_NUM_THREADS"] = "1"
    base = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    err = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731

    import torch
    import harness

    torch.set_num_threads(1)

    bench = harness.load_benchmark(ROOT)
    chips = harness.find(bench["workloads"], args.workload,
                         "workload")["chips"]
    if importlib.util.find_spec("fv3jedi_lm_tpu_torch") is None:
        err("the program (fv3jedi_lm_tpu_torch) is not in this checkout")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        err(f"this cell needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        result, lines = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            root=ROOT, t_start=T_START)
    except Exception:
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules()
    if bad:
        err(f"loaded in this process: {', '.join(bad)}")
        return 4
    print(json.dumps(result), flush=True)
    for line in lines:
        err(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
