"""One run of one cell: set-up, the measured window, the reference's
judgement, the result line.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file found by its name in `BENCHMARK.json`:

* `configs/<config>.json`: the model's sizes and options, its trajectory
  recipe, its operation count per pair;
* `traffic/<mix>.json`: how many trajectories and perturbations a run
  cycles through and which pair the reference judges, read by the one
  generator (`generator.py`);
* `limits/<workload>.json`: the cell's limit on each compared number;
* `metrics/<metric>.py`: a reader `read(ctx)` of one metric, end-to-end or
  per-layer, that returns a number or None (the metric is then left out).

The system under test is reached through `Program` (the port's
`LinearModel`); tests and the control put another object with the same
methods in its place.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

import compare
import generator
import peaks
import trace

HERE = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run (compared whole:
#: the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "fv3jedi_lm_tpu")


# -- loading by name -----------------------------------------------------------

def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root):
    return load_json(Path(root) / "BENCHMARK.json")


def find(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(bench_dir, name):
    return load_json(Path(bench_dir) / "configs" / f"{name}.json")


def load_traffic(bench_dir, name):
    return load_json(Path(bench_dir) / "traffic" / f"{name}.json")


def load_limits(bench_dir, workload):
    path = Path(bench_dir) / "limits" / f"{workload}.json"
    return load_json(path)["limits"] if path.exists() else {}


def load_reader(bench_dir, metric):
    """The `read` function of metrics/<metric>.py."""
    path = Path(bench_dir) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench, workload, kind):
    """The metrics of `kind` ("end_to_end" or "per_layer") this cell
    reports, in BENCHMARK.json's order."""
    return [m["name"] for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


# -- the system under test -----------------------------------------------------

class Program:
    """The port's LinearModel for a configuration file's `model` block."""

    def __init__(self, conf, device):
        from fv3jedi_lm_tpu_torch import debug, timing
        from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
        from fv3jedi_lm_tpu_torch.lm import LinearModel

        m = conf["model"]
        cfg = LMConfig(dyn=DynConfig(**m["dyn"]), dt=float(m["dt"]),
                       do_phy_trb=bool(m.get("do_phy_trb", False)),
                       do_phy_mst=int(m.get("do_phy_mst", 0)))
        ak = bk = None
        if "ak" in m:
            ak, bk = generator.ak_bk(conf)
        self.lm = LinearModel.create(cfg, device=device, ak=ak, bk=bk)
        self.dtype = self.lm.dtype
        self.timing = timing
        self._debug = debug

    def step_nl(self, traj):
        return self.lm.step_nl(traj)

    def step_tl(self, traj, pert):
        return self.lm.step_tl(traj, pert)

    def step_ad(self, traj, pert):
        return self.lm.step_ad(traj, pert)

    def cached_step_bytes(self):
        """The bytes of the most recent cached step (checkpoints, tapes,
        physics linearization)."""
        c = self._debug.cache_bytes(self.lm)
        return sum(c[-1]) if c else None

    def close(self):
        del self.lm


# -- a run ---------------------------------------------------------------------

def _sync(cuda):
    if cuda:
        torch.cuda.synchronize()


def _nonfinite(*dicts):
    """A device scalar: 1 if any of the dicts' tensors holds a value that
    is not finite, else 0."""
    return (sum((~torch.isfinite(x)).sum() for d in dicts
                for x in d.values()) > 0).long()


def stepped_trajectories(stepper, conf, traffic, seed, device):
    """The traffic's trajectories of `seed`, each after the
    configuration's `nl_steps` steps of `stepper.step_nl`, in the
    stepper's dtype."""
    out = []
    for tr in generator.trajectories(conf, traffic, seed, stepper.dtype,
                                     device):
        for _ in range(int(conf["trajectory"].get("nl_steps", 0))):
            tr = dict(tr, **stepper.step_nl(tr))
        out.append(tr)
    return out


def run_cell(workload, seed, seconds, trace_on, *, root, t_start,
             device="cuda", make_program=Program, log=None):
    """One run; returns (result dict, stderr check lines)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    bench_dir = Path(root) / "benchmark"
    bench = load_benchmark(root)
    cell = find(bench["workloads"], workload, "workload")
    conf = load_config(bench_dir, cell["config"])
    traffic = load_traffic(bench_dir, cell["traffic"])
    limits = load_limits(bench_dir, workload)
    cuda = torch.device(device).type == "cuda"
    ctx = SimpleNamespace(conf=conf, traffic=traffic, peaks=peaks,
                          workload=workload)

    # -- set-up: the model, the inputs, one warm pair ----------------------
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    marks = [("start", time.perf_counter())]
    prog = make_program(conf, device)
    marks.append(("model", time.perf_counter()))
    dtype = prog.dtype
    trajs = stepped_trajectories(prog, conf, traffic, seed, device)
    perts = generator.perturbations(conf, traffic, seed, dtype, device)
    _sync(cuda)
    marks.append(("inputs", time.perf_counter()))
    tl = prog.step_tl(trajs[0], perts[0])
    prog.step_ad(trajs[0], tl)
    del tl
    _sync(cuda)
    marks.append(("first pair", time.perf_counter()))
    # the set-up's objects (grid, inputs, cached linearization) are left
    # out of the cyclic collector's passes in the window
    gc.freeze()
    ctx.setup_s = time.perf_counter() - t_start
    log(f"set-up {ctx.setup_s:.3f} s: imports {marks[0][1] - t_start:.3f}"
        + "".join(f", {b[0]} {b[1] - a[1]:.3f}"
                  for a, b in zip(marks, marks[1:])))

    # -- the window ------------------------------------------------------------
    check = generator.checked_pair(traffic, seed)
    bad = torch.zeros((), dtype=torch.int64, device=device)
    kept = {}

    def pair(i):
        nonlocal bad
        traj = trajs[i % len(trajs)]
        tl = prog.step_tl(traj, perts[(i + 1) % len(perts)])
        ad = prog.step_ad(traj, tl)
        bad = bad + _nonfinite(tl, ad)
        if i == check:
            kept.update(tl=tl, ad=ad)

    if not trace_on:
        n = 0
        t0 = time.perf_counter()
        # pairs start while the clock is under `seconds`, and at least
        # the traffic's `check_among` pairs run
        while (n < int(traffic["check_among"])
               or time.perf_counter() - t0 < seconds):
            pair(n)
            _sync(cuda)
            n += 1
        ctx.elapsed_s = time.perf_counter() - t0
        ctx.pairs = n
    else:
        # one pair with the host timers on, for its wall time and theirs;
        # then one under the profiler, timers off
        prog.timing.enable(True)
        prog.timing.timing_reset()
        _sync(cuda)
        t0 = time.perf_counter()
        pair(0)
        _sync(cuda)
        ctx.pair_wall_s = time.perf_counter() - t0
        ctx.timers = {k: v[0] for k, v in prog.timing.timings().items()}
        prog.timing.enable(False)
        ctx.profile = trace.profile(lambda: pair(1), cuda)
        ctx.elapsed_s = ctx.pair_wall_s
        ctx.pairs = 2
        ctx.cached_step_bytes = prog.cached_step_bytes()
    gc.unfreeze()
    failed = int(bad)
    ctx.peak_bytes = (torch.cuda.max_memory_allocated() if cuda else None)
    log(f"window: {ctx.pairs} pairs in {ctx.elapsed_s:.3f} s, "
        f"{failed} with a value that is not finite")

    # -- the judgement: the reference on the same inputs ---------------------
    prog_trajs = trajs if conf["trajectory"].get("nl_steps") else None
    del perts, trajs
    prog.close()
    del prog
    gaps = reference_gaps(conf, traffic, seed, device, check, kept,
                          prog_trajs, log)
    rows, ok = compare.judge(gaps, limits)
    ok = ok and failed == 0 and check in range(ctx.pairs)

    # -- the result ------------------------------------------------------------
    kind = "per_layer" if trace_on else "end_to_end"
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench[kind]}
    for name in cell_metrics(bench, workload, kind):
        value = load_reader(bench_dir, name)(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": ctx.peak_bytes}
    result = {"correct": ok, "attempted": ctx.pairs, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace_on:
        p = ctx.profile
        dev.update(busy_s=p.busy_s, window_s=p.wall_s)
        result["breakdown"] = {"device_ops": trace.top(p.kernel_s),
                               "idle_gaps": trace.top(p.idle_gaps)}
    result["checks"] = {name: {"value": value, "limit": lim}
                        for name, value, lim, _ in rows}
    lines = [f"check {name} {value!r} limit {lim!r} "
             f"{'ok' if good else 'FAILED'}"
             for name, value, lim, good in rows]
    return result, lines


class Stepper:
    """A reference's nonlinear step under the name `step_nl`."""

    def __init__(self, ref):
        self.dtype = ref.dtype
        self.step_nl = ref.nl_step


def reference_gaps(conf, traffic, seed, device, check, kept, prog_trajs,
                   log, ref=None, out=None):
    """The compared numbers: the worst field's relative L2 gap of the
    judged pair's TL and AD (and of the trajectory's nonlinear steps)
    to the reference's, from the same seeded inputs.  `ref`: a reference
    model to use; `out`: a dict that receives the reference's TL and AD
    and the pair's perturbation."""
    import reference

    t0 = time.perf_counter()
    if ref is None:
        ref = reference.Reference(conf, device)
    keys = ref.prog_3d
    trajs = stepped_trajectories(Stepper(ref), conf, traffic, seed, device)
    i_traj = check % len(trajs)
    traj = trajs[i_traj]
    del trajs
    gaps = {}
    if prog_trajs is not None:
        gaps["nl_gap"] = compare.worst_gap(prog_trajs[i_traj], traj, keys)
        del prog_trajs
    perts = generator.perturbations(conf, traffic, seed, ref.dtype, device)
    pert = perts[(check + 1) % len(perts)]
    del perts
    if not kept:
        return dict(gaps, tl_gap=math.inf, ad_gap=math.inf)
    lin = ref.linearize(traj)
    rtl = ref.tl(lin, pert)
    gaps["tl_gap"] = compare.worst_gap(kept["tl"], rtl, keys)
    rad = ref.ad(lin, rtl)
    gaps["ad_gap"] = compare.worst_gap(kept["ad"], rad, keys)
    if out is not None:
        out.update(tl=rtl, ad=rad, pert=pert)
    log(f"reference {time.perf_counter() - t0:.3f} s")
    return gaps
