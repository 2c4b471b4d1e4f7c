"""Count the operations of one TL+AD pair of a configuration, on the
benchmark's own reference, so that `pair_mfu` has a fixed numerator that
no change to the program can move.

    python3 benchmark/opcount.py --config c180L72_dyn [--device cuda]

A `TorchDispatchMode` sees every aten operation of the reference's `tl`
then `ad` (after `linearize`, which the program caches, as the reference
does) at the configuration's shapes, with the inputs of seed 0.  It counts
one operation per output element of each arithmetic operation, per input
element of each reduction and 2k per output element of a matrix product
of inner size k, and nothing for copies, views, indexing, selections or
tensor creation.  The count does not depend on the device.  It prints one
JSON line: the count and the operations that gave the most.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: element-wise arithmetic: one operation per output element
ELEMENTWISE = frozenset("""
add sub rsub mul div neg reciprocal pow exp exp2 expm1 log log2 log10 log1p
sqrt rsqrt abs sign sgn sin cos tan asin acos atan atan2 sinh cosh tanh
floor ceil round trunc frac remainder fmod maximum minimum fmax fmin clamp
clamp_min clamp_max lt le gt ge eq ne addcmul addcdiv lerp square hypot
copysign heaviside sigmoid erf xlogy floor_divide
""".split())
#: reductions and scans: one operation per input element
REDUCTIONS = frozenset("""
sum mean prod amax amin max min cumsum cumprod norm linalg_vector_norm
logsumexp var std
""".split())
#: matrix products: 2k operations per output element
MATMUL = frozenset("mm bmm addmm baddbmm matmul".split())


def _name(func):
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and name != "_" else name


class OpCounter(TorchDispatchMode):
    """Counts operations by aten name (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.by_name = {}

    @property
    def total(self):
        return sum(self.by_name.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = _name(func)
        if name in ELEMENTWISE:
            n = _numel(out)
        elif name in REDUCTIONS:
            n = _numel(args[0])
        elif name in MATMUL:
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            n = 2 * _numel(out) * a.shape[-1]
        else:
            n = 0
        if n:
            self.by_name[name] = self.by_name.get(name, 0) + n
        return out


def _numel(x):
    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, (tuple, list)):
        return sum(_numel(y) for y in x)
    return 0


def count_pair(conf, traffic, device, seed=0):
    """The OpCounter of the reference's pair of configuration `conf` on
    the inputs of `seed` (the traffic's first trajectory and the pair's
    first perturbation)."""
    import generator
    import reference

    ref = reference.Reference(conf, device)
    traj = generator.trajectories(conf, traffic, seed, ref.dtype, device)[0]
    for _ in range(int(conf["trajectory"].get("nl_steps", 0))):
        traj = dict(traj, **ref.nl_step(traj))
    pert = generator.perturbations(conf, traffic, seed, ref.dtype,
                                   device)[0]
    lin = ref.linearize(traj)
    with OpCounter() as counter:
        ref.ad(lin, ref.tl(lin, pert))
    return counter


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="tlad")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import harness

    conf = harness.load_config(here, args.config)
    traffic = harness.load_traffic(here, args.traffic)
    c = count_pair(conf, traffic, args.device)
    top = sorted(c.by_name.items(), key=lambda kv: -kv[1])[:12]
    dev = (torch.cuda.get_device_name(0) if args.device == "cuda"
           else "cpu")
    print(json.dumps({"config": args.config, "count": c.total,
                      "log10": math.log10(max(c.total, 1)), "device": dev,
                      "seed": 0, "top": top}), flush=True)


if __name__ == "__main__":
    main()
