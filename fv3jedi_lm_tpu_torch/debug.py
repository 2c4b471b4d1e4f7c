"""Debug observability (counterpart of fv3jedi_lm_tpu/debug.py).

The reference ships root-PE debug prints and range guards, `prt_maxmin` /
`range_check` (tools/fv_diagnostics_nlm.F90:79-81), plus byte counters on
the AD stack (adStack.c:28-31 `mmctraffic`) and a checkpoint memory report
(tapenade_iter.F90:520-850).  Here:

* `prt_maxmin(name, x)` prints min, max and |max| of a tensor;
* `range_check(name, x, lo, hi)` warns (or raises FloatingPointError with
  FV3LM_DEBUG=raise) when values leave [lo, hi] or are not finite, so an
  unstable configuration shows as a named report, not as NaNs three
  subsystems later;
* `check_state(prog)` runs the standard checks on a prognostic dict (the
  temperature's range, delp's positivity, the winds' magnitude);
* `tape_report(lm)` gives the exact bytes of each cached trajectory's
  checkpoints and branch tapes, the tapes split into bit-packed boolean
  decisions and integer decisions (and of its moist pack and turbulence
  coefficients with the physics).

All are gated on FV3LM_DEBUG: unset or "0", they return at once without
reading any tensor.  `tree_bytes` and `tape_report` count bytes without
reading values and are not gated.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from .core.freeze import Packed


def _mode() -> str:
    return os.environ.get("FV3LM_DEBUG", "")


def enabled() -> bool:
    return _mode() not in ("", "0")


#: plausibility ranges (those of the reference's range_check call sites)
RANGES = {
    "t": (150.0, 350.0),
    "pt": (150.0, 350.0),
    "delp": (0.01, 2.0e5),
    "u": (-280.0, 280.0),
    "v": (-280.0, 280.0),
    "w": (-90.0, 90.0),
}


def prt_maxmin(name, x):
    """Named min/max print (prt_maxmin)."""
    if not enabled():
        return
    a = x.detach().double()
    print(f"# fv3lm {name:12s} min {float(a.min()):+.6e} "
          f"max {float(a.max()):+.6e} |max| {float(a.abs().max()):.6e}")


def range_check(name, x, lo, hi):
    """Warn (or raise with FV3LM_DEBUG=raise) on non-finite or
    out-of-range values; True if the field is clean."""
    if not enabled():
        return True
    a = x.detach().double()
    bad = ~torch.isfinite(a)
    nbad = int(bad.sum())
    nlo = int(((a < lo) & ~bad).sum())
    nhi = int((a > hi).sum())
    if nbad or nlo or nhi:
        fin = a[~torch.isnan(a)]
        mn = float(fin.min()) if fin.numel() else float("nan")
        mx = float(fin.max()) if fin.numel() else float("nan")
        msg = (f"# fv3lm RANGE {name}: {nbad} non-finite, {nlo} < {lo}, "
               f"{nhi} > {hi} (min {mn:+.4e}, max {mx:+.4e})")
        if _mode() == "raise":
            raise FloatingPointError(msg)
        print(msg)
        return False
    return True


def check_state(prog, label=""):
    """range_check over a prognostic dict with the standard bounds."""
    if not enabled():
        return True
    ok = True
    for k, v in prog.items():
        lo, hi = RANGES.get(k, (-1.0e30, 1.0e30))
        ok = range_check(f"{label}{k}", v, lo, hi) and ok
    return ok


def tree_bytes(tree, seen=None):
    """Bytes of every tensor in a pytree (dicts, lists, tuples, the bytes
    of `Packed` tape entries); a tensor met twice counts once (also across
    calls given the same set `seen` of the ids met)."""
    return sum(tape_bytes(tree, seen))


def tape_bytes(tree, seen=None):
    """(boolean bytes, other bytes) of the tensors in a pytree: the first
    counts packed decisions and raw bool tensors, the second every other
    tensor (on a tape, the integer decisions)."""
    seen = set() if seen is None else seen
    nbool, nother, stack = 0, 0, [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, Packed):
            if id(x.data) not in seen:
                seen.add(id(x.data))
                nbool += x.data.numel()
        elif isinstance(x, torch.Tensor) and id(x) not in seen:
            seen.add(id(x))
            if x.dtype == torch.bool:
                nbool += x.numel()
            else:
                nother += x.numel() * x.element_size()
    return nbool, nother


class CachedBytes(NamedTuple):
    """Bytes of one cached trajectory's linearization: checkpoints, the
    dynamics tapes' boolean and integer decisions, the moist
    linearization (ltraj) and its tape's boolean and integer decisions,
    and the turbulence coefficients."""
    ckpts: int
    tape_bool: int
    tape_int: int
    moist: int = 0
    moist_bool: int = 0
    moist_int: int = 0
    turb: int = 0

    @property
    def total(self):
        return sum(self)


def cache_bytes(lm):
    """[CachedBytes] per cached trajectory of `lm`, oldest first."""
    out = []
    for _, (_, entry) in lm._traj_cache.items():
        cks, tapes, mpack, ltraj = entry
        moist = (tree_bytes(mpack[0]),) + tape_bytes(mpack[1]) if (
            mpack is not None) else (0, 0, 0)
        out.append(CachedBytes(tree_bytes(cks), *tape_bytes(tapes), *moist,
                               tree_bytes(ltraj) if ltraj is not None
                               else 0))
    return out


def tape_report(lm) -> str:
    """One-line report of the cached linearization data (the
    tapenade_iter.F90:520-850 memory report).  Call after step_tl/step_ad
    has filled the cache."""
    parts = []
    for c in cache_bytes(lm):
        s = (f"ckpts {c.ckpts / 1e6:9.1f} MB  tapes bool "
             f"{c.tape_bool / 1e6:9.1f} MB int {c.tape_int / 1e6:9.1f} MB")
        if c.moist:
            s += (f"  moist {c.moist / 1e6:9.1f} MB, its tape bool "
                  f"{c.moist_bool / 1e6:9.1f} MB int "
                  f"{c.moist_int / 1e6:9.1f} MB")
        if c.turb:
            s += f"  turbulence {c.turb / 1e6:9.1f} MB"
        parts.append(s)
    body = "; ".join(parts) if parts else "no cached trajectories"
    return f"# fv3lm tape report ({len(parts)} cached traj): {body}"
