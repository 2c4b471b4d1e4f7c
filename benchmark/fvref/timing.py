"""Named timers and profile scopes (counterpart of fv3jedi_lm_tpu/timing.py;
the reference's fv_timing, tools/fv_timing_nlm.F90:20-61
`timing_on`/`timing_off`/`timing_prt`).

* `scope(name)` labels a block of work so that `torch.profiler` traces
  attribute host and device time to model blocks (c_sw, d_sw, riem_c, ...).
  It times nothing by itself and costs nothing when no profiler is active.
* `timing_on(name)` / `timing_off(name)` / `timing(name)` accumulate
  wall-clock seconds per named block of the facade (the trajectory's
  forward and record, step_tl/step_ad and their physics).  A block with a
  `sync` includes the device's time: on the card the timer then ends with
  `torch.cuda.synchronize()` (where the JAX package blocks on its arrays).
  `timing_prt()` prints the reference-style table.  On with FV3LM_TIMERS=1
  or `enable()`; when off, the timers return at once and insert no
  synchronization.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch
from torch.profiler import record_function

scope = record_function

_ENABLED = os.environ.get("FV3LM_TIMERS", "") not in ("", "0")
_ACC: dict = {}     # name -> [total_seconds, count]
_T0: dict = {}


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


def _sync(sync):
    """Wait for the device work behind `sync` (a tensor or a pytree of
    them, or True): one `torch.cuda.synchronize()` when any of them lives
    on the card."""
    if sync is True:
        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    else:
        stack, cuda = [sync], False
        while stack and not cuda:
            x = stack.pop()
            if isinstance(x, dict):
                stack.extend(x.values())
            elif isinstance(x, (list, tuple)):
                stack.extend(x)
            elif isinstance(x, torch.Tensor):
                cuda = x.is_cuda
    if cuda:
        torch.cuda.synchronize()


def timing_on(name: str) -> None:
    if _ENABLED:
        _T0[name] = time.perf_counter()


def timing_off(name: str, sync=None) -> None:
    """End a named block; `sync` (tensors, or True for the whole device)
    includes the device's time."""
    if not _ENABLED:
        return
    if sync is not None:
        _sync(sync)
    dt = time.perf_counter() - _T0.pop(name, time.perf_counter())
    tot = _ACC.setdefault(name, [0.0, 0])
    tot[0] += dt
    tot[1] += 1


@contextmanager
def timing(name: str, sync_fn=None):
    """A timed block: `with timing("step_tl.dyn", lambda: p): ...`;
    `sync_fn` is called at the end, only when the timers are on, for what
    to wait for."""
    timing_on(name)
    try:
        yield
    finally:
        timing_off(name, sync=None if sync_fn is None or not _ENABLED
                   else sync_fn())


def timing_reset() -> None:
    _ACC.clear()
    _T0.clear()


def timings() -> dict:
    """name -> (total_seconds, count)."""
    return {k: tuple(v) for k, v in _ACC.items()}


def timing_prt() -> str:
    """The reference's `timing_prt` table: per-block totals."""
    lines = [f"{'block':<28}{'calls':>8}{'total s':>12}{'mean ms':>12}"]
    for name, (tot, cnt) in sorted(_ACC.items()):
        lines.append(f"{name:<28}{cnt:>8}{tot:>12.4f}"
                     f"{1e3 * tot / max(cnt, 1):>12.3f}")
    out = "\n".join(lines)
    print(out, flush=True)
    return out
