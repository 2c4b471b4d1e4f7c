"""One pair under `torch.profiler` and its reduction to what the per-layer
metrics read: the device's busy time (the union of its kernels'
intervals), the kernel launches, the device time of the kernels under
each named scope, the kernels that took most time, and the idle gaps by
the scope the host was in.

`RawProfile` is copied from `chip_smoke.profile_pair` (commit 0fe27a5),
which reads the raw events because building the profiler's event tree
for the million events of a pair takes minutes.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import numpy as np
import torch

#: the characters of a kernel's name kept (a templated kernel's full name
#: runs to a thousand)
NAME_CHARS = 160
#: device events that move memory rather than run a kernel
_COPIES = ("Memcpy", "Memset")


class RawProfile(torch.autograd.profiler.profile):
    """torch.autograd.profiler.profile that keeps the raw Kineto events and
    does not build the FunctionEvent tree from them."""

    def _parse_kineto_results(self, result):
        return []


@dataclass
class Profile:
    """The reduction of one profiled window."""
    wall_s: float                   # the profiled window's wall time
    busy_s: float = 0.0             # union of the kernels' intervals
    launches: int = 0               # kernels (copies and fills left out)
    kernel_s: dict = field(default_factory=dict)   # kernel name -> s
    scope_kernel_s: dict = field(default_factory=dict)  # scope -> s
    idle_gaps: dict = field(default_factory=dict)  # host scope -> s


def union_s(intervals):
    """Seconds covered by the union of (start_ns, end_ns) intervals."""
    total, end = 0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        elif b > end:
            end = b
    if end is not None:
        total += end - start
    return total / 1e9


def gaps(intervals):
    """The idle gaps (start_ns, end_ns) between the union's pieces."""
    out, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def innermost(ranges, points):
    """For each time in the sorted `points`, the name of the innermost
    range of `ranges` ((name, start, end), properly nested) that holds
    it, or "(none)"."""
    ranges = sorted(ranges, key=lambda r: (r[1], -r[2]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(ranges) and ranges[i][1] <= t:
            stack.append(ranges[i])
            i += 1
        stack = [r for r in stack if r[2] > t]
        out.append(stack[-1][0] if stack else "(none)")
    return out


def reduce(events, wall_s):
    """A Profile from raw Kineto events.  A scope's kernels are those that
    start inside its span on the device's timeline (the profiler's
    `gpu_user_annotation`, one for each host scope that launched
    kernels); the idle gaps are named by the host scope open when they
    begin.  The host's operator events, most of the trace, are skipped
    after one call each."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, names, dev_spans, host_spans = [], [], [], []
    prof = Profile(wall_s=wall_s)
    for e in events:
        if e.is_user_annotation():
            span = (e.name(), e.start_ns(), e.end_ns())
            (dev_spans if e.device_type() == cuda else host_spans).append(
                span + (e.start_thread_id(),))
        elif e.device_type() == cuda:
            a = e.start_ns()
            kernels.append((a, a + e.duration_ns()))
            names.append(e.name()[:NAME_CHARS])
    for (a, b), name in zip(kernels, names):
        if not name.startswith(_COPIES):
            prof.launches += 1
        prof.kernel_s[name] = prof.kernel_s.get(name, 0.0) + (b - a) / 1e9
    prof.busy_s = union_s(kernels)
    order = sorted(range(len(kernels)), key=lambda i: kernels[i][0])
    starts = [kernels[i][0] for i in order]
    cum = np.concatenate([[0.0], np.cumsum(
        [kernels[i][1] - kernels[i][0] for i in order])]) / 1e9
    for name, a, b, _ in dev_spans:
        lo, hi = bisect.bisect_left(starts, a), bisect.bisect_left(starts, b)
        prof.scope_kernel_s[name] = (prof.scope_kernel_s.get(name, 0.0)
                                     + float(cum[hi] - cum[lo]))
    if kernels and host_spans:
        # the host thread that holds the scopes (the one with most)
        count = {}
        for r in host_spans:
            count[r[3]] = count.get(r[3], 0) + 1
        main = max(count, key=count.get)
        idle = gaps(kernels)
        named = innermost([r[:3] for r in host_spans if r[3] == main],
                          [a for a, _ in idle])
        for (a, b), name in zip(idle, named):
            prof.idle_gaps[name] = prof.idle_gaps.get(name, 0.0) + (
                b - a) / 1e9
    return prof


def profile(fn, cuda):
    """Run `fn()` once under the profiler (CPU and, on the card, CUDA
    activities) and reduce its trace."""
    kw = dict(use_device="cuda") if cuda else {}
    with RawProfile(use_kineto=True, **kw) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return reduce(prof.kineto_results.events(), wall)


def top(d, n=10):
    """The `n` largest entries of {name: seconds}, as [[name, s], ...]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
