"""The controls: the reference put in the program's place, in the
nearest precision below the configurations' float32, bfloat16 (TF32,
which touches matrix products alone, would change nothing in the
dynamics and only the cloud scheme's small products in the physics).  A
run with either in place has to come out not correct.

* `bfloat16`: every operation in bfloat16.  At the cells' sizes its
  8-bit significand cannot hold the L72 interface pressures (about 1e5
  Pa, steps of 512 Pa against layers of a few Pa at the top), the step
  divides by zero and gives no number: failed, with no reading.
* `bfloat16_trajectory`: the computation in float32 from the trajectory
  stored in bfloat16 (its `step_nl` output, and the state the pairs are
  linearized at), as 4D-Var may keep the outer loop's trajectory.

`calibrate.py` reads both at the cells' sizes, and
`tests/test_bench_control.py` at the test sizes.
"""

from __future__ import annotations

import torch

import reference

CONTROLS = ("bfloat16", "bfloat16_trajectory")


def rounded(tree, dtype):
    """`tree` with every floating-point tensor rounded to `dtype` and
    back."""
    if isinstance(tree, dict):
        return {k: rounded(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rounded(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype).to(tree.dtype)
    return tree


class ReferenceProgram:
    """The reference with the methods of `harness.Program`, as the control
    `kind` (one of CONTROLS): `step_tl` and `step_ad` linearize a
    trajectory once and keep it (as the program's cache of one)."""

    def __init__(self, conf, device, kind="bfloat16"):
        if kind not in CONTROLS:
            raise ValueError(f"control {kind!r}: one of {CONTROLS}")
        self.kind = kind
        self.ref = reference.Reference(
            conf, device, "bfloat16" if kind == "bfloat16" else None)
        self.dtype = self.ref.dtype
        self._lin = (None, None)

    def _linearized(self, traj):
        if self._lin[0] is not traj:
            self._lin = (None, None)
            if self.kind == "bfloat16_trajectory":
                lin = self.ref.linearize(rounded(traj, torch.bfloat16))
            else:
                lin = self.ref.linearize(traj)
            self._lin = (traj, lin)
        return self._lin[1]

    def step_nl(self, traj):
        out = self.ref.nl_step(traj)
        if self.kind == "bfloat16_trajectory":
            out = rounded(out, torch.bfloat16)
        return out

    def step_tl(self, traj, pert):
        return self.ref.tl(self._linearized(traj), pert)

    def step_ad(self, traj, pert):
        return self.ref.ad(self._linearized(traj), pert)

    def cached_step_bytes(self):
        return None

    def close(self):
        self._lin = (None, None)
