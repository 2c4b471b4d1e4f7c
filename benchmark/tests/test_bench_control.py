"""`correct` comes out false for the control and for each fault the cells
can have, and true for the program: a whole run (set-up, window,
judgement) on the CPU at the test sizes, with the cells' own limits and
the harness's look for a card left out."""

import time

import pytest

import harness
from control import CONTROLS, ReferenceProgram

CELLS = ["tlad.c180L72_dyn", "tlad.c144L72_phys"]


def run(root, workload, make_program=harness.Program, seed=2 ** 31 + 77):
    res, lines = harness.run_cell(workload, seed, 0.5, False, root=root,
                                  t_start=time.perf_counter(), device="cpu",
                                  make_program=make_program,
                                  log=lambda *a: None)
    return res


class TLUnchanged(harness.Program):
    """A TL step that returns its state unchanged."""

    def step_tl(self, traj, pert):
        return dict(pert)


class ADUnchanged(harness.Program):
    """An AD step that returns its state unchanged."""

    def step_ad(self, traj, pert):
        return dict(pert)


class TLAltered(harness.Program):
    """A TL answer altered where it is produced: one level of t doubled."""

    def step_tl(self, traj, pert):
        out = super().step_tl(traj, pert)
        t = out["t"].clone()
        t[t.shape[0] // 2] *= 2.0
        return dict(out, t=t)


@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct(small, workload):
    res = run(small, workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("kind", CONTROLS)
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(small, workload, kind):
    res = run(small, workload,
              lambda conf, dev: ReferenceProgram(conf, dev, kind))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [TLUnchanged, ADUnchanged, TLAltered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(small, workload, fault):
    res = run(small, workload, fault)
    assert not res["correct"], res["checks"]
