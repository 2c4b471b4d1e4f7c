"""A dropped LinearModel is freed at `del`, with its cache.

The stepper, the physics objects and the trajectory cache hold no
reference back to the model, so no reference cycle keeps a model (and the
checkpoints and tapes it caches, gigabytes at c96L72) alive until
Python's cyclic collector runs: with the collector disabled, a weak
reference to the model is dead right after `del`, as the reference frees
its model deterministically (`delete`, fv3jedi_lm_mod.F90:223); and
nothing the sweeps made (tapes unpacked for a replay, autograd graphs)
is left in a reference cycle: a cyclic collection then finds no tensor
among the garbage.  Cases:
a hydrostatic and a nonhydrostatic TL+AD pair, a pair with the turbulence
and moist physics mode 1, and a saveltraj window with its cache filled,
each at a small size on the CPU.
"""

import gc
import weakref

import pytest
import torch

import chip_smoke
from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
from fv3jedi_lm_tpu_torch.lm import LinearModel

torch.set_num_threads(1)


def _small(kind, **lm_kw):
    kw = dict(chip_smoke.TLAD_SMALL[kind], npx=9, npy=9, npz=5, n_split=1)
    return LinearModel.create(LMConfig(dyn=DynConfig(**kw), dt=450.0,
                                       **lm_kw), device="cpu")


def _pair(lm, tr):
    lm.step_ad(tr, lm.step_tl(tr, chip_smoke.rand_pert(lm, 1)))


def _hydrostatic():
    lm = _small("hydrostatic")
    _pair(lm, chip_smoke.spun_up(lm, 1, moist=True))
    return lm


def _nonhydrostatic():
    lm = _small("nonhydrostatic")
    _pair(lm, chip_smoke.spun_up(lm, 1, moist=True))
    return lm


def _physics():
    lm = LinearModel.create(
        LMConfig(dyn=DynConfig(**chip_smoke.PHYS_SMALL_KW), dt=450.0,
                 do_phy_trb=True, do_phy_mst=1),
        device="cpu", ak=chip_smoke.PHYS_AK, bk=chip_smoke.PHYS_BK)
    _pair(lm, chip_smoke.phys_small_traj(lm))
    return lm


def _window():
    lm = _small("hydrostatic", nt=2, saveltraj=True)
    trajs = lm.run_nl(chip_smoke.spun_up(lm, 1, moist=True))
    lm.run_ad(trajs, lm.run_tl(trajs, chip_smoke.rand_pert(lm, 1)))
    assert len(lm._traj_cache) == 2
    return lm


CASES = {"hydrostatic": _hydrostatic, "nonhydrostatic": _nonhydrostatic,
         "physics": _physics, "window": _window}


@pytest.fixture
def no_cyclic_gc():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()


def _tensors_in_cycles():
    """The tensors a cyclic collection finds unreachable now."""
    gc.set_debug(gc.DEBUG_SAVEALL)
    gc.collect()
    found = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    gc.garbage.clear()
    gc.set_debug(0)
    return found


@pytest.mark.parametrize("case", CASES)
def test_dropped_model_is_freed_at_del(no_cyclic_gc, case):
    lm = CASES[case]()
    assert lm._traj_cache and lm._stepper is not None
    cks = next(iter(lm._traj_cache.values()))[1][0]
    cached = weakref.ref(cks["carry_fin"][0]["delp"])
    del cks
    model, stepper = weakref.ref(lm), weakref.ref(lm._stepper)
    del lm
    assert model() is None, "the model outlived its last reference"
    assert stepper() is None and cached() is None
    leaked = _tensors_in_cycles()
    assert not leaked, (f"{len(leaked)} tensors held by reference cycles, "
                        f"{sum(t.numel() * t.element_size() for t in leaked)}"
                        " bytes")
