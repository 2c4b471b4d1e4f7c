"""The port's LinearModel with the GEOS physics on (do_phy_trb,
do_phy_mst), float64 on the CPU.

* `step_nl` with moist physics equals the JAX package's `step_nl` to
  1e-12 * max|ref| per field, at exactly tests/test_moist.py's `lm` and
  `traj` fixtures' numbers (so the JAX programs are that file's, and may
  come from the persistent compilation cache it fills).
* On the port alone, at that configuration with the turbulence on
  (tests/test_moist.py:83-182, tests/test_turbulence.py:91-113): the
  dot-product identity below 1e-12 counting cfcn, for the turbulence
  alone, moist mode 1, moist mode 2 and turbulence with moist mode 1; the
  physics changes the operator and some column convects; with kcbl = 0
  the moist step passes the wind perturbations bitwise while it changes
  t, qv, qi and ql; and a trajectory that differs only in kcbl gets its
  own cache entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from fv3jedi_lm_tpu.config import DynConfig as JaxDynConfig
from fv3jedi_lm_tpu.config import LMConfig as JaxLMConfig
from fv3jedi_lm_tpu.lm import LinearModel as JaxLinearModel
from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
from fv3jedi_lm_tpu_torch.lm import (LinearModel, traj_from_numpy,
                                     traj_to_numpy)
from test_torch_physics import DT, MOIST_AK, MOIST_BK, MOIST_KW
from torch_shared import shared

torch.set_num_threads(1)


def port_model(trb, mst):
    cfg = LMConfig(dyn=DynConfig(**MOIST_KW), dt=DT, do_phy_trb=trb,
                   do_phy_mst=mst)
    return LinearModel.create(cfg, device="cpu", ak=MOIST_AK, bk=MOIST_BK)


def port_traj(lm, turb=True):
    """tests/test_moist.py's trajectory on the port, with
    tests/test_turbulence.py's surface fields if `turb`."""
    if turb:
        return chip_smoke.phys_small_traj(lm)
    n, npz = lm.cfg.dyn.nx, lm.cfg.dyn.npz
    return chip_smoke.moist_traj(lm.rest_traj(t0=285.0), n, npz,
                                 np.random.default_rng(7), torch.as_tensor)


rand_pert = chip_smoke.rand_pert
dot = chip_smoke.dot


# ------------------------------------------------------------ step_nl --------

def _jax_nl():
    """The JAX package's step_nl at tests/test_moist.py's `lm` and `traj`,
    and that trajectory, numpy."""
    jcfg = JaxLMConfig(dyn=JaxDynConfig(**MOIST_KW), dt=DT, do_phy_mst=1)
    jlm = JaxLinearModel.create(jcfg, ak=MOIST_AK, bk=MOIST_BK)
    n, npz = jlm.cfg.dyn.nx, jlm.cfg.dyn.npz
    jtr = chip_smoke.moist_traj(jlm.rest_traj(t0=285.0), n, npz,
                                np.random.default_rng(7), jnp.asarray)
    want = {k: np.asarray(v) for k, v in jlm.step_nl(jtr).items()}
    return want, {k: np.asarray(v) for k, v in jtr.items()}


@pytest.fixture(scope="module")
def nl_pair(request):
    """step_nl of both packages at tests/test_moist.py's `lm` and `traj`
    (the JAX package's kept across runs, tests/torch_shared.py `shared`)."""
    want, first = shared(request, _jax_nl)
    lm = port_model(False, 1)
    tr = traj_from_numpy(lm, first)
    got = traj_to_numpy(lm.step_nl(tr))
    return want, got, first


@pytest.mark.parametrize("field", ("u", "v", "t", "delp", "qv", "ql", "qi",
                                   "o3", "cfcn"))
def test_step_nl_with_moist_matches_jax(nl_pair, field):
    want, got, first = nl_pair
    a, b = want[field], got[field]
    assert a.shape == b.shape and np.isfinite(b).all()
    d = np.abs(a - b).max()
    assert d <= 1e-12 * np.abs(a).max(), (field, d, np.abs(a).max())
    if field in ("u", "t", "qv", "qi", "ql", "cfcn"):
        assert np.abs(a - first[field]).max() > 0.0


def test_step_nl_passes_surface_fields(nl_pair):
    want, got, first = nl_pair
    assert sorted(got) == sorted(want)
    for k in ("ts", "frland", "kcbl", "qls", "qcn", "phis"):
        assert np.array_equal(got[k], first[k]), k


# ------------------------------------------------------------ the identity ---

CASES = {"trb": (True, 0), "mst1": (False, 1), "mst2": (False, 2),
         "trb_mst1": (True, 1)}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    lm = port_model(*CASES[request.param])
    tr = port_traj(lm)
    dx, dy = rand_pert(lm, 1), rand_pert(lm, 2)
    return dict(name=request.param, lm=lm, traj=tr, dx=dx, dy=dy,
                tl=lm.step_tl(tr, dx), ad=lm.step_ad(tr, dy))


def test_dot_product_with_physics(pair):
    lm = pair["lm"]
    for k in lm.prog_3d:
        assert bool(torch.isfinite(pair["tl"][k]).all()), ("tl", k)
        assert bool(torch.isfinite(pair["ad"][k]).all()), ("ad", k)
    assert ("cfcn" in lm.prog_3d) == bool(lm.cfg.do_phy_mst)
    lhs = dot(pair["tl"], pair["dy"], lm.prog_3d)
    rhs = dot(pair["dx"], pair["ad"], lm.prog_3d)
    rel = abs(lhs - rhs) / max(abs(lhs), 1e-300)
    assert rel < 1e-12, (pair["name"], lhs, rhs, rel)


def test_physics_changes_the_operator(pair):
    lm, tr = pair["lm"], pair["traj"]
    cks, tapes, mpack, ltraj = lm._ckpts(tr)
    assert (mpack is None) == (not lm.cfg.do_phy_mst)
    assert (ltraj is None) == (not lm.cfg.do_phy_trb)
    if ltraj is not None:
        assert float(ltraj["aks"].abs().max()) > 0.0
    if pair["name"] in ("mst1", "trb_mst1"):
        assert bool(mpack[0]["doconvec"].any()), \
            "no convective column survived the filters"
    p = lm._staged().tl({k: tr[k] for k in lm.prog_3d}, tr["phis"],
                        pair["dx"], cks, tapes)
    diff = sum(float((pair["tl"][k] - p[k]).abs().max())
               for k in lm.prog_3d)
    assert diff > 0.0


def test_no_convection_moist_passes_winds():
    """With kcbl == 0 no column convects, so the moist step passes the
    wind perturbations through bitwise, while the cloud scheme still
    changes the thermodynamic ones (tests/test_moist.py:121-138)."""
    lm = port_model(True, 1)
    tr = port_traj(lm)
    tr["kcbl"] = torch.zeros_like(tr["kcbl"])
    dx = rand_pert(lm, 9)
    cks, tapes, mpack, _ = lm._ckpts(tr)
    assert not bool(mpack[0]["doconvec"].any())
    p_dyn = lm._staged().tl({k: tr[k] for k in lm.prog_3d}, tr["phis"],
                            dx, cks, tapes)
    p = lm._moist.apply_tl(*mpack, p_dyn)
    for k in ("u", "v"):
        assert torch.equal(p[k], p_dyn[k]), k
    for k in ("t", "qv", "qi", "ql"):
        assert float((p[k] - p_dyn[k]).abs().max()) > 0.0, k


def test_cache_keys_on_physics_fields():
    """A trajectory that differs from another only in kcbl (or any other
    surface or cloud field) gets its own linearization."""
    lm = port_model(True, 1)
    tr = port_traj(lm)
    first = lm._ckpts(tr)
    assert lm._ckpts(dict(tr)) is first
    other = dict(tr, kcbl=torch.zeros_like(tr["kcbl"]))
    second = lm._ckpts(other)
    assert second is not first
    assert bool(first[2][0]["doconvec"].any())
    assert not bool(second[2][0]["doconvec"].any())
    for k in ("ts", "qls"):
        assert lm._ckpts(dict(tr, **{k: tr[k].clone()})) is not second
