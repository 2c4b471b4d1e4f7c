"""The port's nonhydrostatic trajectory step against JAX LinearModel.step_nl.

At the NH_KW configuration of tests/test_nh_e2e.py (c12L10, n_split=2,
float64, dt=450), one step from the smooth thermal bump state (and from
the same state with humidity, so the tracer transport and remap carry a
non-zero field) goes through both packages; every prognostic field must
agree to max|d| <= 1e-10 * max|ref|.  The comparison is at a tolerance
and not bitwise: XLA and PyTorch order sums and transcendentals
differently.

The JAX step is the same program LinearModel.step_nl jits (`_step_fn`),
compiled once for the module at XLA backend optimization level 0: that
halves the compile time of this large graph on the CPU and changes only
the rounding order, which the tolerance covers.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3jedi_lm_tpu.config import DynConfig as JaxDynConfig
from fv3jedi_lm_tpu.config import LMConfig as JaxLMConfig
from fv3jedi_lm_tpu.lm import LinearModel as JaxLinearModel
from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
from fv3jedi_lm_tpu_torch.lm import (LinearModel, traj_from_numpy,
                                     traj_to_numpy)
from torch_shared import shared

torch.set_num_threads(1)

NH_KW = dict(npx=13, npy=13, npz=10, n_split=2, k_split=1,
             d2_bg_k1=0.2, d2_bg_k2=0.1, n_sponge=3,
             n_sponge_pert=4, d2_bg_k1_pert=0.2, d2_bg_k2_pert=0.1,
             d2_bg_ks_pert=0.1, hydrostatic=False)
CFG = LMConfig(dyn=DynConfig(**NH_KW), dt=450.0)                # the port's
JAX_CFG = JaxLMConfig(dyn=JaxDynConfig(**NH_KW), dt=450.0)     # the reference's
FIELDS = ("u", "v", "t", "delp", "qv", "ql", "qi", "o3", "w", "delz")


def _bump(n, npz, amp=3.0):
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    faces = np.arange(6)[:, None, None]
    ks = np.arange(npz)[:, None, None, None]
    return (amp * np.sin(2.0 * np.pi * (jj + 0.5) / n + 0.7 * faces)
            * np.cos(2.0 * np.pi * (ii + 0.5) / n + 0.3 * faces)
            * np.cos(0.5 * np.pi * ks / npz))


def _states(jlm):
    """The input states as dicts of numpy arrays (made with numpy)."""
    n, npz = CFG.dyn.nx, CFG.dyn.npz
    rest = {k: np.asarray(v) for k, v in jlm.rest_traj().items()}
    bump = dict(rest, t=rest["t"] + _bump(n, npz))
    moist = dict(bump, qv=5.0e-3 * (1.0 + 0.1 * _bump(n, npz, amp=1.0)),
                 o3=1.0e-6 * (1.0 + 0.2 * _bump(n, npz, amp=1.0)))
    return {"bump": bump, "bump_moist": moist}


def _jax_steps():
    """The input states and one JAX step of each, numpy."""
    jlm = JaxLinearModel.create(JAX_CFG)
    states = _states(jlm)
    prog0 = {k: jnp.asarray(states["bump"][k]) for k in jlm.prog_3d}
    phis0 = jnp.asarray(states["bump"]["phis"])
    step = jax.jit(jlm._step_fn).lower(prog0, phis0).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    refs = {}
    for name, st in states.items():
        ref = step({k: jnp.asarray(st[k]) for k in jlm.prog_3d},
                   jnp.asarray(st["phis"]))
        refs[name] = {k: np.asarray(v) for k, v in ref.items()}
    return states, refs


@pytest.fixture(scope="module")
def steps(request):
    """One JAX step (kept across runs, tests/torch_shared.py `shared`) and
    one port step of each input state."""
    states, refs = shared(request, _jax_steps)
    lm = LinearModel.create(CFG, device="cpu")
    out = {}
    for name, st in states.items():
        got = traj_to_numpy(lm.step_nl(traj_from_numpy(lm, st)))
        out[name] = (refs[name], got, st)
    return out


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("state", ["bump", "bump_moist"])
def test_step_nl_matches_jax(steps, state, field):
    ref, got, st = steps[state]
    a, b = ref[field], got[field]
    assert a.shape == b.shape and b.dtype == np.float64
    assert np.isfinite(b).all()
    d = np.abs(a - b).max()
    assert d <= 1e-10 * np.abs(a).max(), (field, d, np.abs(a).max())
    if field in ("u", "v", "w", "t", "delz") or (state == "bump_moist"
                                                and field == "qv"):
        # the step moved the field: the comparison is not of inputs
        assert np.abs(a - st[field]).max() > 1e-8


def test_rest_state_stays_at_rest():
    """A discretely balanced NH rest state does not self-accelerate
    (tests/test_nh_e2e.py test_nh_rest_state_stays_at_rest)."""
    lm = LinearModel.create(CFG, device="cpu")
    tr = lm.rest_traj()
    out = lm.step_nl(tr)
    assert float(out["u"].abs().max()) < 1e-8
    assert float(out["w"].abs().max()) < 1e-8
    assert float((out["t"] - 280.0).abs().max()) < 1e-7
    dps = out["delp"].sum(0) - tr["delp"].sum(0)
    assert float(dps.abs().max()) < 1e-8


def test_unported_options_raise():
    """Every dynamics option of DynConfig runs (beta, once refused, steps
    to finite values) and the physics builds; what no configuration can
    ask for still raises: a PPM scheme outside iord 1-13, a remap mode
    outside iv -2..2."""
    phys = LinearModel.create(CFG.replace(do_phy_trb=True, do_phy_mst=1),
                              device="cpu")
    assert phys.tracers[-1] == "cfcn"
    beta = LinearModel.create(CFG.replace(dyn=CFG.dyn.replace(beta=0.5)),
                              device="cpu")
    out = beta.step_nl(beta.rest_traj())
    assert all(bool(torch.isfinite(out[k]).all()) for k in beta.prog_3d)
    from fv3jedi_lm_tpu_torch.ops import fv_mapz, ppm
    q = torch.zeros(2, 6, 18, 18, dtype=torch.float64)
    with pytest.raises(ValueError, match="1-13"):
        ppm.xppm(q, torch.zeros(2, 6, 18, 13, dtype=torch.float64), 14,
                 beta.grid["dxa"])
    a = torch.ones(5, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="iv=3"):
        fv_mapz.cs_profile(a[0], a, a, 3, 8)


_NO_JAX = r"""
import sys
sys.modules["jax"] = None             # any import of jax now fails,
sys.modules["fv3jedi_lm_tpu"] = None  # and any import of the JAX package
import numpy as np
import torch
torch.set_num_threads(1)
import fv3jedi_lm_tpu_torch
from fv3jedi_lm_tpu_torch.lm import LinearModel
from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
cfg = LMConfig(dyn=DynConfig(npx=13, npy=13, npz=10, n_split=2,
                             d2_bg_k1=0.2, d2_bg_k2=0.1, n_sponge=3,
                             hydrostatic=False), dt=450.0)
lm = LinearModel.create(cfg, device="cpu")
tr = lm.rest_traj()
tr["t"] = tr["t"] + 2.0 * torch.rand(tr["t"].shape, dtype=torch.float64,
                                     generator=torch.Generator().manual_seed(0))
out = lm.step_nl(tr)
assert all(bool(torch.isfinite(out[k]).all()) for k in lm.prog_3d)
assert float((out["w"]).abs().max()) > 0.0
print("NOJAX_OK")
"""


def test_port_runs_without_jax():
    """The port imports and steps in a process where every import of jax
    and of the JAX package fails."""
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "NOJAX_OK" in r.stdout, (
        r.stdout[-2000:] + r.stderr[-2000:])
