"""d_sw of the PyTorch port against the JAX package, with the c96L72
sponge bands.

The c96L72 configuration's n_sponge=6 puts isolated del-2 damping levels
inside the sponge band (levels 0, 4, 5 of the first six), so d_sw blends
its del-2 and del-4 divergence damping and its w damping level by level.
The slice test (test_torch_step_nl.py, n_sponge=3) does not reach that
blend; this test does, on random float64 fields (numpy, from a seed) at
c12 with 8 levels.  Every output must agree to 1e-12 * max|ref|.

The JAX d_sw is compiled at XLA backend optimization level 0 (a shorter
compile; only the rounding order changes, which the tolerance covers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3jedi_lm_tpu.config import DynConfig as JaxDynConfig
from fv3jedi_lm_tpu.core.dyn_core import _kcoef as jax_kcoef
from fv3jedi_lm_tpu.grid.device import to_device as jax_to_device
from fv3jedi_lm_tpu.grid.metrics import build_grid as jax_build_grid
from fv3jedi_lm_tpu.ops.d_sw import d_sw as jax_d_sw
from fv3jedi_lm_tpu_torch.config import DynConfig
from fv3jedi_lm_tpu_torch.core.dyn_core import _kcoef
from fv3jedi_lm_tpu_torch.grid.device import to_device
from fv3jedi_lm_tpu_torch.grid.metrics import build_grid
from fv3jedi_lm_tpu_torch.ops.d_sw import d_sw
from torch_shared import shared

torch.set_num_threads(1)

NPX, NPZ, DT = 13, 8, 75.0
D_SW_KW = dict(npx=NPX, npy=NPX, npz=NPZ, d2_bg_k1=0.2, d2_bg_k2=0.1,
               n_sponge=6, hydrostatic=False)
CFG = DynConfig(**D_SW_KW)           # the port's
JAX_CFG = JaxDynConfig(**D_SW_KW)    # the reference's
OUTPUTS = ("delp", "pt", "u", "v", "w", "divg_d", "divd_b", "cx", "cy",
           "xflux", "yflux", "crx", "cry", "xfx", "yfx", "heat_source")


def _inputs():
    rng = np.random.default_rng(11)
    jc, jb, n = NPX + 5, NPX + 6, NPX - 1
    lead = (NPZ, 6)

    def f(*s, sc=1.0, off=0.0):
        return off + sc * rng.standard_normal(lead + s)

    return (f(jc, jc, sc=10.0, off=1000.0), f(jc, jc, off=300.0),
            f(jb, jc, sc=10.0), f(jc, jb, sc=10.0), f(jc, jc, sc=0.1),
            f(jc, jb, sc=10.0), f(jb, jc, sc=10.0), f(jc, jc, sc=10.0),
            f(jc, jc, sc=10.0), f(jb, jb, sc=1e-5),
            np.zeros(lead + (n, n + 1)), np.zeros(lead + (n + 1, n)),
            np.zeros(lead + (jc, n + 1)), np.zeros(lead + (n + 1, jc)))


def _jax_d_sw():
    jgm = jax_build_grid(NPX, big=1.0e30)
    jgrid = jax_to_device(jgm, jnp.float64)
    jkc = jax_kcoef(JAX_CFG, NPZ, jnp.float64)
    fn = jax.jit(lambda *a: jax_d_sw(*a, jgrid, jgm.topo, DT, NPX, 9, 9, 9, 9,
                                     jkc, False))
    jargs = [jnp.asarray(a) for a in _inputs()]
    ref = fn.lower(*jargs).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*jargs)
    return {k: np.asarray(v) for k, v in ref.items()}


@pytest.fixture(scope="module")
def outputs(request):
    """The JAX package's d_sw (kept across runs, tests/torch_shared.py
    `shared`) and the port's, numpy."""
    gm = build_grid(NPX, big=1.0e30)
    args = _inputs()
    # the level blend this test is for: isolated del-2 levels in the band
    kc = _kcoef(CFG, NPZ, torch.float64, torch.device("cpu"))
    assert np.asarray(kc["nord0"]).reshape(-1)[:6].tolist() == [
        True, False, False, False, True, True]

    ref = shared(request, _jax_d_sw)
    grid = to_device(gm, torch.float64, torch.device("cpu"))
    got = d_sw(*[torch.as_tensor(a) for a in args], grid, gm.topo, DT, NPX,
               9, 9, 9, 9, kc)
    return ref, {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("key", OUTPUTS)
def test_d_sw_matches_jax(outputs, key):
    ref, got = outputs
    a, b = ref[key], got[key]
    assert a.shape == b.shape
    d = np.abs(a - b).max()
    assert d <= 1e-12 * np.abs(a).max(), (key, d, np.abs(a).max())
