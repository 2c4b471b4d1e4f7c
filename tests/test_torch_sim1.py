"""SIM1 solver of the PyTorch port against the JAX package and the oracle.

The port's plain `sim1_solver` (the reference for the CUDA kernel) is held
against JAX `nh_core.sim1_solver`, against the Pallas kernel in interpret
mode (as tests/test_pallas_sim1.py runs it) and against the column oracle
of tests/test_reference_oracle.py, in float64 at 1e-12 and float32 at
1e-5 relative.  The Riemann-solver wrappers are compared with JAX on
padded c12 fields.  The CUDA wrapper's own contract (CPU dispatch,
no-grad, build failure) is checked here; its comparison with the plain
version on a card is in test_torch_cuda.py.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3jedi_lm_tpu.constants import GRAV, KAPPA, RGAS
from fv3jedi_lm_tpu.core import nh_core as jnh
from fv3jedi_lm_tpu.ops.pallas_sim1 import sim1_solver_pallas
from fv3jedi_lm_tpu_torch.core import nh_core as tnh
from fv3jedi_lm_tpu_torch.ops import cuda_sim1
from test_reference_oracle import oracle_sim1_column
from test_torch_cuda import sim1_inputs as _inputs
from torch_shared import shared

torch.set_num_threads(1)


def _port(dt, args, dtype):
    out = tnh.sim1_solver(dt, *[torch.as_tensor(a, dtype=dtype) for a in args],
                          KAPPA, 0.05)
    return [o.numpy() for o in out]


def _jax(fn, dt, args, dtype, **kw):
    out = fn(dt, *[jnp.asarray(a, dtype) for a in args], KAPPA, 0.05, **kw)
    return [np.asarray(o) for o in out]


CASES = {
    # name: (km, ncol, seed, dt)
    "f64": (12, 200, 0, 30.0),
    "f32": (10, 128, 1, 20.0),
}


def _jax_refs():
    out = {}
    for case, (km, ncol, seed, dt) in CASES.items():
        args = _inputs(km, ncol, seed)
        dtype = np.float64 if case == "f64" else np.float32
        # jitted: one compile instead of a compile per eager lax.scan
        out[case, "jnp"] = _jax(
            jax.jit(jnh.sim1_solver, static_argnums=(0, 8, 9)), dt, args,
            dtype)
        out[case, "pallas"] = _jax(sim1_solver_pallas, dt, args, dtype,
                                   interpret=True)
    return out


@pytest.fixture(scope="module")
def jax_refs(request):
    """The JAX references, kept across runs (tests/torch_shared.py
    `shared`): {(case, ref): (pe, w, dz)}."""
    return shared(request, _jax_refs)


@pytest.mark.parametrize("ref", ["jnp", "pallas"])
@pytest.mark.parametrize("case", ["f64", "f32"])
def test_plain_sim1_matches_jax(jax_refs, case, ref):
    km, ncol, seed, dt = CASES[case]
    dtype = torch.float64 if case == "f64" else torch.float32
    got = _port(dt, _inputs(km, ncol, seed), dtype)
    for name, a, b in zip(("pe", "w", "dz"), jax_refs[case, ref], got):
        if case == "f64":
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12,
                                       err_msg=name)
        else:
            scale = np.abs(a).max() + 1e-6
            assert np.abs(a - b).max() / scale < 1e-5, name


def test_plain_sim1_matches_oracle():
    """float64, column by column against the Fortran transcription."""
    km, ncol, dt, p_fac = 12, 8, 30.0, 0.05
    args = _inputs(km, ncol, 1)
    pe_g, w_g, dz_g = _port(dt, args, torch.float64)
    dm2, pt2, pm2, pem, w2, dz2, ws = args
    for i in range(ncol):
        pe_o, w_o, dz_o = oracle_sim1_column(
            dt, km, RGAS, KAPPA, p_fac, dm2[:, i], pm2[:, i], pem[:, i],
            w2[:, i], dz2[:, i], pt2[:, i], ws[i])
        for name, a, b in (("pe", pe_o, pe_g[:, i]), ("w", w_o, w_g[:, i]),
                           ("dz", dz_o, dz_g[:, i])):
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12,
                                       err_msg=f"{name} col {i}")


def _padded_column_state(seed, npx=13, km=8):
    """Padded c12 (km, 6, jc, jc) fields a Riemann solver sees."""
    rng = np.random.default_rng(seed)
    jc = npx - 1 + 6
    lead = (6, jc, jc)
    pe_ref = np.linspace(300.0, 1.0e5, km + 1)
    dp = (pe_ref[1:] - pe_ref[:-1])[:, None, None, None]
    delp = dp * (1.0 + 0.02 * rng.random((km,) + lead))
    pt = 290.0 + 10.0 * rng.random((km,) + lead)
    pm = (0.5 * (pe_ref[1:] + pe_ref[:-1]))[:, None, None, None]
    dz = -(delp / GRAV) * RGAS * pt / pm * (1.0 + 0.01 * rng.random((km,) + lead))
    hs = 50.0 * rng.random(lead)
    z = np.concatenate([hs[None] - np.cumsum(dz[::-1], 0)[::-1], hs[None]])
    w = 0.3 * rng.standard_normal((km,) + lead)
    ws = 0.05 * rng.standard_normal(lead)
    return dict(delp=delp, pt=pt, hs=hs, z=z, w=w, ws=ws, ptop=pe_ref[0])


def test_riem_solver_c_matches_jax():
    s = _padded_column_state(3)
    dt = 37.5
    riem_c = jax.jit(jnh.riem_solver_c, static_argnums=(0, 1, 2, 9))
    j = riem_c(dt, KAPPA, float(s["ptop"]), jnp.asarray(s["hs"] * GRAV),
               jnp.asarray(s["w"]), jnp.asarray(s["pt"]),
               jnp.asarray(s["delp"]), jnp.asarray(s["z"]),
               jnp.asarray(s["ws"]), 0.05)
    t = tnh.riem_solver_c(dt, KAPPA, s["ptop"], torch.as_tensor(s["hs"] * GRAV),
                          torch.as_tensor(s["w"]), torch.as_tensor(s["pt"]),
                          torch.as_tensor(s["delp"]), torch.as_tensor(s["z"]),
                          torch.as_tensor(s["ws"]), 0.05)
    for name, a, b in zip(("pef", "gz", "w"), j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                                   atol=1e-12 * np.abs(np.asarray(a)).max(),
                                   err_msg=name)


def test_riem_solver3_matches_jax():
    s = _padded_column_state(4)
    dt = 75.0
    riem_3 = jax.jit(jnh.riem_solver3, static_argnums=(0, 1, 2, 10),
                     static_argnames=("fp_out",))
    j = riem_3(dt, KAPPA, float(s["ptop"]), jnp.asarray(s["hs"]),
               jnp.asarray(s["ws"]), None, jnp.asarray(s["pt"]),
               jnp.asarray(s["delp"]), jnp.asarray(s["z"]),
               jnp.asarray(s["w"]), 0.05, fp_out=False)
    t = tnh.riem_solver3(dt, KAPPA, s["ptop"], torch.as_tensor(s["hs"]),
                         torch.as_tensor(s["ws"]), torch.as_tensor(s["pt"]),
                         torch.as_tensor(s["delp"]), torch.as_tensor(s["z"]),
                         torch.as_tensor(s["w"]), 0.05)
    for name in ("w", "delz", "zh", "pe", "peln", "pk3", "ppe"):
        a = np.asarray(j[name])
        np.testing.assert_allclose(t[name].numpy(), a, rtol=1e-12,
                                   atol=1e-12 * np.abs(a).max(), err_msg=name)


def test_cuda_wrapper_cpu_tensor_takes_plain_path():
    args = [torch.as_tensor(a) for a in _inputs(12, 64, 5)]
    before = cuda_sim1.sim1_solver_cuda.launches
    got = cuda_sim1.sim1_solver_cuda(30.0, *args, KAPPA, 0.05)
    want = tnh.sim1_solver(30.0, *args, KAPPA, 0.05)
    assert cuda_sim1.sim1_solver_cuda.launches == before
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_cuda_wrapper_rejects_grad_and_bad_shapes():
    args = [torch.as_tensor(a) for a in _inputs(6, 16, 6)]
    grad_args = list(args)
    grad_args[4] = grad_args[4].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        cuda_sim1.sim1_solver_cuda(30.0, *grad_args, KAPPA, 0.05)
    bad = list(args)
    bad[3] = bad[3][:-1]                       # pem must have km+1 levels
    with pytest.raises(ValueError, match="pem"):
        cuda_sim1.sim1_solver_cuda(30.0, *bad, KAPPA, 0.05)
    mixed = list(args)
    mixed[0] = mixed[0].float()
    with pytest.raises(ValueError, match="dtype"):
        cuda_sim1.sim1_solver_cuda(30.0, *mixed, KAPPA, 0.05)


def test_cuda_module_without_nvcc():
    """The module imports on a host without nvcc (it did, above); there a
    build raises instead of falling back."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if shutil.which("nvcc") or os.path.exists(os.path.join(home, "bin",
                                                           "nvcc")):
        pytest.skip("this host has nvcc")
    if cuda_sim1.library_path().exists():
        pytest.skip("the library is already built")
    assert cuda_sim1.library_path().name.startswith("libsim1_")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_sim1.build()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_tile_plan_fits_every_km(dtype):
    """Every km from 2 to 137 gets a tile of 32, 16 or 8 columns whose
    shared memory fits a block, with threads a multiple of the tile."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    for km in range(2, 138):
        tile, threads, smem = cuda_sim1.plan(km, itemsize)
        assert tile in (32, 16, 8) and threads % tile == 0
        assert smem == cuda_sim1.smem_bytes(km, tile, itemsize)
        assert smem <= cuda_sim1.SMEM_LIMIT
    # the c96L72 float32 shape takes the widest tile
    assert cuda_sim1.plan(72, 4)[0] == 32


@pytest.mark.parametrize("dtype,km", [(torch.float64, 500),
                                      (torch.float32, 1000)])
def test_cuda_wrapper_rejects_km_above_shared_memory(dtype, km):
    """A column too deep for the smallest tile raises, naming the limit,
    on any device: the wrapper takes what the kernel takes."""
    args = [torch.as_tensor(a, dtype=dtype) for a in _inputs(km, 4, 8)]
    with pytest.raises(ValueError, match=str(cuda_sim1.SMEM_LIMIT)):
        cuda_sim1.sim1_solver_cuda(30.0, *args, KAPPA, 0.05)
