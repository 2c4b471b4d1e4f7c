"""The SIM1 CUDA kernel against its plain PyTorch version, and the TL/AD
pair on the GPU against the CPU, on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU host without JAX, from the repo root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX).  Without a card its
tests skip.  `sim1_inputs` also feeds the CPU tests of test_torch_sim1.py.

The cases are those of chip_smoke.py's kernel phase: the c96L72 shape of
the main path, a 4096-column slice of it, a small float64 case, and for
km = 2, 10, 72 and 127 in both dtypes a ragged B on the 16-byte copy path
(1004), a ragged B on the element copy path (1001) and a B under one tile
(5).  float32 must equal the plain version bit for bit (the kernel keeps
its operation order and rounding); float64 is held to rtol = atol = 1e-12.

The TL/AD check is chip_smoke.py's phase_tlad_small at c12L10 float64,
hydrostatic and nonhydrostatic: step_tl/step_ad on the GPU equal the CPU's
to 1e-10 relative norm per field, the dot-product identity holds below
1e-12 on the card, and SIM1's kernel runs 2 x n_split times in the
nonhydrostatic `forward` and never in the differentiated stages.  The
physics check is chip_smoke.py's phase_phys_small at c8L12 float64 with
the turbulence and moist modes 1 and 2: step_nl/step_tl/step_ad on the
GPU equal the CPU's to 1e-10 of each field's largest value, the identity
holds below 1e-12 on the card counting cfcn, mode 1 convects somewhere,
and SIM1 never runs.  The tape check is chip_smoke.py's phase_tapes:
decisions recorded on the card are stored in the same packed bytes as on
the CPU, replay to the recorded decisions, and qsat's table index takes
2 bytes a value (uint16).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from fv3jedi_lm_tpu_torch.constants import GRAV, KAPPA, RGAS
from fv3jedi_lm_tpu_torch.core import nh_core
from fv3jedi_lm_tpu_torch.ops import cuda_sim1


def sim1_inputs(km, ncol, seed):
    """Random physical column inputs (tests/test_pallas_sim1.py), numpy."""
    rng = np.random.default_rng(seed)
    pe_ref = np.linspace(100.0, 1.0e5, km + 1)
    dm2 = np.repeat((pe_ref[1:] - pe_ref[:-1])[:, None], ncol, 1)
    dm2 *= 1.0 + 0.05 * rng.random((km, ncol))
    pt2 = 250.0 + 30.0 * rng.random((km, ncol))
    pm2 = np.repeat((0.5 * (pe_ref[1:] + pe_ref[:-1]))[:, None], ncol, 1)
    pem = np.repeat(pe_ref[:, None], ncol, 1)
    dz2 = -(dm2 / GRAV) * RGAS * pt2 / pm2 * (
        1.0 + 0.02 * rng.random((km, ncol)))
    w2 = 0.5 * rng.standard_normal((km, ncol))
    ws = 0.1 * rng.standard_normal(ncol)
    return dm2, pt2, pm2, pem, w2, dz2, ws


CASES = ([("float32", 72, 6 * 102 * 102), ("float32", 72, 4096),
          ("float64", 12, 200)]
         + [(dtype, km, ncol) for dtype in ("float32", "float64")
            for km in (2, 10, 72, 127) for ncol in (1004, 1001, 5)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,km,ncol", CASES)
def test_cuda_kernel_matches_plain_on_card(dtype, km, ncol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dtype = getattr(torch, dtype)
    args = [torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in sim1_inputs(km, ncol, 7)]
    want = nh_core.sim1_solver(30.0, *args, KAPPA, 0.05)
    before = cuda_sim1.sim1_solver_cuda.launches
    got = cuda_sim1.sim1_solver_cuda(30.0, *args, KAPPA, 0.05)
    torch.cuda.synchronize()
    assert cuda_sim1.sim1_solver_cuda.launches == before + 1
    for name, a, b in zip(("pe", "w", "dz"), want, got):
        if dtype == torch.float32:
            assert torch.equal(a, b), (name, float((a - b).abs().max()))
        else:
            torch.testing.assert_close(b, a, rtol=1e-12, atol=1e-12,
                                       msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(chip_smoke.TLAD_SMALL))
def test_tlad_gpu_matches_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    kw = chip_smoke.TLAD_SMALL[name]
    res = chip_smoke.tlad_devices(kw)
    for sweep in ("tl", "ad"):
        for k, want in res["cpu"][sweep].items():
            got = res["cuda"][sweep][k]
            assert np.isfinite(got).all(), (sweep, k)
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 1e-10, (sweep, k, rel)
    assert res["cuda"]["dot"] < 1e-12, res["cuda"]["dot"]
    want_fwd = 0 if kw.get("hydrostatic", True) else 2 * kw["n_split"]
    assert res["cuda"]["fwd_launches"] == want_fwd
    assert res["cuda"]["mixed_launches"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2])
def test_physics_gpu_matches_cpu(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = chip_smoke.phys_devices(mode)
    for sweep in ("nl", "tl", "ad"):
        for k, want in res["cpu"][sweep].items():
            got = res["cuda"][sweep][k]
            assert np.isfinite(got).all(), (sweep, k)
            d = np.abs(got - want).max()
            assert d <= 1e-10 * np.abs(want).max(), (sweep, k, d)
    assert res["cuda"]["dot"] < 1e-12, res["cuda"]["dot"]
    assert res["cuda"]["sim1"] == 0
    if mode == 1:
        assert res["cuda"]["doconvec"] > 0


@pytest.mark.cuda
def test_tape_storage_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    nbool, nbits, index = chip_smoke.tape_storage("cuda")
    # four predicates, an fscan of 6 rows of 15, and dqsat's three
    # decisions (the clip's two and the saturation) of 101 values
    sizes = [7, 16, 45, 72 * 13 * 11] + [15] * 6 + [101] * 3
    assert nbits == sum(sizes)
    assert nbool == sum((n + 7) // 8 for n in sizes)
    assert index == (torch.uint16, 2)
