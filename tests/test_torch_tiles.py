"""The port's decomposition into (face, y, x) tiles (parallel/faces.py,
parallel/exchange.py), laid out as the JAX package lays out its device
mesh (`__graft_entry__._mesh_for`): gloo ranks on the CPU, float64, in
the layouts (2, 1, 2) (four ranks: three faces each, halved in x) and
(2, 2, 2) (eight ranks: three faces each, quartered), against one
process of the port and against the JAX package.

* Every cross-face entry of parallel/halo.py on tiles is bitwise the
  single process's in every rank's window, and so is its jvp; its vjp,
  taken from the points each rank holds, is within 1e-14 (the transpose
  adds in another order), and <E t, w> == <t, E^T w> over the ranks to
  1e-14; `g_sum` is bitwise: value, jvp and gradient.
* step_nl, step_tl and step_ad at c12L10 (chip_smoke.TLAD_SMALL,
  hydrostatic and nonhydrostatic) are within 1e-12 of one process, and
  the pair passes the dot-product identity over the ranks at 1e-12.
* The staged TL/AD at tests/test_multidevice.py's configuration and
  inputs on (2, 2, 2), the layout of its sharded test, is within 1e-12
  of the JAX package's `step_tl`/`step_ad`.
* The physics pair (the turbulence and moist modes 1 and 2) at c8L12
  (chip_smoke.PHYS_SMALL_KW) is within 1e-12 of one process.
* The 4D-Var window (run_nl, run_tl, run_ad; nt 2, saveltraj) at c12L10
  is within 1e-12 of one process.

Each layout runs once, in one spawn of its ranks through chip_smoke's
workers (a spawned rank must not import this module, which imports JAX),
while this process computes the references; all of it runs once per test
session (tests/torch_shared.py `per_session`).  The JAX package's staged
TL/AD runs beside it in a process of its own, and is kept across runs
(`shared`).
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fv3jedi_lm_tpu.config import DynConfig as JaxDynConfig
from fv3jedi_lm_tpu.config import LMConfig as JaxLMConfig
from fv3jedi_lm_tpu.lm import PROG_3D
from fv3jedi_lm_tpu.lm import LinearModel as JaxLinearModel
from fv3jedi_lm_tpu_torch.grid.topology import get_topology
from fv3jedi_lm_tpu_torch.lm import LinearModel
from fv3jedi_lm_tpu_torch.parallel.faces import layout, run_faces
from torch_shared import per_session, shared

torch.set_num_threads(1)

#: seconds after which a layout's spawn is killed
TIMEOUT = 600.0
#: the layouts, by their rank count
LAYOUTS = {4: (2, 1, 2), 8: (2, 2, 2)}
HALO_NPX = 13
HALO_SEED = 7
STEP_NAMES = ("hydrostatic", "nonhydrostatic")
MODES = (1, 2)
#: tests/test_multidevice.py's configuration
MULTIDEVICE_KW = dict(npx=9, npy=9, npz=5, n_split=1, k_split=1,
                      d2_bg_k1=0.2, d2_bg_k2=0.1, n_sponge=2,
                      dtype="float64")


def _multidevice_case():
    """tests/test_multidevice.py's inputs (the rest state plus 2 K of
    noise on t, a 1e-3 perturbation, seed 0) from the port's rest state
    (bitwise the JAX package's), and a cotangent for the AD (seed 1):
    a faces_steps case, numpy."""
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.lm import traj_to_numpy

    lm = LinearModel.create(LMConfig(dyn=DynConfig(**MULTIDEVICE_KW),
                                     dt=450.0), device="cpu")
    traj = traj_to_numpy(lm.rest_traj())
    rng = np.random.default_rng(0)
    traj["t"] = traj["t"] + 2.0 * rng.standard_normal(traj["t"].shape)
    tr = {k: traj[k] for k in PROG_3D + ("phis",)}
    pert = {k: 1e-3 * rng.standard_normal(tr[k].shape) for k in PROG_3D}
    rng = np.random.default_rng(1)
    cot = {k: 1e-3 * rng.standard_normal(tr[k].shape) for k in PROG_3D}
    return (MULTIDEVICE_KW, 450.0, tr, pert, cot)


def _jax_multidevice(case):
    """The JAX package's staged TL/AD (the programs tests/test_multidevice
    .py compiles) on `case`, numpy.  Run in a process of its own (its
    tracing would share this process's interpreter lock with the port's
    eager references), it sets up JAX as the tests do, by
    tests/conftest.py."""
    import conftest  # noqa: F401

    _, dt, tr, pert, cot = case
    lm = JaxLinearModel.create(JaxLMConfig(dyn=JaxDynConfig(**MULTIDEVICE_KW),
                                           dt=dt))
    as_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    tl = jax.tree_util.tree_map(np.asarray, lm.step_tl(as_j(tr), as_j(pert)))
    ad = jax.tree_util.tree_map(np.asarray, lm.step_ad(as_j(tr), as_j(cot)))
    return dict(tl=tl, ad=ad)


def _all(md_case):
    """Every spawn of the file and one process's results: the spawns of
    both layouts (chip_smoke.tiles_small: the exchanges, the steps, the
    physics and the window on every rank; on (2, 2, 2) also the staged
    TL/AD of `md_case`) run in threads while this process computes the
    references."""
    kws = {name: chip_smoke.TLAD_SMALL[name] for name in STEP_NAMES}
    trajs = {name: chip_smoke.tlad_traj(kw) for name, kw in kws.items()}
    cases = [(kw, 450.0, trajs[name], *chip_smoke.perts_numpy(kw))
             for name, kw in kws.items()]
    phys_case = chip_smoke.phys_case()
    wkw = chip_smoke.TLAD_SMALL["hydrostatic"]
    wdx = chip_smoke.perts_numpy(wkw, (3,))[0]
    kw = dict(backend="gloo", device="cpu", timeout=TIMEOUT)
    def spawn(ranks):
        return pool.submit(
            run_faces, chip_smoke.tiles_small, HALO_NPX, HALO_SEED,
            cases + [md_case] * (ranks == 8),
            {mode: phys_case for mode in MODES},
            (wkw, trajs["hydrostatic"], wdx), ranks=ranks, **kw)

    with ThreadPoolExecutor(2) as pool:
        jobs = {ranks: spawn(ranks) for ranks in sorted(LAYOUTS)}
        inputs = chip_smoke.halo_inputs(HALO_NPX, HALO_SEED)
        want = dict(
            halos=chip_smoke.halo_results(get_topology(HALO_NPX), inputs,
                                          "cpu"),
            steps={name: chip_smoke.tlad_devices(kw_, ("cpu",),
                                                 trajs[name])["cpu"]
                   for name, kw_ in kws.items()},
            phys={mode: chip_smoke.phys_cpu(mode) for mode in MODES},
            window=chip_smoke.window_run(
                LinearModel.create(chip_smoke.window_cfg(wkw),
                                   device="cpu"),
                trajs["hydrostatic"], wdx))
        runs = {ranks: job.result() for ranks, job in jobs.items()}
    out = {}
    for ranks, results in runs.items():
        out[ranks] = dict(
            halos=dict(got=[r["halos"] for r in results], want=want["halos"],
                       inputs=inputs),
            steps={name: dict(
                got=chip_smoke.join_results([r["steps"][i] for r in results]),
                want=want["steps"][name])
                for i, name in enumerate(STEP_NAMES)},
            phys={mode: dict(
                got=chip_smoke.join_results([r["phys"][mode]
                                           for r in results]),
                want=want["phys"][mode]) for mode in MODES},
            window=dict(got=chip_smoke.join_results([r["window"]
                                                   for r in results]),
                        want=want["window"]))
    out["multidevice"] = chip_smoke.join_results([r["steps"][2]
                                                 for r in runs[8]])
    return out


def _jax_apart(case):
    """_jax_multidevice(case) in a spawned process."""
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        return pool.submit(_jax_multidevice, case).result()


@pytest.fixture(scope="module")
def results(request):
    """_all's results, and the JAX package's staged TL/AD (_jax_multidevice,
    kept across runs) at the case of the port's (2, 2, 2) staged TL/AD,
    computed beside them."""
    md_case = _multidevice_case()
    with ThreadPoolExecutor(1) as pool:
        want = pool.submit(shared, request, _jax_apart, md_case)
        out = per_session(request, lambda: _all(md_case))
        out["multidevice"] = dict(got=out["multidevice"], want=want.result())
    return out


@pytest.fixture(scope="module", params=sorted(LAYOUTS), ids=lambda r:
                "x".join(map(str, LAYOUTS[r])))
def tiles(request, results):
    assert layout(request.param) == LAYOUTS[request.param]
    return results[request.param]


@pytest.fixture(scope="module")
def multidevice(results):
    return results["multidevice"]


# ---- the exchanges -------------------------------------------------------

@pytest.mark.parametrize("case", sorted(chip_smoke.HALO_CASES))
def test_tile_exchange_bitwise(tiles, case):
    """Each exchange on tiles: outputs and jvp bitwise the single
    process's in every window, the vjp within 1e-14 on the points each
    rank holds, and the adjoint identity over the ranks to 1e-14."""
    h = tiles["halos"]
    chip_smoke.check_tile_halos(h["got"], h["want"], h["inputs"], HALO_NPX,
                                f"tiles {case}", cases=(case,))


@pytest.mark.parametrize("mode", [0, 1])
def test_tile_g_sum_bitwise(tiles, mode):
    """g_sum over the tiles: value, jvp and gradient bitwise the single
    process's, whatever the layout."""
    h = tiles["halos"]
    for what in ("value", "jvp", "grad"):
        k = f"g_sum/{mode}/{what}"
        want = h["want"][k]
        for r, got in enumerate(h["got"]):
            if isinstance(want, float):
                assert got[k] == want, (k, r)
        if not isinstance(want, float):
            joined = chip_smoke.join_results([{k: g[k]} for g in h["got"]])
            np.testing.assert_array_equal(joined[k], want, err_msg=k)


# ---- the steps -----------------------------------------------------------

@pytest.mark.parametrize("sweep", ["nl", "tl", "ad"])
@pytest.mark.parametrize("name", STEP_NAMES)
def test_tile_step_matches_one_process(tiles, name, sweep):
    """step_nl, step_tl and step_ad on tiles, joined, within 1e-12 of one
    process, field by field."""
    s = tiles["steps"][name]
    for k, want in s["want"][sweep].items():
        got = s["got"][f"{sweep}/{k}"]
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=f"{name} {sweep} {k}")


@pytest.mark.parametrize("name", STEP_NAMES)
def test_tile_dot_product(tiles, name):
    """<M dx, dy> == <dx, M^T dy> over the ranks to 1e-12."""
    g = tiles["steps"][name]["got"]
    assert abs(g["lhs"] - g["rhs"]) <= 1e-12 * abs(g["lhs"]), (g["lhs"],
                                                               g["rhs"])


@pytest.mark.parametrize("sweep", ["tl", "ad"])
def test_tile_staged_matches_jax(multidevice, sweep):
    """The port's staged TL/AD on (2, 2, 2), the layout of
    tests/test_multidevice.py's sharded test, at its configuration and
    inputs, within 1e-12 of the JAX package's single-device
    step_tl/step_ad."""
    for k in PROG_3D:
        np.testing.assert_allclose(multidevice["got"][f"{sweep}/{k}"],
                                   multidevice["want"][sweep][k], rtol=1e-12,
                                   atol=1e-12, err_msg=f"staged {sweep}/{k}")


# ---- the physics and the window ------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_tile_physics_matches_one_process(tiles, mode):
    """step_nl, step_tl and step_ad with the turbulence and moist mode
    `mode` at c8L12 on tiles, within 1e-12 of one process, and the pair's
    dot-product identity over the ranks at 1e-12."""
    p = tiles["phys"][mode]
    for sweep in ("nl", "tl", "ad"):
        for k, want in p["want"][sweep].items():
            got = p["got"][f"{sweep}/{k}"]
            assert np.isfinite(got).all(), k
            np.testing.assert_allclose(got, want, rtol=1e-12,
                                       atol=1e-12 * np.abs(want).max(),
                                       err_msg=f"mode {mode} {sweep} {k}")
    g = p["got"]
    assert abs(g["lhs"] - g["rhs"]) <= 1e-12 * abs(g["lhs"])


def test_tile_window_matches_one_process(tiles):
    """run_nl, run_tl and run_ad (nt 2, saveltraj) on tiles within 1e-12
    of one process; the window's dot-product identity over the ranks at
    1e-12; each rank caches its own steps, fewer bytes than one process
    caches."""
    w = tiles["window"]
    for key, want in w["want"].items():
        if not isinstance(want, np.ndarray):
            continue
        np.testing.assert_allclose(w["got"][key], want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=f"window {key}")
    g = w["got"]
    assert abs(g["lhs"] - g["rhs"]) <= 1e-12 * abs(g["lhs"])
    assert 0 < g["cached"] < w["want"]["cached"]
