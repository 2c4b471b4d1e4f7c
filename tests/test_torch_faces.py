"""The port's face decomposition (parallel/faces.py, parallel/exchange.py,
parallel/ppermute.py): six gloo ranks on the CPU, one cube face each,
float64, against one process of the port and against the JAX package.

* Every cross-face entry of parallel/halo.py, decomposed, is bitwise the
  single process's, and so is its jvp; its vjp is within 1e-14 (the
  transpose adds in another order) and passes the adjoint identity
  <E t, w> == <t, E^T w> to 1e-14.
* `fill_halo_center_ppermute` is bitwise the port's `fill_halo_center`
  and the JAX package's `fill_halo_center_ppermute` (on 6 of conftest's
  8 virtual CPU devices, as tests/test_ppermute.py runs it).
* `g_sum` is bitwise the single process's: value, jvp and gradient.
* step_nl, step_tl and step_ad at c12L10 (chip_smoke.TLAD_SMALL,
  hydrostatic and nonhydrostatic, and hydrostatic with consv_te) are
  within 1e-12 of one process, and the decomposed pair passes the
  dot-product identity at 1e-12.
* The staged TL/AD at tests/test_multidevice.py's configuration and
  inputs is within 1e-12 of the JAX package's `step_tl`/`step_ad` (the
  same programs that file compiles, so the JAX compile cache serves
  them).
* A rank makes a model with the physics, and a layout that does not
  split the faces raises; a rank's window raises on a whole-cube state;
  a rank's error and a job past its timeout are raised by `run_faces`,
  the ranks killed.

The six-rank jobs run through chip_smoke's workers (a spawned rank must
not import this module, which imports JAX), each killed past TIMEOUT
seconds.  Each job runs once per test session (tests/torch_shared.py
`per_session`), and the JAX reference is kept across runs (`shared`).
"""

import multiprocessing
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import chip_smoke
from fv3jedi_lm_tpu.config import DynConfig as JaxDynConfig
from fv3jedi_lm_tpu.config import LMConfig as JaxLMConfig
from fv3jedi_lm_tpu.grid.topology import get_topology as jax_topology
from fv3jedi_lm_tpu.lm import PROG_3D
from fv3jedi_lm_tpu.lm import LinearModel as JaxLinearModel
from fv3jedi_lm_tpu.parallel.ppermute import (
    fill_halo_center_ppermute as jax_ppermute)
from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
from fv3jedi_lm_tpu_torch.grid.topology import get_topology
from fv3jedi_lm_tpu_torch.lm import LinearModel
from fv3jedi_lm_tpu_torch.parallel.faces import FaceGroup, run_faces
from torch_shared import per_session, shared

torch.set_num_threads(1)

#: seconds after which a six-rank job is killed
TIMEOUT = 300.0
HALO_NPX = (13, 25)
HALO_SEED = 7
#: the step cases: chip_smoke.TLAD_SMALL's two modes, and consv_te
STEP_KW = {
    "hydrostatic": chip_smoke.TLAD_SMALL["hydrostatic"],
    "nonhydrostatic": chip_smoke.TLAD_SMALL["nonhydrostatic"],
    "consv_te": dict(chip_smoke.TLAD_SMALL["hydrostatic"], consv_te=1.0),
}
#: tests/test_multidevice.py's configuration
MULTIDEVICE_KW = dict(npx=9, npy=9, npz=5, n_split=1, k_split=1,
                      d2_bg_k1=0.2, d2_bg_k2=0.1, n_sponge=2,
                      dtype="float64")


# ---- the halo layer ------------------------------------------------------

def _halos():
    out = {}
    for npx in HALO_NPX:
        inputs = chip_smoke.halo_inputs(npx, HALO_SEED)
        parts = run_faces(chip_smoke.faces_halos, npx, HALO_SEED,
                          backend="gloo", device="cpu", timeout=TIMEOUT)
        out[npx] = dict(
            got=chip_smoke.join_results(parts),
            want=chip_smoke.halo_results(get_topology(npx), inputs, "cpu"),
            inputs=inputs)
    return out


@pytest.fixture(scope="module")
def halos(request):
    return per_session(request, _halos)


@pytest.mark.parametrize("case", sorted(chip_smoke.HALO_CASES))
@pytest.mark.parametrize("npx", HALO_NPX)
def test_exchange_bitwise(halos, npx, case):
    """The decomposed exchange, joined, equals the single process's gather
    bit for bit, and so does its jvp."""
    h = halos[npx]
    keys = [k for k in h["want"] if k.startswith(f"{case}/")
            and "/vjp/" not in k]
    assert len(keys) in (2, 4)
    for k in keys:
        np.testing.assert_array_equal(h["got"][k], h["want"][k], err_msg=k)


@pytest.mark.parametrize("case", sorted(chip_smoke.HALO_CASES))
def test_exchange_transpose(halos, case):
    """The decomposed vjp is the single process's within 1e-14, and the
    exchange's jvp and vjp pass <E t, w> == <t, E^T w> to 1e-14."""
    for npx in HALO_NPX:
        h = halos[npx]
        _, ts, ws = h["inputs"][case]
        lhs = rhs = 0.0
        for i in range(len(ts)):
            got = h["got"][f"{case}/vjp/{i}"]
            want = h["want"][f"{case}/vjp/{i}"]
            np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)
            lhs += float(np.vdot(h["got"][f"{case}/jvp/{i}"], ws[i]))
            rhs += float(np.vdot(ts[i], got))
        assert abs(lhs - rhs) <= 1e-14 * abs(lhs), (npx, lhs, rhs)


def _jax_ppermute(q):
    """The JAX package's exchange of q (..., 6, jc, jc), jitted, on a mesh
    of six devices (the topology is the cached one: the plan cache is
    keyed by the id of its map)."""
    mesh = Mesh(np.asarray(jax.devices()[:6]), ("face",))
    spec = P(*([None] * (q.ndim - 3)), "face", None, None)
    qs = jax.device_put(jnp.asarray(q), NamedSharding(mesh, spec))
    topo = jax_topology(q.shape[-1] - 5)
    return np.asarray(jax.jit(lambda x: jax_ppermute(x, topo, mesh))(qs))


@pytest.mark.parametrize("case", ["center", "center_2d"])
@pytest.mark.parametrize("npx", HALO_NPX)
def test_ppermute_matches_gather_and_jax(halos, npx, case):
    """The port's fill_halo_center_ppermute on six ranks is bitwise the
    port's fill_halo_center and the JAX package's ppermute exchange."""
    if jax.device_count() < 6:
        pytest.skip("needs 6 JAX devices")
    h = halos[npx]
    got = h["got"][f"ppermute/{case}"]
    np.testing.assert_array_equal(got, h["want"][f"{case}/fwd/0"])
    np.testing.assert_array_equal(got,
                                  _jax_ppermute(h["inputs"][case][0][0]))


@pytest.mark.parametrize("mode", [0, 1])
def test_g_sum_bitwise(halos, mode):
    """g_sum over six ranks: value, jvp and gradient bitwise the single
    process's."""
    for npx in HALO_NPX:
        h = halos[npx]
        for what in ("value", "jvp", "grad"):
            k = f"g_sum/{mode}/{what}"
            np.testing.assert_array_equal(h["got"][k], h["want"][k],
                                          err_msg=k)


# ---- the steps -----------------------------------------------------------

def _steps():
    """The six ranks' steps of every case, in one job in a thread, while
    this process computes one process's."""
    trajs = {name: chip_smoke.tlad_traj(kw) for name, kw in STEP_KW.items()}
    cases = [(kw, 450.0, trajs[name], *chip_smoke.perts_numpy(kw))
             for name, kw in STEP_KW.items()]
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(run_faces, chip_smoke.faces_steps, cases,
                          backend="gloo", device="cpu", timeout=TIMEOUT)
        want = {name: chip_smoke.tlad_devices(kw, ("cpu",), trajs[name])["cpu"]
                for name, kw in STEP_KW.items()}
        ranks = job.result()
    return {name: dict(got=chip_smoke.join_results([r[i] for r in ranks]),
                       want={k: want[name][k] for k in ("nl", "tl", "ad")})
            for i, name in enumerate(STEP_KW)}


@pytest.fixture(scope="module")
def steps(request):
    return per_session(request, _steps)


@pytest.mark.parametrize("sweep", ["nl", "tl", "ad"])
@pytest.mark.parametrize("name", sorted(STEP_KW))
def test_decomposed_step_matches_one_process(steps, name, sweep):
    """step_nl, step_tl and step_ad of six ranks, joined, within 1e-12 of
    one process of the port, field by field."""
    s = steps[name]
    for k, want in s["want"][sweep].items():
        got = s["got"][f"{sweep}/{k}"]
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=f"{name} {sweep} {k}")


@pytest.mark.parametrize("name", sorted(STEP_KW))
def test_decomposed_dot_product(steps, name):
    """<M dx, dy> == <dx, M^T dy> over the six ranks to 1e-12."""
    g = steps[name]["got"]
    assert abs(g["lhs"] - g["rhs"]) <= 1e-12 * abs(g["lhs"]), (g["lhs"],
                                                               g["rhs"])


# ---- the staged TL/AD against the JAX package ----------------------------

def _jax_multidevice():
    """tests/test_multidevice.py's inputs and single-device staged TL/AD
    (the same programs), numpy."""
    lm = JaxLinearModel.create(JaxLMConfig(dyn=JaxDynConfig(**MULTIDEVICE_KW),
                                           dt=450.0))
    traj = lm.rest_traj()
    rng = np.random.default_rng(0)
    traj["t"] = traj["t"] + 2.0 * rng.standard_normal(traj["t"].shape)
    prog = {k: jnp.asarray(traj[k]) for k in PROG_3D}
    pert = {k: jnp.asarray(1e-3 * rng.standard_normal(v.shape))
            for k, v in prog.items()}
    tr = dict(prog, phis=traj["phis"])
    tl = jax.tree_util.tree_map(np.asarray, lm.step_tl(tr, pert))
    seed = {k: jnp.asarray(v) for k, v in tl.items()}
    ad = jax.tree_util.tree_map(np.asarray, lm.step_ad(tr, seed))
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}
    return dict(tr=as_np(tr), pert=as_np(pert), tl=tl, ad=ad)


@pytest.fixture(scope="module")
def multidevice(request):
    """The JAX package's staged TL/AD (_jax_multidevice) and the port's on
    six ranks at its inputs."""
    ref = shared(request, _jax_multidevice)
    ranks = per_session(request, lambda: run_faces(
        chip_smoke.faces_steps,
        [(MULTIDEVICE_KW, 450.0, ref["tr"], ref["pert"], ref["tl"])],
        backend="gloo", device="cpu", timeout=TIMEOUT))
    return dict(got=chip_smoke.join_results([r[0] for r in ranks]),
                want=dict(tl=ref["tl"], ad=ref["ad"]))


@pytest.mark.parametrize("sweep", ["tl", "ad"])
def test_decomposed_staged_matches_jax(multidevice, sweep):
    """The port's staged TL/AD on six ranks at tests/test_multidevice.py's
    configuration and inputs, within 1e-12 of the JAX package's
    single-device step_tl/step_ad."""
    for k in PROG_3D:
        np.testing.assert_allclose(
            multidevice["got"][f"{sweep}/{k}"],
            multidevice["want"][sweep][k], rtol=1e-12, atol=1e-12,
            err_msg=f"staged {sweep}/{k}")


# ---- what a decomposition refuses, and run_faces' failures ---------------

def _rank0():
    """A FaceGroup of face 0 with no process group: enough for a model
    whose first call raises before any exchange."""
    return FaceGroup(0, "gloo", "cpu")


def test_decomposed_physics_raises():
    """A rank of a decomposition runs the physics (a model with them is
    made on a face's rank); a layout that does not split the faces'
    cells raises."""
    cfg = LMConfig(dyn=DynConfig(**chip_smoke.PHYS_SMALL_KW), dt=450.0,
                   do_phy_trb=True, do_phy_mst=1)
    lm = LinearModel.create(cfg, device="cpu", faces=_rank0())
    assert lm.nf == 1 and lm._turb is not None and lm._moist is not None
    odd = LMConfig(dyn=DynConfig(**dict(chip_smoke.PHYS_SMALL_KW, npx=10,
                                        npy=10)),
                   dt=450.0, do_phy_trb=True, do_phy_mst=1)
    with pytest.raises(ValueError, match="does not split"):
        LinearModel.create(odd, device="cpu",
                           faces=FaceGroup(0, "gloo", "cpu", 8))


@pytest.mark.parametrize("run", ["run_nl", "run_tl", "run_ad"])
def test_decomposed_window_raises(run):
    """A rank's window runs on its face's states and raises, naming the
    shape it holds, on a whole-cube state."""
    lm = LinearModel.create(
        LMConfig(dyn=DynConfig(**MULTIDEVICE_KW), dt=450.0), device="cpu",
        faces=_rank0())
    assert lm.nf == 1 and lm.grid["area"].shape[0] == 1
    whole = LinearModel.create(
        LMConfig(dyn=DynConfig(**MULTIDEVICE_KW), dt=450.0), device="cpu")
    traj = whole.rest_traj()
    args = {"run_nl": (traj,), "run_tl": ([traj], whole.zero_pert()),
            "run_ad": ([traj], whole.zero_pert())}[run]
    with pytest.raises(ValueError, match="this model holds"):
        getattr(lm, run)(*args)


def test_run_faces_raises_a_rank_error():
    """A rank's exception comes back with its traceback."""
    with pytest.raises(RuntimeError, match="TypeError"):
        run_faces(divmod, backend="gloo", device="cpu", timeout=TIMEOUT)
    assert not multiprocessing.active_children()


def test_run_faces_kills_past_its_timeout():
    """A job past its timeout raises at once and leaves no rank running."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_faces(chip_smoke.faces_halos, 13, HALO_SEED, backend="gloo",
                  device="cpu", timeout=1.0)
    assert time.monotonic() - t0 < 30.0
    assert not multiprocessing.active_children()
