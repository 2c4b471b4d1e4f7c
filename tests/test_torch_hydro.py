"""The port's hydrostatic path against the JAX package.

* operators: xppm/yppm at iord 1, 2 and the banded sponge tuple;
  map1_ppm at kord 17 (cs_profile |kord| > 16); the hydrostatic pressure
  chain geopk -> p_grad_c -> one_grad_p; the hydrostatic c_sw; and d_sw
  in its hydrostatic perturbation scheme (hord 2 with the hord-1 sponge
  band, the perturbation damping with vorticity damping) and in the
  trajectory scheme of the linearization (hord 9 with the hord-1 band);
  random float64 inputs from a seed, every output to 1e-12 * max|ref|;
* the single hydrostatic acoustic substep of tests/test_operators.py
  (c12L6, `_substep_carry`) reproduces its GOLD fingerprints at the
  tolerances that test uses (no JAX run);
* `step_nl` at tests/test_lm.py's DYN_KW (c12L10, dt=450) from the bump
  state with humidity, one step and the three steps of `_spun_up`, every
  field to 1e-12 * max|ref|;
* `step_tl`/`step_ad` (split linearization on, the production default) at
  DYN_KW from `_spun_up`'s trajectory and `_rand_pert(1)`/`_rand_pert(2)`,
  each field to 1e-10 relative norm;
* the branch tapes of substep 0 (stages a, b, c) and of the post stage,
  entry for entry and byte for byte (packed decisions, compacted indices)
  against the JAX package's, which sit in its `_traj_cache` after the JAX
  `step_tl`.

The JAX models are built from tests/test_lm.py's own DYN_KW and helpers,
so that their programs are those that file compiles (and may find in the
persistent compilation cache).  The JAX operators are compiled at XLA
backend optimization level 0 (a shorter compile; only the rounding order
changes, which the tolerances cover).  Each JAX reference is computed once
and kept across runs as numpy (tests/torch_shared.py `shared`).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from fv3jedi_lm_tpu.config import DynConfig as JaxDynConfig
from fv3jedi_lm_tpu.config import LMConfig as JaxLMConfig
from fv3jedi_lm_tpu.core import dyn_core as jdc
from fv3jedi_lm_tpu.grid.device import to_device as jax_to_device
from fv3jedi_lm_tpu.grid.metrics import build_grid as jax_build_grid
from fv3jedi_lm_tpu.lm import LinearModel as JaxLinearModel
from fv3jedi_lm_tpu.ops import d_sw as jdsw
from fv3jedi_lm_tpu.ops import fv_mapz as jmapz
from fv3jedi_lm_tpu.ops import ppm as jppm
from fv3jedi_lm_tpu.ops import sw_core as jsw
from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
from fv3jedi_lm_tpu_torch.core import dyn_core as tdc
from fv3jedi_lm_tpu_torch.core import freeze
from fv3jedi_lm_tpu_torch.grid.device import to_device
from fv3jedi_lm_tpu_torch.grid.metrics import build_grid
from fv3jedi_lm_tpu_torch.lm import (LinearModel, traj_from_numpy,
                                     traj_to_numpy)
from fv3jedi_lm_tpu_torch.ops import d_sw as tdsw
from fv3jedi_lm_tpu_torch.ops import fv_mapz as tmapz
from fv3jedi_lm_tpu_torch.ops import ppm as tppm
from fv3jedi_lm_tpu_torch.ops import sw_core as tsw
from test_lm import DYN_KW, _rand_pert, _spun_up
from torch_shared import shared

torch.set_num_threads(1)

HYD_FIELDS = ("u", "v", "t", "delp", "qv", "ql", "qi", "o3")
NPX, NPZ = 13, 8
O0 = {"xla_backend_optimization_level": 0}


def _jit0(fn, *args):
    """`fn` jitted and compiled at XLA backend optimization level 0."""
    return jax.jit(fn).lower(*args).compile(compiler_options=O0)(*args)


def _npy(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol, name):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    d = np.abs(got - want).max()
    assert d <= rtol * np.abs(want).max(), (name, d, np.abs(want).max())


@pytest.fixture(scope="module")
def grids():
    gm = build_grid(NPX, big=1.0e30)
    jgm = jax_build_grid(NPX, big=1.0e30)
    return (gm, to_device(gm, torch.float64, torch.device("cpu")),
            jgm, jax_to_device(jgm, jnp.float64))


# ---------------------------------------------------------------- ppm --------

@pytest.mark.parametrize("ax", [-1, -2])
@pytest.mark.parametrize("iord", [1, 2, (2, 1, 3), (9, 1, 3)],
                         ids=["1", "2", "2-band1", "9-band1"])
def test_ppm_flux_matches_jax(iord, ax):
    """x (ax -1) and y (ax -2) PPM fluxes on 5 levels; the tuple runs the
    sponge scheme on levels [0, 3) and the main scheme below."""
    rng = np.random.default_rng(3)
    n, ic = 12, 18
    shape = (5, 6, ic, ic)
    q = 300.0 + 10.0 * rng.standard_normal(shape)
    cshape = list(shape)
    cshape[ax] = n + 1
    c = rng.uniform(-0.9, 0.9, cshape)
    dxa = 1.0 + 0.1 * rng.random(shape[1:])
    jfn = jppm.xppm if ax == -1 else jppm.yppm
    tfn = tppm.xppm if ax == -1 else tppm.yppm
    want = jfn(jnp.asarray(q), jnp.asarray(c), iord, jnp.asarray(dxa))
    got = tfn(torch.as_tensor(q), torch.as_tensor(c), iord,
              torch.as_tensor(dxa))
    _close(got, want, 1e-12, f"iord {iord}")


# ---------------------------------------------------------------- remap ------

@pytest.mark.parametrize("iv", [0, 1, -1])
def test_map1_ppm_kord17_matches_jax(iv):
    """The fully linear remap of the perturbation scheme (kord 17) for
    tracers (iv 0), temperature (1) and winds (-1)."""
    rng = np.random.default_rng(5 + iv)
    km, b = 16, 40
    ps = 1.0e5 * (1.0 + 0.05 * rng.standard_normal(b))
    kp = np.linspace(0.0, 1.0, km + 1)[:, None]
    pe1 = 1.0 + (ps[None, :] - 1.0) * kp ** 1.2
    pe2 = 1.0 + (ps[None, :] - 1.0) * kp ** 1.0
    q = 1.0 + 0.5 * rng.random((km, b))
    want = _jit0(lambda a, c, d: jmapz.map1_ppm(a, c, None, d, iv, 17),
                 jnp.asarray(pe1), jnp.asarray(q), jnp.asarray(pe2))
    got = tmapz.map1_ppm(torch.as_tensor(pe1), torch.as_tensor(q), None,
                         torch.as_tensor(pe2), iv, 17)
    _close(got, want, 1e-12, f"iv {iv}")


# ---------------------------------------------------------------- pressure ---

PGRAD_OUT = ("pe", "peln", "pk", "gz", "pkz", "uc", "vc", "u", "v")


@pytest.fixture(scope="module")
def pgrad(request, grids):
    """geopk -> p_grad_c (C grid) and geopk -> one_grad_p (D grid)."""
    gm, grid, jgm, jgrid = grids
    rng = np.random.default_rng(13)
    jc, jb = NPX + 5, NPX + 6
    lead = (NPZ, 6)
    delp = 1000.0 * (1.0 + 0.1 * rng.random(lead + (jc, jc)))
    pt = 11.0 * (1.0 + 0.05 * rng.standard_normal(lead + (jc, jc)))
    hs = 100.0 * rng.random((6, jc, jc))
    uc = 10.0 * rng.standard_normal(lead + (jc, jb))
    vc = 10.0 * rng.standard_normal(lead + (jb, jc))
    u = 10.0 * rng.standard_normal(lead + (jb, jc))
    v = 10.0 * rng.standard_normal(lead + (jc, jb))
    ptop, akap, dt = 300.0, 0.2857, 75.0

    def jfn(delp, pt, hs, uc, vc, u, v):
        pe, peln, pk, gz, pkz = jdc.geopk(ptop, delp, pt, hs, akap)
        uc, vc = jdc.p_grad_c(0.5 * dt, pk, gz, uc, vc, jgrid, NPX)
        divg2 = jnp.zeros((6, jb, jb))
        u, v = jdc.one_grad_p(u, v, pk, gz, divg2, dt, jgrid, NPX, ptop,
                              akap, 0.0)
        return pe, peln, pk, gz, pkz, uc, vc, u, v

    args = (delp, pt, hs, uc, vc, u, v)
    want = shared(request, lambda: _npy(_jit0(
        jfn, *[jnp.asarray(a) for a in args])))
    delp, pt, hs, uc, vc, u, v = [torch.as_tensor(a) for a in args]
    pe, peln, pk, gz, pkz = tdc.geopk(ptop, delp, pt, hs, akap)
    uc, vc = tdc.p_grad_c(0.5 * dt, pk, gz, uc, vc, grid, NPX)
    u, v = tdc.one_grad_p(u, v, pk, gz, dt, grid, NPX, ptop, akap)
    return dict(zip(PGRAD_OUT, want)), dict(zip(PGRAD_OUT, (
        pe, peln, pk, gz, pkz, uc, vc, u, v)))


@pytest.mark.parametrize("key", PGRAD_OUT)
def test_hydrostatic_pressure_gradient_matches_jax(pgrad, key):
    want, got = pgrad
    _close(got[key], want[key], 1e-12, key)


# ---------------------------------------------------------------- c_sw -------

C_SW_OUT = ("delpc", "ptc", "wc", "uc", "vc", "divg_d", "ua", "va", "ut",
            "vt")


def _sw_inputs(seed):
    rng = np.random.default_rng(seed)
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


C_SW_DT2 = 37.5


def _jax_c_sw(jgm, jgrid):
    """The JAX package's hydrostatic c_sw on _sw_inputs(17), numpy."""
    return _npy(_jit0(
        lambda *a: jsw.c_sw(*a, jgrid, jgm.topo, C_SW_DT2, 1, True, NPX),
        *[jnp.asarray(a) for a in _sw_inputs(17)[:7]]))


@pytest.fixture(scope="module")
def c_sw_out(request, grids):
    gm, grid, jgm, jgrid = grids
    want = shared(request, lambda: _jax_c_sw(jgm, jgrid))
    got = tsw.c_sw(*[torch.as_tensor(a) for a in _sw_inputs(17)[:7]], grid,
                   C_SW_DT2, 1, NPX, hydrostatic=True)
    return dict(zip(C_SW_OUT, want)), dict(zip(C_SW_OUT, got))


@pytest.mark.parametrize("key", C_SW_OUT)
def test_hydrostatic_c_sw_matches_jax(c_sw_out, key):
    want, got = c_sw_out
    _close(got[key], want[key], 1e-12, key)


def test_kept_reference_is_computed_again_bitwise(c_sw_out, grids):
    """The JAX c_sw that `c_sw_out` read from the references kept across
    runs (tests/torch_shared.py `shared`), computed again here, is the
    same bit for bit."""
    _, _, jgm, jgrid = grids
    again = dict(zip(C_SW_OUT, _jax_c_sw(jgm, jgrid)))
    for key, want in c_sw_out[0].items():
        np.testing.assert_array_equal(again[key], want, err_msg=key)


# ---------------------------------------------------------------- d_sw -------

D_SW_OUT = ("delp", "pt", "u", "v", "divg_d", "divd_b", "cx", "cy", "xflux",
            "yflux", "heat_source")
#: DYN_KW's perturbation sponge (n_sponge_pert 4: hord-1 band on levels
#: [0, 3)) on 8 levels
D_SW_KW = dict(npx=NPX, npy=NPX, npz=NPZ, d2_bg_k1=0.2, d2_bg_k2=0.1,
               n_sponge=3, n_sponge_pert=4, d2_bg_k1_pert=0.2,
               d2_bg_k2_pert=0.1, d2_bg_ks_pert=0.1, hydrostatic=True)


@pytest.fixture(scope="module", params=["pert", "traj_sponge"])
def d_sw_out(request, grids):
    """d_sw of one scheme of the linearization: "pert" is the perturbation
    scheme (hord 2 with the hord-1 band, _kcoef_pert with vorticity
    damping), "traj_sponge" the trajectory scheme inside it (hord 9 with
    the hord-1 band, the trajectory damping)."""
    gm, grid, jgm, jgrid = grids
    cfg = DynConfig(**D_SW_KW).resolve()
    jcfg = JaxDynConfig(**D_SW_KW).resolve()
    dev = torch.device("cpu")
    if request.param == "pert":
        h, jh = tdc._pert_hords(cfg, NPZ), jdc._pert_hords(jcfg, NPZ)
        kc = tdc._kcoef_pert(cfg, NPZ, torch.float64, dev)
        jkc = jdc._kcoef_pert(jcfg, NPZ, jnp.float64)
        assert kc["do_vort_damp"] and h["hord_mt"] == (2, 1, 3)
    else:
        h, jh = (tdc._traj_sponge_hords(cfg, NPZ),
                 jdc._traj_sponge_hords(jcfg, NPZ))
        kc = tdc._kcoef(cfg, NPZ, torch.float64, dev)
        jkc = jdc._kcoef(jcfg, NPZ, jnp.float64)
        assert h["hord_mt"] == (9, 1, 3)
    assert h == jh
    hords = (jh["hord_mt"], jh["hord_vt"], jh["hord_tm"], jh["hord_dp"])
    args = _sw_inputs(11)
    dt = 75.0
    want = shared(request, lambda: _npy(_jit0(
        lambda *a: jdsw.d_sw(*a, jgrid, jgm.topo, dt, NPX, *hords, jkc,
                             True),
        *[jnp.asarray(a) for a in args])))
    got = tdsw.d_sw(*[torch.as_tensor(a) for a in args], grid, gm.topo, dt,
                    NPX, *hords, kc, hydrostatic=True)
    return want, got


@pytest.mark.parametrize("key", D_SW_OUT)
def test_hydrostatic_d_sw_matches_jax(d_sw_out, key):
    want, got = d_sw_out
    _close(got[key], want[key], 1e-12, key)


# ---------------------------------------------------------------- GOLD -------

def _gold():
    path = os.path.join(os.path.dirname(__file__), "test_operators.py")
    spec = importlib.util.spec_from_file_location("_gold_ops", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GOLD


GOLD = _gold()


@pytest.fixture(scope="module")
def gold_substep():
    """tests/test_operators.py `_substep_carry` on the port: one
    hydrostatic acoustic substep at the deterministic c12L6 state."""
    lm = LinearModel.create(LMConfig(
        dyn=DynConfig(npx=13, npy=13, npz=6, n_split=1, k_split=1,
                      d2_bg_k1=0.2, d2_bg_k2=0.1, n_sponge=2,
                      n_sponge_pert=3), dt=450.0), device="cpu")
    tr = lm.rest_traj()
    n, npz = lm.cfg.dyn.nx, lm.cfg.dyn.npz
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    faces = np.arange(6)[:, None, None]
    ks = np.arange(npz)[:, None, None, None]
    bump = (3.0 * np.sin(2.0 * np.pi * (jj + 0.5) / n + 0.7 * faces)
            * np.cos(2.0 * np.pi * (ii + 0.5) / n + 0.3 * faces)
            * np.cos(0.5 * np.pi * ks / npz))
    tr["t"] = tr["t"] + torch.as_tensor(bump)
    stepper = lm._staged()
    s = stepper._stages
    with torch.no_grad():
        st, q = s["prep"]({k: tr[k] for k in lm.prog_3d}, tr["phis"])
        st2, dp1, carry = s["pre"](st)
        return stepper._sub_traj(carry, dict(phis=st2["phis"]))


@pytest.mark.parametrize("key", sorted(GOLD))
def test_acoustic_substep_gold(gold_substep, key):
    """test_operators.py test_acoustic_substep_golden on the port."""
    s_want, v_want = GOLD[key]
    x = gold_substep[key].numpy()
    idx = (min(2, x.shape[0] - 1), 2, 5, 7)
    np.testing.assert_allclose(float(np.abs(x).sum()), s_want, rtol=1e-10,
                               err_msg=f"{key} |sum|")
    np.testing.assert_allclose(float(x[idx]), v_want, rtol=1e-9,
                               atol=1e-300, err_msg=f"{key} probe")


# ---------------------------------------------------------------- the step ---

def _jax_model():
    return JaxLinearModel.create(JaxLMConfig(dyn=JaxDynConfig(**DYN_KW),
                                             dt=450.0))


@pytest.fixture(scope="module")
def jax_model(request):
    """The states `_spun_up` steps the JAX model at DYN_KW through, the
    spun-up trajectory, and the model's step_nl of the first state, as
    numpy."""
    def compute():
        jlm = _jax_model()
        seen = []
        step = jlm.step_nl

        def spy(tr):
            seen.append({k: np.asarray(v) for k, v in tr.items()})
            return step(tr)

        jlm.step_nl = spy
        traj = _spun_up(jlm)
        jlm.step_nl = step
        one = jlm.step_nl({k: jnp.asarray(v) for k, v in seen[0].items()})
        return seen, _npy(traj), _npy(one)

    return shared(request, compute)


@pytest.fixture(scope="module")
def port():
    return LinearModel.create(LMConfig(dyn=DynConfig(**DYN_KW), dt=450.0),
                              device="cpu")


@pytest.fixture(scope="module")
def nl_steps(jax_model, port):
    seen, traj, one_jax = jax_model
    first = seen[0]
    tr = traj_from_numpy(port, first)
    one = traj_to_numpy(port.step_nl(tr))
    for _ in range(len(seen)):
        tr = port.step_nl(tr)
    spun = traj_to_numpy(tr)
    return {"one_step": (one_jax, one, first),
            "spun_up": (traj, spun, first)}


@pytest.mark.parametrize("field", HYD_FIELDS)
@pytest.mark.parametrize("run", ["one_step", "spun_up"])
def test_hydrostatic_step_nl_matches_jax(nl_steps, run, field):
    """One step from the bump state with humidity, and the three steps of
    test_lm._spun_up, to 1e-12 * max|ref| per field."""
    ref, got, first = nl_steps[run]
    _close(got[field], ref[field], 1e-12, field)
    if field in ("u", "v", "t", "qv"):
        # the step moved the field: the comparison is not of inputs
        assert np.abs(ref[field] - first[field]).max() > 1e-8


# ---------------------------------------------------------------- TL / AD ----

@pytest.fixture(scope="module")
def tlad(request, jax_model, port):
    """step_tl(traj, _rand_pert(1)) and step_ad(traj, _rand_pert(2)) of
    both packages at the same spun-up trajectory, and the two packages'
    tapes, as numpy."""
    _, traj, _ = jax_model

    def compute():
        jlm = _jax_model()
        jtr = {k: jnp.asarray(v) for k, v in traj.items()}
        dx = _rand_pert(jlm, 1)
        dy = _rand_pert(jlm, 2)
        tl = jlm.step_tl(jtr, dx)
        ad = jlm.step_ad(jtr, dy)
        (_, (_, jtapes, _, _)), = jlm._traj_cache.values()
        sub0 = jax.tree.map(lambda x: np.asarray(x[0]),
                            tuple(jtapes["sub"][0]))
        return dict(dx=_npy(dx), dy=_npy(dy), tl=_npy(tl), ad=_npy(ad),
                    tapes=dict(sub0=[list(t) for t in sub0],
                               post=_npy(list(jtapes["post"][0]))))

    ref = shared(request, compute)
    tr = traj_from_numpy(port, traj)
    ptl = port.step_tl(tr, traj_from_numpy(port, ref["dx"]))
    pad = port.step_ad(tr, traj_from_numpy(port, ref["dy"]))
    _, ptapes, _, _ = port._ckpts(tr)
    port_tapes = dict(sub0=list(ptapes["sub"][0][0]), post=ptapes["post"][0])
    return dict(tl=(ref["tl"], traj_to_numpy(ptl)),
                ad=(ref["ad"], traj_to_numpy(pad)),
                tapes=(port_tapes, ref["tapes"]), traj=tr)


@pytest.mark.parametrize("field", HYD_FIELDS)
@pytest.mark.parametrize("sweep", ["tl", "ad"])
def test_hydrostatic_tlad_matches_jax(tlad, sweep, field):
    ref, got = tlad[sweep]
    a, b = ref[field], got[field]
    assert a.shape == b.shape and np.isfinite(b).all()
    rel = np.linalg.norm(b - a) / np.linalg.norm(a)
    assert rel <= 1e-10, (sweep, field, rel)


def _entries(port_entry, jax_entry, path, out):
    """(path, port tensor, JAX array) leaves of two tapes, lists
    (fscan entries) descended in step."""
    if isinstance(port_entry, (list, tuple)):
        assert isinstance(jax_entry, (list, tuple)), path
        assert len(port_entry) == len(jax_entry), (path, len(port_entry),
                                                   len(jax_entry))
        for i, (p, j) in enumerate(zip(port_entry, jax_entry)):
            _entries(p, j, path + (i,), out)
    else:
        out.append((path, port_entry, np.asarray(jax_entry)))
    return out


def _decisions(p, j):
    """The bytes the port's entry `p` and the JAX package's entry `j`
    store, as numpy arrays of equal shape and dtype: a boolean entry
    bit-packed on both sides (`freeze.Packed` against the JAX package's
    `_pack`, one packed row per fscan iteration), an integer entry
    compacted alike."""
    p = p.data.numpy() if isinstance(p, freeze.Packed) else p.numpy()
    assert p.shape == j.shape and p.dtype == j.dtype, (p.shape, p.dtype,
                                                       j.shape, j.dtype)
    return p, j


def _bits(x, shape):
    """Packed bytes `x` (*rows, nbytes) as the decisions they hold, bool
    (*rows, *shape)."""
    n = int(np.prod(shape))
    return np.unpackbits(x, axis=-1, count=n).reshape(
        x.shape[:-1] + tuple(shape)).astype(bool)


def _differing(p, j):
    """None where the port's entry `p` and the JAX package's entry `j`
    store the same bytes; else the mask of the decisions that differ, in
    the recorded decision's shape (the bytes unpacked only here)."""
    pp, jj = _decisions(p, j)
    if np.array_equal(pp, jj):
        return None
    if isinstance(p, freeze.Packed):
        return _bits(pp, p.shape) != _bits(jj, p.shape)
    return pp != jj


_CMP = {"gt", "ge", "lt", "le", "eq", "ne", "greater", "greater_equal",
        "less", "less_equal", "__gt__", "__ge__", "__lt__", "__le__",
        "__eq__", "__ne__"}
_LOGIC = {"__and__", "__or__", "__xor__", "__rand__", "__ror__",
          "logical_and", "logical_or", "logical_xor", "bitwise_and",
          "bitwise_or"}
_NOT = {"__invert__", "logical_not", "bitwise_not"}
_SHAPE = {"cat", "concat", "stack", "__getitem__", "reshape", "view",
          "expand", "expand_as", "broadcast_to", "unsqueeze", "squeeze",
          "clone", "contiguous", "flatten", "flip", "to", "select",
          "narrow", "movedim", "permute", "transpose", "unbind", "split",
          "chunk"}


class _TieMode(TorchFunctionMode):
    """Tracks, for every boolean tensor made while it is active, which
    lanes are ties: a comparison whose operands agree to 1e-12 of their
    scale (the larger magnitude over the compared tensors), and what
    logical and shape operations make of such lanes."""

    def __init__(self):
        super().__init__()
        self.ties = {}

    def tie(self, x):
        if isinstance(x, (list, tuple)):
            return type(x)(self.tie(y) for y in x)
        if isinstance(x, torch.Tensor) and x.dtype == torch.bool:
            hit = self.ties.get(id(x))
            return hit[1] if hit is not None and hit[0] is x else (
                torch.zeros_like(x))
        return x

    def _keep(self, out, tie):
        if (isinstance(out, torch.Tensor) and out.dtype == torch.bool
                and isinstance(tie, torch.Tensor)
                and tie.shape == out.shape):
            self.ties[id(out)] = (out, tie)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        bools = (out if isinstance(out, (tuple, list)) else (out,))
        if not any(isinstance(o, torch.Tensor) and o.dtype == torch.bool
                   for o in bools):
            return out
        if name in _CMP:
            a, b = (torch.as_tensor(x, dtype=torch.float64)
                    for x in args[:2])
            scale = max(float(a.abs().max()), float(b.abs().max()))
            self._keep(out, ((a - b).abs() <= 1e-12 * scale).expand(
                out.shape))
        elif name in _LOGIC:
            ta, tb = (self.tie(x) for x in args[:2])
            self._keep(out, torch.logical_or(
                torch.as_tensor(ta, dtype=torch.bool),
                torch.as_tensor(tb, dtype=torch.bool)).expand(out.shape))
        elif name in _NOT:
            self._keep(out, self.tie(args[0]))
        elif name in _SHAPE:
            t = func(*self.tie(args), **kwargs)
            if isinstance(out, (tuple, list)):
                for o, tt in zip(out, t):
                    self._keep(o, tt)
            else:
                self._keep(out, t)
        return out


def _tree(fn, x, lead=0):
    """fn(leaf, its number of row axes) over a raw tape entry (lists are
    fscan entries, each level one more row axis)."""
    if isinstance(x, list):
        return [_tree(fn, y, lead + 1) for y in x]
    return fn(x, lead)


class _Forced(list):
    """A recording tape that keeps the port's own raw decisions at each
    entry and hands the port the JAX package's decision instead (unpacked
    and written into the boolean predicate in place), so that every
    decision is computed from the same upstream decisions as the JAX
    package's."""

    def __init__(self, jax_entries):
        super().__init__()
        self.jax = jax_entries
        self.own = []

    def append(self, entry):
        assert len(self) < len(self.jax), "the port records more entries"
        j = self.jax[len(self)]
        self.own.append(_tree(lambda x, lead: x.clone(), entry))
        if isinstance(entry, torch.Tensor) and entry.dtype == torch.bool:
            want = (_bits(j, entry.shape) if entry.dim() else j)
            entry.copy_(torch.as_tensor(want))
        super().append(entry)


@torch.no_grad()
def _forced_decisions(port, tr, which, jax_tapes):
    """The port's own decisions of the `which` stages, each computed with
    the JAX package's decisions upstream, packed as `freeze.recording`
    packs them, and their tie masks in the decisions' shapes (_TieMode;
    None for integer entries)."""
    cks = port._ckpts(tr)[0]
    stepper = port._staged()
    st2, dp1 = stepper._pre_fwd(cks["pre_in"][0][0])
    mode = _TieMode()
    own = []

    def run(fn, args, jax_entries):
        tape = _Forced(jax_entries)
        prev = freeze._state
        freeze._state = ["rec", tape]
        try:
            with mode:
                out = fn(*args)
        finally:
            freeze._state = prev
        assert len(tape) == len(jax_entries)
        own.append(tape.own)
        return out

    if which == "post":
        run(lambda *a: stepper._stages["post"](*a, True, "mixed"),
            (st2, cks["carry_fin"][0], cks["pre_in"][0][1], dp1), jax_tapes)
        own = own[0]
    else:
        consts = dict(phis=st2["phis"])
        sa, sb, sc = stepper._sub_mix.stages
        ab = run(sa, (stepper._expand_carry(cks["carries"][0][0]), consts),
                 jax_tapes[0])
        bc = run(sb, (ab, consts), jax_tapes[1])
        run(sc, (bc, consts), jax_tapes[2])

    def tie(x, lead):
        return mode.tie(x).numpy() if x.dtype == torch.bool else None

    if which == "post":
        return freeze.pack_tape(own), [_tree(tie, e) for e in own]
    return ([freeze.pack_tape(t) for t in own],
            [[_tree(tie, e) for e in t] for t in own])


def _untied(leaves, own, ties, jax_tape, root):
    """(number of differing decisions at ties, the paths and counts of
    those that differ elsewhere): the port's own decisions `own`
    (recorded with the JAX package's upstream) against the JAX package's,
    over the entries whose recorded bytes differ."""
    n_tie, untied = 0, []
    for (path, p, j), (_, o, _), (_, t, _) in zip(
            leaves, _entries(own, jax_tape, root, []),
            _entries(ties, jax_tape, root, [])):
        diff = _differing(o, j)
        if diff is None:
            continue
        tie = np.zeros_like(diff) if t is None else t
        n_tie += int((diff & tie).sum())
        if (diff & ~tie).any():
            untied.append(f"{path}: {int((diff & ~tie).sum())} of "
                          f"{diff.size} decisions differ where the operands "
                          "do not tie")
    return n_tie, untied


@pytest.mark.parametrize("which", ["sub0", "post"])
def test_tapes_match_jax(tlad, port, which):
    """Substep 0 (stages a, b, c) and the post stage: equal entry counts,
    and each entry's stored bytes (packed decisions, compacted indices)
    equal to the JAX package's.  Where they differ, the stage is recorded
    again with the JAX package's decisions handed to the port at every
    entry, so that no difference propagates; there each of the port's own
    decisions must equal the JAX package's or be a tie, the comparison
    that made it having operands that agree to 1e-12 of their scale.  Ties
    are printed; every other mismatch is named in the failure."""
    port_tapes, jax_tapes = tlad["tapes"]
    leaves = _entries(port_tapes[which], jax_tapes[which], (which,), [])
    assert len(leaves) > 0
    n_diff = 0
    for path, p, j in leaves:
        diff = _differing(p, j)
        n_diff += 0 if diff is None else int(diff.sum())
    if n_diff == 0:
        return
    own, ties = _forced_decisions(port, tlad["traj"], which,
                                  jax_tapes[which])
    n_tie, untied = _untied(leaves, own, ties, jax_tapes[which], (which,))
    print(f"{which}: {n_diff} decisions differ in the recorded tapes; with "
          f"the upstream decisions equal, {n_tie} ties and "
          f"{len(untied)} entries with other differences")
    assert not untied, "; ".join(untied)
