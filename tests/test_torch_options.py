"""The port's dynamics options against the JAX package.

* Operators, on random float64 fields from numpy seeds at c12: the PPM
  schemes iord 1-13 (xppm/yppm and the D-grid wind fluxes xtp_u/ytp_v),
  cs_profile/map1_ppm for kord 9 and 10 at every iv, mapn_tracer/fillz
  (tests/test_mapn.py's cases), a2b_ord2, c2l_ord4, g_sum (also against
  math.fsum), del2_cubed, adv_pe, mix_dp (tests/test_mix_dp.py's cases),
  grad1_p_update, split_p_grad, rayleigh_super/rayleigh_friction,
  update_dz_d with del-n damping and tracer_2d with trdm2.  Each output
  agrees to 1e-12 of its largest value, each branch tape entry for entry
  and byte for byte (packed decisions), and a vjp through each port operator runs under
  `torch.autograd.set_detect_anomaly`.
* Steps, one case per option at the configuration of the JAX package's
  test of that option (tests/test_energetics.py, test_beta.py,
  test_rayleigh.py, test_mix_dp.py, test_omega.py, test_sponge_depth.py):
  `step_nl` against the JAX package to 1e-11, and the dot-product
  identity of the port's step_tl/step_ad to that JAX test's tolerance.
  `step_tl`/`step_ad` against the JAX package to 1e-11, and their tapes
  byte for byte (differing decisions only at ties), for the production
  options together (hord 10, kord 9, d_con with the vorticity damping,
  consv_te, tau, fill_dp): one JAX TL/AD compile costs minutes on one
  core.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fv3jedi_lm_tpu.config import DynConfig as JaxDynConfig
from fv3jedi_lm_tpu.config import LMConfig as JaxLMConfig
from fv3jedi_lm_tpu.core import dyn_core as jdc
from fv3jedi_lm_tpu.core import freeze as jfreeze
from fv3jedi_lm_tpu.core import fv_dynamics as jfv
from fv3jedi_lm_tpu.core import nh_core as jnh
from fv3jedi_lm_tpu.core import tracer2d as jtr
from fv3jedi_lm_tpu.grid.device import to_device as jax_to_device
from fv3jedi_lm_tpu.grid.eta import default_ak_bk
from fv3jedi_lm_tpu.grid.metrics import build_grid as jax_build_grid
from fv3jedi_lm_tpu.grid.topology import get_topology as jax_topology
from fv3jedi_lm_tpu.lm import LinearModel as JaxLinearModel
from fv3jedi_lm_tpu.ops import a2b_edge as ja2b
from fv3jedi_lm_tpu.ops import c2l as jc2l
from fv3jedi_lm_tpu.ops import d_sw as jdsw
from fv3jedi_lm_tpu.ops import fv_mapz as jmapz
from fv3jedi_lm_tpu.ops import ppm as jppm
from fv3jedi_lm_tpu.ops import reductions as jred
from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
from fv3jedi_lm_tpu_torch.core import dyn_core as tdc
from fv3jedi_lm_tpu_torch.core import freeze
from fv3jedi_lm_tpu_torch.core import fv_dynamics as tfv
from fv3jedi_lm_tpu_torch.core import nh_core as tnh
from fv3jedi_lm_tpu_torch.core import tracer2d as ttr
from fv3jedi_lm_tpu_torch.core.staged import _leaves
from fv3jedi_lm_tpu_torch.grid.device import to_device
from fv3jedi_lm_tpu_torch.grid.metrics import build_grid
from fv3jedi_lm_tpu_torch.lm import LinearModel, traj_to_numpy
from fv3jedi_lm_tpu_torch.ops import a2b_edge as ta2b
from fv3jedi_lm_tpu_torch.ops import c2l as tc2l
from fv3jedi_lm_tpu_torch.ops import d_sw as tdsw
from fv3jedi_lm_tpu_torch.ops import fv_mapz as tmapz
from fv3jedi_lm_tpu_torch.ops import ppm as tppm
from fv3jedi_lm_tpu_torch.ops import reductions as tred
from test_torch_hydro import (_differing, _entries, _forced_decisions,
                              _TieMode, _untied)
from torch_shared import shared

torch.set_num_threads(1)

NPX = 13
N = NPX - 1
JC = N + 6
JB = JC + 1
NZ = 3


# ------------------------------------------------------------- helpers ----

@pytest.fixture(scope="module")
def grids():
    """(JAX grid, port grid, topology) at c12 with the float64 sentinel."""
    jgm = jax_build_grid(NPX, big=1.0e30)
    gm = build_grid(NPX, big=1.0e30)
    return (jax_to_device(jgm, jnp.float64),
            to_device(gm, torch.float64, torch.device("cpu")), gm.topo)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(got, ref, tol=1e-12, what=""):
    """Every leaf of `got` within tol * max|ref leaf| of `ref`."""
    gl = _leaves(got, []) if not isinstance(got, torch.Tensor) else [got]
    if isinstance(ref, dict):
        rl = [ref[k] for k in got]
    elif isinstance(ref, (list, tuple)):
        rl = list(ref)
    else:
        rl = [ref]
    assert len(gl) == len(rl), what
    for i, (g, r) in enumerate(zip(gl, rl)):
        g, r = _np(g), _np(r)
        assert g.shape == r.shape, (what, i, g.shape, r.shape)
        assert np.isfinite(g).all(), (what, i)
        scale = max(np.abs(r).max(), 1e-300)
        err = np.abs(g - r).max()
        assert err <= tol * scale, (what, i, err, scale)


def _tapes_equal(port_tape, jax_tape, what=""):
    """The two tapes have the same entries and each entry the same stored
    bytes; a decision may differ only at a tie (its comparison's operands
    agree to 1e-12 of their scale, tests/test_torch_hydro.py _TieMode),
    found on the raw decisions the block recorded.  Returns the number of
    entries."""
    tape, raw, mode = port_tape
    leaves = _entries(list(tape), list(jax_tape), (what,), [])
    for (path, p, j), (_, r, _) in zip(
            leaves, _entries(raw, list(jax_tape), (what,), [])):
        diff = _differing(p, j)
        if diff is not None:
            tie = mode.tie(r).numpy() if r.dtype == torch.bool else False
            assert not (diff & ~tie).any(), (path, int(diff.sum()))
    return len(leaves)


def _jx(fn, *args):
    """fn(*args) of the JAX package, compiled as one program at XLA
    backend optimization level 0 (a short compile; eager JAX compiles
    every operation on its own)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _jax_recorded(jfn, *jargs):
    """(outputs, tape) of the JAX package's jfn(*jargs) recording its
    decisions, compiled as one program (_jx), numpy."""
    def rec(*a):
        with jfreeze.recording() as t:
            out = jfn(*a)
        return out, list(t)

    return jax.tree.map(np.asarray, _jx(rec, *jargs))


def _port_recorded(tfn, targs):
    """(outputs, (tape, its raw decisions, their ties)) of the port's
    tfn(*targs) recording its decisions."""
    mode = _TieMode()
    with freeze.recording() as tt, mode:
        got = tfn(*targs)
        raw = list(tt)        # the decisions before the block packs them
    return got, (tt, raw, mode)


def _both(jfn, tfn, jargs, targs):
    """(JAX outputs, port outputs, JAX tape, (port tape, its raw
    decisions, their ties)) of one operator called on the same inputs,
    both recording their decisions."""
    ref, jt = _jax_recorded(jfn, *jargs)
    got, tt = _port_recorded(tfn, targs)
    return ref, got, jt, tt


def _vjp_anomaly(fn, args):
    """A vjp of the port operator `fn` through every floating input, under
    anomaly detection (no in-place write into a tensor autograd saved, no
    NaN made in the backward pass)."""
    ins = [torch.tensor(a, requires_grad=True)
           if np.asarray(a).dtype.kind == "f" else torch.as_tensor(a)
           for a in args]
    gen = torch.Generator().manual_seed(0)
    with torch.autograd.set_detect_anomaly(True):
        out = fn(*ins)
        outs = [o for o in _leaves(out, []) if o.requires_grad]
        cts = [torch.randn(o.shape, generator=gen, dtype=o.dtype)
               for o in outs]
        want = [x for x in ins if x.requires_grad]
        grads = torch.autograd.grad(outs, want, cts, allow_unused=True)
    assert any(g is not None for g in grads)


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------ PPM schemes --

def _ppm_inputs(seed, ax):
    r = _rng(seed)
    q = 0.3 + r.standard_normal((NZ, 6, JC, JC))
    cshape = (NZ, 6, JC, N + 1) if ax == -1 else (NZ, 6, N + 1, JC)
    return q, r.uniform(-0.8, 0.8, cshape)


@pytest.mark.parametrize("ax", [-1, -2], ids=["x", "y"])
@pytest.mark.parametrize("iord", list(range(1, 14)))
def test_xppm_yppm_schemes(grids, iord, ax):
    jgrid, grid, _ = grids
    q, c = _ppm_inputs(iord, ax)
    dname = "dxa" if ax == -1 else "dya"
    jf = jppm.xppm if ax == -1 else jppm.yppm
    tf = tppm.xppm if ax == -1 else tppm.yppm
    ref, got, jt, tt = _both(lambda a, b: jf(a, b, iord, jgrid[dname]),
                             lambda a, b: tf(a, b, iord, grid[dname]),
                             (jnp.asarray(q), jnp.asarray(c)),
                             (torch.as_tensor(q), torch.as_tensor(c)))
    _close(got, ref, what=f"iord {iord}")
    n = _tapes_equal(tt, jt, f"iord {iord}")
    assert iord in (1, 2) or n > 0
    _vjp_anomaly(lambda a, b: tf(a, b, iord, grid[dname]), (q, c))


@pytest.mark.parametrize("ax", [-1, -2], ids=["u", "v"])
@pytest.mark.parametrize("iord", list(range(1, 14)))
def test_xtp_u_ytp_v_schemes(grids, iord, ax):
    """The D-grid wind fluxes of every scheme (sw_core_nlm.F90:1970-2306)."""
    jgrid, grid, _ = grids
    r = _rng(100 + iord)
    dx = float(np.median(_np(grid["dx"])[:, 3:-3, 3:-3]))
    cb = r.uniform(-0.8, 0.8, (NZ, 6, JB, JB)) * dx
    wshape = (NZ, 6, JB, JC) if ax == -1 else (NZ, 6, JC, JB)
    w = 0.3 + r.standard_normal(wshape)
    m, rm = ("dx", "rdx") if ax == -1 else ("dy", "rdy")
    jf = jdsw.xtp_u if ax == -1 else jdsw.ytp_v
    tf = tdsw.xtp_u if ax == -1 else tdsw.ytp_v
    ref, got, jt, tt = _both(
        lambda a, b: jf(a, b, jgrid[m], jgrid[rm], iord, NPX),
        lambda a, b: tf(a, b, grid[m], grid[rm], iord, NPX),
        (jnp.asarray(cb), jnp.asarray(w)),
        (torch.as_tensor(cb), torch.as_tensor(w)))
    _close(got, ref, what=f"iord {iord}")
    _tapes_equal(tt, jt, f"iord {iord}")
    _vjp_anomaly(lambda a, b: tf(a, b, grid[m], grid[rm], iord, NPX),
                 (cb, w))


# --------------------------------------------------------------- remapping --

def _coords(km, ncol, seed):
    """tests/test_mapn.py's source and target interfaces."""
    rng = _rng(seed)
    pe1 = np.sort(rng.random((km + 1, ncol)), axis=0) * 9.0e4 + 100.0
    pe1[0] = 100.0
    pe1[-1] = 1.0e5
    frac = np.sort(rng.random((km - 1, ncol)), axis=0)
    pe2 = np.concatenate([pe1[:1], 100.0 + frac * (1.0e5 - 100.0),
                          pe1[-1:]], axis=0)
    return pe1, pe2


@pytest.mark.parametrize("iv", [-2, -1, 0, 1, 2])
@pytest.mark.parametrize("kord", [9, 10])
def test_map1_ppm_kord(kord, iv):
    """cs_profile's kord 9 and 10 limiters through map1_ppm, on profiles
    with extrema (the wave and monotonicity switches)."""
    km, ncol = 12, 40
    pe1, pe2 = _coords(km, ncol, 20 + kord)
    r = _rng(30 + kord - iv)
    k = np.arange(km)[:, None]
    q = (0.2 + np.sin(1.3 * k + np.arange(ncol)[None] * 0.7)
         + 0.3 * r.standard_normal((km, ncol)))
    qs = r.standard_normal(ncol)
    ref, got, jt, tt = _both(
        lambda a, b, c, d: jmapz.map1_ppm(a, b, d, c, iv, kord),
        lambda a, b, c, d: tmapz.map1_ppm(a, b, d, c, iv, kord),
        [jnp.asarray(x) for x in (pe1, q, pe2, qs)],
        [torch.as_tensor(x) for x in (pe1, q, pe2, qs)])
    _close(got, ref, what=f"kord {kord} iv {iv}")
    assert _tapes_equal(tt, jt) > 0
    _vjp_anomaly(lambda a, b, c, d: tmapz.map1_ppm(a, b, d, c, iv, kord),
                 (pe1, q, pe2, qs))


def test_mapn_matches_per_tracer_map1(request):
    km, ncol, nq = 12, 30, 6
    pe1, pe2 = _coords(km, ncol, 0)
    q = np.abs(_rng(1).standard_normal((nq, km, ncol))) * 1e-3
    got = tmapz.mapn_tracer(torch.as_tensor(pe1), torch.as_tensor(q),
                            torch.as_tensor(pe2), 8, q_min=0.0)
    ref = shared(request, lambda: np.asarray(_jx(
        lambda a, b, c: jmapz.mapn_tracer(a, b, c, 8, q_min=0.0),
        jnp.asarray(pe1), jnp.asarray(q), jnp.asarray(pe2))))
    _close(got, ref)
    for iq in range(nq):
        want = tmapz.map1_q2(torch.as_tensor(pe1), torch.as_tensor(q[iq]),
                             torch.as_tensor(pe2), 8, q_min=0.0)
        np.testing.assert_allclose(_np(got[iq]), _np(want), rtol=1e-13,
                                   atol=1e-18)


def test_mapn_per_tracer_kords():
    km, ncol = 10, 8
    pe1, pe2 = _coords(km, ncol, 2)
    q = np.abs(_rng(3).standard_normal((3, km, ncol))) * 1e-3
    args = (pe1, q, pe2)
    got = tmapz.mapn_tracer(*map(torch.as_tensor, args), [8, 9, 17],
                            q_min=0.0)
    ref = _jx(lambda *a: jmapz.mapn_tracer(*a, [8, 9, 17], q_min=0.0),
              *map(jnp.asarray, args))
    _close(got, ref)


def test_fillz_noop_on_positive():
    km, ncol = 8, 5
    r = _rng(4)
    q = np.abs(r.standard_normal((km, ncol))) + 0.1
    dp = 1.0 + r.random((km, ncol))
    out = tmapz.fillz(torch.as_tensor(q), torch.as_tensor(dp))
    np.testing.assert_array_equal(_np(out), q)


def test_fillz_fixes_negatives_conservatively():
    km, ncol = 10, 6
    r = _rng(5)
    q = np.abs(r.standard_normal((km, ncol))) * 1e-3 + 1e-4
    dp = 1.0 + r.random((km, ncol))
    q[4, :3] = -2e-4
    q[-1, 3] = -1e-4
    q[0, 4] = -1e-4
    ref, got, jt, tt = _both(jmapz.fillz, tmapz.fillz,
                             (jnp.asarray(q), jnp.asarray(dp)),
                             (torch.as_tensor(q), torch.as_tensor(dp)))
    _close(got, ref)
    assert _tapes_equal(tt, jt) > 0
    out = _np(got)
    assert out.min() >= 0.0
    np.testing.assert_allclose((out * dp).sum(0), (q * dp).sum(0),
                               rtol=1e-12)
    _vjp_anomaly(tmapz.fillz, (q, dp))


def test_mapn_fill_pass():
    km, ncol = 12, 10
    pe1, pe2 = _coords(km, ncol, 6)
    q = _rng(7).standard_normal((2, km, ncol)) * 1e-3 + 2e-3
    args = (pe1, q, pe2)
    got = tmapz.mapn_tracer(*map(torch.as_tensor, args), 8,
                            q_min=-math.inf, fill=True)
    ref = _jx(lambda *a: jmapz.mapn_tracer(*a, 8, q_min=-jnp.inf, fill=True),
              *map(jnp.asarray, args))
    _close(got, ref)


# --------------------------------------------------- horizontal operators --

def test_a2b_ord2(grids):
    jgrid, grid, _ = grids
    q = 1000.0 + _rng(40).standard_normal((NZ, 6, JC, JC))
    _close(ta2b.a2b_ord2(torch.as_tensor(q), grid),
           _jx(lambda x: ja2b.a2b_ord2(x, jgrid), jnp.asarray(q)))
    _vjp_anomaly(lambda x: ta2b.a2b_ord2(x, grid), (q,))


def test_c2l_ord4(grids):
    jgrid, grid, topo = grids
    r = _rng(41)
    u = r.standard_normal((NZ, 6, JB, JC)) * 10.0
    v = r.standard_normal((NZ, 6, JC, JB)) * 10.0
    _close(tc2l.c2l_ord4(torch.as_tensor(u), torch.as_tensor(v), grid, topo,
                         NPX),
           _jx(lambda a, b: jc2l.c2l_ord4(a, b, jgrid, topo, NPX),
               jnp.asarray(u), jnp.asarray(v)))
    _vjp_anomaly(lambda a, b: tc2l.c2l_ord4(a, b, grid, topo, NPX), (u, v))


def test_g_sum_against_fsum_and_jax():
    """tests/test_energetics.py's g_sum case: within 2 ulp of math.fsum,
    mode 1 within 1e-12; the plain sum too; and the tangent and the
    cotangent of the (linear) sum transpose each other."""
    r = _rng(0)
    p = r.standard_normal((6, 12, 12)) * np.logspace(-6, 6, 864).reshape(
        6, 12, 12)
    area = 1.0 + r.random((6, 12, 12))
    exact = math.fsum((p * area).reshape(-1).tolist())
    tp, ta = torch.as_tensor(p), torch.as_tensor(area)
    got = float(tred.g_sum(tp, ta))
    assert abs(got - exact) <= 2 * abs(exact) * np.finfo(np.float64).eps
    assert got == pytest.approx(float(jred.g_sum(jnp.asarray(p),
                                                 jnp.asarray(area))),
                                rel=1e-15)
    mean = float(tred.g_sum(tp, ta, mode=1))
    assert abs(mean - exact / math.fsum(area.reshape(-1).tolist())) < 1e-12
    assert float(tred.g_sum(tp, ta, reproduce=False)) == pytest.approx(
        exact, rel=1e-12)
    dp = torch.as_tensor(r.standard_normal(p.shape))
    for mode in (0, 1):
        _, t = torch.func.jvp(lambda x: tred.g_sum(x, ta, mode), (tp,),
                              (dp,))
        x = tp.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(tred.g_sum(x, ta, mode), x)
        assert float(t) == pytest.approx(float((g * dp).sum()), rel=1e-13)


@pytest.mark.parametrize("nmax", [1, 3])
def test_del2_cubed(grids, nmax):
    jgrid, grid, topo = grids
    q = _rng(42 + nmax).standard_normal((NZ, 6, JC, JC))
    cd = 0.2 * grid["da_min"]
    _close(tdc.del2_cubed(torch.as_tensor(q), cd, grid, topo, nmax, NPX),
           _jx(lambda x: jdc.del2_cubed(x, cd, jgrid, topo, nmax, NPX),
               jnp.asarray(q)))
    _vjp_anomaly(lambda x: tdc.del2_cubed(x, cd, grid, topo, nmax, NPX),
                 (q,))


def _column_pressures(r, nz=NZ, ptop=100.0):
    delp = 3.0e4 / nz * (1.0 + 0.1 * r.random((nz, 6, JC, JC)))
    pe = np.concatenate([np.full((1, 6, JC, JC), ptop),
                         ptop + np.cumsum(delp, axis=0)])
    return delp, pe


def test_adv_pe(grids):
    jgrid, grid, _ = grids
    r = _rng(43)
    ua = r.standard_normal((NZ, 6, JC, JC)) * 10.0
    va = r.standard_normal((NZ, 6, JC, JC)) * 10.0
    _, pem = _column_pressures(r)
    om = r.standard_normal((NZ, 6, JC, JC))
    args = (ua, va, pem, om)
    _close(tdc.adv_pe(*map(torch.as_tensor, args), grid, NPX),
           _jx(lambda *a: jdc.adv_pe(*a, jgrid, NPX),
               *map(jnp.asarray, args)))
    _vjp_anomaly(lambda *a: tdc.adv_pe(*a, grid, NPX), args)


def _dp_ref(npz, ptop=100.0, ps=1.0e5):
    pe = np.linspace(ptop, ps, npz + 1)
    return pe[1:] - pe[:-1]


def test_mix_dp_noop_on_healthy_columns():
    npz = 8
    dp_ref = _dp_ref(npz)
    delp = dp_ref[:, None, None, None] * np.ones((1, 6, 4, 4))
    pt = 280.0 + np.arange(npz)[:, None, None, None] * np.ones((1, 6, 4, 4))
    d2, t2, _ = tdc.mix_dp(torch.as_tensor(delp), torch.as_tensor(pt), None,
                           dp_ref, True)
    assert float((d2 - torch.as_tensor(delp)).abs().max()) == 0.0
    assert float((t2 - torch.as_tensor(pt)).abs().max()) == 0.0


@pytest.mark.parametrize("hydro", [False, True], ids=["nh", "hydrostatic"])
def test_mix_dp_thin_layers(hydro):
    """tests/test_mix_dp.py's thinned layers: the JAX package's values and
    tape, mass and pt*delp (w*delp) conserved, delp >= dpmin."""
    npz = 8
    dp_ref = _dp_ref(npz)
    r = _rng(0)
    delp = dp_ref[:, None, None, None] * np.ones((1, 6, 4, 4))
    pt = 280.0 + r.standard_normal((npz, 6, 4, 4))
    delp[3] *= 0.001
    delp[-1] *= 0.001
    w = r.standard_normal((npz, 6, 4, 4))
    ref, got, jt, tt = _both(
        lambda a, b, c: jdc.mix_dp(a, b, None if hydro else c, dp_ref,
                                   hydro),
        lambda a, b, c: tdc.mix_dp(a, b, None if hydro else c, dp_ref,
                                   hydro),
        [jnp.asarray(x) for x in (delp, pt, w)],
        [torch.as_tensor(x) for x in (delp, pt, w)])
    _close(got[:2] if hydro else got, ref[:2] if hydro else ref)
    assert _tapes_equal(tt, jt) > 0
    d2, t2 = _np(got[0]), _np(got[1])
    dpmin = 0.01 * dp_ref
    assert (d2 - dpmin[:, None, None, None]).min() >= -1e-12
    np.testing.assert_allclose(d2.sum(0), delp.sum(0), rtol=1e-13)
    np.testing.assert_allclose((t2 * d2).sum(0), (pt * delp).sum(0),
                               rtol=1e-12)
    if not hydro:
        np.testing.assert_allclose((_np(got[2]) * d2).sum(0),
                                   (w * delp).sum(0), rtol=1e-12)
    _vjp_anomaly(lambda a, b, c: tdc.mix_dp(a, b, None if hydro else c,
                                            dp_ref, hydro), (delp, pt, w))


def _grad_inputs(seed):
    r = _rng(seed)
    delp, pe = _column_pressures(r)
    akap = 0.2857
    pk = pe ** akap
    gz = np.concatenate([np.cumsum((delp * 10.0)[::-1], axis=0)[::-1],
                         np.zeros((1, 6, JC, JC))]) * 9.8
    u = r.standard_normal((NZ, 6, JB, JC)) * 10.0
    v = r.standard_normal((NZ, 6, JC, JB)) * 10.0
    du = r.standard_normal((NZ, 6, NPX, N)) * 1e-3
    dv = r.standard_normal((NZ, 6, N, NPX)) * 1e-3
    return r, delp, pe, pk, gz, u, v, du, dv, akap


def test_grad1_p_update(grids):
    jgrid, grid, _ = grids
    r, _, pe, pk, gz, u, v, du, dv, akap = _grad_inputs(44)
    divg2 = r.standard_normal((6, JB, JB)) * 1e-3
    args = (u, v, pk, gz, divg2, du, dv)
    _close(tdc.grad1_p_update(*map(torch.as_tensor, args), 75.0, grid, NPX,
                              100.0, akap, 0.4),
           _jx(lambda *a: jdc.grad1_p_update(*a, 75.0, jgrid, NPX, 100.0,
                                             akap, 0.4),
               *map(jnp.asarray, args)))
    _vjp_anomaly(lambda *a: tdc.grad1_p_update(*a, 75.0, grid, NPX, 100.0,
                                               akap, 0.4), args)


def test_split_p_grad(grids):
    jgrid, grid, _ = grids
    r, delp, pe, pk, gz, u, v, du, dv, akap = _grad_inputs(45)
    pp = r.standard_normal((NZ + 1, 6, JC, JC)) * 10.0
    args = (u, v, pp, gz, delp, pk, du, dv)
    _close(tdc.split_p_grad(*map(torch.as_tensor, args), 75.0, grid, NPX,
                            100.0, akap, 0.4),
           _jx(lambda *a: jdc.split_p_grad(*a, 75.0, jgrid, NPX, 100.0,
                                           akap, 0.4),
               *map(jnp.asarray, args)))
    _vjp_anomaly(lambda *a: tdc.split_p_grad(*a, 75.0, grid, NPX, 100.0,
                                             akap, 0.4), args)


@pytest.mark.parametrize("variant", ["super", "friction"])
def test_rayleigh(grids, variant):
    """Rayleigh_Super and Rayleigh_Friction on tests/test_rayleigh.py's
    sponge (tau 5 days, rf_cutoff 50 hPa) at c12L10."""
    jgrid, grid, topo = grids
    npz = 10
    kw = dict(npx=NPX, npy=NPX, npz=npz, tau=5.0, rf_cutoff=50.0e2,
              grid_type=0 if variant == "super" else 4)
    ak, bk = default_ak_bk(npz)
    ptop = float(ak[0])
    r = _rng(46)
    st = dict(u=r.standard_normal((npz, 6, JB, JC)) * 10.0,
              v=r.standard_normal((npz, 6, JC, JB)) * 10.0,
              pt=250.0 + r.standard_normal((npz, 6, JC, JC)),
              delp=np.ones((npz, 6, JC, JC)))
    jf = jfv.rayleigh_super if variant == "super" else jfv.rayleigh_friction
    tf = (tfv.rayleigh_super if variant == "super"
          else tfv.rayleigh_friction)
    pm = tfv.reference_pressure(ak, bk)
    assert (pm < 50.0e2).any()
    ref = _jx(lambda d: jf(d, jgrid, topo, JaxDynConfig(**kw), 900.0, ak,
                           bk, ptop),
              {k: jnp.asarray(v) for k, v in st.items()})
    got = tf({k: torch.as_tensor(v) for k, v in st.items()}, grid, topo,
             DynConfig(**kw), 900.0, pm, ptop)
    for k in ("u", "v", "pt"):
        _close(got[k], ref[k], what=k)
    assert np.abs(_np(got["u"]) - st["u"]).max() > 0.0

    def f(u, v, pt):
        out = tf(dict(st, u=u, v=v, pt=pt), grid, topo, DynConfig(**kw),
                 900.0, pm, ptop)
        return [out["u"], out["v"], out["pt"]]
    _vjp_anomaly(f, (st["u"], st["v"], st["pt"]))


@pytest.mark.parametrize("ndif", [1, 2])
def test_update_dz_d_damping(request, grids, ndif):
    """update_dz_d with its del-n damping (nh_utils_nlm.F90:183-295); the
    JAX half kept across runs on the JAX package's topology."""
    jgrid, grid, topo = grids
    r = _rng(50 + ndif)
    km = NZ
    dp0 = _dp_ref(km)
    zs = np.zeros((6, JC, JC))
    zh = ((km - np.arange(km + 1))[:, None, None, None] * 1000.0
          + 20.0 * r.standard_normal((km + 1, 6, JC, JC)))
    zh[-1] = 0.0
    area = float(np.median(_np(grid["area"])[:, 3:-3, 3:-3]))
    crx = r.uniform(-0.3, 0.3, (km, 6, JC, N + 1))
    cry = r.uniform(-0.3, 0.3, (km, 6, N + 1, JC))
    xfx, yfx = 0.3 * area * crx, 0.3 * area * cry
    damp = np.full((km + 1, 1, 1, 1), (0.1 * grid["da_min"]) ** (ndif + 1))
    args = (zh, crx, cry, xfx, yfx, damp)
    ref, jt = shared(request, lambda *a: _jax_recorded(
        lambda zh, a, b, c, d, e: jnh.update_dz_d(
            75.0, dp0, jnp.asarray(zs), zh, a, b, c, d, 9, jgrid,
            jax_topology(NPX), NPX, damp=e, ndif=ndif),
        *[jnp.asarray(x) for x in a]), *args)
    got, tt = _port_recorded(
        lambda zh, a, b, c, d, e: tnh.update_dz_d(
            75.0, dp0, torch.as_tensor(zs), zh, a, b, c, d, 9, grid, topo,
            damp=e, ndif=ndif), [torch.as_tensor(x) for x in args])
    _close(got, ref)
    assert _tapes_equal(tt, jt) > 0
    _vjp_anomaly(lambda zh, a, b, c, d, e: tnh.update_dz_d(
        75.0, dp0, torch.as_tensor(zs), zh, a, b, c, d, 9, grid, topo,
        damp=e, ndif=ndif), args)


@pytest.mark.parametrize("nord_tr", [0, 1])
def test_tracer_2d_trdm2(request, grids, nord_tr):
    """tracer_2d with the del-n damping of its first sub-cycle (trdm2); the
    JAX half kept across runs on the JAX package's topology."""
    jgrid, grid, topo = grids
    r = _rng(60 + nord_tr)
    area = float(np.median(_np(grid["area"])[:, 3:-3, 3:-3]))
    q = [1e-3 * (1.0 + 0.3 * r.standard_normal((NZ, 6, JC, JC)))
         for _ in range(2)]
    dp1 = 1000.0 * (1.0 + 0.05 * r.random((NZ, 6, JC, JC)))
    cx = r.uniform(-0.3, 0.3, (NZ, 6, JC, N + 1))
    cy = r.uniform(-0.3, 0.3, (NZ, 6, N + 1, JC))
    mfx = 50.0 * area * r.uniform(-1, 1, (NZ, 6, N, N + 1))
    mfy = 50.0 * area * r.uniform(-1, 1, (NZ, 6, N + 1, N))
    kw = dict(npx=NPX, npy=NPX, npz=NZ, nord_tr=nord_tr, trdm2=0.1)
    flx = (dp1, mfx, mfy, cx, cy)
    ref, jt = shared(request, lambda q, flx: _jax_recorded(
        lambda q, *f: jtr.tracer_2d(q, *f, jgrid, jax_topology(NPX),
                                    JaxDynConfig(**kw), NPX, 8,
                                    nord_tr=nord_tr, trdm=0.1),
        [jnp.asarray(x) for x in q], *[jnp.asarray(x) for x in flx]), q, flx)
    got, tt = _port_recorded(
        lambda q, *f: ttr.tracer_2d(q, *f, grid, topo, DynConfig(**kw), NPX,
                                    8, nord_tr=nord_tr, trdm=0.1),
        [[torch.as_tensor(x) for x in q]] + [torch.as_tensor(x)
                                             for x in flx])
    _close(got, ref)
    assert _tapes_equal(tt, jt) > 0
    _vjp_anomaly(lambda q0, q1, *f: ttr.tracer_2d(
        [q0, q1], *f, grid, topo, DynConfig(**kw), NPX, 8, nord_tr=nord_tr,
        trdm=0.1), tuple(q) + flx)


# ------------------------------------------------------------------ steps --

# the JAX package's test configurations of each option
ENERGETICS_KW = dict(npx=13, npy=13, npz=10, n_split=2, k_split=1,
                     d2_bg_k1=0.2, d2_bg_k2=0.1, n_sponge=3, n_sponge_pert=4,
                     d2_bg_k1_pert=0.2, d2_bg_k2_pert=0.1,
                     d2_bg_ks_pert=0.1)
RAYLEIGH_KW = dict(npx=9, npy=9, npz=8, n_split=1, k_split=1, d2_bg_k1=0.2,
                   d2_bg_k2=0.1, n_sponge=2, tau=5.0, rf_cutoff=50.0e2)
# d_con heats only the top n_con levels unless the vorticity damping is
# on (dyn_core._n_con), and those are sponge levels without d_con: the
# vorticity damping makes the heating real
PRODUCTION = dict(hord_mt=10, hord_vt=10, hord_tm=10, hord_dp=10,
                  kord_mt=9, kord_tm=9, kord_tr=9, d_con=1.0, consv_te=1.0,
                  tau=5.0, fill_dp=True, do_vort_damp=True, vtdm4=0.05)
CASES = {
    "consv_te": (dict(ENERGETICS_KW, consv_te=1.0), 450.0, "bump2", 1e-12),
    "beta": (dict(ENERGETICS_KW, beta=0.4), 450.0, "bump2", 1e-12),
    "beta_nh": (dict(ENERGETICS_KW, beta=0.4, hydrostatic=False), 450.0,
                "bump2", 1e-12),
    "rayleigh_super": (RAYLEIGH_KW, 450.0, "winds", 1e-12),
    "rayleigh_friction": (dict(RAYLEIGH_KW, grid_type=4), 450.0, "winds",
                          1e-12),
    "rayleigh_fast": (dict(RAYLEIGH_KW, n_split=2, rayleigh_fast=True),
                      450.0, "winds", 1e-12),
    "fill_dp": (dict(ENERGETICS_KW, fill_dp=True), 450.0, "thin", 1e-12),
    "omega": (dict(npx=13, npy=13, npz=16, n_split=2, k_split=2,
                   compute_omega=True), 900.0, "stirred", None),
    "deep_sponge": (dict(npx=13, npy=13, npz=24, n_split=2, k_split=1,
                         n_sponge=9, d2_bg_k1=0.2, d2_bg_k2=0.12,
                         n_sponge_pert=9, d2_bg_k1_pert=0.2,
                         d2_bg_k2_pert=0.12, d2_bg_ks_pert=0.06), 450.0,
                    "bump2", 1e-12),
    "d_con": (dict(ENERGETICS_KW, d_con=1.0, do_vort_damp=True, vtdm4=0.05),
              450.0, "bump2", 1e-12),
    "d_ext": (dict(ENERGETICS_KW, d_ext=0.02), 450.0, "bump2", 1e-12),
    "hord10_kord9": (dict(ENERGETICS_KW, hord_mt=10, hord_vt=10, hord_tm=10,
                          hord_dp=10, kord_mt=9, kord_tm=9, kord_tr=9),
                     450.0, "bump2", 1e-12),
    "trdm2": (dict(ENERGETICS_KW, nord_tr=1, trdm2=0.1), 450.0, "bump2",
              1e-12),
}
_MODELS = {}


def _traj(lm, kind):
    """The trajectory of the option's JAX test, made on the port."""
    n, npz = lm.cfg.dyn.nx, lm.cfg.dyn.npz
    if kind == "bump2":
        return chip_smoke.spun_up(lm, 2, moist=True)
    tr = lm.rest_traj()
    if kind == "winds":     # tests/test_rayleigh.py _traj
        r = _rng(3)
        tr["u"] = tr["u"] + torch.as_tensor(
            5.0 * r.standard_normal((npz, 6, n + 1, n)))
        tr["v"] = tr["v"] + torch.as_tensor(
            5.0 * r.standard_normal((npz, 6, n, n + 1)))
        return tr
    if kind == "stirred":   # tests/test_omega.py
        ks = np.arange(npz)[:, None, None, None] / (npz - 1.0)
        r = _rng(3)
        tr["u"] = tr["u"] + torch.as_tensor(
            3.0 * np.sin(2 * np.pi * ks) * np.ones(tuple(tr["u"].shape)))
        tr["v"] = tr["v"] + torch.as_tensor(
            0.3 * r.standard_normal(tuple(tr["v"].shape)))
        return tr
    # "thin": tests/test_mix_dp.py's trajectory with a thinned layer
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    faces = np.arange(6)[:, None, None]
    bump = (3.0 * np.sin(2 * np.pi * (jj + 0.5) / n + 0.7 * faces)
            * np.cos(2 * np.pi * (ii + 0.5) / n + 0.3 * faces))
    tr["t"] = tr["t"] + torch.as_tensor(bump)[None]
    delp = tr["delp"].clone()
    delp[4, :, 3:6, 3:6] *= 0.002
    tr["delp"] = delp
    return lm.step_nl(tr)


def _case(name):
    if name not in _MODELS:
        kw, dt, kind, _ = CASES[name]
        lm = LinearModel.create(LMConfig(dyn=DynConfig(**kw), dt=dt),
                                device="cpu")
        _MODELS[name] = (lm, _traj(lm, kind))
    return _MODELS[name]


def _jax_step_nl(name, traj):
    """The JAX package's step_nl of the option `name`'s model, numpy."""
    kw, dt, _, _ = CASES[name]
    jlm = JaxLinearModel.create(JaxLMConfig(dyn=JaxDynConfig(**kw), dt=dt))
    out = jlm.step_nl({k: jnp.asarray(v) for k, v in traj.items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_step_nl_matches_jax(request, name):
    lm, tr = _case(name)
    ref = shared(request, _jax_step_nl, name, traj_to_numpy(tr))
    got = lm.step_nl(tr)
    keys = lm.prog_3d + (("omga",) if name == "omega" else ())
    for k in keys:
        _close(got[k], ref[k], 1e-11, what=k)
    assert np.abs(_np(got["u"]) - _np(tr["u"])).max() > 1e-8


@pytest.mark.parametrize("name", [c for c in CASES if CASES[c][3]])
def test_dot_product_identity(name):
    lm, tr = _case(name)
    dx, dy = chip_smoke.rand_pert(lm, 1), chip_smoke.rand_pert(lm, 2)
    lhs = chip_smoke.dot(lm.step_tl(tr, dx), dy, lm.prog_3d)
    rhs = chip_smoke.dot(dx, lm.step_ad(tr, dy), lm.prog_3d)
    assert abs(lhs - rhs) / abs(lhs) < CASES[name][3], (lhs, rhs)


def test_beta_nsplit1_matches_beta0():
    """tests/test_beta.py: with n_split=1 every substep is the first
    (beta_d = 0), so beta reproduces beta = 0."""
    kw = dict(ENERGETICS_KW, n_split=1)
    lm0 = LinearModel.create(LMConfig(dyn=DynConfig(**kw), dt=450.0),
                             device="cpu")
    lmb = LinearModel.create(LMConfig(dyn=DynConfig(**kw, beta=0.4),
                                      dt=450.0), device="cpu")
    tr = chip_smoke.spun_up(lm0, 1, moist=True)
    o0, ob = lm0.step_nl(tr), lmb.step_nl(tr)
    for k in lm0.prog_3d:
        _close(ob[k], o0[k], 1e-13, what=k)


def test_consv_te_changes_the_tl():
    """tests/test_energetics.py: the energy fixer couples every column,
    so the TL with consv_te differs from the TL without it."""
    lm, tr = _case("consv_te")
    lm0 = LinearModel.create(LMConfig(dyn=DynConfig(**ENERGETICS_KW),
                                      dt=450.0), device="cpu")
    dx = chip_smoke.rand_pert(lm, 1)
    a, b = lm.step_tl(tr, dx), lm0.step_tl(tr, dx)
    assert float((a["t"] - b["t"]).abs().max()) > 1e-12


@pytest.fixture(scope="module")
def production(request):
    """step_tl/step_ad of both packages with the production options at
    ENERGETICS_KW from one spun-up trajectory, and their tapes (the JAX
    package's kept across runs, numpy)."""
    kw = dict(ENERGETICS_KW, **PRODUCTION)
    lm = LinearModel.create(LMConfig(dyn=DynConfig(**kw), dt=450.0),
                            device="cpu")
    tr = chip_smoke.spun_up(lm, 2, moist=True)
    dx, dy = chip_smoke.rand_pert(lm, 1), chip_smoke.rand_pert(lm, 2)

    def compute(traj, dx, dy):
        jlm = JaxLinearModel.create(JaxLMConfig(dyn=JaxDynConfig(**kw),
                                                dt=450.0))
        J = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
        ref_tl = jlm.step_tl(J(traj), J(dx))
        ref_ad = jlm.step_ad(J(traj), J(dy))
        (_, (_, jtapes, _, _)), = jlm._traj_cache.values()
        sub0 = jax.tree.map(lambda x: np.asarray(x[0]),
                            tuple(jtapes["sub"][0]))
        return dict(tl=jax.tree.map(np.asarray, ref_tl),
                    ad=jax.tree.map(np.asarray, ref_ad),
                    tapes=dict(sub0=[list(t) for t in sub0],
                               post=jax.tree.map(np.asarray,
                                                 list(jtapes["post"][0]))))

    npy = lambda d: {k: v.numpy() for k, v in d.items()}
    ref = shared(request, compute, traj_to_numpy(tr), npy(dx), npy(dy))
    tl, ad = lm.step_tl(tr, dx), lm.step_ad(tr, dy)
    _, ptapes, _, _ = lm._ckpts(tr)
    port_tapes = dict(sub0=list(ptapes["sub"][0][0]), post=ptapes["post"][0])
    return dict(lm=lm, traj=tr, tl=(tl, ref["tl"]), ad=(ad, ref["ad"]),
                tapes=(port_tapes, ref["tapes"]),
                dot=(chip_smoke.dot(tl, dy, lm.prog_3d),
                     chip_smoke.dot(dx, ad, lm.prog_3d)))


@pytest.mark.parametrize("sweep", ["tl", "ad"])
def test_production_tlad_matches_jax(production, sweep):
    got, ref = production[sweep]
    for k in production["lm"].prog_3d:
        _close(got[k], ref[k], 1e-11, what=(sweep, k))


def test_production_dot_product(production):
    lhs, rhs = production["dot"]
    assert abs(lhs - rhs) / abs(lhs) < 1e-12, (lhs, rhs)


@pytest.mark.parametrize("which", ["sub0", "post"])
def test_production_tapes_match_jax(production, which):
    """Substep 0 (stages a, b, c) and the post stage: equal entry counts
    and stored bytes; where a decision differs, recorded again with the
    JAX package's decisions upstream it must be a tie
    (tests/test_torch_hydro.py test_tapes_match_jax)."""
    port_tapes, jax_tapes = production["tapes"]
    leaves = _entries(port_tapes[which], jax_tapes[which], (which,), [])
    if all(_differing(p, j) is None for _, p, j in leaves):
        return
    own, ties = _forced_decisions(production["lm"], production["traj"],
                                  which, jax_tapes[which])
    _, untied = _untied(leaves, own, ties, jax_tapes[which], (which,))
    assert not untied, "; ".join(untied)
