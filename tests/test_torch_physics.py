"""The port's GEOS physics (fv3jedi_lm_tpu_torch/physics/) against the
NumPy oracles of the JAX package's tests and against the JAX package.

* NumPy oracles, no JAX run: ACRITN, SUNDQ3_ICE and DQSAT_RAS
  (tests/test_physics_oracle.py), ls_cloud (tests/test_lscloud_oracle.py,
  at that file's tolerances), the tridiagonal LU solve against
  numpy.linalg.solve (tests/test_turbulence.py), and the balanced Gelfand
  spectral radius against numpy.linalg.eigvals (tests/test_cloud_gate.py).
* The JAX package, float64, 1e-12 * max|ref| per field: bl_driver (the
  sounding below, and tests/test_lock_rad.py's stratocumulus column with
  the radlw_dep=1 cloud-top branch and LW cooling), Turbulence set_ltraj,
  apply and apply_transpose, rase with and without winds, cloud_driver at
  modes 1 and 2, and Moist: every ltraj field, the tape entry for entry
  (a decision that differs must be a tie: its comparison's operands agree
  to 1e-12 of their scale), apply_nl, apply_tl and apply_ad at modes 1
  and 2.

The inputs are tests/test_moist.py's convective sounding at npx 9, npz 12
on its troposphere-heavy ak/bk, with winds, condensate and
tests/test_turbulence.py's surface fields, all from numpy seeds.  The JAX
moist programs are those of tests/test_moist.py's models (same
configuration, shapes and argument structure), so that they may come from
the persistent compilation cache that file fills; everything else of the
JAX package runs eagerly.  Each JAX reference is computed once and kept
across runs as numpy (tests/torch_shared.py `shared`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from fv3jedi_lm_tpu.config import DynConfig as JaxDynConfig
from fv3jedi_lm_tpu.config import LMConfig as JaxLMConfig
from fv3jedi_lm_tpu.lm import LinearModel as JaxLinearModel
from fv3jedi_lm_tpu.physics import bldriver as jbl
from fv3jedi_lm_tpu.physics import cloud as jcl
from fv3jedi_lm_tpu.physics import convection as jcv
from fv3jedi_lm_tpu.physics import turbulence as jtu
from fv3jedi_lm_tpu.physics.qsat import ESTBLX as JAX_ESTBLX
from fv3jedi_lm_tpu_torch.config import DynConfig
from fv3jedi_lm_tpu_torch.core import freeze
from fv3jedi_lm_tpu_torch.physics import bldriver as tbl
from fv3jedi_lm_tpu_torch.physics import cloud as tcl
from fv3jedi_lm_tpu_torch.physics import convection as tcv
from fv3jedi_lm_tpu_torch.physics import moist as tmo
from fv3jedi_lm_tpu_torch.physics import qsat as tqs
from fv3jedi_lm_tpu_torch.physics import turbulence as ttu
from test_cloud_gate import _exact
from test_lock_rad import _column_setup
from test_lscloud_oracle import _random_columns, oracle_ls_cloud
from test_physics_oracle import (oracle_acritn, oracle_dqsat_ras,
                                 oracle_sundq3)
from test_torch_hydro import _TieMode, _differing, _entries
from torch_shared import shared

torch.set_num_threads(1)

#: tests/test_moist.py's configuration and troposphere-heavy hybrid
#: coordinate (only the top 2 interfaces above 30 hPa, so deep convection
#: is geometrically possible)
MOIST_KW = dict(npx=9, npy=9, npz=12, n_split=1, k_split=1, d2_bg_k1=0.2,
                d2_bg_k2=0.1, n_sponge=2, n_sponge_pert=3,
                d2_bg_k1_pert=0.2, d2_bg_k2_pert=0.1, d2_bg_ks_pert=0.1)
PREF = np.array([30., 1500., 4000., 8000., 14000., 22000., 32000.,
                 44000., 57000., 71000., 85000., 93000., 100000.])
MOIST_BK = np.clip((PREF - 20000.0) / (1.0e5 - 20000.0), 0.0, 1.0)
MOIST_AK = PREF - MOIST_BK * 1.0e5
DT = 450.0
N, NPZ = 8, 12


def _close(got, want, rtol, name):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    d = np.abs(got - want).max() if got.size else 0.0
    assert d <= rtol * np.abs(want).max(), (name, d, np.abs(want).max())


def _t(x, dtype=torch.float64):
    x = np.asarray(x)
    if x.dtype.kind in "iub":
        return torch.as_tensor(x)
    return torch.as_tensor(x, dtype=dtype)


def sounding():
    """(prog, sfc): the post-dynamics state the physics sees, as numpy.
    tests/test_moist.py's sounding (cold top, warm moist surface, seed 7),
    its cloud trajectory and cloud base at the lowest level, with winds and
    condensate (seed 11), stratocumulus layers khu..khl on half the columns,
    and tests/test_turbulence.py's surface fields (seed 3)."""
    n, npz = N, NPZ
    sh = (npz, 6, n, n)
    pe = MOIST_AK[:, None, None, None] + MOIST_BK[:, None, None, None] * 1e5
    tr = chip_smoke.moist_traj(
        dict(delp=(pe[1:] - pe[:-1]) * np.ones((1, 6, n, n))), n, npz,
        np.random.default_rng(7), np.asarray)
    prog = {k: tr[k] for k in ("delp", "t", "qv", "cfcn")}
    sfc = {k: tr[k] for k in ("ts", "frland", "kcbl", "qls", "qcn")}
    prof = tr["cfcn"] / 0.1
    r2 = np.random.default_rng(11)
    prog["u"] = 5.0 * r2.standard_normal((npz, 6, n + 1, n))
    prog["v"] = 5.0 * r2.standard_normal((npz, 6, n, n + 1))
    prog["qi"] = 2e-6 * prof * r2.random(sh)
    prog["ql"] = 3e-6 * prof * r2.random(sh)
    prog["o3"] = 1e-7 * r2.random(sh)
    half = (np.arange(6)[:, None, None] % 2 == 0) * np.ones((6, n, n))
    sfc["khu"] = 4.0 * half
    sfc["khl"] = 9.0 * half
    sfc.update(chip_smoke.turb_sfc(n, np.random.default_rng(3)))
    return prog, sfc


def rand_pert(seed):
    """tests/test_moist.py `_rand_pert`'s numbers for the sounding's
    fields."""
    prog, _ = sounding()
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(prog[k].shape) * chip_smoke.PERT_SCALE[k]
            for k in ("u", "v", "t", "delp", "qv", "ql", "qi", "o3", "cfcn")}


# ------------------------------------------------------------ oracles --------

def test_acritn_matches_oracle():
    rng = np.random.default_rng(0)
    pls = np.concatenate([rng.uniform(60.0, 900.0, 200),
                          np.array([100.0, 151.0, 849.0, 880.0])])
    plbs = pls + rng.uniform(5.0, 60.0, pls.size)
    got = tcv.acritn(_t(pls), _t(plbs), 0.5).numpy()
    want = np.array([oracle_acritn(p, pb, 0.5) for p, pb in zip(pls, plbs)])
    np.testing.assert_allclose(got, want, rtol=1e-13)


def test_sundq3_matches_oracle():
    rng = np.random.default_rng(1)
    temps = np.concatenate([rng.uniform(180.0, 300.0, 200),
                            np.array([273.0, 258.0, 200.0])])
    f2, f3 = tcv.sundq3_ice(_t(temps), 1.3, 2.0, 258.0)
    for i, t in enumerate(temps):
        f2_o, f3_o = oracle_sundq3(t, 1.3, 2.0, 258.0)
        np.testing.assert_allclose(float(f2[i]), f2_o, rtol=1e-13,
                                   err_msg=f"T={t}")
        assert float(f3[i]) == f3_o


def test_dqsat_matches_oracle():
    rng = np.random.default_rng(2)
    temps = np.concatenate([rng.uniform(150.0, 340.0, 300),
                            np.array([150.0, 333.0, 332.999])])
    plo = rng.uniform(10.0, 1050.0, temps.size)  # hPa
    dq, qs = tqs.dqsat(_t(temps), _t(plo * 100.0))
    for i in range(temps.size):
        dq_o, qs_o = oracle_dqsat_ras(temps[i], plo[i], JAX_ESTBLX)
        np.testing.assert_allclose(float(dq[i]), dq_o, rtol=1e-12,
                                   err_msg=f"dq T={temps[i]}")
        np.testing.assert_allclose(float(qs[i]), qs_o, rtol=1e-12,
                                   err_msg=f"qs T={temps[i]}")


def test_ls_cloud_matches_oracle():
    pars = tcl.cloud_params(32)
    ph, te, qv, qcl, qal, qci, qai, cf, af, alpha = _random_columns()
    got = [g.numpy() for g in tcl.ls_cloud(
        DT, _t(alpha), _t(ph), _t(te), _t(qv), _t(qcl), _t(qal), _t(qci),
        _t(qai), _t(cf), _t(af), pars, None, False)]
    names = ("te", "qv", "qcl", "qal", "qci", "qai", "cf", "af")
    npz, nb = te.shape
    for k in range(npz):
        for b in range(nb):
            want = oracle_ls_cloud(
                DT, alpha[k, b], ph[k, b], te[k, b], qv[k, b], qcl[k, b],
                qal[k, b], qci[k, b], qai[k, b], cf[k, b], af[k, b],
                JAX_ESTBLX)
            for nm, g, w in zip(names, (x[k, b] for x in got), want):
                np.testing.assert_allclose(
                    g, w, rtol=1e-11, atol=1e-14,
                    err_msg=f"{nm} at k={k} b={b}")


@pytest.mark.parametrize("ygswitch", [1, 0])
def test_tridiag_solver_exact(ygswitch):
    """vtrilu + vtrisolve solve the tridiagonal system: with ygswitch 1
    exactly A x = y (tests/test_turbulence.py); with 0 the surface fix
    replaces the last row's equation, so the first npz-1 rows hold."""
    rng = np.random.default_rng(0)
    npz, ncol = 17, 5
    a = rng.uniform(-0.3, 0.0, (npz, ncol))
    c = rng.uniform(-0.3, 0.0, (npz, ncol))
    b = 1.0 - (a + c)     # diagonally dominant, as the BL tridiagonals
    y = rng.standard_normal((npz, ncol))
    al, bl, cl = ttu.vtrilu(_t(a), _t(b), _t(c))
    x = ttu.vtrisolve(al, bl, cl, _t(y), ygswitch).numpy()
    rows = npz if ygswitch == 1 else npz - 1
    for j in range(ncol):
        A = (np.diag(b[:, j]) + np.diag(a[1:, j], -1)
             + np.diag(c[:-1, j], 1))
        if ygswitch == 1:
            np.testing.assert_allclose(x[:, j], np.linalg.solve(A, y[:, j]),
                                       rtol=1e-12, atol=1e-12)
        resid = A[:rows] @ x[:, j] - y[:rows, j]
        assert np.abs(resid).max() < 1e-12


def test_spectral_radius_matches_eigvals():
    """tests/test_cloud_gate.py: never under the spectral radius beyond
    the power iteration's slack, within 5 % on generic matrices, and the
    Jordan block overestimated in the safe direction only."""
    rng = np.random.default_rng(0)
    mats = [scale * rng.standard_normal((8, 8, 64))
            for scale in (1e-3, 1.0, 1e3)]
    skew = rng.standard_normal((8, 8, 32))
    mats.append(skew - np.transpose(skew, (1, 0, 2))
                + 0.05 * rng.standard_normal((8, 8, 32)))
    d = 10.0 ** rng.uniform(-4, 4, (8, 1, 32))
    mats.append(rng.standard_normal((8, 8, 32)) * d / np.swapaxes(d, 0, 1))
    jac = np.concatenate(mats, axis=2)
    est = tcl.spectral_radius(_t(jac)).numpy()
    rho, _ = _exact(jac)
    assert (est >= rho * (1.0 - 2e-3)).all(), (est / rho).min()
    assert (est <= rho * 1.05).all(), (est / rho).max()
    jordan = np.zeros((8, 8, 1))
    jordan[:, :, 0] = np.eye(8) + np.diag(np.ones(7), 1)
    est = float(tcl.spectral_radius(_t(jordan))[0])
    assert 1.0 - 1e-9 <= est <= 1.8


# ------------------------------------------------------------ bl_driver ------

BL_KEYS = ("aks", "bks", "cks", "akq", "bkq", "ckq", "akv", "bkv", "ckv",
           "zpbl")


def _bl_inputs():
    """bl_driver's arguments at the sounding: the physics' (n, n) winds,
    theta, edge pressures, condensate and surface fields."""
    prog, sfc = sounding()
    ptop = float(MOIST_AK[0])
    pe = ptop + np.concatenate([np.zeros((1, 6, N, N)),
                                np.cumsum(prog["delp"], 0)], 0)
    kappa = jbl.KAPPA
    pk = (pe[1:] ** kappa - pe[:-1] ** kappa) / (
        kappa * (np.log(pe[1:]) - np.log(pe[:-1])))
    th = jbl.P00 ** kappa * prog["t"] / pk
    return (prog["u"][..., :N, :], prog["v"][..., :, :N], th, prog["qv"],
            pe, prog["qi"], prog["ql"], sfc["frland"], sfc["frocean"],
            sfc["varflt"], sfc["zpbl"], sfc["cm"], sfc["ct"], sfc["cq"],
            sfc["ustar"], sfc["bstar"]), None


def _lock_rad_inputs():
    """tests/test_lock_rad.py's stratocumulus column with LW cooling at its
    top, for the radlw_dep=1 branch."""
    f, tdtlw = _column_setup(ncld=True, cool=5e-3)
    f = {k: np.asarray(v) for k, v in f.items()}
    return (f["u"], f["v"], f["th"], f["q"], f["phalf"], f["qit"],
            f["qlt"], f["frland"], f["frocean"], f["varflt"], f["zpbl"],
            f["cm"], f["ct"], f["cq"], f["ustar"], f["bstar"]), \
        np.asarray(tdtlw)


@pytest.fixture(scope="module", params=["sounding", "radlw"])
def bl_pair(request):
    args, tdtlw = (_bl_inputs() if request.param == "sounding"
                   else _lock_rad_inputs())
    pref = args[4][:, 0, 0, 0] if request.param == "radlw" else (
        MOIST_AK + MOIST_BK * 1e5)
    params = jbl.default_turb_params(pref)
    if request.param == "radlw":
        params = dict(params, radlw_dep=1)
    flat = lambda r: dict(r[0], zpbl=r[1])

    def compute():
        want = jbl.bl_driver(*[jnp.asarray(a) for a in args], params, 900.0,
                             tdtlw=None if tdtlw is None
                             else jnp.asarray(tdtlw))
        return {k: np.asarray(v) for k, v in flat(want).items()}

    want = shared(request, compute)
    got = tbl.bl_driver(*[_t(a) for a in args], params, 900.0,
                        tdtlw=None if tdtlw is None else _t(tdtlw))
    return want, {k: v.numpy() for k, v in flat(got).items()}


@pytest.mark.parametrize("key", BL_KEYS)
def test_bl_driver_matches_jax(bl_pair, key):
    want, got = bl_pair
    _close(got[key], want[key], 1e-12, key)


def test_bl_driver_radlw_branch_acts():
    """The radlw case runs the cloud-top branch: its scalar mixing is
    stronger than with radlw_dep=0 (tests/test_lock_rad.py)."""
    args, tdtlw = _lock_rad_inputs()
    p0 = tbl.default_turb_params(args[4][:, 0, 0, 0])
    c0, _ = tbl.bl_driver(*[_t(a) for a in args], p0, 900.0)
    c1, _ = tbl.bl_driver(*[_t(a) for a in args], dict(p0, radlw_dep=1),
                          900.0, tdtlw=_t(tdtlw))
    assert float(c1["aks"].abs().sum()) > 1.0001 * float(c0["aks"].abs().sum())


# ------------------------------------------------------------ turbulence -----

TURB_LTRAJ = ("akv", "bkv", "ckv", "aks", "bks", "cks", "akq", "bkq", "ckq",
              "pk", "zpbl")
TURB_FIELDS = ("u", "v", "t", "qv", "qi", "ql", "o3")


@pytest.fixture(scope="module", params=[0, 1], ids=["mst0", "mst1"])
def turb_pair(request):
    prog, sfc = sounding()
    traj = dict(prog, **sfc)
    pert = rand_pert(5)
    fs = {k: pert[k] for k in TURB_FIELDS}
    fs["u"] = pert["u"][..., :N, :]
    fs["v"] = pert["v"][..., :, :N]
    npy = lambda d: {k: np.asarray(v) for k, v in d.items()}

    def compute():
        cfg = JaxDynConfig(**MOIST_KW).resolve()
        jt = jtu.Turbulence(cfg, MOIST_AK, MOIST_BK)
        jl = jt.set_ltraj({k: jnp.asarray(v) for k, v in traj.items()}, DT,
                          do_phy_mst=request.param)
        ja = jt.apply(jl, {k: jnp.asarray(v) for k, v in fs.items()})
        jat = jt.apply_transpose(jl, {k: jnp.asarray(v)
                                      for k, v in fs.items()})
        return npy(jl), npy(ja), npy(jat)

    jl, ja, jat = shared(request, compute)
    tt = ttu.Turbulence(DynConfig(**MOIST_KW).resolve(), MOIST_AK, MOIST_BK)
    tl = tt.set_ltraj({k: _t(v) for k, v in traj.items()}, DT,
                      do_phy_mst=request.param)
    ta = tt.apply(tl, {k: _t(v) for k, v in fs.items()})
    tat = tt.apply_transpose(tl, {k: _t(v) for k, v in fs.items()})
    tor = lambda d: {k: v.detach().numpy() for k, v in d.items()}
    return dict(ltraj=(jl, tor(tl)), apply=(ja, tor(ta)),
                transpose=(jat, tor(tat)))


@pytest.mark.parametrize("key", TURB_LTRAJ)
def test_turbulence_ltraj_matches_jax(turb_pair, key):
    want, got = turb_pair["ltraj"]
    _close(got[key], want[key], 1e-12, key)


@pytest.mark.parametrize("sweep", ["apply", "transpose"])
@pytest.mark.parametrize("key", TURB_FIELDS)
def test_turbulence_apply_matches_jax(turb_pair, sweep, key):
    want, got = turb_pair[sweep]
    _close(got[key], want[key], 1e-12, f"{sweep} {key}")


# ------------------------------------------------------------ rase -----------

RASE_OUT = ("tho", "qho", "uho", "vho", "clw", "flxd", "cnv_prc3",
            "cnv_updfrc")


def _moist_port(mode):
    return tmo.Moist(DynConfig(**MOIST_KW).resolve(), MOIST_AK, MOIST_BK, DT,
                     mode)


@pytest.fixture(scope="module")
def port_ltraj():
    """The port's Moist linearization of the sounding at mode 1 (its own
    parity with the JAX package is tested below), as column inputs."""
    prog, sfc = sounding()
    m = _moist_port(1)
    (lt, _), _ = m.linearize({k: _t(v) for k, v in prog.items()},
                             {k: _t(v) for k, v in sfc.items()})
    return m, {k: v.numpy() for k, v in lt.items()}


@pytest.fixture(scope="module", params=[True, False],
                ids=["winds", "no_winds"])
def rase_pair(request, port_ltraj):
    m, lt = port_ltraj
    args = (lt["kcbl"], lt["wgt0"], lt["wgt1"], lt["frland"], lt["ts"],
            lt["ptt"], lt["qvt"], lt["ut"], lt["vt"], lt["co_auto"],
            lt["cnv_ple"])
    want = shared(request, lambda icmin, sige, args, params, seed: {
        k: np.asarray(v) for k, v in zip(RASE_OUT, jcv.rase(
            DT, icmin, sige, *[jnp.asarray(a) for a in args], params,
            jnp.asarray(seed), with_winds=request.param))},
        m.icmin, m.sige, args, m.rasparams, lt["seedras"])
    got = tcv.rase(DT, m.icmin, m.sige, *[_t(a) for a in args],
                   m.rasparams, _t(lt["seedras"]), with_winds=request.param)
    return (want,
            {k: v.numpy() for k, v in zip(RASE_OUT, got)},
            dict(zip(RASE_OUT[:4], args[5:9])))


@pytest.mark.parametrize("key", RASE_OUT)
def test_rase_matches_jax(rase_pair, key):
    want, got, ins = rase_pair
    _close(got[key], want[key], 1e-12, key)
    if key in ("tho", "qho"):
        # convection moved the column: the comparison is not of inputs
        assert np.abs(want[key] - ins[key]).max() > 0.0


# ------------------------------------------------------------ cloud ----------

CLOUD_OUT = ("th", "q", "qi_ls", "ql_ls", "qi_con", "ql_con", "cf_ls",
             "cf_con")


@pytest.fixture(scope="module", params=[1, 2], ids=["mode1", "mode2"])
def cloud_pair(request, port_ltraj):
    """cloud_driver at the ungated RASE0 trajectory of the sounding."""
    m, lt = port_ltraj
    args = (lt["ptt_c"], lt["qvt_c"], lt["ple"], lt["clw_c"], lt["flxd_c"],
            lt["prc3_c"], lt["updf_c"], lt["qilst"], lt["qllst"],
            lt["qicnt"], lt["qlcnt"], np.zeros_like(lt["qilst"]),
            lt["cfcnt"], lt["frland"], lt["khu"], lt["khl"])
    want = shared(request, lambda args, params: {
        k: np.asarray(v) for k, v in zip(CLOUD_OUT, jcl.cloud_driver(
            DT, *[jnp.asarray(a) for a in args], params, None,
            request.param))}, args, m.cloudparams)
    got = tcl.cloud_driver(DT, *[_t(a) for a in args], m.cloudparams, None,
                           request.param)
    return (want,
            {k: v.numpy() for k, v in zip(CLOUD_OUT, got)})


@pytest.mark.parametrize("key", CLOUD_OUT)
def test_cloud_driver_matches_jax(cloud_pair, key):
    want, got = cloud_pair
    _close(got[key], want[key], 1e-12, key)


# ------------------------------------------------------------ Moist ----------

#: the configurations of tests/test_moist.py's models: its `lm` fixture
#: (mode 1) and test_mode2_jacobian_gate_dot_product's (mode 2)
def _jax_lm(mode):
    cfg = JaxLMConfig(dyn=JaxDynConfig(**MOIST_KW), dt=DT, do_phy_mst=mode)
    return JaxLinearModel.create(cfg, ak=MOIST_AK, bk=MOIST_BK)


MST_SFC = ("ts", "frland", "kcbl", "khu", "khl", "qls", "qcn")


@pytest.fixture(scope="module", params=[1, 2], ids=["mode1", "mode2"])
def moist_pair(request):
    """Moist.set_ltraj, apply_nl, apply_tl(rand_pert(1)) and
    apply_ad(rand_pert(2)) of both packages at the sounding, with the
    argument structure tests/test_moist.py's models give them."""
    mode = request.param
    prog, sfc = sounding()
    sfc = {k: sfc[k] for k in MST_SFC}
    sfc["cfcn"] = prog["cfcn"]
    dx, dy = rand_pert(1), rand_pert(2)

    def compute():
        jlm = _jax_lm(mode)
        J = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
        lt, tape = jlm._moist.set_ltraj(J(prog), J(sfc))
        nl = jlm._jit_m("nl", jlm._moist.apply_nl)(lt, tape, J(prog))
        tl = jlm._jit_m("tl", jlm._moist.apply_tl)(lt, tape, J(dx))
        ad = jlm._jit_m("ad", jlm._moist.apply_ad)(lt, tape, J(dy))
        npy = lambda d: {k: np.asarray(v) for k, v in d.items()}
        return dict(ltraj=npy(lt), tape=jax.tree.map(np.asarray, list(tape)),
                    nl=npy(nl), tl=npy(tl), ad=npy(ad))

    want = shared(request, compute)

    m = _moist_port(mode)
    T = lambda d: {k: _t(v) for k, v in d.items()}
    (plt, ptape), pnl = m.linearize(T(prog), T(sfc))
    tor = lambda d: {k: v.detach().numpy() for k, v in d.items()}
    got = dict(ltraj=tor(plt), tape=ptape, nl=tor(pnl),
               tl=tor(m.apply_tl(plt, ptape, T(dx))),
               ad=tor(m.apply_ad(plt, ptape, T(dy))))
    return dict(want=want, got=got, model=m, ltraj=plt, prog=prog)


def test_moist_ltraj_matches_jax(moist_pair):
    want, got = moist_pair["want"]["ltraj"], moist_pair["got"]["ltraj"]
    assert sorted(got) == sorted(want)
    for k in want:
        if want[k].dtype.kind in "biu":
            assert np.array_equal(got[k].astype(np.int64),
                                  want[k].astype(np.int64)), k
        else:
            _close(got[k], want[k], 1e-12, k)


def test_moist_filters_leave_convection(moist_pair):
    """Mode 1 keeps convecting columns through the DOCONVEC filters (the
    comparisons above are not vacuous); mode 2's deeper-convection filter
    removes them all on 12 levels."""
    doconvec = moist_pair["got"]["ltraj"]["doconvec"]
    if moist_pair["model"].do_phy_mst == 1:
        assert doconvec.any()
    else:
        assert not doconvec.any()


class _PlainTieMode(_TieMode):
    """_TieMode that also knows a decision made inside a `torch.func`
    transform by the plain tensor the tape stores for it."""

    def _keep(self, out, tie):
        super()._keep(out, tie)
        if isinstance(out, torch.Tensor) and out.dtype == torch.bool:
            plain = freeze._plain(out)
            if plain is not out and id(out) in self.ties:
                self.ties[id(plain)] = (plain, freeze._plain(tie))


def _tape_ties(m, ltraj):
    """The port's tape recorded again under _PlainTieMode, packed, with
    the tie mask of every boolean decision in its recorded shape (None
    for integer entries)."""
    mode = _PlainTieMode()
    with torch.no_grad(), freeze.recording() as tape, mode:
        m._moist_step(ltraj, m._x0(ltraj))
        raw = list(tape)          # the decisions before the block packs them

    def masks(t):
        if isinstance(t, (list, tuple)):
            return [masks(x) for x in t]
        return mode.tie(t).numpy() if t.dtype == torch.bool else None
    return tape, masks(raw)


def test_moist_tape_matches_jax(moist_pair):
    """Equal entry counts and stored bytes (packed decisions, compacted
    indices); a decision that differs must be a tie of the port's own
    comparison.  Ties are printed, every other mismatch is named in the
    failure."""
    jtape = moist_pair["want"]["tape"]
    ptape = moist_pair["got"]["tape"]
    leaves = _entries(ptape, jtape, ("tape",), [])
    assert len(leaves) > 100
    assert any(isinstance(p, freeze.Packed) for _, p, _ in leaves)
    diffs = [path for path, p, j in leaves if _differing(p, j) is not None]
    if not diffs:
        return
    tape, ties = _tape_ties(moist_pair["model"], moist_pair["ltraj"])
    untied, n_tie = [], 0
    for (path, p, j), (_, t, _) in zip(
            _entries(tape, jtape, ("tape",), []),
            _entries(ties, jtape, ("tape",), [])):
        if path not in diffs:
            continue
        diff = _differing(p, j)
        if diff is None:
            continue
        tie = np.zeros_like(diff) if t is None else t
        n_tie += int((diff & tie).sum())
        if (diff & ~tie).any():
            untied.append(f"{path}: {int((diff & ~tie).sum())} of "
                          f"{diff.size} decisions differ where the operands "
                          "do not tie")
    print(f"{len(diffs)} entries differ, {n_tie} decisions at ties")
    assert not untied, "; ".join(untied)


MOIST_FIELDS = ("u", "v", "t", "delp", "qv", "ql", "qi", "o3", "cfcn")


@pytest.mark.parametrize("sweep", ["nl", "tl", "ad"])
def test_moist_apply_matches_jax(moist_pair, sweep):
    want = moist_pair["want"][sweep]
    got = moist_pair["got"][sweep]
    assert sorted(got) == sorted(want)
    for k in MOIST_FIELDS:
        _close(got[k], want[k], 1e-12, f"{sweep} {k}")
    if sweep == "nl":
        # the step moved the fields: the comparison is not of inputs (t
        # and qv come from the convection, which mode 2 filters out on 12
        # levels)
        prog = moist_pair["prog"]
        moved = ("qi", "ql", "cfcn")
        if moist_pair["model"].do_phy_mst == 1:
            moved = moved + ("t", "qv")
        for k in moved:
            assert np.abs(want[k] - prog[k]).max() > 0.0, k
