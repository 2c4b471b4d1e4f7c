"""The port's tangent-linear and adjoint sweeps.

* Against the JAX package: `step_tl`/`step_ad` at tests/test_nh_e2e.py's
  NH_KW (c12L10 nonhydrostatic, split linearization on, dt=450) from that
  file's `_spun_up` trajectory and `_rand_pert(1)`/`_rand_pert(2)`, each
  field to 1e-10 relative norm.  (The hydrostatic pair at DYN_KW is in
  test_torch_hydro.py.)
* On the port alone, the properties of tests/test_lm.py and
  tests/test_nh_e2e.py: the dot-product identity with the split
  linearization (hydrostatic and NH), without it, and over a two-step
  window; without the split, the TL equals `torch.func.jvp` of the
  nonlinear step and converges to finite differences of it; and
  <M^T y, M^T y> == <y, M M^T y>.
* The mechanics: `mix_primal` under forward and reverse mode, the tapes'
  length checks, the trajectory cache, SIM1 dispatch by mode, the kernel
  wrapper refusing differentiated inputs, and a vjp through every stage
  under `torch.autograd.set_detect_anomaly` (no in-place write into a
  tensor autograd saved).

The JAX reference is built once and kept across runs as numpy
(tests/torch_shared.py `shared`).  Its tests come last, so that the port's
own tests run before the long JAX compile when it is built.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from fv3jedi_lm_tpu.config import DynConfig as JaxDynConfig
from fv3jedi_lm_tpu.config import LMConfig as JaxLMConfig
from fv3jedi_lm_tpu.lm import LinearModel as JaxLinearModel
from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
from fv3jedi_lm_tpu_torch.constants import KAPPA
from fv3jedi_lm_tpu_torch.core import freeze, nh_core
from fv3jedi_lm_tpu_torch.core.staged import _leaves, _rebuild, vjp
from fv3jedi_lm_tpu_torch.lm import (LinearModel, traj_from_numpy,
                                     traj_to_numpy)
from fv3jedi_lm_tpu_torch.ops import cuda_sim1
from test_lm import DYN_KW
from test_nh_e2e import NH_KW
from test_nh_e2e import _rand_pert as jax_rand_pert
from test_nh_e2e import _spun_up as jax_spun_up
from test_torch_cuda import sim1_inputs
from torch_shared import shared

torch.set_num_threads(1)

NH_FIELDS = ("u", "v", "t", "delp", "qv", "ql", "qi", "o3", "w", "delz")
spun_up = chip_smoke.spun_up
rand_pert = chip_smoke.rand_pert


def _dot(lm, a, b):
    return chip_smoke.dot(a, b, lm.prog_3d)


def _rel(lhs, rhs):
    return abs(lhs - rhs) / max(abs(lhs), 1e-300)


def _model(kw, **over):
    return LinearModel.create(LMConfig(dyn=DynConfig(**kw, **over),
                                       dt=450.0), device="cpu")


# ---------------------------------------------------------------- port only --

@pytest.fixture(scope="module")
def hyd():
    lm = _model(DYN_KW)
    return lm, spun_up(lm, 3, moist=True)


@pytest.fixture(scope="module")
def nosplit():
    lm = _model(DYN_KW, split_hord=False, split_kord=False,
                split_damp=False, split_damp_tr=False)
    return lm, spun_up(lm, 3, moist=True)


def test_dot_product_identity(hyd):
    lm, traj = hyd
    dx, dy = rand_pert(lm, 1), rand_pert(lm, 2)
    rel = _rel(_dot(lm, lm.step_tl(traj, dx), dy),
               _dot(lm, dx, lm.step_ad(traj, dy)))
    assert rel < 1e-12, rel


def test_dot_product_identity_nosplit(nosplit):
    lm, traj = nosplit
    dx, dy = rand_pert(lm, 5), rand_pert(lm, 6)
    rel = _rel(_dot(lm, lm.step_tl(traj, dx), dy),
               _dot(lm, dx, lm.step_ad(traj, dy)))
    assert rel < 1e-12, rel


def test_nosplit_tl_is_jvp_of_nlm(nosplit):
    """Without the split the TL is the derivative of the nonlinear step
    (the tapes freeze only measure-zero tie lanes)."""
    lm, traj = nosplit
    dx = rand_pert(lm, 7)
    tl = lm.step_tl(traj, dx)
    prog = {k: traj[k] for k in lm.prog_3d}
    _, jv = torch.func.jvp(lambda pr: lm._step_fn(pr, traj["phis"]),
                           (prog,), ({k: dx[k] for k in lm.prog_3d},))
    num = sum(float(((tl[k] - jv[k]) ** 2).sum()) for k in lm.prog_3d)
    den = sum(float((jv[k] ** 2).sum()) for k in lm.prog_3d)
    assert (num / den) ** 0.5 < 1e-10


def test_tlm_linearity(nosplit):
    """||M(x + e dx) - M(x) - e M' dx|| / (e ||M' dx||) small, and not
    growing as e shrinks (tests/test_lm.py test_tlm_linearity)."""
    lm, traj = nosplit
    dx = rand_pert(lm, 3)
    base = lm.step_nl(traj)
    tl = lm.step_tl(traj, dx)

    def rel_err(eps):
        moved = dict(traj)
        for k in lm.prog_3d:
            moved[k] = traj[k] + eps * dx[k]
        stepped = lm.step_nl(moved)
        num = sum(float(((((stepped[k] - base[k]) / eps) - tl[k]) ** 2).sum())
                  for k in lm.prog_3d)
        den = sum(float((tl[k] ** 2).sum()) for k in lm.prog_3d)
        return (num / den) ** 0.5

    e1 = rel_err(1e-4)
    e2 = rel_err(1e-6)
    assert e1 < 1e-2, e1
    assert e2 < max(1.2 * e1, 1e-7), (e1, e2)


def test_adjoint_of_tl_is_involutive(hyd):
    lm, traj = hyd
    dy = rand_pert(lm, 4)
    mtdy = lm.step_ad(traj, dy)
    m_mtdy = lm.step_tl(traj, mtdy)
    lhs = _dot(lm, mtdy, mtdy)
    assert lhs > 0.0
    assert _rel(lhs, _dot(lm, m_mtdy, dy)) < 1e-12


def test_nh_window_dot_product():
    """A two-step NH window: the composed TL against the reversed
    composed AD, with saveltraj keeping both steps' checkpoints cached
    (tests/test_nh_e2e.py test_nh_window_dot_product)."""
    lm = LinearModel.create(LMConfig(dyn=DynConfig(**NH_KW), dt=450.0, nt=2,
                                     saveltraj=True), device="cpu")
    traj = spun_up(lm, 2, moist=False)
    trajs = [traj, lm.step_nl(traj)]
    dx, dy = rand_pert(lm, 3), rand_pert(lm, 4)
    mdx = dx
    for tr in trajs:
        mdx = lm.step_tl(tr, mdx)
    assert len(lm._traj_cache) == 2
    mtdy = dy
    for tr in reversed(trajs):
        mtdy = lm.step_ad(tr, mtdy)
    assert len(lm._traj_cache) == 2
    assert _rel(_dot(lm, mdx, dy), _dot(lm, dx, mtdy)) < 1e-12


# ---------------------------------------------------------------- mechanics --

def test_mix_primal_under_jvp_and_autograd():
    """The value of the trajectory scheme, the derivative of the
    perturbation scheme: the pert tangent under torch.func.jvp, the pert
    cotangent under autograd."""
    x = torch.tensor([1.0, -2.0, 3.0], dtype=torch.float64)
    t = torch.tensor([0.5, 1.0, -1.5], dtype=torch.float64)

    def f(x):
        return freeze.mix_primal({"y": x ** 3}, {"y": 2.0 * x})["y"]

    y, ty = torch.func.jvp(f, (x,), (t,))
    assert torch.equal(y, x ** 3)
    assert torch.equal(ty, 2.0 * t)
    xg = x.clone().requires_grad_(True)
    f(xg).backward(t)
    assert torch.equal(xg.grad, 2.0 * t)


def test_tape_replay_checks_length():
    x = torch.tensor([1.0, -1.0, 2.0], dtype=torch.float64)
    with freeze.recording() as tape:
        freeze.fmax(x, 0.0)
        freeze.fbool(x > 1.0)
    assert len(tape) == 2
    with pytest.raises(RuntimeError, match="consumed 1 of 2"):
        with freeze.replaying(tape):
            freeze.fbool(x > 0.0)
    with pytest.raises(RuntimeError, match="exhausted"):
        with freeze.replaying(tape[:1]):
            freeze.fbool(x > 0.0)
            freeze.fbool(x > 0.0)


def test_tape_replays_decisions_and_fscan_entries():
    """Replayed decisions are the recorded ones whatever the inputs; an
    fscan records one entry holding its iterations' decisions, the
    boolean ones packed a row per iteration."""
    xs = torch.tensor([[1.0, -1.0], [-2.0, 3.0], [0.5, 0.5]],
                      dtype=torch.float64)

    def body(c, x):
        return c + freeze.fmax(x, 0.0), freeze.fint(torch.argmax(x),
                                                    maxval=2)

    with freeze.recording() as tape:
        c_rec, i_rec = freeze.fscan(body, torch.zeros(2, dtype=xs.dtype), xs)
    assert len(tape) == 1 and len(tape[0]) == 2
    assert isinstance(tape[0][0], freeze.Packed)
    assert tape[0][0].data.shape == (3, 1) and tape[0][0].shape == (2,)
    assert tape[0][1].dtype == torch.uint8
    with freeze.replaying(tape):
        c_rep, i_rep = freeze.fscan(body, torch.zeros(2, dtype=xs.dtype),
                                    -xs)
    assert torch.equal(i_rep, i_rec)
    want = torch.where(freeze.unpack_tape(tape)[0][0], -xs, 0.0).sum(0)
    assert torch.equal(c_rep, want)


def test_traj_cache_is_keyed_and_pinned_by_identity(hyd):
    lm, traj = hyd
    first = lm._ckpts(traj)
    assert lm._ckpts(traj) is first
    assert lm._ckpts(dict(traj)) is first          # same tensors, new dict
    other = dict(traj, t=traj["t"].clone())
    assert lm._ckpts(other) is not first           # a new tensor: new entry
    assert len(lm._traj_cache) == 1                # saveltraj off: one kept
    pins = next(iter(lm._traj_cache.values()))[0]
    assert any(p is other["t"] for p in pins)


def test_sim1_by_mode(monkeypatch):
    """The trajectory substeps call the kernel wrapper, 2 per substep; the
    mixed stages that record, TL and AD never do."""
    calls = []
    wrapper = nh_core.sim1_solver_cuda

    def counted(*args):
        calls.append(1)
        return wrapper(*args)

    monkeypatch.setattr(nh_core, "sim1_solver_cuda", counted)
    lm = _model(NH_KW)
    traj = lm.rest_traj()
    traj["t"] = traj["t"] + chip_smoke._bump(lm)
    stepper = lm._staged()
    record = stepper.record
    at_record = []

    def counted_record(cks):
        at_record.append(len(calls))
        return record(cks)

    stepper.record = counted_record
    lm.step_ad(traj, lm.step_tl(traj, rand_pert(lm, 1)))
    assert at_record == [2 * NH_KW["n_split"]]    # forward: the kernel's
    assert len(calls) == 2 * NH_KW["n_split"]     # record, TL, AD: none


def test_sim1_wrapper_refuses_differentiated_inputs():
    """On the CPU too, an input that requires grad or carries a tangent
    (forward-mode dual, torch.func.jvp) raises: the kernel has no
    derivative."""
    args = [torch.as_tensor(a) for a in sim1_inputs(6, 16, 6)]

    def call(*a):
        return cuda_sim1.sim1_solver_cuda(30.0, *a, KAPPA, 0.05)

    grad = list(args)
    grad[4] = grad[4].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="not differentiable"):
        call(*grad)
    with torch.autograd.forward_ad.dual_level():
        dual = list(args)
        dual[1] = torch.autograd.forward_ad.make_dual(
            args[1], torch.ones_like(args[1]))
        with pytest.raises(ValueError, match="not differentiable"):
            call(*dual)
    with pytest.raises(ValueError, match="not differentiable"):
        torch.func.jvp(lambda w: call(*args[:4], w, *args[5:])[1],
                       (args[4],), (torch.ones_like(args[4]),))


def _stage_calls(lm, traj):
    """(name, fn, primals) of every stage of the sweeps at `traj`."""
    stepper = lm._staged()
    s = stepper._stages
    prog = {k: traj[k] for k in lm.prog_3d}
    calls = [("prep", s["prep"], (prog, traj["phis"]))]
    with torch.no_grad():
        st, q = s["prep"](prog, traj["phis"])
        st2, dp1, carry = s["pre"](st)
    calls.append(("pre", s["pre"], (st,)))
    consts = dict(phis=st2["phis"])
    for mode, sub in (("traj", stepper._sub_traj),
                      ("mixed", stepper._sub_mix)):
        c = carry
        for name, stage in zip("abc", sub.stages):
            calls.append((f"{name}_{mode}", stage, (c, consts)))
            with torch.no_grad():
                c = stage(c, consts)
        calls.append((f"post_{mode}", lambda a, b, q, d, m=mode: s["post"](
            a, b, q, d, True, m), (st2, c, q, dp1)))
    return calls


STAGES = ["prep", "pre", "a_traj", "b_traj", "c_traj", "post_traj",
          "a_mixed", "b_mixed", "c_mixed", "post_mixed"]


@pytest.fixture(scope="module")
def stage_calls():
    out = {}
    for name, kw in (("hydrostatic", DYN_KW), ("nonhydrostatic", NH_KW)):
        lm = _model(kw)
        traj = lm.rest_traj()
        traj["t"] = traj["t"] + chip_smoke._bump(lm)
        traj = lm.step_nl(traj)
        out[name] = {s: (f, p) for s, f, p in _stage_calls(lm, traj)}
    return out


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("dyn", ["hydrostatic", "nonhydrostatic"])
def test_stage_vjp_under_anomaly_mode(stage_calls, dyn, stage):
    """A vjp through the stage with anomaly detection: no in-place write
    into a tensor autograd saved, and finite cotangents.  The NH trajectory
    stages a and c call the SIM1 kernel wrapper, which refuses inputs that
    require grad (the differentiated substep is the mixed one)."""
    fn, primals = stage_calls[dyn][stage]
    with torch.no_grad():
        out = fn(*primals)
    g = torch.Generator().manual_seed(0)
    ct = _rebuild(out, iter([torch.randn(x.shape, generator=g,
                                         dtype=x.dtype)
                             for x in _leaves(out, [])]))
    if dyn == "nonhydrostatic" and stage in ("a_traj", "c_traj"):
        with pytest.raises(ValueError, match="not differentiable"):
            vjp(fn, primals, ct)
        return
    with torch.autograd.set_detect_anomaly(True):
        res = vjp(fn, primals, ct)
    leaves = [x for x in _leaves(res, []) if x.is_floating_point()]
    assert all(bool(torch.isfinite(x).all()) for x in leaves)
    assert any(bool((x != 0).any()) for x in leaves)


# ---------------------------------------------------------------- vs JAX -----

def _nh_jax():
    """The JAX package's NH pair at its spun-up trajectory, numpy."""
    jlm = JaxLinearModel.create(JaxLMConfig(dyn=JaxDynConfig(**NH_KW),
                                            dt=450.0))
    traj = jax_spun_up(jlm)
    dx = jax_rand_pert(jlm, 1)
    dy = jax_rand_pert(jlm, 2)
    ref_tl = jlm.step_tl(traj, dx)
    ref_ad = jlm.step_ad(traj, dy)
    npy = lambda d: {k: np.asarray(v) for k, v in d.items()}
    return dict(traj=npy(traj), dx=npy(dx), tl=npy(ref_tl), ad=npy(ref_ad))


@pytest.fixture(scope="module")
def nh_tlad(request):
    """The NH pair of both packages at the same spun-up trajectory, numpy."""
    ref = shared(request, _nh_jax)
    lm = _model(NH_KW)
    tr = traj_from_numpy(lm, ref["traj"])
    pdx, pdy = rand_pert(lm, 1), rand_pert(lm, 2)
    for k in lm.prog_3d:           # the same perturbations, bit for bit
        assert np.array_equal(pdx[k].numpy(), ref["dx"][k])
    tl = lm.step_tl(tr, pdx)
    ad = lm.step_ad(tr, pdy)
    return dict(
        tl=(ref["tl"], traj_to_numpy(tl)),
        ad=(ref["ad"], traj_to_numpy(ad)),
        dot=_rel(_dot(lm, tl, pdy), _dot(lm, pdx, ad)))


@pytest.mark.parametrize("field", NH_FIELDS)
@pytest.mark.parametrize("sweep", ["tl", "ad"])
def test_nh_tlad_matches_jax(nh_tlad, sweep, field):
    ref, got = nh_tlad[sweep]
    a, b = ref[field], got[field]
    assert a.shape == b.shape and np.isfinite(b).all()
    rel = np.linalg.norm(b - a) / np.linalg.norm(a)
    assert rel <= 1e-10, (sweep, field, rel)


def test_nh_dot_product_identity(nh_tlad):
    """tests/test_nh_e2e.py test_nh_dot_product_identity on the port."""
    assert nh_tlad["dot"] < 1e-12, nh_tlad["dot"]
