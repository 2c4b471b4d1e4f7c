"""The port's 4D-Var window sweeps and its observability.

* The window: `run_nl`/`run_tl`/`run_ad` against the JAX package at
  tests/test_window.py's configuration (c8L6, n_split=1, saveltraj) with
  nt = 2, every state and both sweeps to 1e-11; the window's dot-product
  identity; the saveltraj cache holding the window's linearizations, and
  one without saveltraj.
* `debug`: tests/test_debug.py's cases on the port, the step_nl
  check_state hook, the gate off reading no tensor, and `tape_report`
  equal to the bytes of the cached tensors counted independently.
* `timing`: the host timers accumulate only when on, and time the
  trajectory's forward and record and the sweeps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fv3jedi_lm_tpu.config import DynConfig as JaxDynConfig
from fv3jedi_lm_tpu.config import LMConfig as JaxLMConfig
from fv3jedi_lm_tpu.lm import LinearModel as JaxLinearModel
from fv3jedi_lm_tpu_torch import debug, timing
from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
from fv3jedi_lm_tpu_torch.core import freeze
from fv3jedi_lm_tpu_torch.lm import LinearModel, traj_to_numpy
from torch_shared import shared

torch.set_num_threads(1)

WINDOW_KW = dict(npx=9, npy=9, npz=6, n_split=1, k_split=1, d2_bg_k1=0.2,
                 d2_bg_k2=0.1, n_sponge=2, n_sponge_pert=3,
                 d2_bg_k1_pert=0.2, d2_bg_k2_pert=0.1, d2_bg_ks_pert=0.1)
NT = 2


def _model(nt=NT, saveltraj=True, **over):
    return LinearModel.create(
        LMConfig(dyn=DynConfig(**WINDOW_KW, **over), dt=450.0, nt=nt,
                 saveltraj=saveltraj), device="cpu")


def _traj0(lm):
    """tests/test_window.py's trajectory: rest plus the thermal bump."""
    tr = lm.rest_traj()
    tr["t"] = tr["t"] + chip_smoke._bump(lm)
    return tr


def _close(got, ref, tol, what):
    g, r = got.detach().numpy(), np.asarray(ref)
    assert g.shape == r.shape and np.isfinite(g).all(), what
    err = np.abs(g - r).max()
    assert err <= tol * np.abs(r).max(), (what, err)


@pytest.fixture(scope="module")
def window(request):
    """Both packages' window: the states, run_tl(rand_pert(1)) and
    run_ad(rand_pert(2)) (the JAX package's kept across runs, numpy:
    tests/torch_shared.py `shared`)."""
    lm = _model()
    tr0 = _traj0(lm)
    dx, dy = chip_smoke.rand_pert(lm, 1), chip_smoke.rand_pert(lm, 2)

    def compute(traj0, dx, dy):
        jlm = JaxLinearModel.create(JaxLMConfig(
            dyn=JaxDynConfig(**WINDOW_KW), dt=450.0, nt=NT, saveltraj=True))
        J = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
        jtrajs = jlm.run_nl(J(traj0))
        jtl, jad = jlm.run_tl(jtrajs, J(dx)), jlm.run_ad(jtrajs, J(dy))
        npy = lambda d: {k: np.asarray(v) for k, v in d.items()}
        return [npy(t) for t in jtrajs], npy(jtl), npy(jad)

    npy = lambda d: {k: v.numpy() for k, v in d.items()}
    jtrajs, jtl, jad = shared(request, compute, traj_to_numpy(tr0), npy(dx),
                              npy(dy))
    trajs = lm.run_nl(tr0)
    tl, ad = lm.run_tl(trajs, dx), lm.run_ad(trajs, dy)
    return dict(lm=lm, trajs=trajs, jtrajs=jtrajs, tl=(tl, jtl),
                ad=(ad, jad), dx=dx, dy=dy)


@pytest.mark.parametrize("step", range(1, NT + 1))
def test_run_nl_matches_jax(window, step):
    lm = window["lm"]
    assert len(window["trajs"]) == NT + 1
    for k in lm.prog_3d:
        _close(window["trajs"][step][k], window["jtrajs"][step][k], 1e-11,
               (step, k))


@pytest.mark.parametrize("sweep", ["tl", "ad"])
def test_run_tl_ad_match_jax(window, sweep):
    got, ref = window[sweep]
    for k in window["lm"].prog_3d:
        _close(got[k], ref[k], 1e-11, (sweep, k))


def test_window_dot_product(window):
    lm = window["lm"]
    lhs = chip_smoke.dot(window["tl"][0], window["dy"], lm.prog_3d)
    rhs = chip_smoke.dot(window["dx"], window["ad"][0], lm.prog_3d)
    assert abs(lhs - rhs) / abs(lhs) < 1e-12, (lhs, rhs)


def test_saveltraj_keeps_the_window(window):
    """With saveltraj the window's nt linearizations stay cached, and a
    second sweep reuses them."""
    lm = window["lm"]
    assert len(lm._traj_cache) == NT
    before = {id(v[1]) for v in lm._traj_cache.values()}
    lm.run_tl(window["trajs"], window["dx"])
    assert {id(v[1]) for v in lm._traj_cache.values()} == before


def test_window_without_saveltraj():
    """Without saveltraj only the latest step's linearization is kept;
    the window's result is the same."""
    lm, lm1 = _model(), _model(saveltraj=False)
    trajs = lm.run_nl(_traj0(lm))
    dx = chip_smoke.rand_pert(lm, 1)
    a, b = lm.run_tl(trajs, dx), lm1.run_tl(trajs, dx)
    assert len(lm1._traj_cache) == 1
    for k in lm.prog_3d:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------------------ debug --

@pytest.fixture
def dbg_on(monkeypatch):
    monkeypatch.setenv("FV3LM_DEBUG", "1")


class _Untouchable:
    """Any attribute access fails: a stand-in for a tensor that must not
    be read."""

    def __getattr__(self, name):
        raise AssertionError(f"read .{name}")


def test_disabled_is_noop(monkeypatch, capsys):
    monkeypatch.delenv("FV3LM_DEBUG", raising=False)
    assert not debug.enabled()
    assert debug.range_check("t", torch.full((3,), 1e9), 150.0, 350.0)
    assert debug.range_check("t", _Untouchable(), 150.0, 350.0)
    assert debug.check_state({"t": _Untouchable()})
    debug.prt_maxmin("t", _Untouchable())
    assert capsys.readouterr().out == ""


def test_range_check_reports(dbg_on, capsys):
    bad = torch.tensor([200.0, 400.0, float("nan")], dtype=torch.float64)
    assert not debug.range_check("t", bad, 150.0, 350.0)
    out = capsys.readouterr().out
    assert "RANGE t" in out and "non-finite" in out


def test_range_check_raise(monkeypatch):
    monkeypatch.setenv("FV3LM_DEBUG", "raise")
    with pytest.raises(FloatingPointError):
        debug.range_check("delp", torch.tensor([-1.0]), 0.01, 2e5)


def test_check_state_clean(dbg_on, capsys):
    prog = dict(t=torch.full((4,), 280.0), delp=torch.full((4,), 1e3),
                u=torch.zeros(4))
    assert debug.check_state(prog)
    assert capsys.readouterr().out == ""


def test_prt_maxmin(dbg_on, capsys):
    debug.prt_maxmin("u", torch.tensor([-3.0, 7.0]))
    out = capsys.readouterr().out
    assert "u" in out and "+7.0" in out


def test_step_nl_checks_its_state(monkeypatch):
    """step_nl runs check_state on its result: a trajectory 100 K too warm
    raises with FV3LM_DEBUG=raise."""
    lm = _model(nt=1)
    tr = lm.rest_traj(t0=380.0)
    monkeypatch.setenv("FV3LM_DEBUG", "raise")
    with pytest.raises(FloatingPointError, match="step_nl.t"):
        lm.step_nl(tr)


def test_tape_report_on_lm():
    """tests/test_debug.py's case, and the report's bytes are those of the
    cached checkpoints and tapes counted tensor by tensor, the tapes split
    into packed boolean decisions and integer decisions."""
    cfg = LMConfig(dyn=DynConfig(npx=9, npy=9, npz=4, n_split=1, k_split=1,
                                 d2_bg_k1=0.2, d2_bg_k2=0.1, n_sponge=2),
                   dt=300.0)
    lm = LinearModel.create(cfg, device="cpu")
    tr = lm.rest_traj()
    lm.step_tl(tr, lm.zero_pert())
    rep = debug.tape_report(lm)
    assert "1 cached traj" in rep and "ckpts" in rep and "tapes" in rep
    (_, (cks, tapes, mpack, _)), = lm._traj_cache.values()

    def nbytes(tree, want):
        seen = {}

        def walk(x):
            if isinstance(x, dict):
                for y in x.values():
                    walk(y)
            elif isinstance(x, (list, tuple)):
                for y in x:
                    walk(y)
            elif isinstance(x, freeze.Packed):
                seen[id(x.data)] = (True, x.data.numel())
            elif isinstance(x, torch.Tensor) and id(x) not in seen:
                seen[id(x)] = (x.dtype == torch.bool,
                               x.numel() * x.element_size())
        walk(tree)
        return sum(n for kind, n in seen.values() if want(kind))

    everything = lambda kind: True
    n_bool = nbytes(tapes, lambda kind: kind)
    n_int = nbytes(tapes, lambda kind: not kind)
    assert debug.cache_bytes(lm) == [(nbytes(cks, everything), n_bool, n_int,
                                      0, 0, 0, 0)]
    assert debug.tree_bytes(tapes) == n_bool + n_int
    assert n_bool > 0 and mpack is None
    assert f"{nbytes(cks, everything) / 1e6:9.1f} MB" in rep
    assert f"bool {n_bool / 1e6:9.1f} MB int {n_int / 1e6:9.1f} MB" in rep


# ----------------------------------------------------------------- timing --

@pytest.fixture
def timers():
    timing.timing_reset()
    yield
    timing.enable(False)
    timing.timing_reset()


def test_timers_off_accumulate_nothing(timers):
    timing.enable(False)
    with timing.timing("blk", lambda: _Untouchable()):
        pass
    timing.timing_on("x")
    timing.timing_off("x", sync=_Untouchable())
    assert timing.timings() == {}


def test_timers_on(timers, capsys):
    timing.enable(True)
    for _ in range(3):
        with timing.timing("blk", lambda: torch.zeros(2)):
            pass
    tot, cnt = timing.timings()["blk"]
    assert cnt == 3 and tot >= 0.0
    table = timing.timing_prt()
    assert "blk" in table and "blk" in capsys.readouterr().out
    timing.timing_reset()
    assert timing.timings() == {}


def test_timers_time_the_sweeps(timers):
    lm = _model(nt=1)
    tr = lm.rest_traj()
    timing.enable(True)
    p = lm.step_tl(tr, lm.zero_pert())
    lm.step_ad(tr, p)
    got = timing.timings()
    for name in ("ckpts.forward", "ckpts.record", "step_tl.dyn",
                 "step_ad.dyn"):
        assert got[name][1] == 1, name
