"""Pointwise helpers of the PyTorch port against the JAX package.

core/freeze.py's pass-through selects must pick the same operand as the
JAX package's on ties, signed zeros and NaNs, so they are compared bit for
bit; `fscan` is compared with `lax.scan`, and `mix_primal` must take its
value from the trajectory and its derivative from the perturbation.
core/fv_pressure.py is compared with its JAX counterpart in float64.

The tapes' storage: each boolean entry is bit-packed byte for byte as
np.packbits (bitorder "big") and the JAX package's `_pack` store it (an
`fscan` or `record_entry` entry a row per iteration, a 0-dim decision
raw), and replays to the recorded decisions; qsat's table index takes 2
bytes a value; replaying a tape costs the same few operations however
many entries it holds; and step_tl/step_ad replaying the packed tapes are
bitwise those replaying the same decisions recorded unpacked (c12L10,
hydrostatic and nonhydrostatic, float64 and float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke

from fv3jedi_lm_tpu.constants import KAPPA
from fv3jedi_lm_tpu.core import freeze as jfz
from fv3jedi_lm_tpu.core.fv_pressure import (
    compute_fv3_pressures as jax_pressures)
from fv3jedi_lm_tpu_torch.core import freeze as tfz
from fv3jedi_lm_tpu_torch import debug
from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
from fv3jedi_lm_tpu_torch.core.fv_pressure import compute_fv3_pressures
from fv3jedi_lm_tpu_torch.lm import LinearModel
from fv3jedi_lm_tpu_torch.physics.qsat import dqsat

torch.set_num_threads(1)


def _operands():
    """Two float64 vectors covering ties, signed zeros, NaNs and random
    values (numpy, from a seed)."""
    rng = np.random.default_rng(3)
    special = np.array([0.0, -0.0, 0.0, 1.5, np.nan, 2.0, np.nan, -np.nan,
                        np.inf, -np.inf])
    other = np.array([-0.0, 0.0, 0.0, 1.5, 1.0, np.nan, np.nan, 3.0,
                      np.inf, 1.0])
    a = np.concatenate([special, rng.standard_normal(54)])
    b = np.concatenate([other, rng.standard_normal(54)])
    return a, b


def _bits(x):
    return np.asarray(x, np.float64).view(np.uint64)


SELECTS = {
    "fmax": lambda m, a, b: m.fmax(a, b),
    "fmin": lambda m, a, b: m.fmin(a, b),
    "fclip": lambda m, a, b: m.fclip(a, -0.5, 0.5),
    "fabs": lambda m, a, b: m.fabs(a),
    "fsign_mul": lambda m, a, b: m.fsign_mul(a, b),
    "fwhere": lambda m, a, b: m.fwhere(a > b, a, b),
}


@pytest.mark.parametrize("name", SELECTS)
def test_select_helpers_bitwise(name):
    a, b = _operands()
    want = SELECTS[name](jfz, jnp.asarray(a), jnp.asarray(b))
    got = SELECTS[name](tfz, torch.as_tensor(a), torch.as_tensor(b))
    assert np.array_equal(_bits(got.numpy()), _bits(want)), name


@pytest.mark.parametrize("reverse", [False, True])
def test_fscan_matches_lax_scan(reverse):
    rng = np.random.default_rng(5)
    xs = (rng.standard_normal((7, 4)), rng.standard_normal((7, 4)))
    c0 = rng.standard_normal(4)

    def body(mod):
        def f(c, x):
            c = mod.fmax(c * x[0], x[1]) + 0.25
            return c, (c, c * x[1])
        return f

    jc, (jy0, jy1) = lax.scan(body(jnp), jnp.asarray(c0),
                              tuple(jnp.asarray(x) for x in xs),
                              reverse=reverse)
    tc, (ty0, ty1) = tfz.fscan(body(torch), torch.as_tensor(c0),
                               tuple(torch.as_tensor(x) for x in xs),
                               reverse=reverse)
    for w, g in ((jc, tc), (jy0, ty0), (jy1, ty1)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15,
                                   atol=0)


def test_mix_primal_value_and_derivative():
    traj = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64,
                        requires_grad=True)
    pert = torch.tensor([5.0, -1.0, 0.5], dtype=torch.float64,
                        requires_grad=True)
    out = tfz.mix_primal({"x": (traj, 2.0 * pert)},
                         {"x": (3.0 * pert, pert * pert)})
    a, b = out["x"]
    assert torch.equal(a, traj.detach()) and torch.equal(b, 2.0 * pert.detach())
    (a.sum() + b.sum()).backward()
    assert traj.grad is None
    assert torch.equal(pert.grad, 3.0 + 2.0 * pert.detach())


def test_fv3_pressures_match_jax():
    rng = np.random.default_rng(9)
    pe_ref = np.linspace(300.0, 1.0e5, 9)
    delp = ((pe_ref[1:] - pe_ref[:-1])[:, None, None, None]
            * (1.0 + 0.05 * rng.random((8, 6, 5, 5))))
    want = jax_pressures(jnp.asarray(delp), KAPPA, 300.0)
    got = compute_fv3_pressures(torch.as_tensor(delp), KAPPA, 300.0)
    for name, w, g in zip(("pe", "peln", "pk", "pkz"), want, got):
        w = np.asarray(w)
        assert g.dtype == torch.float64 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-14, atol=0,
                                   err_msg=name)


# ------------------------------------------------------------ packed tapes --

def _pred(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).random(shape) > 0.5)


def _packbits(pred):
    return np.packbits(np.asarray(pred).reshape(-1), bitorder="big")


@pytest.mark.parametrize("shape", [(1,), (3,), (7,), (9,), (16,), (5, 7),
                                   (2, 3, 5), (4, 0)], ids=str)
def test_bool_entry_is_packed_as_jax_packs_it(shape):
    """ceil(n/8) bytes, the bits of the flattened predicate first bit
    high, equal to np.packbits and the JAX package's `_pack`; the replay
    gives the recorded decisions in the predicate's shape."""
    pred = _pred(shape, 11)
    with tfz.recording() as tape:
        tfz.fbool(pred)
    (e,) = tape
    assert isinstance(e, tfz.Packed) and e.shape == pred.shape
    assert e.data.dtype == torch.uint8
    assert e.data.shape == ((pred.numel() + 7) // 8,)
    assert np.array_equal(e.data.numpy(), _packbits(pred))
    assert np.array_equal(e.data.numpy(),
                          np.asarray(jfz._pack(jnp.asarray(pred.numpy()))))
    with tfz.replaying(tape):
        got = tfz.fbool(~pred)
    assert got.dtype == torch.bool and torch.equal(got, pred)


def test_decision_recorded_twice_is_packed_once():
    """One predicate tensor recorded by two calls (stored once unpacked)
    is one packed entry the tape holds twice, counted once by
    debug.tape_bytes and replayed to both calls."""
    pred = _pred((3, 11), 31)
    with tfz.recording() as tape:
        tfz.fbool(pred)
        tfz.fbool(~pred)
        tfz.fbool(pred)
    assert tape[0] is tape[2] and tape[0] is not tape[1]
    assert debug.tape_bytes(tape) == (2 * 5, 0)
    with _CountOps() as ops:
        got = tfz.unpack_tape(tape)
    assert ops.n <= 3
    assert torch.equal(got[0], pred) and torch.equal(got[1], ~pred)
    assert torch.equal(got[2], pred)


def test_zero_dim_decision_stays_raw():
    """A 0-dim decision is stored as the bool it is, as `_pack` leaves it."""
    with tfz.recording() as tape:
        tfz.fbool(torch.tensor(True))
        tfz.fbool(torch.tensor(False))
    assert [(e.dtype, e.dim(), bool(e)) for e in tape] == [
        (torch.bool, 0, True), (torch.bool, 0, False)]
    assert np.asarray(jfz._pack(jnp.asarray(True))).dtype == bool
    with tfz.replaying(tape):
        assert bool(tfz.fbool(torch.tensor(False)))
        assert not bool(tfz.fbool(torch.tensor(True)))


@pytest.mark.parametrize("shape", [(5,), (3, 4), (2, 3, 3)], ids=str)
def test_fscan_entry_packs_each_iteration(shape):
    """An fscan entry holds one packed row per iteration (the JAX
    package's `_pack` of each iteration's predicate), its 0-dim decisions
    raw, and replays them to the iterations in order."""
    xs = torch.as_tensor(np.random.default_rng(13).standard_normal(
        (6,) + shape))

    def body(c, x):
        tfz.fbool(x > 0.0)
        tfz.fbool(x.sum() > 0.0)
        return c + tfz.fmax(x, 0.0).sum(), None

    zero = torch.zeros((), dtype=xs.dtype)
    with tfz.recording() as tape:
        tfz.fscan(body, zero, xs)
    (entry,) = tape
    rows, sums, maxes = entry
    n = int(np.prod(shape))
    for e in (rows, maxes):
        assert isinstance(e, tfz.Packed) and e.shape == shape
        assert e.data.shape == (6, (n + 7) // 8)
    want = np.stack([np.asarray(jfz._pack(jnp.asarray(x.numpy() > 0.0)))
                     for x in xs])
    assert np.array_equal(rows.data.numpy(), want)
    assert sums.dtype == torch.bool and torch.equal(
        sums, xs.reshape(6, -1).sum(1) > 0.0)
    assert torch.equal(tfz.unpack_tape(tape)[0][0], xs > 0.0)
    with tfz.replaying(tape):
        c_rep, _ = tfz.fscan(body, zero, -xs)
    want_c = zero
    for x in xs:
        want_c = want_c + torch.where(x >= 0.0, -x, 0.0).sum()
    assert torch.equal(c_rep, want_c)


def test_nested_fscan_entry_round_trip():
    """An fscan inside an fscan body (the moist physics' cloud-type and
    level scans): its entry is packed a row per inner iteration, stacked
    over the outer ones, (outer, inner, nbytes), and replays each outer
    iteration's rows."""
    xs = torch.as_tensor(np.random.default_rng(29).standard_normal(
        (3, 4, 2, 5)))

    def inner(c, x):
        tfz.fbool(x > 0.0)
        return c, None

    def outer(c, x):
        tfz.fscan(inner, c, x)
        return c, None

    with tfz.recording() as tape:
        tfz.fscan(outer, torch.zeros(()), xs)
    e = tape[0][0][0]
    assert isinstance(e, tfz.Packed) and e.data.shape == (3, 4, 2)
    want = np.stack([np.stack([_packbits(r > 0.0) for r in x]) for x in xs])
    assert np.array_equal(e.data.numpy(), want)
    seen = []

    def inner_rep(c, x):
        seen.append(tfz.fbool(x < 0.0))
        return c, None

    def outer_rep(c, x):
        tfz.fscan(inner_rep, c, x)
        return c, None

    with tfz.replaying(tape):
        tfz.fscan(outer_rep, torch.zeros(()), xs)
    assert torch.equal(torch.stack(seen).reshape(xs.shape), xs > 0.0)
    got = tfz.unpack_tape(tape)[0][0][0]
    assert got.shape == xs.shape and torch.equal(got, xs > 0.0)


def test_record_entry_packs_each_row():
    """`record_entry` lays its entry out as fscan does: a packed row per
    iteration; `take_entry` replays the rows unpacked."""
    a, b = _pred((4, 10), 17), _pred((4, 10), 18)
    with tfz.recording() as tape:
        tfz.record_entry([a, b])
    (entry,) = tape
    for e, pred in zip(entry, (a, b)):
        assert isinstance(e, tfz.Packed) and e.data.shape == (4, 2)
        assert np.array_equal(e.data.numpy(),
                              np.stack([_packbits(r) for r in pred]))
    with tfz.replaying(tape):
        ea, eb = tfz.take_entry()
    assert torch.equal(ea, a) and torch.equal(eb, b)


def test_functorch_wrapped_decision_is_packed_plain():
    """A decision made inside torch.func.jvp (the physics' probes) is
    stored as the packed bits of the plain predicate and replays inside
    a transform."""
    x = torch.as_tensor(np.random.default_rng(19).standard_normal(11))

    def f(y):
        return tfz.fwhere(y > 0.0, y, 0.5 * y)

    with tfz.recording() as tape:
        torch.func.jvp(f, (x,), (torch.ones_like(x),))
    (e,) = tape
    assert isinstance(e, tfz.Packed)
    assert not torch._C._functorch.is_functorch_wrapped_tensor(e.data)
    assert np.array_equal(e.data.numpy(), _packbits(x.numpy() > 0.0))
    with tfz.replaying(tape):
        _, tan = torch.func.jvp(f, (-x,), (torch.ones_like(x),))
    assert torch.equal(tan, torch.where(x > 0.0, 1.0, 0.5).double())


def test_uint16_index_takes_two_bytes():
    """A bound of 256-65535 stores uint16 as the JAX package does (2 bytes
    a value, the same bytes), replayed as int64; qsat's table index is
    such an entry, and dqsat replaying it is bitwise dqsat."""
    vals = torch.tensor([0, 1, 255, 256, 18300, 65535])
    with tfz.recording() as tape:
        tfz.fint(vals, maxval=65535)
    with jfz.recording() as jtape:
        jfz.fint(jnp.asarray(vals.numpy().astype(np.int32)), maxval=65535)
    (e,) = tape
    assert e.dtype == torch.uint16 and e.element_size() == 2
    assert np.array_equal(e.numpy().view(np.uint8),
                          np.asarray(jtape[0]).view(np.uint8))
    with tfz.replaying(tape):
        got = tfz.fint(torch.zeros_like(vals), maxval=65535)
    assert got.dtype == torch.int64 and torch.equal(got, vals)

    temp = torch.as_tensor(np.linspace(150.0, 330.0, 37))
    pres = torch.as_tensor(np.linspace(1.0e3, 1.0e5, 37))
    want = dqsat(temp, pres)
    with tfz.recording() as tape:
        dqsat(temp, pres)
    ints = [e for e in tape if isinstance(e, torch.Tensor)
            and e.dtype != torch.bool]
    assert [(e.dtype, e.numel() * e.element_size()) for e in ints] == [
        (torch.uint16, 2 * 37)]
    with tfz.replaying(tape):
        got = dqsat(temp, pres)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


class _CountOps(TorchDispatchMode):
    """Counts the operators dispatched while active, views apart (a view
    launches no kernel)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _ops_to_record_and_replay(n_entries):
    """(operators to pack, operators to replay) a tape of `n_entries`
    decisions of 21 bits each and 3 rows of an fscan-like entry."""
    preds = [_pred((3, 7), i) for i in range(n_entries)]
    with _CountOps() as rec:
        with tfz.recording() as tape:
            for p in preds:
                tfz.fbool(p)
            tfz.record_entry(preds[:3])
    flipped = [~p for p in preds]
    with _CountOps() as rep:
        with tfz.replaying(tape):
            got = [tfz.fbool(p) for p in flipped]
            rows = tfz.take_entry()
    assert all(torch.equal(g, p) for g, p in zip(got, preds))
    assert all(torch.equal(g, p) for g, p in zip(rows, preds[:3]))
    return rec.n, rep.n


def test_pack_and_replay_cost_per_tape_not_per_entry():
    """Packing a tape and replaying it take the same few operators for 4
    entries as for 96: the entries are packed and unpacked in one batch,
    each entry a view."""
    _ops_to_record_and_replay(1)    # the bit weights made once per device
    few = _ops_to_record_and_replay(4)
    many = _ops_to_record_and_replay(96)
    assert few == many, (few, many)
    assert few[0] <= 4 and few[1] <= 4, few


def _unpacked_record(monkeypatch, stepper, cks):
    """The tapes of `cks` recorded with the decisions left unpacked."""
    with monkeypatch.context() as m:
        m.setattr(tfz, "pack_tape", list)
        return stepper.record(cks)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["hydrostatic", "nonhydrostatic"])
def test_packed_tapes_replay_bitwise(monkeypatch, kind, dtype):
    """step_tl/step_ad's dynamics sweeps replaying the packed tapes are
    bitwise those replaying the same decisions recorded unpacked, and the
    packed tapes unpack to those decisions."""
    lm = LinearModel.create(LMConfig(dyn=DynConfig(
        **chip_smoke.TLAD_SMALL[kind], dtype=dtype), dt=450.0), device="cpu")
    tr = chip_smoke.spun_up(lm, 1, moist=True)
    cks, tapes, _, _ = lm._ckpts(tr)
    stepper = lm._staged()
    raw = _unpacked_record(monkeypatch, stepper, cks)
    flat = lambda t: [x for k in t["sub"] for t3 in k for x in t3] + t["post"]
    n_packed = 0
    for packed, plain in zip(flat(tapes), flat(raw)):
        n_packed += sum(isinstance(e, tfz.Packed) for e in packed)
        got = tfz.unpack_tape(packed)
        assert len(got) == len(plain)
        for g, w in zip(_leaves(got), _leaves(plain)):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert n_packed > 0
    prog = {k: tr[k] for k in lm.prog_3d}
    for sweep, seed in (("tl", 1), ("ad", 2)):
        p = chip_smoke.rand_pert(lm, seed)
        a = getattr(stepper, sweep)(prog, tr["phis"], p, cks, tapes)
        b = getattr(stepper, sweep)(prog, tr["phis"], p, cks, raw)
        for k in lm.prog_3d:
            assert torch.equal(a[k], b[k]), (sweep, k)


def _leaves(tape):
    out = []
    for e in tape:
        out.extend(_leaves(e) if isinstance(e, list) else [e])
    return out


def test_chip_smoke_tape_check_on_cpu():
    """chip_smoke.py's tape check (run on the card there) holds on the
    CPU against itself: its counts are those of its decisions."""
    nbool, nbits, index = chip_smoke.tape_storage("cpu")
    # four predicates, an fscan of 6 rows of 15, and dqsat's three
    # decisions (the clip's two and the saturation) of 101 values
    sizes = [7, 16, 45, 72 * 13 * 11] + [15] * 6 + [101] * 3
    assert nbits == sum(sizes)
    assert nbool == sum((n + 7) // 8 for n in sizes)
    assert index == (torch.uint16, 2)
