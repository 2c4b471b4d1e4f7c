"""Frozen-branch tape: trajectory-time control flow recorded as data.

Counterpart of fv3jedi_lm_tpu/core/freeze.py (the reference's Tapenade
PUSHCONTROL/POPCONTROL, utils/tapenade/adBuffer.f:114-343).  Every
trajectory-dependent discrete decision (where-predicates, max/min/abs/sign
selections, searchsorted indices) goes through the helpers below.  Inside
`recording()` the decisions are computed and appended to a tape (a flat
list of tensors); inside `replaying(tape)` they are consumed from it, so
the tangent-linear and the adjoint sweeps linearize at bitwise-identical
branch decisions and the dot-product identity holds at the rounding of
the sweeps.  Outside any context the helpers are the plain operations (the
nonlinear step is unchanged).

The tape layout is the JAX package's: one entry per `fbool`/`fint` call,
and one entry per `fscan` call holding that call's per-iteration entries
stacked along a leading iteration axis.  Boolean entries are stored
unpacked (the JAX package bit-packs them); integer entries with a static
bound are stored in uint8 or int32.

`fmax`/`fmin` stay `where(a >= b, a, b)` rather than `torch.maximum`: ties
and NaNs select the same operand as the JAX package does.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

_state = None  # None | ["rec", list] | ["rep", list, [cursor]]


@contextmanager
def recording():
    """Record every frozen decision; yields the tape (a list of tensors)."""
    global _state
    prev = _state
    tape: list = []
    _state = ["rec", tape]
    try:
        yield tape
    finally:
        _state = prev


@contextmanager
def replaying(tape):
    """Replay decisions from `tape` (a sequence in recording order); raises
    if the block does not consume the whole tape."""
    global _state
    prev = _state
    _state = ["rep", list(tape), [0]]
    try:
        yield
        used = _state[2][0]
        if used != len(_state[1]):
            raise RuntimeError(
                f"frozen-branch tape length mismatch: consumed {used} of "
                f"{len(_state[1])} entries — record/replay control flow "
                "differs")
    finally:
        _state = prev


def active() -> bool:
    return _state is not None


def mode():
    """None outside any context, else "rec" (recording) or "rep"
    (replaying)."""
    return None if _state is None else _state[0]


def record_entry(entry):
    """Append one entry, a list of tensors, to the tape being recorded (a
    loop that records its own decisions, laid out as `fscan` lays out its
    entry)."""
    _state[1].append([_plain(t) for t in entry])


def take_entry():
    """The next entry of the tape being replayed."""
    return _next_entry()


def rewinder():
    """A context-manager factory that replays, each time it is entered,
    from the tape position current now (a block recomputed later, e.g. by
    activation checkpointing, sees the decisions it saw the first time);
    outside any context it is a plain block.  Not for recording."""
    if _state is not None and _state[0] == "rec":
        raise RuntimeError("a recording cannot be rewound")
    st = None if _state is None else (_state[1], _state[2][0])

    @contextmanager
    def again():
        global _state
        prev = _state
        _state = None if st is None else ["rep", st[0], [st[1]]]
        try:
            yield
        finally:
            _state = prev
    return again


def _next_entry():
    tape, cur = _state[1], _state[2]
    if cur[0] >= len(tape):
        raise RuntimeError(
            f"frozen-branch tape exhausted after {len(tape)} entries — "
            "record/replay control flow differs")
    entry = tape[cur[0]]
    cur[0] += 1
    return entry


def _plain(t):
    """`t` outside any `torch.func` transform's wrapper: a decision made
    inside a transform (the jvp probes of the physics) is stored as the
    plain tensor it wraps."""
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


def fbool(pred):
    """Freeze a boolean decision tensor."""
    if _state is None:
        return pred
    if _state[0] == "rec":
        _state[1].append(_plain(pred))
        return pred
    return _next_entry()


def fint(idx, maxval=None):
    """Freeze an integer decision tensor (e.g. a searchsorted result).
    `maxval`, a static bound on the values (a remap level index is below
    npz), selects compact storage: uint8 up to 255, int32 up to 2**31-1."""
    if _state is None:
        return idx
    if _state[0] == "rec":
        ent = _plain(idx)
        if maxval is not None and not idx.dtype.is_floating_point:
            if maxval <= 255:
                ent = ent.to(torch.uint8)
            elif maxval < 2 ** 31:
                ent = ent.to(torch.int32)
        _state[1].append(ent)
        return idx
    entry = _next_entry()
    return entry if entry.dtype == idx.dtype else entry.to(idx.dtype)


def fwhere(pred, a, b):
    return torch.where(fbool(pred), a, b)


def fmax(a, b):
    return fwhere(a >= b, a, b)


def fmin(a, b):
    return fwhere(a <= b, a, b)


def fclip(x, lo, hi):
    return fmin(fmax(x, lo), hi)


def fabs(x):
    return fwhere(x >= 0, x, -x)


def fsign_mul(x, y):
    """sign(x)*y for the reference's SIGN(y, x) idiom (y >= 0, y == 0
    where x == 0 at every call site)."""
    return fwhere(x >= 0, y, -y)


def _index(xs, i):
    if isinstance(xs, dict):
        return {k: _index(x, i) for k, x in xs.items()}
    if isinstance(xs, (tuple, list)):
        return type(xs)(_index(x, i) for x in xs)
    return xs[i]


def _stack(ys):
    first = ys[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([y[k] for y in ys]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([y[j] for y in ys])
                           for j in range(len(first)))
    return torch.stack(ys, dim=0)


def _first_leaf(xs):
    while isinstance(xs, (dict, tuple, list)):
        xs = next(iter(xs.values())) if isinstance(xs, dict) else xs[0]
    return xs


def fscan(body, carry, xs, length=None, reverse=False):
    """`lax.scan` as a Python loop over the leading axis of `xs`; the body
    may use the freeze helpers.

    `xs` is a tensor or a (nested) dict, tuple or list of tensors;
    `body(carry, x)` returns `(carry, y)` (`y` may be None).  Returns the
    final carry and the stacked `y`s in the order of `xs` (also when
    `reverse`).  Recording, the body's per-iteration entries are stacked
    along a leading axis (in the order of `xs`) and appended to the tape as
    ONE entry; replaying, that entry is consumed and its slices fed back to
    the iterations."""
    global _state
    if length is None:
        length = _first_leaf(xs).shape[0]
    order = range(length - 1, -1, -1) if reverse else range(length)
    st = _state
    ys = [None] * length
    if st is None:
        for i in order:
            carry, ys[i] = body(carry, None if xs is None else _index(xs, i))
        return carry, _stack(ys)
    if st[0] == "rec":
        tapes = [None] * length
        try:
            for i in order:
                _state = ["rec", []]
                carry, ys[i] = body(carry,
                                    None if xs is None else _index(xs, i))
                tapes[i] = _state[1]
        finally:
            _state = st
        st[1].append(_stack(tapes) if tapes[0] else [])
        return carry, _stack(ys)
    entry = _next_entry()
    try:
        for i in order:
            _state = ["rep", _index(entry, i) if entry else [], [0]]
            carry, ys[i] = body(carry, None if xs is None else _index(xs, i))
    finally:
        _state = st
    return carry, _stack(ys)


def mix_primal(traj_val, pert_val):
    """Primal from `traj_val`, derivative through `pert_val` only (the
    split-linearization idiom: the reference's TLM runs the perturbation-
    scheme operator for the tangent and overwrites the primal with the
    trajectory scheme, e.g. sw_core_tlm.F90:1664-1687).  Works under
    `torch.func.jvp` and under autograd alike."""
    if isinstance(traj_val, dict):
        return {k: mix_primal(traj_val[k], pert_val[k]) for k in traj_val}
    if isinstance(traj_val, (tuple, list)):
        return type(traj_val)(mix_primal(a, b)
                              for a, b in zip(traj_val, pert_val))
    return traj_val.detach() + (pert_val - pert_val.detach())
