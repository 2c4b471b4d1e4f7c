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
stacked along a leading iteration axis.  A boolean decision with ndim > 0
is stored bit-packed (`Packed`): the bits of its flattened predicate 8 to
a byte, first bit in the high bit (np.packbits, bitorder "big"), each
iteration's predicate of an `fscan` entry packed as a row of its own, so
an entry equals the JAX package's `_pack` byte for byte; a 0-dim decision
stays a raw bool.  Integer entries with a static bound are stored in
uint8, uint16 or int32.  The decisions are packed in a few batched
operations when a `recording()` block exits, and unpacked in a few when
`replaying(tape)` is entered, each entry then a view of the result: the
cost is per tape, not per entry.

`fmax`/`fmin` stay `where(a >= b, a, b)` rather than `torch.maximum`: ties
and NaNs select the same operand as the JAX package does.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch

_state = None  # None | ["rec", list] | ["rep", list, [cursor]]

#: bits packed per batch when a recording exits: bounds the transient
#: copy of the raw decisions (and keeps the batch 32-bit indexable)
PACK_CHUNK_BITS = 1 << 28
_CONSTS: dict = {}     # device -> (bit weights, zero padding bits)


class Packed:
    """A boolean tape entry stored bit-packed.  `data` is uint8 of shape
    (*rows, ceil(n / 8)): each row the bits of one predicate of `shape`
    (n elements) flattened, 8 to a byte, first bit in the high bit, the
    last byte zero-padded; no row axis for an `fbool` entry, one per
    enclosing `fscan` (or `record_entry`) for the entries inside it."""

    __slots__ = ("data", "shape")

    def __init__(self, data, shape):
        self.data = data
        self.shape = torch.Size(shape)

    @property
    def decisions(self):
        """The decisions the entry holds: rows times the predicate's
        elements (the padding bits not counted)."""
        return self.data.shape[:-1].numel() * self.shape.numel()

    def __repr__(self):
        return (f"Packed(rows={tuple(self.data.shape[:-1])}, "
                f"shape={tuple(self.shape)}, bytes={self.data.numel()})")


def _consts(device):
    """The bit weights 128, 64, ..., 1 (uint8) and 7 zero bits, made once
    per device (no host-to-device copy per tape)."""
    hit = _CONSTS.get(device)
    if hit is None:
        hit = (torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                            device=device),
               torch.zeros(7, dtype=torch.bool, device=device))
        _CONSTS[device] = hit
    return hit


def _pack_group(group):
    """Pack [(raw bool tensor, number of row axes, Packed slot)] in one
    batch: the rows' bits, each row zero-padded to whole bytes, joined by
    one `torch.cat`, then 8 bits to a byte; each slot's data is a view of
    the packed bytes."""
    weights, pad = _consts(group[0][0].device)
    pieces, plan = [], []
    for x, lead, slot in group:
        rows = math.prod(x.shape[:lead])
        n = math.prod(slot.shape)
        nb = (n + 7) // 8
        flat = x.reshape(rows, n)
        if n % 8:
            for r in range(rows):
                pieces += [flat[r], pad[:8 * nb - n]]
        else:
            pieces.append(flat.reshape(-1))
        plan.append((slot, x.shape[:lead], rows * nb))
    bits = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
    data = (bits.view(torch.uint8).view(-1, 8) * weights).sum(
        -1, dtype=torch.uint8)
    off = 0
    for slot, lead_shape, nbytes in plan:
        slot.data = data[off:off + nbytes].view(*lead_shape, -1)
        off += nbytes


def _slots(e, lead, raw):
    """`e` with its boolean leaves of ndim > 0 per row as empty `Packed`
    slots, each new one added to the dict `raw` as (tensor, row axes,
    slot); a decision recorded twice (one tensor) shares one slot, as it
    shared one tensor.  (Module level, as are the walks below: a nested
    function that calls itself is a reference cycle, which would keep the
    decisions alive until a cyclic collection.)"""
    if isinstance(e, list):
        return [_slots(x, lead + 1, raw) for x in e]
    if e.dtype != torch.bool or e.dim() == lead:
        return e
    hit = raw.get((id(e), lead))
    if hit is None:
        hit = raw[(id(e), lead)] = (e, lead, Packed(None, e.shape[lead:]))
    return hit[2]


def pack_tape(tape):
    """A recorded tape with every boolean entry of ndim > 0 (of ndim > 0
    per row inside an `fscan` entry) as a `Packed` entry: the JAX
    package's `_pack`, in batches of at most PACK_CHUNK_BITS bits."""
    raw = {}
    out = [_slots(e, 0, raw) for e in tape]
    group, size = [], 0
    for x, lead, slot in raw.values():
        if x.numel() == 0:
            slot.data = torch.zeros(*x.shape[:lead],
                                    (math.prod(slot.shape) + 7) // 8,
                                    dtype=torch.uint8, device=x.device)
            continue
        if group and size + x.numel() > PACK_CHUNK_BITS:
            _pack_group(group)
            group, size = [], 0
        group.append((x, lead, slot))
        size += x.numel()
    if group:
        _pack_group(group)
    return out


def leaves(entries, lead=0):
    """Yields (leaf, number of row axes) for each leaf of `entries` (a
    tape, or a list of tapes), in order: a nested list (an `fscan` or
    `record_entry` entry) adds a row axis; a leaf is a tensor or a
    `Packed`."""
    for e in entries:
        if isinstance(e, (list, tuple)):
            yield from leaves(e, lead + 1)
        else:
            yield e, lead


def _rebuilt(e, views):
    """Entry `e` with each `Packed` leaf replaced by views[id(leaf)]."""
    if isinstance(e, list):
        return [_rebuilt(x, views) for x in e]
    return views[id(e)] if isinstance(e, Packed) else e


def unpack_tape(tape):
    """The tape with every `Packed` entry unpacked, in one batch: the
    packed bytes joined by one `torch.cat` and expanded to bits by two
    operations; each entry is a view of the bits, of shape (*rows,
    *shape).  Other entries are passed through."""
    # a shared slot once
    slots = list({id(p): p for p, _ in leaves(tape)
                  if isinstance(p, Packed)}.values())
    if not slots:
        return list(tape)
    data = [p.data.reshape(-1) for p in slots]
    flat = torch.cat(data) if len(data) > 1 else data[0]
    bits = (flat.unsqueeze(-1) & _consts(flat.device)[0]).ne(0).view(-1)
    views, off = {}, 0
    for p in slots:
        # the entry's bits as one strided view: a row every 8 * nb bits
        # (its padding skipped), the predicate's elements contiguous
        lead, nb = p.data.shape[:-1], p.data.shape[-1]
        shape = (*lead, *p.shape)
        stride, step = [0] * len(shape), 1
        for i in range(len(shape) - 1, -1, -1):
            if i == len(lead) - 1:
                step = 8 * nb
            stride[i] = step
            step *= shape[i]
        views[id(p)] = bits.as_strided(shape, stride, 8 * off)
        off += math.prod(lead) * nb
    return [_rebuilt(e, views) for e in tape]


@contextmanager
def recording():
    """Record every frozen decision; yields the tape, a list of entries,
    which holds the raw decisions inside the block and is packed in
    place (`pack_tape`) when the block exits."""
    global _state
    prev = _state
    tape: list = []
    _state = ["rec", tape]
    try:
        yield tape
    finally:
        _state = prev
    tape[:] = pack_tape(tape)


@contextmanager
def replaying(tape):
    """Replay decisions from `tape` (a sequence in recording order, its
    packed entries unpacked at once on entry); raises if the block does
    not consume the whole tape."""
    global _state
    prev = _state
    _state = ["rep", unpack_tape(tape), [0]]
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
    entry: a row per iteration, each packed on its own)."""
    _state[1].append([_plain(t) for t in entry])


def take_entry():
    """The next entry of the tape being replayed (unpacked)."""
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
    npz), selects compact storage: uint8 up to 255, uint16 up to 65535
    (the JAX package's), int32 up to 2**31-1."""
    if _state is None:
        return idx
    if _state[0] == "rec":
        ent = _plain(idx)
        if maxval is not None and not idx.dtype.is_floating_point:
            if maxval <= 255:
                ent = ent.to(torch.uint8)
            elif maxval <= 65535:
                ent = ent.to(torch.uint16)
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
