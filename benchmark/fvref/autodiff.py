"""`vjp` for the physics' transposes, copied from the port's
core/staged.py (which this frozen copy leaves out: the reference does not
run the staged sweeps it tests)."""

from __future__ import annotations

from contextlib import nullcontext

import torch

from .core import freeze


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in tree:
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _leaves(x, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, it) for x in tree)
    if isinstance(tree, torch.Tensor):
        return next(it)
    return tree


def _pairs(out, ct, acc):
    """(output, cotangent) leaf pairs of matching dict keys and positions;
    a missing or None cotangent is zero."""
    if ct is None:
        return acc
    if isinstance(out, dict):
        for k in out:
            _pairs(out[k], ct.get(k), acc)
    elif isinstance(out, (list, tuple)):
        for o, c in zip(out, ct):
            _pairs(o, c, acc)
    elif isinstance(out, torch.Tensor):
        acc.append((out, ct))
    return acc


def vjp(fn, primals, cotangent, tape=None):
    """Cotangent of `fn`'s inputs: fn(*primals) recomputed with autograd
    from detached copies of the primals (a tape, if given, replayed), then
    one `torch.autograd.grad`.  Returns the input cotangents with the
    structure of `primals` (zeros where an input does not reach an output
    with a cotangent)."""
    leaves = _leaves(primals, [])
    ins = [x.detach().requires_grad_(x.is_floating_point()) for x in leaves]
    args = _rebuild(primals, iter(ins))
    with torch.enable_grad(), (freeze.replaying(tape) if tape is not None
                               else nullcontext()):
        out = fn(*args)
    pairs = [(o, c) for o, c in _pairs(out, cotangent, [])
             if o.requires_grad]
    want = [x for x in ins if x.requires_grad]
    grads = iter(torch.autograd.grad(
        [o for o, _ in pairs], want, [c for _, c in pairs],
        allow_unused=True) if pairs else [None] * len(want))
    res = []
    for x in ins:
        g = next(grads) if x.requires_grad else None
        res.append(torch.zeros_like(x) if g is None else g)
    return _rebuild(primals, iter(res))
