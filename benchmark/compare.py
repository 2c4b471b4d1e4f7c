"""The comparison that decides `correct`: per field, the relative L2 gap
of the program's output to the reference's, and the worst field's gap
held to the cell's limit."""

from __future__ import annotations

import math

import torch


def field_gap(got, want):
    """||got - want|| / ||want|| in float64; 0 where both are zero, inf
    where only `want` is, or where `got` is not finite."""
    g, w = got.double(), want.double().to(got.device)
    num = float(torch.linalg.vector_norm(g - w))
    den = float(torch.linalg.vector_norm(w))
    if not math.isfinite(num):
        return math.inf
    if den == 0.0:
        return 0.0 if num == 0.0 else math.inf
    return num / den


def worst_gap(got, want, keys):
    """The largest field_gap over the fields `keys`."""
    return max(field_gap(got[k], want[k]) for k in keys)


def judge(gaps, limits):
    """[(name, value, limit, ok)] for each compared number, and whether
    all hold; a number without a limit fails."""
    rows = []
    for name, value in gaps.items():
        lim = limits.get(name)
        ok = lim is not None and math.isfinite(value) and value <= lim
        rows.append((name, value, lim, ok))
    return rows, bool(rows) and all(r[3] for r in rows)
