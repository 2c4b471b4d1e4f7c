"""The arithmetic the metric readers share."""

from __future__ import annotations


def rate_s(elapsed_s, pairs):
    """Seconds per pair over the whole window: its whole elapsed time over
    its whole pairs (never a best or a median, so a stall counts)."""
    return elapsed_s / pairs if pairs else None


def idle_share(busy_s, wall_s):
    """Percent of `wall_s` in which no kernel ran; None without a trace of
    the device."""
    if not busy_s or not wall_s:
        return None
    return 100.0 - 100.0 * busy_s / wall_s


def mfu(ops, wall_s, peak_ops_per_s):
    """Percent of the chip's peak that `ops` operations in `wall_s` are."""
    if not ops or not wall_s:
        return None
    return 100.0 * ops / (wall_s * peak_ops_per_s)


def timers_sum(timers, names):
    """The seconds of the named host timers present; None if none is."""
    hit = [timers[n] for n in names if n in (timers or {})]
    return sum(hit) if hit else None


def scope_ms(profile, names):
    """Device milliseconds of the kernels the named scopes launched; None
    without a trace of the device."""
    if profile is None or not profile.busy_s:
        return None
    return 1e3 * sum(profile.scope_kernel_s.get(n, 0.0) for n in names)
