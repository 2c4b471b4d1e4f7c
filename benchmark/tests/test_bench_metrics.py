"""The metric arithmetic: the whole-window rate, the union of kernel
intervals and the idle gaps behind `idle_share`, `pair_mfu`, the scope
and timer sums, and the reduction of a trace's raw events."""

from types import SimpleNamespace

import pytest
import torch

import metric_math as mm
import peaks
import trace
import harness
from conftest import BENCH


def test_rate_is_the_whole_window_over_its_pairs():
    assert mm.rate_s(40.0, 3) == pytest.approx(40.0 / 3)
    assert mm.rate_s(10.0, 0) is None


@pytest.mark.parametrize("intervals, union, gaps", [
    ([], 0.0, []),
    ([(0, 10)], 10e-9, []),
    ([(0, 10), (5, 20)], 20e-9, []),
    ([(0, 10), (2, 3), (30, 35)], 15e-9, [(10, 30)]),
    ([(30, 35), (0, 10), (10, 12)], 17e-9, [(12, 30)]),
])
def test_union_and_gaps(intervals, union, gaps):
    assert trace.union_s(intervals) == pytest.approx(union)
    assert trace.gaps(intervals) == gaps


def test_idle_share_and_mfu():
    assert mm.idle_share(2.5, 10.0) == pytest.approx(75.0)
    assert mm.idle_share(0.0, 10.0) is None
    assert mm.mfu(67e12, 1.0, peaks.F32_OPS_PER_S) == pytest.approx(100.0)
    assert mm.mfu(6.7e11, 10.0, peaks.F32_OPS_PER_S) == pytest.approx(0.1)
    assert mm.mfu(None, 10.0, peaks.F32_OPS_PER_S) is None


def test_timer_and_scope_sums():
    assert mm.timers_sum({"a": 1.0, "b": 2.0}, ("a", "b", "c")) == 3.0
    assert mm.timers_sum({"a": 1.0}, ("c",)) is None
    p = trace.Profile(wall_s=1.0, busy_s=0.5,
                      scope_kernel_s={"d_sw": 0.1, "d_sw_pert": 0.2})
    assert mm.scope_ms(p, ("d_sw", "d_sw_pert")) == pytest.approx(300.0)
    assert mm.scope_ms(trace.Profile(wall_s=1.0), ("d_sw",)) is None


def test_innermost_scope():
    ranges = [("step_tl", 0, 100), ("d_sw", 10, 20), ("remap", 50, 60)]
    assert trace.innermost(ranges, [5, 15, 30, 55, 120]) == [
        "step_tl", "d_sw", "step_tl", "remap", "(none)"]


class Ev:
    """A stand-in for a raw Kineto event."""

    def __init__(self, name, dev, start, dur, corr=0, link=0, ann=False,
                 tid=1):
        self._v = (name, dev, start, dur, corr, link, ann, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def end_ns(self):
        return self._v[2] + self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]

    def start_thread_id(self):
        return self._v[7]


def test_reduce_raw_events():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = [Ev("step_tl", cpu, 0, 1000, ann=True),
          Ev("d_sw", cpu, 100, 200, ann=True),
          # the scopes' spans on the device's timeline
          Ev("step_tl", cuda, 200, 410, ann=True),
          Ev("d_sw", cuda, 200, 100, ann=True),
          Ev("aten::mul", cpu, 150, 5, corr=1),
          Ev("aten::add", cpu, 400, 5, corr=2),
          Ev("k_mul", cuda, 200, 100, link=1),
          Ev("k_add", cuda, 500, 50, link=2),
          Ev("Memcpy HtoD", cuda, 600, 10, link=2)]
    p = trace.reduce(ev, wall_s=2e-6)
    assert p.launches == 2
    assert p.busy_s == pytest.approx(160e-9)
    assert p.scope_kernel_s["d_sw"] == pytest.approx(100e-9)
    assert p.scope_kernel_s["step_tl"] == pytest.approx(160e-9)
    assert p.idle_gaps == {"step_tl": pytest.approx(250e-9)}
    assert trace.top(p.kernel_s, 1) == [["k_mul", pytest.approx(100e-9)]]


def test_readers_on_a_traced_context():
    prof = trace.Profile(wall_s=20.0, busy_s=4.0, launches=345000,
                         scope_kernel_s={"d_sw": 1.0, "remap": 0.25})
    ctx = SimpleNamespace(
        conf={"ops_per_pair": {"count": 6.7e11}}, peaks=peaks,
        pair_wall_s=10.0, profile=prof, cached_step_bytes=2 ** 31,
        timers={"step_tl.dyn": 6.0, "step_ad.dyn": 3.5,
                "step_tl.moist": 1.0, "step_ad.turb": 0.5},
        setup_s=60.0, elapsed_s=45.0, pairs=3, peak_bytes=2 ** 34)
    want = {"idle_share.dyn": 60.0, "pair_mfu.dyn": 0.1,
            "d_sw_kernel_ms": 1000.0, "remap_kernel_ms": 250.0,
            "launches_per_pair.dyn": 345000, "cached_step_gib": 2.0,
            "tl_dyn_s": 6.0, "ad_dyn_s": 3.5, "physics_s": 1.5,
            "pair_s": 15.0, "phys_pair_s": 15.0, "setup_s": 60.0,
            "peak_gib": 16.0}
    for name, value in want.items():
        assert harness.load_reader(BENCH, name)(ctx) == pytest.approx(value)
