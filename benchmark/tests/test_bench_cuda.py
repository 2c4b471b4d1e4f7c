"""A whole run on the card at the test sizes (skips without one)."""

import time

import pytest
import torch

import harness


@pytest.mark.cuda
@pytest.mark.parametrize("trace_on", [False, True])
def test_run_on_the_card(small, trace_on):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    res, lines = harness.run_cell("tlad.c180L72_dyn", 5, 1.0, trace_on,
                                  root=small, t_start=time.perf_counter(),
                                  device="cuda")
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    if trace_on:
        assert res["device"]["busy_s"] > 0
        assert "launches_per_pair.dyn" in res["metrics"]
