"""The reference against the port at the test sizes in float64, with each
configuration's options: the dynamics' (production options, perturbation
sponge) at c12L10, and with the GEOS physics at c8L12 on the convective
sounding."""

import pytest
import torch

import compare
import generator
import harness
import reference
from conftest import small_root


@pytest.mark.parametrize("config", ["c180L72_dyn", "c144L72_phys"])
def test_reference_matches_the_port(tmp_path, config):
    root = small_root(tmp_path, dtype="float64")
    conf = harness.load_config(root / "benchmark", config)
    traffic = harness.load_traffic(root / "benchmark", "tlad")
    prog = harness.Program(conf, "cpu")
    ref = reference.Reference(conf, "cpu")
    keys = ref.prog_3d
    traj = generator.trajectories(conf, traffic, 12345, prog.dtype, "cpu")[0]
    dx = generator.perturbations(conf, traffic, 12345, prog.dtype, "cpu")[0]
    rtraj = traj
    for _ in range(conf["trajectory"]["nl_steps"]):
        nl = prog.step_nl(traj)
        rnl = ref.nl_step(traj)
        assert compare.worst_gap(nl, rnl, keys) == 0.0
        traj, rtraj = dict(traj, **nl), dict(traj, **rnl)
    tl = prog.step_tl(traj, dx)
    ad = prog.step_ad(traj, tl)
    lin = ref.linearize(rtraj)
    rtl = ref.tl(lin, dx)
    rad = ref.ad(lin, rtl)
    assert compare.worst_gap(tl, rtl, keys) <= 1e-14
    assert compare.worst_gap(ad, rad, keys) <= 1e-13
    if conf["model"].get("do_phy_mst"):
        assert bool(lin.moist["doconvec"].any())   # some column convects
    # the dot-product identity of the reference itself
    lhs = sum(float((rtl[k] * rtl[k]).sum()) for k in keys)
    rhs = sum(float((dx[k] * rad[k]).sum()) for k in keys)
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    assert isinstance(rtl["u"], torch.Tensor)
