"""The benchmark's own tests: on the CPU, at c12L10 and c8L12.  Run from
the repository's root:

    python -m pytest -q -p no:cacheprovider benchmark/tests

Tests that need the card carry the `cuda` marker and skip without one."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
for p in (str(REPO), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: tests/test_moist.py's troposphere-heavy hybrid coordinate (c8L12)
PHYS_PREF = [30., 1500., 4000., 8000., 14000., 22000., 32000., 44000.,
             57000., 71000., 85000., 93000., 100000.]
#: each configuration at the size of the repository's CPU tests
SMALL = {
    "c180L72_dyn": dict(npx=13, npy=13, npz=10, n_split=2, n_sponge=3,
                        n_sponge_pert=4),
    "c144L72_phys": dict(npx=9, npy=9, npz=12, n_split=1, n_sponge=2,
                         n_sponge_pert=3),
}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA GPU (skips without one)")


def small_root(root, dtype="float32"):
    """A checkout-like directory whose BENCHMARK.json, traffic, metrics
    and limits are the benchmark's, and whose configurations are its own
    at SMALL's sizes (dt 450 s, `dtype`)."""
    root = Path(root)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for d in ("metrics", "traffic", "limits"):
        shutil.copytree(BENCH / d, root / "benchmark" / d)
    (root / "benchmark" / "configs").mkdir()
    bk = [min(max((p - 20000.0) / 80000.0, 0.0), 1.0) for p in PHYS_PREF]
    ak = [p - b * 1e5 for p, b in zip(PHYS_PREF, bk)]
    for name, kw in SMALL.items():
        with open(BENCH / "configs" / f"{name}.json") as f:
            conf = json.load(f)
        conf["model"]["dyn"].update(kw, dtype=dtype)
        conf["model"]["dt"] = 450.0
        if conf["model"].get("do_phy_mst"):
            conf["model"]["ak"], conf["model"]["bk"] = ak, bk
        with open(root / "benchmark" / "configs" / f"{name}.json", "w") as f:
            json.dump(conf, f)
    return root


@pytest.fixture
def small(tmp_path):
    return small_root(tmp_path)
