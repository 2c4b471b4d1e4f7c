"""BENCHMARK.json and what it names: every configuration, traffic mix,
limit and metric reader is found by its name, and a new one is found
from a new file alone."""

import json
import re
from pathlib import Path

import pytest

import harness
from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark(REPO)


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_every_named_file_loads(bench, kind):
    for item in bench[kind]:
        if kind == "configs":
            conf = harness.load_config(BENCH, item["name"])
            assert conf["name"] == item["name"]
            assert Path(REPO / item["file"]) == (
                BENCH / "configs" / f"{item['name']}.json")
            assert conf["reduced"] == item["reduced"]
        elif kind == "workloads":
            harness.load_config(BENCH, item["config"])
            assert harness.load_traffic(BENCH, item["traffic"])[
                "name"] == item["traffic"]
            assert set(harness.load_limits(BENCH, item["name"])) >= {
                "tl_gap", "ad_gap"}
        else:
            assert callable(harness.load_reader(BENCH, item["name"]))


def test_each_cell_reports_setup_another_e2e_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = harness.cell_metrics(bench, w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(bench, w["name"], "per_layer")


def test_new_entries_found_from_new_files_alone(tmp_path, bench):
    """A configuration, a traffic mix, a cell's limits and a metric added
    as new files, with new entries in BENCHMARK.json, are found by name."""
    b = tmp_path / "benchmark"
    for d in ("configs", "traffic", "limits", "metrics"):
        (b / d).mkdir(parents=True)
    conf = harness.load_config(BENCH, "c180L72_dyn")
    conf["name"] = "c96L72_new"
    (b / "configs" / "c96L72_new.json").write_text(json.dumps(conf))
    (b / "traffic" / "relin.json").write_text(json.dumps(
        {"name": "relin", "trajectories": 2, "perturbations": 4,
         "check_among": 2}))
    (b / "limits" / "relin.c96L72_new.json").write_text(json.dumps(
        {"limits": {"tl_gap": 1.0, "ad_gap": 1.0}}))
    (b / "metrics" / "linearize_s.py").write_text(
        "def read(ctx):\n    return ctx.timers.get('ckpts.forward')\n")
    new = dict(bench)
    new["configs"] = bench["configs"] + [dict(
        name="c96L72_new", source="x", file="benchmark/configs/x.json",
        reduced=[], why="x")]
    new["workloads"] = bench["workloads"] + [dict(
        name="relin.c96L72_new", config="c96L72_new", traffic="relin",
        chips=1, why="x")]
    new["per_layer"] = bench["per_layer"] + [dict(
        name="linearize_s", unit="s", better="lower", source="program_span",
        layer="sweeps", moves="pair_s", workloads=["relin.c96L72_new"])]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))

    loaded = harness.load_benchmark(tmp_path)
    cell = harness.find(loaded["workloads"], "relin.c96L72_new", "workload")
    assert harness.load_config(b, cell["config"])["name"] == "c96L72_new"
    assert harness.load_traffic(b, cell["traffic"])["trajectories"] == 2
    assert harness.load_limits(b, cell["name"]) == {"tl_gap": 1.0,
                                                    "ad_gap": 1.0}
    assert "linearize_s" in harness.cell_metrics(loaded, cell["name"],
                                                 "per_layer")
    read = harness.load_reader(b, "linearize_s")

    class Ctx:
        timers = {"ckpts.forward": 2.5}
    assert read(Ctx) == 2.5
    # the existing cells do not report the new metric
    assert "linearize_s" not in harness.cell_metrics(
        loaded, "tlad.c180L72_dyn", "per_layer")
