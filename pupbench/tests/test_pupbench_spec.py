"""BENCHMARK.json and the files it names: every configuration, cell and
per-layer metric is found by its name."""

import json
import re

import pytest

from conftest import CELLS
from pupbench import reference, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_shape():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["pupbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    w = spec.workload(name)
    cfg = spec.config(w["config"])
    cell = spec.cell(name)
    assert cell["config"] == w["config"] == cfg["name"]
    assert cell["traffic"] == w["traffic"]
    assert cell["why"] == w["why"] and len(w["why"]) <= 200
    assert w["chips"] == 1
    assert set(cell["limits"]) == {"rows", "n_gap", "num_gap", "nan_gap",
                                   "data_gap", "data_mean_gap"}
    ref = reference.parts(cell["reference"])
    assert set(vars(ref)) == set(reference.ROLES)
    entry = [c for c in spec.benchmark()["configs"]
             if c["name"] == w["config"]][0]
    assert entry["file"] == f"pupbench/configs/{w['config']}.json"
    assert entry["source"] == cfg["source"]
    assert entry["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    spec.benchmark()["per_layer"]])
def test_metric_readers_load_by_name(metric):
    assert callable(spec.reader(metric))
    if metric.endswith("_roofline"):
        assert spec.kernel_names(metric)


def test_every_config_is_used():
    used = {w["config"] for w in spec.benchmark()["workloads"]}
    assert used == {c["name"] for c in spec.benchmark()["configs"]}
