"""Whole runs on tiny copies of the cells, on the CPU: the result line's
keys, the comparison broken underneath, the control, and the entry's
refusals."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

import coolpuppy_tpu_torch as cpt
from conftest import BIG_SEED, CELLS, ROOT, tiny
from pupbench import compare, control, harness, spec

TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_run(name, trace, seconds=0.5):
    cfg, cell = tiny(name)
    return harness.run(name, BIG_SEED, seconds, trace, "cpu",
                       time.perf_counter(), config=cfg, cell=cell)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace):
    name = "tads_10kb.corners_expected"
    r = tiny_run(name, trace)
    assert list(r)[:5] == TOP_KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec.metrics_for(name, section)}
    got = set(r["metrics"])
    if trace:  # no card: the device readers find nothing to read
        want -= {"device_idle", "quad_roofline", "wide_roofline"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(r["device"])
    assert got == want
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(r["checks"]) == set(compare.NUMBERS)
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


def half_the_features(monkeypatch):
    real = cpt.pileup

    def broken(clr, feats, **kw):
        return real(clr, feats.iloc[: len(feats) // 2], **kw)

    monkeypatch.setattr(cpt, "pileup", broken)


def altered_answer(monkeypatch):
    real = cpt.pileup

    def broken(clr, feats, **kw):
        table = real(clr, feats, **kw)
        data = np.array(table.loc[0, "data"], float, copy=True)
        data[np.unravel_index(np.nanargmax(data), data.shape)] *= 1.05
        table.at[0, "data"] = data
        return table

    monkeypatch.setattr(cpt, "pileup", broken)


@pytest.mark.parametrize("fault", [half_the_features, altered_answer])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    r = tiny_run(name, 0)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    """The reference through bfloat16 in the program's place fails; the
    program (float32 on the CPU, no wire) passes."""
    cfg, cell = tiny(name)
    prog, ctrl = control.readings(name, BIG_SEED, True, "cpu", cfg, cell)
    assert compare.judge(prog, cell["limits"])[0]
    assert not compare.judge(ctrl, cell["limits"])[0]


def entry(args, cwd, code=""):
    """run.py in a subprocess; ``code`` runs before it (a stand-in card)."""
    prog = (f"{code}\nimport runpy, sys\nsys.argv = {['run.py'] + args!r}\n"
            "runpy.run_path('pupbench/run.py', run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", prog], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


ARGS = ["--workload", CELLS[0], "--seed", str(BIG_SEED), "--seconds", "1",
        "--trace", "0"]


def test_no_card_no_result():
    p = entry(ARGS, ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    """A checkout of BENCHMARK.json and pupbench/ alone: the program does
    not import, and no result is printed, even with a card."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "pupbench"), tmp_path / "pupbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    card = ("import torch\ntorch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1")
    p = entry(ARGS, tmp_path, card)
    assert p.returncode != 0 and p.stdout == ""
    assert "does not import" in p.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name, card):
    """The same on the card, on a tiny copy: the program's counts are
    exact, the bfloat16 control fails the cell's limits, and each gap of
    the control reads three times the program's or more. The program's
    own gaps are not held to the limits here: its float16 wire's rounding
    averages over a few hundred windows at this size, against millions in
    the cell, where the runs themselves hold it to them."""
    cfg, cell = tiny(name)
    prog, ctrl = control.readings(name, BIG_SEED, True, card, cfg, cell)
    print(f"{name}: program {prog}, control {ctrl}")
    assert prog["rows"] == prog["n_gap"] == prog["num_gap"] == 0
    assert prog["nan_gap"] == 0
    assert not compare.judge(ctrl, cell["limits"])[0]
    for k in ("data_gap", "data_mean_gap"):
        assert ctrl[k] >= 3 * prog[k]


def test_a_jax_import_stops_the_run(monkeypatch):
    """JAX in ``sys.modules`` once the window has closed: no result."""
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.ForbiddenImport):
        tiny_run("tads_10kb.corners_expected", 0, seconds=0.1)
    assert "coolpuppy_tpu_torch" in sys.modules
    assert harness.forbidden_modules() == ["jax"]
