"""Whole runs on tiny copies of the cells, on the CPU: the result line's
keys, the comparison broken underneath, the control, and the entry's
refusals."""

import json
import os
import shutil
import subprocess
import sys
import time
import weakref

import numpy as np
import pytest

import coolpuppy_tpu_torch as cpt
from conftest import BIG_SEED, CELLS, ROOT, tiny
from pupbench import compare, control, harness, spec
from pupbench.gen import features

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


class FakeTable:
    """A job's table of a known size: ``snips`` snips, 1 MiB of payload."""

    def __init__(self, snips):
        self.snips, self.payload = snips, np.zeros(2**20, np.uint8)


class FakeCell:
    """What ``harness.measure`` drives, with jobs that return a
    ``FakeTable`` after ``job_s`` seconds, or raise where ``raises(j)``.
    It logs each job's start and the pool's draws (``events``), and at
    each job's start the window's tables that are still alive."""

    def __init__(self, check_jobs, pool_jobs, job_s=0.002,
                 raises=lambda j: False):
        cfg, cell = tiny("tads_10kb.corners_expected")
        self.cell = dict(cell, check_jobs=check_jobs)
        self.job_s, self.raises = job_s, raises
        self.events, self.refs, self.alive = [], [], []
        self.parts = type("Parts", (), {})()
        self.parts.table = type("Table", (), {
            "snips": staticmethod(lambda t: t.snips)})()
        self.pool = features.Pool(cfg, self.cell, BIG_SEED, pool_jobs)
        self.seed_job = {features.job_seed(BIG_SEED, j): j
                         for j in range(10_000)}

    def run(self, feats, job_seed):
        job = self.seed_job[job_seed]
        self.events.append(("run", job))
        self.alive.append(sum(r() is not None for r in self.refs))
        time.sleep(self.job_s)
        if self.raises(job):
            raise RuntimeError(f"job {job} fails")
        table = FakeTable(len(feats))
        self.refs.append(weakref.ref(table))
        return table


def logging_draws(monkeypatch, log):
    real = features.job_features

    def draw(config, cell, seed, job, stream=features.FEATURES):
        log.append(("draw", job))
        return real(config, cell, seed, job, stream)

    monkeypatch.setattr(features, "job_features", draw)


@pytest.mark.parametrize("check_jobs", [1, 2, 3])
def test_window_holds_only_the_checked_tables(check_jobs):
    """At each job's start at most ``check_jobs`` window tables are
    alive, so with the job in flight at most ``check_jobs + 1``; the kept
    ones are the checked jobs'."""
    c = FakeCell(check_jobs, pool_jobs=200)
    w = harness.measure(c, BIG_SEED, 0.3)
    assert w.jobs > 3 * check_jobs and w.failed == 0
    assert max(c.alive) <= check_jobs
    assert len(w.kept.slots) == check_jobs
    assert w.snips == sum(len(c.pool.sets[j]) for j in range(w.jobs))
    alive = [r() for r in c.refs if r() is not None]
    assert sorted(id(t) for t in alive) == sorted(
        id(t) for _, t in w.kept.slots)


@pytest.mark.parametrize("k,n", [(1, 7), (2, 10), (3, 40)])
def test_checked_jobs_follow_the_seed(k, n):
    """The choice is the same for one seed and one job count, differs
    across seeds, and is uniform over the jobs offered."""
    def chosen(seed):
        r = harness.Reservoir(k, seed)
        for j in range(n):
            r.offer(j, None)
        return r.jobs()

    assert chosen(BIG_SEED) == chosen(BIG_SEED)
    picks = [chosen(BIG_SEED + s) for s in range(3000)]
    assert len({tuple(p) for p in picks}) > 1
    assert all(len(set(p)) == k and set(p) <= set(range(n)) for p in picks)
    hits = np.bincount(np.concatenate(picks), minlength=n)
    expect = 3000 * k / n
    assert np.all(np.abs(hits - expect) < 5 * np.sqrt(expect))


def test_a_job_that_raises_is_never_checked():
    c = FakeCell(2, pool_jobs=200, raises=lambda j: j % 2 == 1)
    w = harness.measure(c, BIG_SEED, 0.2)
    assert w.failed == w.jobs // 2 and w.jobs >= 6
    assert w.kept.jobs() and all(j % 2 == 0 for j in w.kept.jobs())
    assert w.snips == sum(len(c.pool.sets[j]) for j in range(0, w.jobs, 2))


def test_no_draw_inside_the_window(monkeypatch):
    """A pool that covers the window: no set is drawn between the first
    job and the last. One that does not: each set past it is drawn with
    the window's clock stopped, and counted."""
    log = []
    logging_draws(monkeypatch, log)
    c = FakeCell(1, pool_jobs=200)
    c.events = log
    w = harness.measure(c, BIG_SEED, 0.2)
    runs = [i for i, e in enumerate(log) if e[0] == "run"]
    assert w.drawn == 0 and w.jobs == len(runs)
    assert not any(e[0] == "draw" for e in log[runs[0]:])

    log.clear()
    c = FakeCell(1, pool_jobs=2, job_s=0.001)
    c.events = log
    real = features.job_features

    def slow(*a, **k):
        time.sleep(0.02)
        return real(*a, **k)

    monkeypatch.setattr(features, "job_features", slow)
    t = time.perf_counter()
    w = harness.measure(c, BIG_SEED, 0.1)
    wall = time.perf_counter() - t
    assert w.drawn == w.jobs - 2 and w.drawn >= 10
    assert w.seconds < 0.1 + 0.05 and w.drawn_s >= 0.02 * w.drawn
    assert wall >= w.seconds + w.drawn_s - 1e-3
    assert [e[1] for e in log if e[0] == "run"] == list(range(w.jobs))


def test_a_run_holds_only_the_checked_tables(monkeypatch):
    """A whole run on the CPU: the program's tables that stay alive
    through the window are the checked jobs' alone."""
    refs, alive = [], []
    real = harness.Cell.run

    def run(self, feats, job_seed):
        alive.append(sum(r() is not None for r in refs))
        table = real(self, feats, job_seed)
        refs.append(weakref.ref(table))
        return table

    monkeypatch.setattr(harness.Cell, "run", run)
    cfg, cell = tiny("tads_10kb.corners_expected")
    cell["pool_jobs"] = 40
    r = harness.run("tads_10kb.corners_expected", BIG_SEED, 1.0, False,
                    "cpu", time.perf_counter(), config=cfg, cell=cell)
    assert r["correct"] is True and r["attempted"] >= 3
    assert r["drawn_past_pool"] == 0
    assert max(alive[1:]) <= cell["check_jobs"]


def test_a_jax_import_stops_the_run(monkeypatch):
    """JAX in ``sys.modules`` once the window has closed: no result."""
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.ForbiddenImport):
        tiny_run("tads_10kb.corners_expected", 0, seconds=0.1)
    assert "coolpuppy_tpu_torch" in sys.modules
    assert harness.forbidden_modules() == ["jax"]
