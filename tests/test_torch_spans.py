"""The span log of ``PhaseTimers`` (``observability``) on the CPU: a toy
genome ``pileup(timers=...)`` with the log off and on (the same phase
sums, self times that add up to them, one job id, the prefetch threads'
spans under the root, ``wait`` and ``ingest`` of one region under one
index, little of the job outside every span), detail spans that leave the
sums alone, the span clock against the profiler's, the readings of a job
(self and off-CPU seconds, device time by launching span) on synthetic
traces, an idle gap named by the spans open in it, ``snips_host`` on the
host stream; and on the card (``cuda`` marker) a kernel's launch inside
the span that launched it.

On a machine with a card:

    python -m pytest tests/test_torch_spans.py -q -m cuda
"""

import importlib
import json
import threading
import time

import numpy as np
import pytest
import torch

import coolpuppy_tpu_torch as port
from coolpuppy_tpu_torch.observability import (
    PhaseTimers,
    Span,
    SpanIndex,
    launched_seconds,
    span_seconds,
    union_seconds,
)
from torch_cases import GENOME_KW, genome_workload

engine = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")
DETAILS = {"coords/sweep", "coords/frames", "ingest/fetch"}


@pytest.fixture(scope="module")
def genome():
    """A 3-chromosome cut of the genome map with 300 stranded sites: three
    streamed regions, about a second a job on the CPU."""
    return genome_workload(n_chroms=3, bins_per=600, contacts_per=20_000,
                           n_sites=300)


@pytest.fixture
def runs(monkeypatch):
    """Every PileUpper that runs ``pileupsWithControl``, in order."""
    seen = []
    inner = engine.PileUpper.pileupsWithControl

    def recording(self, *a, **k):
        seen.append(self)
        return inner(self, *a, **k)

    monkeypatch.setattr(engine.PileUpper, "pileupsWithControl", recording)
    return seen


@pytest.fixture(scope="module")
def traced(genome):
    """One job with the log on: ``(timers, wall seconds, table)``."""
    clr, feats = genome
    port.pileup(clr, feats, device="cpu", **GENOME_KW)  # warm
    timers = PhaseTimers(spans=True)
    t0 = time.perf_counter()
    table = port.pileup(clr, feats, device="cpu", timers=timers, **GENOME_KW)
    return timers, time.perf_counter() - t0, table


def test_spans_off_keeps_todays_sums(genome, runs, traced):
    clr, feats = genome
    plain = port.pileup(clr, feats, device="cpu", **GENOME_KW)
    today = runs[-1].timers
    assert today.spans is None and "job" not in today.seconds
    off = PhaseTimers()
    again = port.pileup(clr, feats, device="cpu", timers=off, **GENOME_KW)
    assert runs[-1].timers is off and off.spans is None
    # wait opens only where a prefetch is late
    assert set(off.seconds) - {"wait"} == (set(today.seconds) - {"wait"}
                                           | {"job", "prepare"})
    assert dict(off.counts) == dict(today.counts)
    on, _, table = traced
    assert set(on.seconds) - {"wait"} == set(off.seconds) - {"wait"}
    for got in (again, table):
        np.testing.assert_array_equal(np.stack(got["data"]),
                                      np.stack(plain["data"]))


def test_self_times_add_up_to_the_sums(traced):
    timers, _, _ = traced
    spans = timers.spans
    phases = {s.name for s in spans if not s.detail}
    details = {s.name for s in spans if s.detail}
    assert phases == set(timers.seconds)
    assert {"job", "prepare", "region", "ingest", "coords", "device",
            "finalize"} <= phases
    assert details == DETAILS and not details & set(timers.seconds)
    for name in phases:
        n = sum(s.name == name for s in spans)
        assert abs(span_seconds(spans, name)
                   - timers.seconds[name]) <= 1e-6 * n, name
    for s in spans:
        assert s.end_ns >= s.start_ns and s.cpu_end_ns >= s.cpu_start_ns
        assert 0 <= s.self_s <= s.wall_s + 1e-6


def test_one_job_id_and_the_root_as_parent(traced):
    timers, _, _ = traced
    spans = timers.spans
    root = spans[0]
    assert root.name == "job" and root.parent is None
    assert {s.job for s in spans} == {timers.job_id}
    assert [s for s in spans if s.name == "job"] == [root]
    by_id = {s.id: s for s in spans}
    elsewhere = [s for s in spans if s.tid != root.tid]
    assert {s.name for s in elsewhere} >= {"ingest", "tiles", "stage"}
    for s in elsewhere:
        parent = by_id[s.parent]
        assert parent is root or parent.tid == s.tid, s
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    prepare = [s for s in spans if s.name == "prepare"]
    assert len(prepare) == 1 and prepare[0].parent == root.id
    first = min(s.start_ns for s in spans if s.name in ("ingest", "wait"))
    assert prepare[0].end_ns <= first


def test_wait_and_ingest_share_the_region(genome, monkeypatch):
    """Every region's staging slowed down: each ``wait`` names the region
    whose ``ingest`` kept the main thread waiting."""
    clr, feats = genome
    inner = engine.PileUpper._region_device_inputs

    def slow(self, *a, **k):
        time.sleep(0.05)
        return inner(self, *a, **k)

    monkeypatch.setattr(engine.PileUpper, "_region_device_inputs", slow)
    timers = PhaseTimers(spans=True)
    port.pileup(clr, feats, device="cpu", timers=timers, **GENOME_KW)
    spans = timers.spans
    ingest = {s.region: s for s in spans if s.name == "ingest"}
    assert sorted(ingest) == [0, 1, 2]
    root = spans[0]
    # the region loop's waits (a stream's wait on its session's build
    # opens inside ``device``)
    waits = [s for s in spans if s.name == "wait" and s.parent == root.id]
    assert waits and all(w.region is not None for w in waits)
    for w in waits:
        assert ingest[w.region].tid != w.tid
        assert ingest[w.region].end_ns >= w.start_ns
    for s in spans:
        if s.name == "ingest/fetch":
            assert by_parent(spans, s).name == "ingest"


def by_parent(spans, span):
    return next(s for s in spans if s.id == span.parent)


def test_root_self_time_is_small(traced):
    timers, wall, _ = traced
    root = timers.spans[0]
    assert root.self_s == timers.seconds["job"]
    assert root.wall_s <= wall
    assert root.self_s <= 0.05 * wall, (root.self_s, wall)


def test_detail_spans_leave_the_sums_alone():
    def run(spans):
        timers = PhaseTimers(spans=spans)
        with timers.phase("a"):
            time.sleep(0.01)
            with timers.detail("a/part", region=2):
                time.sleep(0.02)
                with timers.phase("b"):
                    time.sleep(0.01)
        return timers

    off, on = run(False), run(True)
    assert set(off.seconds) == set(on.seconds) == {"a", "b"}
    assert off.detail("x") is off.detail("y")  # the shared null context
    a, part, b = on.spans
    assert (part.parent, b.parent, part.region) == (a.id, part.id, 2)
    assert part.detail and not a.detail
    assert 0.02 <= part.self_s < part.wall_s - 0.009
    assert abs(a.self_s - on.seconds["a"]) < 1e-9
    assert on.seconds["a"] >= 0.03 and on.seconds["b"] >= 0.01


def test_span_clock_is_the_profilers(tmp_path):
    """A span's ends are ``time.time_ns()`` readings, and the profiler's
    event of the same block lies on that clock: each profiler event's
    start and end fall within 1 ms of the ``time.time_ns()`` readings
    taken just before and after ``record_function`` opens and closes, and
    the span holds those readings. The readings bracket the calls, so a
    thread preempted between the span and the event (or a slow first
    ``record_function``) widens the bracket instead of failing."""
    from torch.profiler import ProfilerActivity, profile, record_function

    timers = PhaseTimers(spans=True)
    marks = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            t = [time.time_ns()]
            with timers.phase("x"):
                t.append(time.time_ns())
                with record_function("span_clock"):
                    t.append(time.time_ns())
                    x = torch.randn(128, 128)
                    for _ in range(10):
                        x = x @ x / 128
                    t.append(time.time_ns())
                t.append(time.time_ns())
            t.append(time.time_ns())
            marks.append(t)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    got = sorted((base + round(e["ts"] * 1e3),
                  base + round((e["ts"] + e["dur"]) * 1e3))
                 for e in trace["traceEvents"]
                 if e.get("name") == "span_clock")
    assert len(got) == 3 and len(timers.spans) == 3
    for (a, b), s, t in zip(got, timers.spans, marks):
        assert t[0] <= s.start_ns <= t[1] and t[4] <= s.end_ns <= t[5]
        assert t[1] - 1_000_000 <= a <= t[2] + 1_000_000, (a - t[1], t[2] - a)
        assert t[3] - 1_000_000 <= b <= t[4] + 1_000_000, (b - t[3], t[4] - b)


# -- synthetic traces: what a job's readings are made of -------------------

MS = 1_000_000
T0 = 1_700_000_000_000_000_000  # an instant of time.time_ns()


def _spans():
    """A job on thread 1 (``prepare``, ``coords`` with ``coords/sweep``,
    ``wait`` r1, ``device``) and region 1's ``ingest`` on thread 2."""
    rows = [  # name, id, parent, tid, start ms, end ms, region, detail
        ("job", 1, None, 1, 0, 100, None, False),
        ("prepare", 2, 1, 1, 0, 10, None, False),
        ("coords", 3, 1, 1, 10, 40, None, False),
        ("coords/sweep", 4, 3, 1, 12, 20, None, True),
        ("wait", 5, 1, 1, 40, 60, 1, False),
        ("device", 6, 1, 1, 60, 90, None, False),
        ("ingest", 7, 1, 2, 30, 65, 1, False),
    ]
    out = []
    for name, i, parent, tid, a, b, region, detail in rows:
        s = Span(name, i, 7, parent, tid, T0 + a * MS, 0, region, detail)
        s.end_ns, s.cpu_end_ns = T0 + b * MS, (b - a) * MS // 2
        s.self_s = (b - a) * 1e-3
        out.append(s)
    return out


def _trace(runtime=True):
    """Kernels at 70-75 ms (launched at 62 ms in ``device``) and 95-97 ms
    (launched at 45 ms by thread 2's ``ingest``), a copy at 64-66 ms
    (launched at 63 ms), in microseconds after the trace's base."""
    base = T0 - 5 * MS
    us = lambda ms: (ms + 5) * 1e3  # noqa: E731
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": us(70), "dur": 5e3,
         "args": {"correlation": 11}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": us(95), "dur": 2e3,
         "args": {"correlation": 12}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c1", "ts": us(64),
         "dur": 2e3, "args": {"correlation": 13}},
    ]
    if runtime:
        ev += [
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "tid": 1, "ts": us(62), "dur": 10.0,
             "args": {"correlation": 11}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "tid": 2, "ts": us(45), "dur": 10.0,
             "args": {"correlation": 12}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
             "tid": 1, "ts": us(63), "dur": 10.0,
             "args": {"correlation": 13}},
        ]
    return {"baseTimeNanoseconds": base, "traceEvents": ev}


@pytest.mark.parametrize("name, want", [
    ("prepare", 0.010), ("coords/sweep", 0.008), ("ingest", 0.035),
    ("stripes", None)])
def test_self_seconds_reading(name, want):
    got = span_seconds(_spans(), name)
    assert got == pytest.approx(want) if want is not None else got is None


def test_offcpu_reading():
    assert span_seconds(_spans(), "ingest", "offcpu_s") == pytest.approx(0.0175)
    assert span_seconds(_spans(), "ingest/fetch", "offcpu_s") is None


def test_correlation_join_attributes_to_the_launching_span():
    events, method = SpanIndex(_spans()).launcher(_trace())
    assert method == "correlation"
    who = {name: s.name for name, _, _, s in events}
    assert who == {"k1": "device", "k2": "ingest", "c1": "device"}
    assert launched_seconds(_trace(), _spans(), "device") == \
        pytest.approx(0.007)
    assert launched_seconds(_trace(), _spans(), "ingest") == \
        pytest.approx(0.002)
    assert launched_seconds(_trace(), _spans(), "stage") is None
    assert launched_seconds({"traceEvents": []}, _spans(), "device") is None


def test_a_pthread_id_finds_the_native_thread():
    """A trace without host activity gives its runtime events the low 32
    bits of the launching thread's pthread id as ``tid``."""
    spans = _spans()
    for s in spans:
        s.ident = (0x7F00_0000_0000 | (0x1000 * s.tid)) + 0x6C0
    trace = _trace()
    for e in trace["traceEvents"]:
        if e["cat"] == "cuda_runtime":
            e["tid"] = ((0x1000 * e["tid"]) + 0x6C0) & 0xFFFFFFFF
    events, _ = SpanIndex(spans).launcher(trace)
    who = {name: s.name for name, _, _, s in events}
    assert who == {"k1": "device", "k2": "ingest", "c1": "device"}


def test_without_runtime_events_the_start_decides():
    events, method = SpanIndex(_spans()).launcher(_trace(runtime=False))
    assert method == "start"
    who = {name: (s.name if s else None) for name, _, _, s in events}
    # k2 starts after the job's last span closed: the root holds it
    assert who == {"k1": "device", "k2": "job", "c1": "device"}


def test_idle_gap_named_by_the_open_spans():
    idx = SpanIndex(_spans())
    assert idx.main_tid == 1
    assert idx.label(T0 + 50 * MS) == "wait r1 ← ingest*"
    assert idx.label(T0 + 15 * MS) == "coords/sweep"
    assert idx.label(T0 + 95 * MS) == "job"
    assert idx.label(T0 + 200 * MS) == ""
    # at a boundary the span that opens there is the one open
    assert idx.label(T0 + 40 * MS) == "wait r1 ← ingest*"
    assert union_seconds([(0, 5), (3, 8), (10, 12)]) == pytest.approx(1e-8)


def test_snips_host_on_the_host_stream(genome, runs):
    """The per-snip host stream (a snip hook) reports ``snips_host``: the
    loop's time less the stream's own phases, which pause it."""
    clr, feats = genome
    timers = PhaseTimers(spans=True)
    cc = port.CoordCreator(feats[:60], clr.binsize, features_format="bed",
                           flank=100_000, maxdist=2_000_000, nshifts=1,
                           seed=0, timers=timers)
    pu = port.PileUpper(clr, cc, control=True, device="cpu", timers=timers)
    with timers.job():
        pu.pileupsWithControl(postprocess_snip_func=lambda s: s)
    sec = runs[-1].timers.seconds
    assert sec["snips_host"] > 0 and {"coords", "tiles", "device"} <= set(sec)
    host = [s for s in timers.spans if s.name == "snips_host"]
    assert host and all(by_parent(timers.spans, s).name == "region"
                        for s in host)
    inside = [s for s in timers.spans if s.parent in {h.id for h in host}]
    assert {s.name for s in inside} >= {"coords", "tiles", "device"}
    assert span_seconds(timers.spans, "snips_host") == pytest.approx(
        sec["snips_host"], abs=1e-6 * len(host))


def test_timers_across_threads_keep_their_threads():
    timers = PhaseTimers(spans=True)
    seen = {}

    def work():
        with timers.phase("ingest", region=0):
            seen[threading.get_native_id()] = True

    with timers.job():
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    root = timers.spans[0]
    kids = [s for s in timers.spans if s.name == "ingest"]
    assert {s.tid for s in kids} == set(seen)
    assert all(s.parent == root.id and s.job == root.job for s in kids)


# -- on the card ------------------------------------------------------------


@pytest.mark.cuda
def test_kernel_launch_lies_in_its_span(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    x = torch.randn(2048, 2048, device=dev)
    torch.cuda.synchronize(dev)
    timers = PhaseTimers(spans=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with timers.phase("device"):
            y = x @ x
            torch.cuda.synchronize(dev)
    assert y.shape == x.shape
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    span = timers.spans[0]
    events, method = SpanIndex(timers.spans).launcher(trace)
    assert events and method == "correlation"
    base = trace["baseTimeNanoseconds"]
    launch = [base + round(e["ts"] * 1e3) for e in trace["traceEvents"]
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "Launch" in e.get("name", "")]
    assert launch and all(span.start_ns - 1_000_000 <= t <= span.end_ns
                          for t in launch)
    for _, a, b, s in events:
        assert s is span
        assert b <= span.end_ns + 1_000_000
