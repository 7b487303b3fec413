"""The port's span log on the card, over the benchmark's cells: what each
job's spans read, the device time by launching span, the idle gaps named by
the host spans open in them, and what turning the log on costs.

    python3 tools/torch_spans.py [--cells A,B] [--seed N] [--seconds S]
        [--windows K] [--out DIR]

For each cell of ``BENCHMARK.json`` (all by default) the process builds the
benchmark's inputs (``pupbench.harness.Cell``: the map, the expected table,
the feature pool, from ``--seed``) and a warm-up job, then runs 2K windows
of ``--seconds`` each, whole jobs back to back as the benchmark does, the
log off and on in turns (off, on, on, off, ...): ``snips_per_s`` of every
window, and of each job with the log on its readings (``job_readings``).
Two more jobs with the log on run under ``torch.profiler`` (kernels and
copies, as ``pupbench/trace.py`` profiles): each kernel and copy goes to
the span that launched it (``SpanIndex.launcher``), and the ten longest
idle gaps of the device (as ``pupbench.trace.Trace.breakdown`` finds and
names them) get the host spans open at their midpoint in front. The
warm-up job runs with the log on too: its ``prepare/coverage`` span is the
one-off coverage pass of a ``coverage_norm`` cell. Prints the card's name
and power limit, one JSON line a cell, which it writes to
``DIR/spans_<cell>.json``, and a line a cell of the means a job of the
``coverage`` phase and of the counters in ``COUNTS``. Needs an NVIDIA
card; imports neither JAX nor the JAX package."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DETAILS = ("coords/sweep", "coords/frames", "ingest/fetch",
           "prepare/coverage")
COUNTS = ("fetch_views", "fetch_dropped_pixels", "coverage_regions",
          "coverage_hist_regions", "coverage_scatter_regions",
          "tile_wire_exact_f16_regions", "tile_wire_f32_regions",
          "tile_cast_native_regions")


def job_readings(timers, wall):
    """One job's readings from its span log: the phases' sums, the
    timers' counts, the self times of ``prepare`` and the detail spans, the
    off-CPU seconds of ``ingest``, the root's self time and its share of
    the wall."""
    from coolpuppy_tpu_torch.observability import span_seconds

    spans = timers.spans
    out = {"wall_s": wall, "spans": len(spans),
           "seconds": dict(timers.seconds), "counts": dict(timers.counts)}
    for name in ("prepare",) + DETAILS:
        out[name] = span_seconds(spans, name)
    out["ingest_offcpu"] = span_seconds(spans, "ingest", "offcpu_s")
    out["root_self_s"] = timers.seconds["job"]
    out["root_share"] = timers.seconds["job"] / wall
    # where the root's self time lies: between which of its children
    root = spans[0]
    kids = sorted((s for s in spans if s.parent == root.id
                   and s.tid == root.tid), key=lambda s: s.start_ns)
    between, t, last = {}, root.start_ns, "start"
    for k in kids + [None]:
        nxt = k.start_ns if k is not None else root.end_ns
        key = f"{last}>{k.name if k is not None else 'end'}"
        between[key] = between.get(key, 0.0) + (nxt - t) * 1e-9
        if k is not None:
            t, last = k.end_ns, k.name
    out["root_between"] = dict(sorted(between.items(),
                                      key=lambda kv: -kv[1])[:4])
    return out


def run_job(cell, j, timers):
    """Job ``j`` of the cell's pool, as the benchmark's ``Cell.run`` runs
    it, with ``timers`` handed to ``pileup``; returns its snips."""
    from pupbench.gen import features

    extra = {}
    if cell.expected is not None:
        extra = dict(expected_df=cell.expected, view_df=cell.view)
    table = cell.cpt.pileup(cell.clr, cell.pool[j], device=cell.device,
                            seed=features.job_seed(cell.seed, j),
                            timers=timers, **cell.kw, **extra)
    cell.sync()
    return cell.parts.table.snips(table)


def windows(cell, seconds, k, job=0):
    """2k windows, the log off and on in turns; returns the windows'
    ``(on, snips_per_s)``, the readings of the jobs run with the log on,
    and the next job's index."""
    from coolpuppy_tpu_torch.observability import PhaseTimers

    rates, readings = [], []
    for w in range(2 * k):
        on = w % 4 in (1, 2)
        snips, w0 = 0, time.perf_counter()
        while True:
            timers = PhaseTimers(spans=True) if on else None
            j0 = time.perf_counter()
            snips += run_job(cell, job, timers)
            if on:
                readings.append(job_readings(timers,
                                             time.perf_counter() - j0))
            job += 1
            if time.perf_counter() - w0 >= seconds:
                break
        rates.append((on, snips / (time.perf_counter() - w0)))
    return rates, readings, job


def profiled(cell, jobs):
    """``jobs`` with the log on under ``torch.profiler`` (CUDA activity;
    the host's where there is no card):
    ``(chrome trace dict, [(timers, wall)], window seconds)``."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from coolpuppy_tpu_torch.observability import PhaseTimers

    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    done = []
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [
        ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        cell.sync()
        t0 = time.perf_counter()
        for j in jobs:
            timers = PhaseTimers(spans=True)
            j0 = time.perf_counter()
            run_job(cell, j, timers)
            done.append((timers, time.perf_counter() - j0))
        cell.sync()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="spans_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return trace, done, window


def gaps(trace, spans, window):
    """The breakdown's ten longest idle gaps, in its order and with its
    seconds, each label led by the host spans open at the gap's
    midpoint."""
    from coolpuppy_tpu_torch.observability import SpanIndex
    from pupbench.trace import TOP, Trace, union

    t = Trace(trace["traceEvents"], window)
    busy = union((s, e) for _, s, e in t.device)
    found = sorted(((a, b) for (_, a), (b, _) in zip(busy, busy[1:])),
                   key=lambda g: g[0] - g[1])[:TOP]
    base = trace.get("baseTimeNanoseconds", 0)
    index = SpanIndex(spans)
    out = []
    for (a, b), (label, sec) in zip(found, t.breakdown()["idle_gaps"]):
        mid = base + round((a + b) / 2 * 1e3)
        out.append([f"{index.label(mid)} | {label}", sec])
    return out


def measure(cell, seconds, k, prof_jobs=2):
    """Every reading of one cell (a ``pupbench.harness.Cell``)."""
    from coolpuppy_tpu_torch.observability import (
        PhaseTimers, SpanIndex, launched_seconds, span_seconds)

    timers, j0 = PhaseTimers(spans=True), time.perf_counter()
    run_job(cell, 0, timers)  # warm-up
    warmup = job_readings(timers, time.perf_counter() - j0)
    rates, readings, job = windows(cell, seconds, k, job=1)
    trace, done, window = profiled(cell, range(job, job + prof_jobs))
    spans = [s for timers, _ in done for s in timers.spans]
    _, method = SpanIndex(spans).launcher(trace)
    prof = []
    for timers, wall in done:
        r = job_readings(timers, wall)
        r["device_busy"] = launched_seconds(trace, timers.spans, "device")
        r["device_self"] = span_seconds(timers.spans, "device")
        prof.append(r)
    off = [r for on, r in rates if not on]
    on = [r for on, r in rates if on]
    return {
        "rates_off": off, "rates_on": on,
        "median_off": statistics.median(off),
        "median_on": statistics.median(on),
        "on_over_off": statistics.median(on) / statistics.median(off),
        "warmup_job": warmup, "per_job": per_job(readings),
        "window_jobs": readings, "profiled_jobs": prof,
        "attribution": method, "idle_gaps": gaps(trace, spans, window),
        "runtime_events": sum(e.get("cat") == "cuda_runtime"
                              for e in trace["traceEvents"]),
    }


def per_job(readings):
    """Means over the jobs' readings: the ``coverage`` phase's seconds and
    each counter of ``COUNTS`` (0 where a job did not count it)."""
    n = max(len(readings), 1)
    out = {"coverage_s": sum(r["seconds"].get("coverage", 0.0)
                             for r in readings) / n}
    for c in COUNTS:
        out[c] = sum(r["counts"].get(c, 0) for r in readings) / n
    return out


def phase_cost(n=200_000):
    """Host seconds of one phase with the log off and on, over ``n``."""
    from coolpuppy_tpu_torch.observability import PhaseTimers

    out = {}
    for spans in (False, True):
        timers = PhaseTimers(spans=spans)
        t0 = time.perf_counter()
        for _ in range(n):
            with timers.phase("x"):
                pass
        out["on" if spans else "off"] = (time.perf_counter() - t0) / n
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", default=None)
    p.add_argument("--seed", type=int, default=2**31 + 16)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--windows", type=int, default=6)
    p.add_argument("--out", default="build/spans")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_spans: needs an NVIDIA card", file=sys.stderr)
        return 3
    from pupbench import harness, spec

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    print("phase cost (s): " + json.dumps(phase_cost()), flush=True)
    names = (args.cells.split(",") if args.cells else
             [w["name"] for w in spec.benchmark()["workloads"]])
    os.makedirs(args.out, exist_ok=True)
    for name in names:
        t0 = time.perf_counter()
        cell = harness.Cell(name, args.seed, "cuda:0")
        got = measure(cell, args.seconds, args.windows)
        got.update(cell=name, seed=args.seed, card=smi,
                   seconds=time.perf_counter() - t0)
        with open(os.path.join(args.out, f"spans_{name}.json"), "w") as f:
            json.dump(got, f)
        print(json.dumps(got), flush=True)
        warm = got["warmup_job"]
        cov = warm["prepare/coverage"]
        print(f"{name}: a job {json.dumps(got['per_job'])}; warm-up "
              f"prepare/coverage {'none' if cov is None else f'{cov:.3f} s'}"
              f" of {warm['wall_s']:.3f} s", flush=True)
        cell.free_program()
        del cell
    bad = harness.forbidden_modules()
    if bad:
        print(f"torch_spans: imported {bad}", file=sys.stderr)
        return 5
    return 0


if __name__ == "__main__":
    sys.exit(main())
