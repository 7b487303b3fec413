"""Per-phase timers, their span log and the device trace (counterpart of
``coolpuppy_tpu/observability.py``).

``PhaseTimers`` sums wall seconds per named phase and counts events; the
engine times ``ingest`` (region fetch and per-bin vectors), ``coords``
(coordinate frames to flat index arrays), ``tiles`` (host tile scatter),
``stage`` (a stream's stack upload, expand or COO scatter, normalize),
``device`` (stack upload, expand, normalize, quad sort, kernel, fetch, side
sums, stripe gather; the stream's chunk sorts and launches), ``wait`` (the
main thread blocked on a prefetched region or a stream's session),
``stripes`` (stripe planes and coordinate strings split per group),
``region`` (the rest of one region on the main thread: its flat arrays
joined, its accumulators packed, its checkpoint), ``coverage`` (under
``coverage_norm`` only: a region's coverage vectors fetched, inside
``ingest``, and its coverage side sums, inside ``device``) and
``finalize`` (region merge and the output table). The hook routes add
``hook`` (the user's batch hook), ``fold`` (the batch route's per-group
numpy fold) and ``snips_host`` (the host stream's per-snip dicts, hooks and
fold); their ``device`` is upload, normalize, window cut and fetch. Given
to ``pileup(timers=...)``, the timers also hold ``job`` (the whole call,
the root) and ``prepare`` (everything before the region loop: the
``CoordCreator`` and the ``PileUpper``, with its view and expected
checks).

A phase opened inside another on the same thread pauses it, so each second
of one thread lands in one phase. Phases of different threads overlap:
``ingest`` runs on the region prefetch threads and a stream's ``tiles``
and ``stage`` on the staging worker, beside the main thread's ``coords``,
``device`` and ``wait``; the sum of the phases can then exceed the wall.
Counts: ``snips``, ``stream_regions`` (regions accumulated by a stream),
``stream_aborts`` (streams given up for the collected path),
``stream_chunks`` (a stream's launches of the quad accumulation),
``coverage_regions`` (regions that fetched coverage vectors),
``coverage_hist_regions`` and ``coverage_scatter_regions`` (the path of a
region's coverage side sums: the host histogram or the device
scatter-add), ``tile_wire_exact_f16_regions`` and ``tile_wire_f32_regions``
(regions whose raw integer tiles went over the exact float16 wire, and
those that fell back to float32), ``tile_cast_native_regions`` (regions
whose tiles went over a float16 wire, exact or lossy, cast by the native
``cast_f16``).

``PhaseTimers(spans=True)`` also keeps every phase as a ``Span``: an
interval on the wall clock of ``time.time_ns()`` (the clock of the
profiler's chrome trace: ``baseTimeNanoseconds + 1000 * ts``) with its
thread, its thread's CPU time, its parent and the job id of its
``pileup()`` call. ``detail(name)`` records a span inside a phase that
leaves ``seconds`` alone: ``coords/sweep`` (the cis pair enumeration),
``coords/frames`` (controls, groups, flips and the modify function of a
frame), ``ingest/fetch`` (the region's pixel slab) and
``prepare/coverage`` (the one-off whole-map coverage pass that stores the
coverage columns in the cooler's bins). ``SpanIndex``
finds the span open on a thread at a time, which attributes a trace's
kernels and copies to the span that launched them and names an idle gap
of the device by what the host was doing.

``device_trace(trace_dir, timers)`` records the block with
``torch.profiler`` and writes a chrome trace into ``trace_dir``, with the
timers' spans as events of category ``program_span``."""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import itertools
import json
import logging
import os
import threading
import time
from collections import defaultdict

logger = logging.getLogger("coolpuppy_tpu_torch")

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_NULL = contextlib.nullcontext()
_JOB_IDS = itertools.count(1)  # one id a pileup() call, across timers


@dataclasses.dataclass(slots=True)
class Span:
    """One phase or detail interval. Times are ``time.time_ns()``, CPU
    times ``time.thread_time_ns()`` of ``tid`` (``threading.
    get_native_id()``, the profiler's ``tid`` of host events); ``ident``
    is the thread's ``threading.get_ident()``, whose low 32 bits a trace
    without host activity gives its ``cuda_runtime`` events as ``tid``.
    ``end_ns`` is None while open. ``self_s`` is a phase's share of
    ``PhaseTimers.seconds`` (its wall less the phases nested in it), a
    detail's wall less every span nested in it."""

    name: str
    id: int
    job: int | None
    parent: int | None
    tid: int
    start_ns: int
    cpu_start_ns: int
    region: int | None = None
    detail: bool = False
    ident: int = 0
    end_ns: int | None = None
    cpu_end_ns: int | None = None
    self_s: float = 0.0
    inner_ns: int = 0

    @property
    def wall_s(self):
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def offcpu_s(self):
        """Wall less the thread's CPU time: waits for the GIL, a lock,
        I/O or page faults."""
        return self.wall_s - (self.cpu_end_ns - self.cpu_start_ns) * 1e-9


class PhaseTimers:
    def __init__(self, spans=False):
        self.seconds = defaultdict(float)
        self.counts = defaultdict(int)
        self.spans = [] if spans else None
        self.job_id = None
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        # this thread's [name, since, span] phase stack and open spans
        self._open = threading.local()
        self._ids = itertools.count(1)
        self._root = None  # the open ``job`` span

    def _add(self, name, dt):
        with self._lock:
            self.seconds[name] += dt

    @contextlib.contextmanager
    def phase(self, name, region=None):
        stack = self._open.__dict__.setdefault("stack", [])
        span = (self._begin(name, region, False) if self.spans is not None
                else None)
        now = time.perf_counter()
        if stack:  # pause the enclosing phase of this thread
            outer = stack[-1]
            self._add(outer[0], now - outer[1])
            if outer[2] is not None:
                outer[2].self_s += now - outer[1]
        stack.append([name, now, span])
        try:
            yield
        finally:
            end = time.perf_counter()
            since = stack.pop()[1]
            self._add(name, end - since)
            if stack:
                stack[-1][1] = end
            if span is not None:
                span.self_s += end - since
                self._end(span)

    def detail(self, name, region=None):
        """A span inside the current phase that pauses nothing and adds to
        no ``seconds`` entry; a shared null context while the log is
        off."""
        if self.spans is None:
            return _NULL
        return self._detail(name, region)

    @contextlib.contextmanager
    def _detail(self, name, region):
        span = self._begin(name, region, True)
        try:
            yield
        finally:
            self._end(span)
            span.self_s = (span.end_ns - span.start_ns - span.inner_ns) * 1e-9

    @contextlib.contextmanager
    def job(self):
        """The root phase ``job`` of one ``pileup()`` call, under a new job
        id. Spans opened on a thread where no span is open (the prefetch
        threads, the staging worker) take it as their parent."""
        self.job_id = next(_JOB_IDS)
        with self.phase("job"):
            if self.spans is not None:
                self._root = self._open.spans[-1]
            try:
                yield
            finally:
                self._root = None

    def _begin(self, name, region, detail):
        opened = self._open.__dict__.setdefault("spans", [])
        parent = opened[-1] if opened else self._root
        span = Span(name, next(self._ids), self.job_id,
                    parent.id if parent is not None else None,
                    threading.get_native_id(), time.time_ns(),
                    time.thread_time_ns(), region, detail,
                    threading.get_ident())
        opened.append(span)
        self.spans.append(span)
        return span

    def _end(self, span):
        span.cpu_end_ns = time.thread_time_ns()
        span.end_ns = time.time_ns()
        opened = self._open.spans
        opened.remove(span)
        if opened:
            opened[-1].inner_ns += span.end_ns - span.start_ns

    def count(self, name, n=1):
        with self._lock:
            self.counts[name] += n

    def summary(self):
        total = time.perf_counter() - self._t0
        parts = ", ".join(
            f"{k}={v:.2f}s" for k, v in sorted(self.seconds.items())
        )
        snips = self.counts.get("snips", 0)
        rate = snips / total if total > 0 else 0.0
        return (
            f"wall={total:.2f}s [{parts}] snips={snips} "
            f"({rate:,.0f} snips/s)"
        )

    def log_summary(self, level=logging.INFO):
        logger.log(level, self.summary())


# -- reading spans --------------------------------------------------------


def span_seconds(spans, name, what="self_s"):
    """The sum of ``what`` (``self_s``, ``wall_s`` or ``offcpu_s``) over
    the closed spans called ``name``; None where none closed."""
    got = [getattr(s, what) for s in spans if s.name == name and s.end_ns]
    return sum(got) if got else None


def union_seconds(intervals):
    """The length of the union of ``(start_ns, end_ns)`` intervals, in
    seconds."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total * 1e-9


class SpanIndex:
    """The innermost span open on each thread at any time, from closed
    spans (a thread's spans nest). ``main_tid``: the thread of the first
    ``job`` span, else of the first span."""

    def __init__(self, spans):
        spans = [s for s in spans if s.end_ns is not None]
        roots = [s for s in spans if s.name == "job"] or spans
        self.main_tid = roots[0].tid if roots else None
        by_tid = defaultdict(list)
        for s in spans:
            by_tid[s.tid].append(s)
        self._alias = {s.ident & 0xFFFFFFFF: s.tid for s in spans}
        self._lines = {}
        for tid, own in by_tid.items():
            # at one instant closes come before opens, an outer span
            # opening first and closing last
            edges = sorted(
                [(s.start_ns, 1, s.start_ns - s.end_ns, s) for s in own]
                + [(s.end_ns, 0, s.end_ns - s.start_ns, s) for s in own],
                key=lambda e: e[:3])
            times, active, stack = [], [], []
            for t, opens, _, s in edges:
                if opens:
                    stack.append(s)
                else:
                    stack.remove(s)
                times.append(t)
                active.append(stack[-1] if stack else None)
            self._lines[tid] = (times, active)

    def at(self, tid, t_ns):
        """The innermost span of thread ``tid`` (its native id, or its
        pthread id as a trace may give it) open at ``t_ns``."""
        line = self._lines.get(tid) or self._lines.get(self._alias.get(tid))
        if line is None:
            return None
        i = bisect.bisect_right(line[0], t_ns) - 1
        return line[1][i] if i >= 0 else None

    def label(self, t_ns):
        """What the host did at ``t_ns``: the main thread's innermost span
        with its region (``wait r3``), then the innermost spans of the
        other threads, each name once and marked ``*``, after an arrow:
        ``wait r3 ← ingest/fetch*``. ``-`` for a main thread in no span;
        empty where no thread is in a span."""
        now = {tid: self.at(tid, t_ns) for tid in self._lines}
        now = {tid: s for tid, s in now.items() if s is not None}
        if not now:
            return ""
        main = now.pop(self.main_tid, None)
        head = "-" if main is None else main.name + (
            "" if main.region is None else f" r{main.region}")
        others = sorted({s.name for s in now.values()})
        return head + ("" if not others
                       else " ← " + " ".join(n + "*" for n in others))

    def launcher(self, trace):
        """Each kernel and copy of a chrome trace (the dict
        ``export_chrome_trace`` writes) with the span that launched it:
        ``([(name, start_ns, end_ns, span or None)], method)``, on
        ``time.time_ns()``'s clock. Joined
        through ``correlation`` to its launch (a ``cuda_runtime`` or
        ``cuda_driver`` event), whose thread and time place it in a span
        (``method == "correlation"``); where the trace holds no launches,
        the span of the main thread open at the device event's start
        (``"start"``)."""
        base = trace.get("baseTimeNanoseconds", 0)
        ns = lambda us: base + round(float(us) * 1e3)  # noqa: E731
        launches, device = {}, []
        for e in trace.get("traceEvents", ()):
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                launches[corr] = (e.get("tid"), ns(e["ts"]))
            elif e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
                device.append((e.get("name", "?"), ns(e["ts"]),
                               ns(float(e["ts"]) + float(e["dur"])), corr))
        out = []
        for name, a, b, corr in device:
            if launches:
                tid, t = launches.get(corr, (None, None))
                span = None if tid is None else self.at(tid, t)
            else:
                span = self.at(self.main_tid, a)
            out.append((name, a, b, span))
        return out, ("correlation" if launches else "start")


def launched_seconds(trace, spans, name):
    """The union of the device intervals launched inside spans called
    ``name`` (``SpanIndex.launcher``), in seconds; None where no such span
    closed or the trace holds no device events."""
    if not any(s.name == name and s.end_ns for s in spans):
        return None
    events, _ = SpanIndex(spans).launcher(trace)
    if not events:
        return None
    return union_seconds((a, b) for _, a, b, s in events
                         if s is not None and s.name == name)


def span_events(spans, base_ns, pid, until_ns=None):
    """Chrome trace ``X`` events of category ``program_span``, on the
    trace's clock (``ts`` in microseconds after ``base_ns``); a span still
    open ends at ``until_ns``."""
    out = []
    for s in spans:
        end = s.end_ns if s.end_ns is not None else until_ns
        if end is None:
            continue
        out.append({
            "ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
            "tid": s.tid, "ts": (s.start_ns - base_ns) / 1e3,
            "dur": (end - s.start_ns) / 1e3,
            "args": {"job": s.job, "id": s.id, "parent": s.parent,
                     "region": s.region, "self_s": s.self_s},
        })
    return out


@contextlib.contextmanager
def device_trace(trace_dir=None, timers=None):
    """Profile the block with ``torch.profiler`` (host ops, plus CUDA
    kernels and copies when a card is present) and write
    ``trace_dir/trace_<pid>_<time>.json`` (chrome trace format) when
    ``trace_dir`` is given, with the spans of ``timers`` that overlap the
    block; a null context otherwise."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=acts) as prof:
        yield
    t1 = time.time_ns()
    path = os.path.join(
        str(trace_dir),
        f"trace_{os.getpid()}_{time.strftime('%Y%m%d-%H%M%S')}.json",
    )
    prof.export_chrome_trace(path)
    spans = timers.spans if timers is not None else None
    if spans:
        with open(path) as f:
            trace = json.load(f)
        if "baseTimeNanoseconds" in trace:
            keep = [s for s in spans
                    if s.start_ns <= t1 and (s.end_ns or t1) >= t0]
            trace["traceEvents"] += span_events(
                keep, trace["baseTimeNanoseconds"], os.getpid(), t1)
            with open(path, "w") as f:
                json.dump(trace, f)
        else:
            logger.warning("the trace has no baseTimeNanoseconds: its "
                           "spans are left out")
    logger.info("device trace written to %s", path)
