"""Per-phase timers and the device trace (counterpart of
``coolpuppy_tpu/observability.py``).

``PhaseTimers`` sums wall seconds per named phase and counts events; the
engine times ``ingest`` (region fetch and per-bin vectors), ``coords``
(coordinate frames to flat index arrays), ``tiles`` (host tile scatter),
``stage`` (a stream's stack upload, expand or COO scatter, normalize),
``device`` (stack upload, expand, normalize, quad sort, kernel, fetch, side
sums, stripe gather; the stream's chunk sorts and launches), ``wait`` (the
main thread blocked on a prefetched region or a stream's session),
``stripes`` (stripe planes and coordinate strings split per group) and
``finalize`` (region merge and the output table). The hook routes add
``hook`` (the user's batch hook), ``fold`` (the batch route's per-group
numpy fold) and ``snips_host`` (the host stream's per-snip dicts, hooks and
fold); their ``device`` is upload, normalize, window cut and fetch.

A phase opened inside another on the same thread pauses it, so each second
of one thread lands in one phase. Phases of different threads overlap:
``ingest`` runs on the region prefetch threads and a stream's ``tiles``
and ``stage`` on the staging worker, beside the main thread's ``coords``,
``device`` and ``wait``; the sum of the phases can then exceed the wall.
Counts: ``snips``, ``stream_regions`` (regions accumulated by a stream),
``stream_aborts`` (streams given up for the collected path),
``stream_chunks`` (a stream's launches of the quad accumulation).
``device_trace(trace_dir)`` records the block with ``torch.profiler`` and
writes a chrome trace into ``trace_dir``."""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict

logger = logging.getLogger("coolpuppy_tpu_torch")


class PhaseTimers:
    def __init__(self):
        self.seconds = defaultdict(float)
        self.counts = defaultdict(int)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._open = threading.local()  # this thread's [name, since] stack

    def _add(self, name, dt):
        with self._lock:
            self.seconds[name] += dt

    @contextlib.contextmanager
    def phase(self, name):
        stack = self._open.__dict__.setdefault("stack", [])
        now = time.perf_counter()
        if stack:  # pause the enclosing phase of this thread
            self._add(stack[-1][0], now - stack[-1][1])
        stack.append([name, now])
        try:
            yield
        finally:
            end = time.perf_counter()
            self._add(name, end - stack.pop()[1])
            if stack:
                stack[-1][1] = end

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


@contextlib.contextmanager
def device_trace(trace_dir=None):
    """Profile the block with ``torch.profiler`` (host ops, plus CUDA
    kernels and copies when a card is present) and write
    ``trace_dir/trace_<pid>_<time>.json`` (chrome trace format) when
    ``trace_dir`` is given; a null context otherwise."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(
        str(trace_dir),
        f"trace_{os.getpid()}_{time.strftime('%Y%m%d-%H%M%S')}.json",
    )
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)
