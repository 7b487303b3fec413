"""A ``torch.profiler`` window over whole jobs, read back from its chrome
trace: the device's busy intervals, the kernels' time by name, and the
breakdown (the device operations that took most time, the longest idle
gaps named by the device operations on either side). Only the device is
traced: the host's time is nearly all numpy and native code, which the
profiler does not see, and recording every host torch call made the
trace of a rescale job take half a minute to write and read.

The trace is written under ``TMPDIR`` and deleted once read."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
import warnings
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """Events of one profiled window: ``device``, a list of (name,
    start_us, end_us) of kernels and copies; ``window_s`` the host clock's
    span."""

    def __init__(self, events, window_s):
        self.window_s = window_s
        self.device = [
            (e.get("name", "?"), float(e["ts"]),
             float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in DEVICE_CATS]

    def busy_s(self):
        return sum(b - a for a, b in union((s, e) for _, s, e in
                                           self.device)) * 1e-6

    def kernel_s(self, names):
        """Device seconds of the kernels whose name contains one of
        ``names``."""
        return sum(e - s for n, s, e in self.device
                   if any(k in n for k in names)) * 1e-6

    def breakdown(self):
        by_name = defaultdict(float)
        for n, s, e in self.device:
            by_name[n] += (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        busy = union((s, e) for _, s, e in self.device)
        gaps = sorted(((a, b) for (_, a), (b, _) in zip(busy, busy[1:])),
                      key=lambda g: g[0] - g[1])[:TOP]
        ends = sorted((e, n) for n, _, e in self.device)
        starts = sorted((s, n) for n, s, _ in self.device)
        named = []
        for a, b in gaps:
            prev = max((x for x in ends if x[0] <= a), default=(0, "start"))
            nxt = min((x for x in starts if x[0] >= b), default=(0, "end"))
            named.append([f"after {prev[1][:50]} | before {nxt[1][:50]}",
                          (b - a) * 1e-6])
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": named}


@contextlib.contextmanager
def profiled(sync):
    """Profile the block (kernels and copies; host ops where there is no
    card); yields a holder whose ``trace`` is set on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [
        ProfilerActivity.CPU]
    holder = type("Holder", (), {"trace": None})()
    # one cycle, whose events are all read
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        yield holder
        sync()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="pupbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    holder.trace = Trace(events, window)
