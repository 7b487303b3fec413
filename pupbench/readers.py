"""Arithmetic shared by the per-layer readers (``metrics/<name>/reader.py``).
A reader that finds nothing to read returns None and the metric is left
out of the line."""

from __future__ import annotations

from . import spec


def phase_per_job(ctx, phase):
    """A ``PhaseTimers`` phase's seconds summed over the window's jobs, over
    the number of jobs (s/job); 0 where the phase never opened, None
    without jobs."""
    jobs = [p for p in ctx.phases if p]
    if not jobs:
        return None
    return sum(p.get(phase, 0.0) for p in jobs) / len(jobs)


def idle_share(ctx):
    """100 * (1 - the union of the device's kernel and copy intervals over
    the profiled window); None where the trace holds no device activity."""
    t = ctx.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def roofline_share(ctx, metric):
    """100 * the profiled jobs' bound (``roofline.Work``) over the device
    time of the kernels named under ``metrics/<metric>/kernels/``; None
    where those kernels did not run."""
    if ctx.trace is None or not ctx.work:
        return None
    kernel_s = ctx.trace.kernel_s(spec.kernel_names(metric))
    if kernel_s <= 0:
        return None
    return 100.0 * sum(w.bound_s()[0] for w in ctx.work) / kernel_s
