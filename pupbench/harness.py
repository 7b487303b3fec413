"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, and the result line.

The load is a closed loop of one client, as a Hi-C analyst runs it: the
map is made once in set-up; the window runs whole
``coolpuppy_tpu_torch.pileup`` jobs back to back until ``--seconds`` have
passed and finishes the job in progress. Job ``j`` takes feature set ``j``
of a pool drawn in set-up from (``--seed``, ``j``) (``gen/features.py``).
One operation is one job. The window keeps the tables of the jobs that the
comparison checks and no others (``Reservoir``).
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

from . import compare, hostload, reference, spec
from .gen import contact_map, expected as gen_expected, features
from .roofline import job_work

FORBIDDEN = ("jax", "jaxlib", "flax", "coolpuppy_tpu")
CHECK_STREAM = 3


class RssSampler:
    """The highest resident set of this process, sampled from
    ``/proc/self/statm`` every ``every`` seconds while running."""

    def __init__(self, every=0.02):
        self.every, self.peak = every, 0
        self._stop = threading.Event()
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self):
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * self._page
        self.peak = max(self.peak, rss)

    def _run(self):
        while not self._stop.wait(self.every):
            self._sample()

    def __enter__(self):
        self._sample()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()


class Reservoir:
    """A uniform choice of ``k`` of the jobs offered to it, made as they
    come (Algorithm R) from ``SeedSequence([seed, CHECK_STREAM])``: it
    holds the tables of at most ``k`` jobs at any time."""

    def __init__(self, k, seed):
        self.k, self.offered, self.slots = int(k), 0, []
        self.rng = np.random.default_rng(np.random.SeedSequence(
            [int(seed), CHECK_STREAM]))

    def offer(self, job, table):
        if len(self.slots) < self.k:
            self.slots.append((job, table))
        else:
            r = int(self.rng.integers(self.offered + 1))
            if r < self.k:
                self.slots[r] = (job, table)
        self.offered += 1

    def jobs(self):
        return sorted(j for j, _ in self.slots)


class Window:
    """What the measured window did: ``jobs`` run, ``snips`` counted,
    ``failed`` jobs, each job's seconds and CPU seconds, each job's phases
    (traced runs), the feature sets ``drawn`` past the pool with the clock
    stopped, ``seconds`` on the window's clock, and the tables ``kept`` for
    the comparison."""

    def __init__(self, check_jobs, seed):
        self.jobs = self.snips = self.failed = self.drawn = 0
        self.job_s, self.job_cpu, self.phases = [], [], []
        self.seconds = self.drawn_s = 0.0
        self.kept = Reservoir(check_jobs, seed)


def measure(c, seed, seconds, probe=None):
    """Run whole jobs from job 0 until ``seconds`` have passed on the
    window's clock, and finish the job in progress. A job's table counts
    its snips and is dropped unless ``Window.kept`` takes it. A job's
    feature set comes from the pool drawn in set-up; past it, the set is
    drawn with the window's clock stopped, and counted."""
    w = Window(c.cell["check_jobs"], seed)
    w0 = time.perf_counter()
    while True:
        if w.jobs >= len(c.pool.sets):
            d0 = time.perf_counter()
            c.pool.draw(w.jobs + 1)
            w.drawn_s += time.perf_counter() - d0
            w.drawn += 1
        j0 = time.perf_counter()
        h_job = hostload.Snapshot()
        try:
            table = c.run(c.pool.sets[w.jobs],
                          features.job_seed(seed, w.jobs))
            w.snips += c.parts.table.snips(table)
            w.kept.offer(w.jobs, table)
        except Exception:  # a job that raises is a failed operation
            traceback.print_exc()
            w.failed += 1
        table = None
        w.job_s.append(time.perf_counter() - j0)
        w.job_cpu.append(hostload.between(h_job, hostload.Snapshot()))
        if probe is not None:
            w.phases.append(probe.seconds())
        w.jobs += 1
        w.seconds = time.perf_counter() - w0 - w.drawn_s
        if w.seconds >= seconds:
            return w


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Cell:
    """A cell's inputs and its one call into the program."""

    def __init__(self, name, seed, device, config=None, cell=None):
        import torch

        import coolpuppy_tpu_torch as cpt

        self.cpt, self.torch = cpt, torch
        w = spec.workload(name) if config is None else None
        self.config = config or spec.config(w["config"])
        self.cell = cell or spec.cell(name)
        self.seed, self.device = int(seed), device
        self.parts = reference.parts(self.cell["reference"])
        self.steps = {}
        t = time.perf_counter()
        self.cmap = contact_map.draw(self.config["map"], seed, device)
        t = self._step("map", t)
        self.clr = cpt.Cooler.from_arrays(
            self.cmap.chromsizes, self.cmap.binsize,
            (self.cmap.bin1, self.cmap.bin2, self.cmap.count),
            weights=self.cmap.weights)
        t = self._step("reader", t)
        self.expected = self.view = None
        if self.config.get("expected"):
            self.expected = gen_expected.expected_cis(self.cmap)
            self.view = gen_expected.view(self.cmap)
            t = self._step("expected", t)
        self.pool = features.Pool(self.config, self.cell, seed,
                                  int(self.cell["pool_jobs"]))
        self._step("pool", t)
        prec = self.config["precision"]
        self.kw = dict(self.cell["pileup"], tile_f16=prec["tile_f16"],
                       stripe_f16=prec["stripe_f16"])

    def _step(self, name, t):
        now = time.perf_counter()
        self.steps[name] = now - t
        return now

    def sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize(self.device)

    def job_kw(self, job):
        return dict(self.cell["pileup"], seed=features.job_seed(self.seed,
                                                                job))

    def run(self, feats, job_seed):
        extra = {}
        if self.expected is not None:
            extra = dict(expected_df=self.expected, view_df=self.view)
        table = self.cpt.pileup(self.clr, feats, device=self.device,
                                seed=job_seed, **self.kw, **extra)
        self.sync()
        return table

    def free_program(self):
        self.clr = None
        gc.collect()
        if self.device != "cpu":
            self.torch.cuda.empty_cache()


def run(name, seed, seconds, trace, device, t0, config=None, cell=None):
    """One run of workload ``name``; returns the result line's dict."""
    import torch

    bench = spec.benchmark()
    on_card = device != "cpu"
    h_setup = hostload.Snapshot()
    started = time.perf_counter() - t0
    c = Cell(name, seed, device, config, cell)
    t = time.perf_counter()
    c.run(c.pool.warmup(), features.warmup_seed(seed))
    c._step("warm-up", t)
    setup_s = time.perf_counter() - t0

    probe = None
    if trace:
        from .probe import PhaseProbe
        probe = PhaseProbe().__enter__()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    h_window = hostload.Snapshot()
    with RssSampler() as rss:
        w = measure(c, seed, seconds, probe)
    host = {"setup": hostload.between(h_setup, h_window),
            "window": hostload.between(h_window, hostload.Snapshot())}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if probe is not None:
        probe.__exit__(None, None, None)

    ctx = Context(phases=w.phases)
    t_prof = time.perf_counter()
    if trace:
        from .trace import profiled
        prof_jobs = range(w.jobs,
                          w.jobs + int(c.cell.get("profile_jobs", 1)))
        with profiled(c.sync) as holder:
            for j in prof_jobs:
                c.run(c.pool[j], features.job_seed(seed, j))
        ctx.trace = holder.trace
        ctx.jobs = [job_windows(c, j) for j in prof_jobs]
        ctx.device = device

    e2e = {
        "snips_per_s": w.snips / w.seconds,
        "device_peak_mib": peak / 2**20,
        "host_rss_peak_mib": rss.peak / 2**20,
        "setup_s": setup_s,
    }
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    metrics = {}
    if not trace:
        for m in spec.metrics_for(name, "end_to_end", bench):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in spec.metrics_for(name, "per_layer", bench):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}

    # the comparison, once the program's state is freed
    t_ref = time.perf_counter()
    sample = w.kept.jobs()
    kept = {j: compare.program_rows(t, c.parts) for j, t in w.kept.slots}
    w.kept = None
    c.free_program()
    from .reference.pileup import reference_pileup
    readings = []
    for j in sample:
        ref = reference_pileup(c.cmap, c.pool[j], c.job_kw(j), device,
                               c.parts, expected=c.expected)
        readings.append(compare.compare(kept[j], ref))
    if readings:
        correct, checks = compare.judge(compare.worst(readings),
                                        c.cell["limits"])
    else:
        correct, checks = False, [[k, None, c.cell["limits"][k]]
                                  for k in compare.NUMBERS
                                  if k in c.cell["limits"]]
    steps = ", ".join(f"{k} {v:.3f}" for k, v in
                      {"start": started, **c.steps}.items())
    print(f"pupbench: setup {setup_s:.3f} s ({steps}), window "
          f"{w.seconds:.3f} s ({w.jobs} jobs, {w.snips} snips), profiled "
          f"{t_ref - t_prof:.3f} s, "
          f"reference {time.perf_counter() - t_ref:.3f} s; jobs "
          + " ".join(f"{x:.3f}" for x in w.job_s), file=sys.stderr)
    print(f"pupbench: pool {len(c.pool.sets)} sets; {w.drawn} drawn past it "
          f"in the window, its clock stopped {w.drawn_s:.3f} s",
          file=sys.stderr)
    for phase, h in host.items():
        print(f"pupbench: host in {phase}: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in h.items()), file=sys.stderr)
    print("pupbench: jobs' CPU s (process, main thread, kernel) " + " ".join(
        f"{h['process_cpu_s']:.2f}/{h['main_thread_cpu_s']:.2f}/"
        f"{h['process_sys_s']:.2f}" for h in w.job_cpu), file=sys.stderr)
    result = {
        "correct": correct,
        "attempted": w.jobs,
        "failed": w.failed,
        "metrics": metrics,
        "device": device_block(device, peak, ctx, trace),
    }
    if trace and ctx.trace is not None:
        result["breakdown"] = ctx.trace.breakdown()
    result["checked_jobs"] = [int(j) for j in sample]
    result["drawn_past_pool"] = w.drawn
    result["host"] = host
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(bad)
    return result


def job_windows(c, j):
    """The windows of job ``j``, from its inputs (``reference.coords``)."""
    from .reference.coords import JobSnips
    return JobSnips(c.pool[j], c.job_kw(j), c.cmap.chroms, c.cmap.bins_per,
                    c.cmap.binsize, c.parts)


class Context:
    """What the per-layer readers read: ``phases`` (one dict of phase
    seconds a window job), ``trace`` (``trace.Trace`` of the profiled
    jobs) and ``work`` (``roofline.Work`` of each profiled job, counted
    from its windows at first use)."""

    def __init__(self, phases=(), trace=None, work=None):
        self.phases, self.trace = list(phases), trace
        self.jobs, self.device, self._work = [], "cpu", work

    @property
    def work(self):
        if self._work is None:
            self._work = [job_work(j, self.device) for j in self.jobs]
        return self._work


class ForbiddenImport(RuntimeError):
    pass


def device_block(device, peak, ctx, trace):
    import torch

    if device == "cpu":
        block = {"platform": "cpu", "kind": "cpu", "count": 0,
                 "memory_peak_bytes": 0}
    else:
        block = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                 "count": 1, "memory_peak_bytes": int(peak),
                 "power_limit_w": power_limit_w()}
    if trace and ctx.trace is not None:
        block["busy_s"] = ctx.trace.busy_s()
        block["window_s"] = ctx.trace.window_s
    return block
