"""Drive the PyTorch/CUDA port's loop-APA path and its ``pileup()`` engine
once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device, ``nvcc``
and PyTorch built for CUDA. It needs no network and no JAX. Phases, each
printing its lines:

1. probe: torch/CUDA and pandas versions, the card's name and power limit
   (``nvidia-smi``), the ``nvcc`` release, and which of triton, pandas, h5py
   and jax are importable (jax is only looked up, never imported);
2. build: compiles ``coolpuppy_tpu_torch/csrc/*.cu`` for sm_90a and loads it;
3. kernel vs plain: the CUDA quad gather-accumulate against its plain
   PyTorch version at W = 11, 21, 65 and 120 on small synthetic stacks (a
   900-snip quad, group ids above 512, zero ``evec`` entries that poison
   sums with +inf, an empty stream): ``num`` exact, poison planes equal,
   finite ``sum`` within rtol 1e-5 / atol 1e-5;
4. the slice at the headline size (``bench.make_workload``: a 20,000-bin
   chromosome, 12M contacts, 1M loci, W = 21, observed-over-expected, 4
   groups, 25% flips): COO -> ``build_tile_stack_sym`` ->
   ``QuadPileupSession(device="cuda")`` -> ``run_many`` -> ``finalize`` ->
   ``merge_flip_banks``. It checks that the kernel ran on that path, holds
   the path's own accumulators and a second launch of the kernel against
   the plain version on the card (``num`` exact, poison
   equal, ``sum`` rtol 1e-4: float32 atomics add ~250k snips per (group,
   pixel) in an order that changes from run to run) and a 20,000-snip subset
   against the host oracle (numpy normalize + window cuts + nansum: ``num``
   exact, ``sum`` rtol 1e-5), then times the kernel, the plain version and
   the whole path (with its phases), and prints the device's busy share of
   one end-to-end run from ``torch.profiler``;
5. the engine: ``coolpuppy_tpu_torch.pileup`` on an in-memory ``Cooler``.
   (a) Every mode of the port (``ENGINE_MODES``) on a toy two-chromosome
   map with ``device="cuda"`` and with ``device="cpu"`` (the plain
   version): group keys, ``n``, ``control_n``, ``num`` and ``control_num``
   exact, ``data`` within rtol 1e-5 / atol 1e-7 with NaN positions equal.
   (b) ``bench.py``'s ``--engine`` cell (``engine_workload``: a 200 Mb
   chromosome at 10 kb, 12M zipf contacts, 3% NaN-weight bins, 20,000
   stranded sites; ``pileup(flank=100_000, maxdist=2_000_000, nshifts=1,
   seed=0, by_strand=True)``, W = 21): a 1,000-site warm-up, then a checked
   run that must launch the kernel and record ``cuda_kernel``, the same run
   with ``quad_accumulate`` swapped for the plain version (0 launches; ``n``,
   ``control_n`` and ``num`` exact, ``data`` rtol 1e-4), three timed runs
   (engine snips/s = ROI ``n`` + ``control_n`` of the ``all`` row over the
   wall, median, with the engine's phase breakdown) and the busy share of
   one run.

Any failure raises and exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the per-kernel JSON
record, and the one before that the card's name and power limit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time

import numpy as np

KERNEL = {
    "name": "quad_accumulate",
    "route": "cuda",
    "source": "coolpuppy_tpu_torch/csrc/quad_accumulate.cu",
    "replaces": "coolpuppy_tpu/ops/pallas_gather.py:80",
}
B = 128
SMALL_TOL = dict(rtol=1e-5, atol=1e-5)
HEADLINE_RTOL = 1e-4
REPEATS = 5

# phase 5: the modes of the port's pileup() on the toy map (TOY_KW plus
# these); "expected_df": True stands for the toy expected table
TOY_KW = dict(features_format="bed", mindist=0, flank=2_000_000)
ENGINE_MODES = {
    "balanced": {},
    "ooe": {"expected_df": True},
    "expected_emission": {"expected_df": True, "ooe": False},
    "controls": {"nshifts": 2, "seed": 7},
    "by_strand": {"by_strand": True, "nshifts": 1, "seed": 0},
    "by_distance": {"by_distance": True, "nshifts": 1, "seed": 0},
    "by_strand_by_distance_edges": {
        "by_strand": True, "nshifts": 1, "seed": 0,
        "by_distance": [0] + [50_000 * 2**k for k in range(30)],
    },
    "groupby": {"groupby": ["name1", "strand2"]},
    "ignore_group_order": {"by_strand": True, "ignore_group_order": True},
    "flip_negative_strand": {"by_strand": True, "flip_negative_strand": True},
    "local": {"local": True},
    "coverage_norm": {"clr_weight_name": None, "coverage_norm": True},
}
ENGINE_MODES_TOL = dict(rtol=1e-5, atol=1e-7)
# bench.py --engine (bench_engine): pileup() arguments and warm-up size
ENGINE_KW = dict(features_format="bed", flank=100_000, maxdist=2_000_000,
                 nshifts=1, seed=0, by_strand=True)
ENGINE_WARMUP_SITES = 1_000
ENGINE_RTOL = 1e-4
ENGINE_REPEATS = 3


def smi_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def nvcc_line():
    from coolpuppy_tpu_torch.kernels.build import find_nvcc

    res = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    lines = [ln for ln in res.stdout.splitlines() if "release" in ln]
    return lines[0].strip() if lines else res.stdout.strip()


def importable(name):
    """Whether ``name`` imports here. jax is only looked up: this script
    never imports it."""
    if name == "jax":
        return importlib.util.find_spec(name) is not None
    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def compare(got, want, rtol, atol, what):
    """Hold ``(sum, num)`` from the kernel against the plain version:
    ``num`` exact, the +inf poison planes equal, finite sums within
    tolerance. Returns the largest absolute difference of the finite sums."""
    gs, gn = (t.cpu().numpy() for t in got)
    ws, wn = (t.cpu().numpy() for t in want)
    if not np.array_equal(gn, wn):
        bad = int((gn != wn).sum())
        raise AssertionError(f"{what}: num differs at {bad} entries")
    pois = np.isinf(ws)
    if not np.array_equal(np.isinf(gs), pois):
        raise AssertionError(f"{what}: poison planes differ")
    if np.isnan(gs).any() or np.isnan(ws).any():
        raise AssertionError(f"{what}: NaN in a sum")
    np.testing.assert_allclose(gs[~pois], ws[~pois], rtol=rtol, atol=atol,
                               err_msg=what)
    return float(np.abs(gs[~pois] - ws[~pois]).max(initial=0.0))


def small_problem(W, seed):
    """A small cis region and snip stream for one window size: 700 bins,
    one quad holding 900 snips, 600 groups (ids above 512), and zero
    ``evec`` entries that poison some sums with +inf."""
    from scipy import sparse as sp

    rng = np.random.default_rng(seed)
    n, C, S = 700, 600, 2500
    dense = rng.gamma(1.0, 1.0, (n, n)) * (rng.random((n, n)) < 0.2)
    dense = np.triu(dense) + np.triu(dense, 1).T
    coo = sp.coo_matrix(dense)
    valid = (rng.random(n) > 0.05).astype(np.float32)
    evec = (5.0 / (1.0 + np.arange(n))).astype(np.float32)
    evec[rng.integers(2, n, 4)] = 0.0
    r1 = np.concatenate([
        3 + rng.integers(0, 5, 900),
        rng.integers(0, n - W, S - 900),
    ]).astype(np.int32)
    r2 = np.concatenate([
        9 + rng.integers(0, 5, 900),
        rng.integers(0, n - W, S - 900),
    ]).astype(np.int32)
    cid = rng.integers(0, C, S).astype(np.int32)
    cid[:10] = C - 1
    cfg_kw = dict(W=W, capacity=C, cis=True, ignore_diags=2, ooe=True)
    return coo, r1, r2, cid, valid, evec, cfg_kw


def kernel_cases(device):
    """Phase 3's inputs on ``device``: ``(name, args)`` where ``args`` are
    the ``quad_accumulate`` arguments ``(stiles, k, qstart, qcount, snips,
    W, C)``."""
    from coolpuppy_tpu_torch.ops.quad_gather import QuadPileupSession
    from coolpuppy_tpu_torch.ops.tiles import build_tile_stack_sym

    for W, seed in ((11, 7), (21, 8), (65, 9), (120, 10)):
        coo, r1, r2, cid, valid, evec, cfg_kw = small_problem(W, seed)
        ts = build_tile_stack_sym(coo, B, r1=r1, r2=r2, window1=W, window2=W)
        sess = QuadPileupSession(ts, valid, valid, evec, cfg_kw, device)
        yield f"W={W}", (sess.stiles, *sess.stage(r1, r2, cid), W, sess.C)
        if W == 21:
            empty = np.zeros(0, np.int32)
            yield "W=21 empty", (sess.stiles, *sess.stage(empty, empty, empty),
                                 W, sess.C)


def host_oracle(ts, r1, r2, cid, valid, evec, W, C):
    """Host numpy oracle: normalize the full stack, cut every window, and
    nansum / count finite values per group in float64."""
    from coolpuppy_tpu_torch.ops.tiles import (
        assemble_windows_batch,
        normalize_tile_stack,
    )

    full = ts.to_tile_stack() if hasattr(ts, "upper") else ts
    stiles = normalize_tile_stack(full, valid, valid, evec=evec, ooe=True,
                                  cis=True, ignore_diags=2)
    win = assemble_windows_batch(stiles, full.tile_map, B, r1, r2, W)
    fin = win == win
    s = np.zeros((C, W, W))
    m = np.zeros((C, W, W))
    np.add.at(s, cid, np.where(fin, win, 0.0).astype(np.float64))
    np.add.at(m, cid, (fin & ~np.isinf(win)).astype(np.float64))
    return stiles, s, m


def busy_share(fn, sync):
    """Device time of the CUDA kernels and copies that ``fn`` issued, over
    its wall time, from one ``torch.profiler`` run. Only device-side events
    count (a host op's device time would count its kernels twice), less the
    profiler's own buffer requests."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not e.key.startswith("Activity Buffer")]
    dev_us = sum(e.self_device_time_total for e in dev)
    if dev_us <= 0:
        return "not measured (the profiler saw no device time)"
    dev.sort(key=lambda e: -e.self_device_time_total)
    names = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                      for e in dev[:4])
    return (f"{dev_us / 1e6 / wall:.4f} (device {dev_us / 1e3:.3f} ms of "
            f"{wall * 1e3:.1f} ms wall, profiled; top: {names})")


def timed(fn, sync):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return time.perf_counter() - t0, out


def check_kernels(dev, sync):
    """Phase 3: the kernel against the plain version at small shapes."""
    import torch

    import coolpuppy_tpu_torch.ops.quad_gather as qg

    for name, args in kernel_cases(dev):
        got = qg.quad_accumulate(*args)
        sync()
        want = qg.quad_accumulate_plain(*args)
        err = compare(got, want, what=f"kernel vs plain {name}", **SMALL_TOL)
        print(f"kernel vs plain {name}: items {int(args[1].shape[0])} "
              f"max_abs_err {err:.3g} num {int(want[1].sum())} "
              f"poison {int(torch.isinf(want[0]).sum())} ok")


def check_slice(dev, sync, workload, card):
    """Phase 4: the slice on ``workload`` (``bench.make_workload``'s
    tuple): drive it once with the launch count reset, check it against the
    plain version and the host oracle, and time it. Returns the kernel's
    JSON record."""
    import torch

    import coolpuppy_tpu_torch.ops.quad_gather as qg
    from coolpuppy_tpu_torch.ops.gather import merge_flip_banks
    from coolpuppy_tpu_torch.ops.tiles import build_tile_stack_sym

    _, coo, r1, r2, gid, flip, valid, evec = workload
    W, half = 21, 4
    C = 2 * half + 8
    cid = (gid + half * flip).astype(np.int32)
    cfg_kw = dict(W=W, capacity=C, cis=True, ignore_diags=2, ooe=True)
    n_snips = len(r1)
    phases = {}

    def run_slice():
        t0 = time.perf_counter()
        ts = build_tile_stack_sym(coo, B, r1=r1, r2=r2, window1=W, window2=W)
        t1 = time.perf_counter()
        sess = qg.QuadPileupSession(ts, valid, valid, evec, cfg_kw, dev)
        sync()
        t2 = time.perf_counter()
        out = sess.run_many(r1, r2, cid, fetch=False)
        sync()
        t3 = time.perf_counter()
        total = sess.finalize([out])
        merged = merge_flip_banks(total, half)
        t4 = time.perf_counter()
        phases.update(scatter=t1 - t0, stack_to_device=t2 - t1,
                      sort_and_accumulate=t3 - t2, finalize_merge=t4 - t3)
        return ts, sess, total, merged

    qg.LAUNCHES = 0
    ts, sess, total, merged = run_slice()
    launches = qg.LAUNCHES
    if launches < 1:
        raise AssertionError("the headline path launched no kernel")
    for k in ("sum", "num", "poison"):
        if merged[k].shape != (half, W, W):
            raise AssertionError(f"merged {k} has shape {merged[k].shape}")
    if not np.isfinite(merged["sum"]).all() or merged["poison"].any():
        raise AssertionError("headline sums are not finite")
    if int(merged["num"].sum()) <= 0:
        raise AssertionError("headline counts are empty")
    args = (sess.stiles, *sess.stage(r1, r2, cid), W, C)
    print(f"slice: launches {launches} items {int(args[1].shape[0])} "
          f"tiles {ts.n_tiles} num {int(merged['num'].sum())} ok")
    sync()
    got = qg.quad_accumulate(*args)
    sync()
    want = qg.quad_accumulate_plain(*args)
    # the main path's own accumulators, and a second launch on the same
    # staged inputs, both against the plain version
    session = tuple(torch.from_numpy(total[k]) for k in ("sum", "num"))
    if not np.array_equal(total["poison"], np.isinf(total["sum"])):
        raise AssertionError("session poison plane differs from its sums")
    max_err = max(
        compare(session, want, rtol=HEADLINE_RTOL, atol=1e-6,
                what="session vs plain headline"),
        compare(got, want, rtol=HEADLINE_RTOL, atol=1e-6,
                what="kernel vs plain headline"),
    )
    print(f"kernel vs plain headline (session and relaunch): "
          f"max_abs_err {max_err:.3g} "
          f"max_sum {float(want[0].max()):.6g} ok")

    n_sub = min(20_000, n_snips)
    s_r1, s_r2, s_cid = r1[:n_sub], r2[:n_sub], cid[:n_sub]
    stiles_h, want_s, want_m = host_oracle(ts, s_r1, s_r2, s_cid, valid,
                                           evec, W, C)
    st = sess.stiles.cpu().numpy()
    if not np.array_equal(np.isnan(st), np.isnan(stiles_h)):
        raise AssertionError("device normalize NaN mask differs from host")
    fin = ~np.isnan(stiles_h)
    np.testing.assert_allclose(st[fin], stiles_h[fin], rtol=1e-6, atol=1e-6)
    sub = sess.run_many(s_r1, s_r2, s_cid)
    if not np.array_equal(sub["num"], want_m):
        raise AssertionError("subset num differs from the host oracle")
    np.testing.assert_allclose(sub["sum"], want_s, rtol=1e-5, atol=0,
                               err_msg="subset sum vs host oracle")
    print(f"host oracle subset ({n_sub} snips): num exact, sum rtol 1e-5 ok")

    # timing: kernel and plain on the same pre-staged inputs, then the path
    kern_t = [timed(lambda: qg.quad_accumulate(*args), sync)[0]
              for _ in range(REPEATS)]
    plain_t = [timed(lambda: qg.quad_accumulate_plain(*args), sync)[0]
               for _ in range(REPEATS)]
    stage_t = [timed(lambda: sess.stage(r1, r2, cid), sync)[0]
               for _ in range(REPEATS)]
    e2e_t, e2e_phases = [], []
    for _ in range(REPEATS):
        e2e_t.append(timed(run_slice, sync)[0])
        e2e_phases.append(dict(phases))
    kern_med = statistics.median(kern_t)
    plain_med = statistics.median(plain_t)
    e2e_med = statistics.median(e2e_t)
    mid = e2e_phases[int(np.argsort(e2e_t)[len(e2e_t) // 2])]
    mid["of_which_sort_split_upload"] = statistics.median(stage_t)
    print("timing: kernel_ms "
          + json.dumps([round(x * 1e3, 3) for x in kern_t])
          + " plain_ms " + json.dumps([round(x * 1e3, 3) for x in plain_t])
          + " e2e_s " + json.dumps([round(x, 4) for x in e2e_t]))
    print("e2e phases (median run, s): " + json.dumps(
        {k: round(v, 4) for k, v in mid.items()}))
    print("device busy share of one end-to-end run: "
          + busy_share(run_slice, sync))
    print(f"snips/s: device-only {n_snips / kern_med:.0f} "
          f"(kernel median {kern_med * 1e3:.3f} ms, "
          f"plain {plain_med * 1e3:.3f} ms), "
          f"end-to-end {n_snips / e2e_med:.0f} (median {e2e_med:.3f} s)"
          f" on {card}")
    return dict(KERNEL, launches=launches, max_abs_err=max_err,
                ms=kern_med * 1e3, plain_ms=plain_med * 1e3)


def toy_cooler(seed=1, binsize=1_000_000, bad_bin_frac=0.05):
    """The toy map of ``tests/fixtures.make_toy_cooler`` (two mm9-sized
    chromosomes at 1 Mb, distance-decaying Poisson cis counts, 30%-dense
    trans counts, 5% NaN-weight bins), built in memory with the same RNG
    calls. Returns ``(Cooler, dense, weights)``: ``dense`` maps (chrom1,
    chrom2) to the full raw block."""
    from coolpuppy_tpu_torch import Cooler

    chromsizes = {"chr1": 197_195_432, "chr2": 181_748_087}
    rng = np.random.default_rng(seed)
    chroms = list(chromsizes)
    n_per = {c: int(np.ceil(n / binsize)) for c, n in chromsizes.items()}
    offsets = dict(zip(chroms, np.cumsum([0] + [n_per[c] for c in chroms])))
    n_bins = sum(n_per.values())
    weights = rng.uniform(0.5, 1.5, n_bins)
    weights[rng.random(n_bins) < bad_bin_frac] = np.nan
    pix1, pix2, cnt, dense = [], [], [], {}
    for ci, c1 in enumerate(chroms):
        for c2 in chroms[ci:]:
            n1, n2 = n_per[c1], n_per[c2]
            if c1 == c2:
                i, j = np.triu_indices(n1)
                vals = rng.poisson(100.0 / (1.0 + np.abs(i - j)) + 0.5)
                keep = vals > 0
                i, j, vals = i[keep], j[keep], vals[keep]
                block = np.zeros((n1, n1))
                block[i, j] = vals
                block[j, i] = vals
            else:
                i, j = np.nonzero(rng.random((n1, n2)) < 0.3)
                vals = rng.poisson(2.0, len(i)) + 1
                block = np.zeros((n1, n2))
                block[i, j] = vals
            dense[(c1, c2)] = block
            pix1.append(i + offsets[c1])
            pix2.append(j + offsets[c2])
            cnt.append(vals)
    clr = Cooler.from_arrays(
        chromsizes, binsize,
        (np.concatenate(pix1), np.concatenate(pix2), np.concatenate(cnt)),
        weights=weights,
    )
    return clr, dense, weights


def toy_features():
    """Six stranded BED features on the toy map (the reference's
    tests/data/toy_features.bed)."""
    import pandas as pd

    return pd.DataFrame({
        "chrom": ["chr1", "chr1", "chr1", "chr2", "chr2", "chr2"],
        "start": [102_000_000, 105_000_000, 108_000_000] * 2,
        "end": [102_500_000, 105_500_000, 108_500_000] * 2,
        "name": ["toy"] * 6,
        "score": [0] * 6,
        "strand": ["+", "-", "+", "+", "-", "-"],
    })


def toy_regions():
    """The toy view (the reference's tests/data/CN.mm9.toy_regions.bed)."""
    import pandas as pd

    return pd.DataFrame({"chrom": ["chr1", "chr2"],
                         "start": [100_000_000] * 2,
                         "end": [150_000_000] * 2, "name": ["foo", "bar"]})


def toy_expected(clr, dense, weights, view_df):
    """By-distance balanced expected of each view region (the arithmetic of
    ``tests/fixtures.toy_expected``): per diagonal, the nansum of balanced
    counts over the number of pairs of valid bins."""
    import pandas as pd

    rows = []
    for _, reg in view_df.iterrows():
        lo = int(reg["start"] // clr.binsize)
        hi = int(np.ceil(reg["end"] / clr.binsize))
        o = clr.offset(reg["chrom"])
        w = weights[o + lo : o + hi]
        block = dense[(reg["chrom"], reg["chrom"])][lo:hi, lo:hi]
        block = block * np.outer(w, w)
        valid = ~np.isnan(w)
        for d in range(hi - lo):
            i = np.arange(hi - lo - d)
            nv = int((valid[i] & valid[i + d]).sum())
            s = np.nansum(block[i, i + d])
            rows.append({"region1": reg["name"], "region2": reg["name"],
                         "dist": d, "n_valid": nv, "count.sum": np.nan,
                         "balanced.sum": s,
                         "balanced.avg": s / nv if nv > 0 else np.nan})
    return pd.DataFrame(rows)


def mode_kwargs(name, expected_df):
    """``pileup()`` keywords of one ENGINE_MODES entry on the toy map."""
    kw = dict(TOY_KW, **ENGINE_MODES[name])
    if kw.get("expected_df") is True:
        kw["expected_df"] = expected_df
    return kw


def compare_tables(got, want, rtol, atol, what):
    """Hold two pileup tables row by row: the group keys, ``n``,
    ``control_n``, ``num`` and ``control_num`` exact; ``data`` within
    tolerance with NaN positions equal. Returns the largest absolute
    ``data`` difference."""
    if list(got["group"]) != list(want["group"]):
        raise AssertionError(f"{what}: groups {list(got['group'])} != "
                             f"{list(want['group'])}")
    for col in ("n", "control_n"):
        if (col in got) != (col in want):
            raise AssertionError(f"{what}: column {col} on one side only")
        if col in want:
            np.testing.assert_array_equal(got[col].to_numpy(float),
                                          want[col].to_numpy(float),
                                          err_msg=f"{what}: {col}")
    err = 0.0
    for i in range(len(want)):
        for col in ("num", "control_num"):
            if col in want:
                np.testing.assert_array_equal(
                    got[col].iloc[i], want[col].iloc[i],
                    err_msg=f"{what}: {col} of row {i}",
                )
        g = np.asarray(got["data"].iloc[i], float)
        w = np.asarray(want["data"].iloc[i], float)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   equal_nan=True,
                                   err_msg=f"{what}: data of row {i}")
        fin = np.isfinite(w)
        err = max(err, float(np.abs(g[fin] - w[fin]).max(initial=0.0)))
    return err


def check_engine_modes(dev):
    """Phase 5a: every mode of the port's pileup() on the toy map, on
    ``dev`` against the plain version on the CPU."""
    from coolpuppy_tpu_torch import pileup

    clr, dense, weights = toy_cooler()
    expected = toy_expected(clr, dense, weights, toy_regions())
    for name in ENGINE_MODES:
        kw = mode_kwargs(name, expected)
        got = pileup(clr, toy_features(), view_df=toy_regions(), device=dev,
                     **kw)
        want = pileup(clr, toy_features(), view_df=toy_regions(),
                      device="cpu", **kw)
        err = compare_tables(got, want, what=f"engine mode {name}",
                             **ENGINE_MODES_TOL)
        routes = (got["accumulate"].iloc[0], want["accumulate"].iloc[0])
        if routes != ("cuda_kernel", "plain"):
            raise AssertionError(f"engine mode {name}: routes {routes}")
        print(f"engine mode {name}: {len(got)} rows, n {list(got['n'])}, "
              f"route {got['accumulate'].iloc[0]}, max_abs_err {err:.3g} ok")


def engine_workload(n_sites=20_000, n_bins=20_000, n_contacts=12_000_000,
                    binsize=10_000, seed=0):
    """``bench.py``'s ``bench_engine`` workload, with its RNG calls, as an
    in-memory Cooler: a 200 Mb chromosome at 10 kb, 12M zipf(1.35)
    contacts with Poisson(3)+1 counts, 3% NaN-weight bins, and ``n_sites``
    stranded 1 kb sites. Returns ``(Cooler, features)``."""
    import pandas as pd

    from coolpuppy_tpu_torch import Cooler

    rng = np.random.default_rng(seed)
    length = n_bins * binsize
    d = rng.zipf(1.35, 2 * n_contacts)
    d = d[d < n_bins][:n_contacts]
    i = rng.integers(0, n_bins, len(d))
    j = np.minimum(i + d, n_bins - 1)
    vals = rng.poisson(3.0, len(d)) + 1
    keep = i <= j
    weights = rng.uniform(0.5, 1.5, n_bins)
    weights[rng.random(n_bins) < 0.03] = np.nan
    clr = Cooler.from_arrays({"chr1": length}, binsize,
                             (i[keep], j[keep], vals[keep]), weights=weights)
    starts = np.sort(rng.choice(length - 10_000, n_sites, replace=False))
    feats = pd.DataFrame({
        "chrom": "chr1", "start": starts, "end": starts + 1_000,
        "name": ".", "score": 0,
        "strand": rng.choice(["+", "-"], n_sites),
    })
    return clr, feats


def engine_snips(pups):
    """ROI n + control_n of the 'all' row (bench_engine's count)."""
    row = pups.loc[pups["orientation"] == "all"].iloc[0]
    return int(row["n"]) + int(row["control_n"])


def check_engine(dev, sync, card):
    """Phase 5b: the engine at bench_engine's size. Returns the checked
    run's kernel launch count."""
    import coolpuppy_tpu_torch.ops.quad_gather as qg
    from coolpuppy_tpu_torch import CoordCreator, PileUpper, pileup

    t, (clr, feats) = timed(engine_workload, lambda: None)
    print(f"engine workload: {clr.n_bins} bins, {clr.n_pixels} pixels, "
          f"{len(feats)} sites in {t:.1f} s")

    def run(f):
        return pileup(clr, f, device=dev, **ENGINE_KW)

    t, warm = timed(lambda: run(feats.iloc[:ENGINE_WARMUP_SITES]), sync)
    print(f"engine warm-up ({ENGINE_WARMUP_SITES} sites): "
          f"{engine_snips(warm)} snips in {t:.2f} s")

    qg.LAUNCHES = 0
    t, checked = timed(lambda: run(feats), sync)
    launches = qg.LAUNCHES
    route = checked["accumulate"].iloc[0]
    if launches < 1 or route != "cuda_kernel":
        raise AssertionError(f"engine run: {launches} launches, route "
                             f"{route!r}; the kernel did not run")
    n_snips = engine_snips(checked)
    data = np.stack(checked["data"].to_list())
    if data.shape[1:] != (21, 21) or not np.isfinite(data).any():
        raise AssertionError(f"engine output: shape {data.shape}, finite "
                             f"{int(np.isfinite(data).sum())}")
    print(f"engine checked run: {n_snips} snips, {len(checked)} rows "
          f"({list(checked['orientation'])}), launches {launches}, route "
          f"{route}, {t:.2f} s")

    kernel = qg.quad_accumulate
    qg.quad_accumulate = qg.quad_accumulate_plain
    try:
        qg.LAUNCHES = 0
        plain = run(feats)
        plain_launches = qg.LAUNCHES
    finally:
        qg.quad_accumulate = kernel
    if plain_launches != 0 or plain["accumulate"].iloc[0] != "plain":
        raise AssertionError(f"plain-swapped run launched {plain_launches}")
    err = compare_tables(checked, plain, rtol=ENGINE_RTOL, atol=1e-7,
                         what="engine kernel vs plain")
    print(f"engine kernel vs plain (whole run): n/control_n/num exact, "
          f"data max_abs_err {err:.3g} (rtol {ENGINE_RTOL}) ok")

    # the timed runs build the PileUpper that pileup(**ENGINE_KW) builds,
    # to read its phase timers
    def run_timed():
        kw = dict(ENGINE_KW)
        del kw["by_strand"]
        nshifts = kw.pop("nshifts")
        cc = CoordCreator(feats, clr.binsize, nshifts=nshifts, **kw)
        pu = PileUpper(clr, cc, control=nshifts > 0, device=dev)
        return pu, pu.pileupsByStrandWithControl()

    walls, phases = [], []
    for _ in range(ENGINE_REPEATS):
        t, (pu, pups) = timed(run_timed, sync)
        if engine_snips(pups) != n_snips:
            raise AssertionError("timed run counted other snips")
        walls.append(t)
        ph = dict(pu.timers.seconds)
        ph["outside_phases"] = t - sum(ph.values())
        phases.append(ph)
    med = statistics.median(walls)
    mid = phases[int(np.argsort(walls)[len(walls) // 2])]
    print("engine timing: wall_s " + json.dumps([round(x, 4) for x in walls]))
    print("engine phases (median run, s): " + json.dumps(
        {k: round(v, 4) for k, v in sorted(mid.items())}))
    print("engine device busy share of one run: "
          + busy_share(lambda: run(feats), sync))
    print(f"engine snips/s: {n_snips / med:.0f} ({n_snips} snips, median "
          f"{med:.3f} s of {ENGINE_REPEATS}) on {card}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1

    from bench import make_workload
    from coolpuppy_tpu_torch.kernels.build import build, load_kernels

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    card = smi_line()
    kind = torch.cuda.get_device_name(0)

    # -- 1. probe ---------------------------------------------------------
    import pandas as pd

    print(f"probe: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} pandas {pd.__version__} "
          f"numpy {np.__version__} device {kind} "
          f"count {torch.cuda.device_count()}")
    print(f"probe: nvidia-smi {card}")
    print(f"probe: nvcc {nvcc_line()}")
    print("probe: importable " + " ".join(
        f"{m}={importable(m)}" for m in ("triton", "pandas", "h5py"))
        + f"; jax installed={importable('jax')} (looked up, not imported)")

    # -- 2. build ---------------------------------------------------------
    t, lib = timed(lambda: build(verbose=True), lambda: None)
    load_kernels()
    print(f"build: {lib} in {t:.1f} s")

    # -- 3. kernel vs plain at small shapes -------------------------------
    check_kernels(dev, sync)

    # -- 4. the slice at the headline size --------------------------------
    t, workload = timed(make_workload, lambda: None)
    coo, r1 = workload[1], workload[2]
    print(f"workload: {coo.shape[0]} bins, {coo.nnz} nnz, {len(r1)} snips "
          f"in {t:.1f} s")
    record = check_slice(dev, sync, workload, card)
    del workload, coo, r1

    # -- 5. the engine: pileup() modes, then bench_engine's size ----------
    check_engine_modes(dev)
    record["engine_launches"] = check_engine(dev, sync, card)

    # -- result -----------------------------------------------------------
    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
