"""Drive the PyTorch/CUDA port's loop-APA path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device, ``nvcc``
and PyTorch built for CUDA. It needs no network and no JAX. Phases, each
printing its lines:

1. probe: torch/CUDA versions, the card's name and power limit
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
   one end-to-end run from ``torch.profiler``.

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
    print(f"probe: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {kind} "
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

    # -- result -----------------------------------------------------------
    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
