"""Inputs, oracles and comparators that the port's tests share: the toy
maps and features, the mode tables, the workloads of ``bench.py``'s cells
built in memory with its RNG calls, the host oracles, the table and
accumulator comparators, the fuzz cases, the recording stores and spies,
and the helpers that swap the quad kernel for its plain version.

Not a test module (its name does not start with ``test_``): the files of
``tests/`` import it. Several tests run on the card and, at a smaller
size, on the CPU (``DEVICES``): the ``cuda`` case carries the ``cuda``
marker and skips where there is no card. The card takes the transfer wires
by default, so a card run held against the CPU or a host oracle passes
``F32_WIRE`` (``wires_off`` for the CLI), and both sides of a card-vs-card
comparison of a blocked by-window run pass ``F32_FETCH``.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import sys
import threading

import numpy as np
import pytest
import torch

# the device cases of a test that runs on the card and, smaller, on the CPU
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
B = 128
SMALL_TOL = dict(rtol=1e-5, atol=1e-5)
# float32 atomics add up to ~250k snips per (group, pixel) in an order that
# changes from run to run: a whole run on the card against the plain version
HEADLINE_RTOL = 1e-4

# the modes of the port's pileup() on the toy map (TOY_KW plus these);
# "expected_df": True stands for the toy expected table
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
# the transfer wires off: a card run held against the CPU (which takes no
# wire) or against a host oracle passes these, since the card takes the
# float16 tile upload and fetches by default
F32_WIRE = dict(tile_f16=False, stripe_f16=False)
# the float16 fetches off: both sides of a card-vs-card comparison of a
# blocked by-window run, whose float32 sums differ by the atomics' order
# before the flip-merged accumulator fetch rounds them to float16
F32_FETCH = dict(stripe_f16=False)
# bench.py --engine (bench_engine): pileup() arguments
ENGINE_KW = dict(features_format="bed", flank=100_000, maxdist=2_000_000,
                 nshifts=1, seed=0, by_strand=True)
ENGINE_RTOL = 1e-4

# the 2D modes on the toy map (TOY_KW plus these); "features":
# "bedpe" stands for toy_bedpe(), "expected_df": "trans" for the toy trans
# expected table. MODE_PATCHES sets engine module constants for one mode:
# a block cap of 4 groups at the toy's W = 5, and the coverage histogram
# bound at 0 so coverage goes through the device scatter-add
MODES_2D = {
    "stripes_controls": {"store_stripes": True, "nshifts": 2, "seed": 1},
    "stripes_local": {"store_stripes": True, "local": True},
    "trans": {"trans": True},
    "trans_controls": {"trans": True, "nshifts": 2, "seed": 5},
    "trans_ooe": {"trans": True, "expected_df": "trans"},
    "bedpe": {"features": "bedpe"},
    "bedpe_controls_stripes": {"features": "bedpe", "nshifts": 2, "seed": 6,
                               "store_stripes": True},
    "bedpe_by_distance": {"features": "bedpe", "by_distance": True},
    "by_window": {"by_window": True},
    "by_window_controls": {"by_window": True, "nshifts": 1, "seed": 4},
    "by_window_coverage": {"by_window": True, "clr_weight_name": None,
                           "coverage_norm": True},
    "by_window_coverage_scatter": {"by_window": True, "clr_weight_name": None,
                                   "coverage_norm": True},
    "by_window_stripes": {"by_window": True, "store_stripes": True},
    "by_window_blocked": {"by_window": True, "nshifts": 1, "seed": 4},
}
MODE_PATCHES = {
    "by_window_blocked": {"_BLOCK_BYTES": 2 * 4 * 5 * 5 * 8},
    "by_window_coverage_scatter": {"_COV_HIST_MAX": 0},
}
STRIPE_RTOL = 1e-5
# bench.py --modes (bench_modes, bench.py:419-534): pileup() keywords of
# each cell; the trans cell runs on the two-chromosome map
MODES_KW = dict(features_format="bed", flank=100_000, maxdist=2_000_000,
                seed=0)
MODES_CELLS = {
    "stripes": dict(MODES_KW, store_stripes=True),
    "by_window": dict(MODES_KW, by_window=True),
    "bedpe": dict(features_format="bedpe", flank=100_000, mindist=0, seed=0),
    "trans": dict(features_format="bed", flank=100_000, trans=True, seed=0),
}
STRIPE_SAMPLE = 20_000

# rescaled pileups of toy TADs (toy_features() 3 Mb wide) in the
# toy view (RESCALE_KW plus these), and 123-bin windows (flank 61 Mb, the
# generic path) over whole chromosomes (WIDE_KW plus these); "expected_df":
# True stands for the toy expected table of that view, "features": "bedpe"
# for toy_bedpe() with 2 Mb anchors
RESCALE_KW = dict(features_format="bed", mindist=0, rescale=True,
                  rescale_flank=1, rescale_size=33)
RESCALE_MODES = {
    "local": {"local": True},
    "local_controls": {"local": True, "nshifts": 1, "seed": 7},
    "local_stripes": {"local": True, "store_stripes": True},
    "ooe": {"local": True, "expected_df": True},
    "expected_emission": {"expected_df": True, "ooe": False},
    "coverage_norm": {"clr_weight_name": None, "coverage_norm": True},
    "bedpe": {"features": "bedpe"},
    "trans": {"trans": True},
}
WIDE_KW = dict(features_format="bed", mindist=0, flank=61_000_000)
WIDE_MODES = {
    "ooe": {"expected_df": True},
    "controls_by_strand": {"by_strand": True, "nshifts": 1, "seed": 0},
    "stripes": {"store_stripes": True},
    "by_window": {"by_window": True},
    "trans": {"trans": True},
    "expected_emission": {"expected_df": True, "ooe": False},
    "coverage_norm": {"clr_weight_name": None, "coverage_norm": True},
}
# bench.py --rescale (bench_rescale, bench.py:342-416)
RESCALE_CELL_KW = dict(features_format="bed", local=True, rescale=True,
                       rescale_flank=1, rescale_size=99, mindist=0, seed=0)
RESCALE_ORACLE_TADS = 200
ORACLE_RTOL = 1e-4
# 201-bin windows (+-1 Mb at 10 kb) on the engine map
WIDE_CELL_KW = dict(features_format="bed", flank=1_000_000,
                    maxdist=5_000_000, nshifts=1, seed=0, by_strand=True)
WIDE_CELL_SITES = 2_000
WIDE_SUBSET_SITES = 300
# the wide kernel against its plain version at these W, on
# WIDE_CASE_SNIPS snips each; sums within WIDE_RTOL, counts exact
WIDE_KERNEL_W = (121, 129, 130, 201, 257, 258, 401)
WIDE_CASE_SNIPS = 600
WIDE_RTOL = 1e-5
# 119-bin windows (+-590 kb at 10 kb) over the engine cell's sites,
# the staged kernel in two bands; mindist automatic (2 * flank + 2 bins)
W119_CELL_KW = dict(ENGINE_KW, flank=590_000, maxdist=3_000_000)
W119_SUBSET_SITES = 300

# the extension routes and the by-window cases that group through
# a frame hook, on the toy map. Per mode: "features" (toy_features() with
# distinct scores unless "bedpe", "tads" or "bedpe_tads"), CoordCreator and
# PileUpper keywords ("expected": True stands for the toy expected table),
# "run" (pileupsWithControl keywords; hooks and extras by name, resolved in
# hook_mode_table), "by_window", the accumulate routes on the card and on
# the CPU, and the extras columns with the tolerance they are held to (None:
# equal, copied from frame columns)
HOOK_MODES = {
    "frame_func": dict(run={"postprocess_frame_func": "group_by_region"},
                       routes=("cuda_kernel", "plain")),
    "frame_column_by_strand": dict(
        run={"extras": "score1", "groupby": ["strand1", "strand2"]},
        routes=("cuda_kernel", "plain"), extras=(["score1"], None)),
    "frame_column_controls": dict(
        cc={"nshifts": 2, "seed": 3}, run={"extras": "score1"},
        routes=("cuda_kernel", "plain"),
        extras=(["score1", "control_score1"], None)),
    "batch_hook": dict(
        run={"postprocess_batch_func": "center_batch", "extras": "center"},
        routes=("batch_hook",) * 2, extras=(["center"], 1e-5)),
    "batch_hook_flip_controls": dict(
        cc={"nshifts": 1, "seed": 5}, pu={"flip_negative_strand": True},
        run={"postprocess_batch_func": "center_batch", "extras": "center",
             "groupby": ["strand1", "strand2"]},
        routes=("batch_hook",) * 2,
        extras=(["center", "control_center"], 1e-5)),
    "snip_domain_score": dict(
        features="tads", cc={"local": True, "rescale_flank": 1},
        pu={"rescale": True, "rescale_size": 33},
        run={"postprocess_snip_func": "domain_score",
             "extras": "domain_score"},
        routes=("host_stream",) * 2, extras=(["domain_score"], 1e-5)),
    "snip_per_anchor": dict(
        run={"postprocess_snip_func": "per_anchor"},
        routes=("host_stream",) * 2),
    "opaque_extra": dict(
        run={"extras": "count_snips"}, routes=("host_stream",) * 2,
        extras=(["snipcount"], None)),
    "extras_expected_emission": dict(
        pu={"expected": True, "ooe": False}, run={"extras": "score1"},
        routes=("host_stream",) * 2, extras=(["score1"], None)),
    "host_stripes": dict(
        cc={"nshifts": 1, "seed": 4}, pu={"store_stripes": True},
        run={"postprocess_snip_func": "center_snip", "extras": "center"},
        routes=("host_stream",) * 2,
        extras=(["center", "control_center"], 1e-5)),
    "host_rescale": dict(
        features="tads", cc={"rescale_flank": 1},
        pu={"rescale": True, "rescale_size": 33, "expected": True},
        run={"postprocess_snip_func": "noop"},
        routes=("host_stream",) * 2),
    "by_window_bedpe": dict(features="bedpe", by_window=True,
                            routes=("cuda_kernel", "plain")),
    "by_window_bedpe_controls": dict(
        features="bedpe", cc={"nshifts": 2, "seed": 6}, by_window=True,
        routes=("cuda_kernel", "plain")),
    "by_window_rescale": dict(
        features="tads", cc={"rescale_flank": 1},
        pu={"rescale": True, "rescale_size": 33}, by_window=True,
        routes=("rescale_torch",) * 2),
    "by_window_rescale_bedpe": dict(
        features="bedpe_tads", cc={"rescale_flank": 1},
        pu={"rescale": True, "rescale_size": 33}, by_window=True,
        routes=("rescale_torch",) * 2),
}
EXTRAS_RTOL = 1e-5
# bench.py:575 bench_extension (its sizes, keywords and hooks)
EXTENSION_KW = dict(features_format="bed", flank=100_000, maxdist=1_000_000,
                    nshifts=0)
EXTENSION_SITES = (20_000, 6_000)  # frame column; batch and snip hooks
EXTENSION_CPU_SITES = 1_000
# by-window of BEDPE rows: every pair of these sites of the engine
# map within this distance, written out as rows
BEDPE_WINDOW_SITES = 5_000
BEDPE_WINDOW_KW = dict(flank=100_000, maxdist=2_000_000)

# bench.py:866 bench_genome (its pileup() arguments); the native entries'
# tolerance against the numpy branches
GENOME_KW = dict(features_format="bed", flank=100_000, maxdist=2_000_000,
                 nshifts=10, seed=0, by_strand=True)
# the native scatter adds float32 in input order where the numpy branch
# sums in float64: near the diagonal of bench's zipf maps a cell holds
# hundreds of duplicate contacts, whose float32 sum drifts by a few 1e-6
# (4.3e-6 on the genome map, NVIDIA H100 host)
NATIVE_RTOL = 1e-5


def device(name):
    """The torch device of a ``DEVICES`` case; the ``cuda`` case skips where
    there is no card."""
    if name == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        return torch.device("cuda", 0)
    return torch.device(name)


def counted_plain(monkeypatch):
    """``quad_accumulate`` swapped for the plain version on the CPU, its
    calls counted as launches (the engine then records ``cuda_kernel``).
    Returns the snips of each call, in call order."""
    import coolpuppy_tpu_torch.ops.quad_gather as qg

    plain = qg.quad_accumulate_plain
    calls = []

    def counted(*args):
        qg.LAUNCHES += 1
        calls.append(int(args[4].shape[0]))
        return plain(*args)

    monkeypatch.setattr(qg, "quad_accumulate", counted)
    return calls


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


def band_limit():
    """``(largest one-band W, first banded W)`` from ``corner_layout``."""
    from coolpuppy_tpu_torch.ops.quad_gather import W_MAX, corner_layout

    first = next(W for W in range(1, W_MAX + 1)
                 if corner_layout(W).bands > 1)
    return first - 1, first


def synthetic_case(W, seed, counts, k, runs=None, C=64):
    """A stack of random tiles (10% NaN, 1% +inf, slot 0 all NaN) and
    quads ``k`` ([nq, 4] slots, 0 = a missing tile) of ``counts`` snips
    each at random offsets (some at 127), groups sorted inside a quad: drawn
    from [0, C), or with ``runs`` in runs of 1..runs snips of rising groups.
    Returns ``(stiles, (snips, k, qstart, qcount), W, C)`` as numpy."""
    rng = np.random.default_rng(seed)
    k = np.asarray(k, np.int32)
    counts = np.asarray(counts, np.int32)
    st = rng.gamma(1.0, 1.0, (int(k.max()) + 1, B, B)).astype(np.float32)
    st[rng.random(st.shape) < 0.1] = np.nan
    st[rng.random(st.shape) < 0.01] = np.inf
    st[0] = np.nan
    n = int(counts.sum())
    o1, o2 = rng.integers(0, 128, (2, n))
    o1[::97], o2[::89] = 127, 127
    if runs:
        g = [np.repeat(np.arange(c), rng.integers(1, runs + 1, c))[:c]
             for c in counts]
        C = max(C, int(max(x.max() for x in g if len(x)) + 1))
    else:
        g = [np.sort(rng.integers(0, C, c)) for c in counts]
    from coolpuppy_tpu_torch.ops.quad_gather import pack_snips

    snips = pack_snips(o1, o2, np.concatenate(g))
    qstart = (np.cumsum(counts) - counts).astype(np.int32)
    return st, (snips, k, qstart, counts), W, C


def kernel_cases():
    """The kernel's small cases: ``(name, stiles, quads, W, C)`` with ``stiles`` a
    float32 numpy stack and ``quads = (snips, k, qstart, qcount)`` the
    unsplit output of ``sort_quads`` (numpy)."""
    from coolpuppy_tpu_torch.ops.quad_gather import (
        ITEM_MAX,
        STAGE_CHUNK,
        QuadPileupSession,
        sort_quads,
    )
    from coolpuppy_tpu_torch.ops.tiles import build_tile_stack_sym

    last_single, first_banded = band_limit()
    for W, seed in ((11, 7), (21, 8), (65, 9), (120, 10), (last_single, 11),
                    (first_banded, 12), (115, 17)):
        coo, r1, r2, cid, valid, evec, cfg_kw = small_problem(W, seed)
        ts = build_tile_stack_sym(coo, B, r1=r1, r2=r2, window1=W, window2=W)
        sess = QuadPileupSession(ts, valid, valid, evec, cfg_kw, "cpu")
        st = sess.stiles.numpy()
        yield (f"W={W}", st, sort_quads(r1, r2, cid, ts.tile_map, B), W,
               sess.C)
        if W == 21:
            empty = np.zeros(0, np.int32)
            yield ("W=21 empty", st,
                   sort_quads(empty, empty, empty, ts.tile_map, B), W, sess.C)
    full = [1, 2, 3, 4]
    yield ("W=21 by-window runs", *synthetic_case(
        21, 13, [150, 90, 3], [full, [5, 6, 7, 8], full], runs=3))
    yield ("W=21 ITEM_MAX cuts", *synthetic_case(
        21, 14, [ITEM_MAX, ITEM_MAX + 1, 1], [full, [5, 6, 7, 8], full]))
    yield ("W=21 item longer than the chunk", *synthetic_case(
        21, 15, [2 * STAGE_CHUNK + 77, 40], [full, [5, 6, 7, 8]], C=9))
    missing = [[1, 0, 2, 0], [0, 0, 3, 4], [0, 0, 0, 0], [0, 5, 0, 0]]
    for W in (21, 33, first_banded, 120):
        yield (f"W={W} missing tiles", *synthetic_case(
            W, 16 + W, [60, 50, 7, 40], missing))


def variant_args(quads, variant, device):
    """``quad_accumulate`` arguments on ``device``: the quads cut by
    ``split_items`` ("staged"), or left whole ("whole": one item per quad,
    many groups, any length)."""
    from coolpuppy_tpu_torch.ops.quad_gather import split_items

    snips, k, qstart, qcount = quads
    if variant == "staged":
        k, qstart, qcount = split_items(k, qstart, qcount)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
        for a in (k, qstart, qcount, snips)
    )


def check_case(name, stiles, quads, W, C, device):
    """One kernel case: the staged kernel on split and on whole quads, and
    the routed ``quad_accumulate`` on the staged kernel's items, against
    the plain version (``num`` exact, poison equal, ``sum`` within
    SMALL_TOL); the routed call must launch the staged kernel once (none
    for an empty stream). Returns the variants held, the largest absolute
    error and the plain version's ``(sum, num)``."""
    import coolpuppy_tpu_torch.ops.quad_gather as qg

    st = torch.from_numpy(stiles).to(device)
    want = qg.quad_accumulate_plain(
        st, *variant_args(quads, "whole", device), W, C)
    runs = [("staged", qg.quad_accumulate_staged, "staged"),
            ("staged, whole quads", qg.quad_accumulate_staged, "whole"),
            ("routed", qg.quad_accumulate, "staged")]
    err = 0.0
    for label, fn, split in runs:
        args = variant_args(quads, split, device)
        before = qg.LAUNCHES
        got = fn(st, *args, W, C)
        took = qg.LAUNCHES - before
        if label == "routed" and took != int(args[0].shape[0] > 0):
            raise AssertionError(f"{name}: routed call launched {took}")
        err = max(err, compare(got, want, what=f"{label} vs plain {name}",
                               **SMALL_TOL))
    return [label for label, _, _ in runs], err, want


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


def toy_bedpe():
    """BEDPE rows on the toy map: tests/test_combo_matrix.py's three cis
    loops, and one whose second anchor comes first (its windows lie below
    the diagonal)."""
    import pandas as pd

    return pd.DataFrame({
        "chrom1": ["chr1", "chr1", "chr2", "chr1"],
        "start1": [102_000_000, 104_000_000, 103_000_000, 111_000_000],
        "end1": [102_500_000, 104_500_000, 103_500_000, 111_500_000],
        "chrom2": ["chr1", "chr1", "chr2", "chr1"],
        "start2": [107_000_000, 110_000_000, 109_000_000, 105_000_000],
        "end2": [107_500_000, 110_500_000, 109_500_000, 105_500_000],
    })


def toy_trans_expected(clr, dense, weights, view_df):
    """The scalar trans expected of each pair of view regions on distinct
    chromosomes (the arithmetic of ``coolpuppy_tpu.expected.
    expected_trans``): the balanced sum of the block over the number of
    pairs of valid bins."""
    import pandas as pd

    rows = []
    regions = [reg for _, reg in view_df.iterrows()]
    for a, r1 in enumerate(regions):
        for r2 in regions[a + 1:]:
            if r1["chrom"] == r2["chrom"]:
                continue
            ext = []
            for reg in (r1, r2):
                lo = int(reg["start"] // clr.binsize)
                hi = int(np.ceil(reg["end"] / clr.binsize))
                o = clr.offset(reg["chrom"])
                ext.append((lo, hi, weights[o + lo : o + hi]))
            (lo1, hi1, w1), (lo2, hi2, w2) = ext
            block = dense[(r1["chrom"], r2["chrom"])][lo1:hi1, lo2:hi2]
            bal = np.nansum(block * np.outer(np.nan_to_num(w1),
                                             np.nan_to_num(w2)))
            nv = int((~np.isnan(w1)).sum()) * int((~np.isnan(w2)).sum())
            rows.append({"region1": r1["name"], "region2": r2["name"],
                         "n_valid": nv, "count.sum": float(block.sum()),
                         "balanced.sum": float(bal),
                         "balanced.avg": float(bal) / nv if nv else np.nan})
    return pd.DataFrame(rows)


def mode_2d_inputs(name, trans_expected):
    """``(features, pileup() keywords)`` of one MODES_2D entry on the toy
    map."""
    kw = dict(TOY_KW, **MODES_2D[name])
    features = toy_features()
    if kw.pop("features", None) == "bedpe":
        features = toy_bedpe()
        kw["features_format"] = "bedpe"
    if kw.get("expected_df") == "trans":
        kw["expected_df"] = trans_expected
    return features, kw


class engine_patch:
    """Set engine module constants (``MODE_PATCHES``) for one block and put
    them back after it."""

    def __init__(self, **values):
        self.values = values

    # the package's ``pileup`` function shadows the module's name
    MODULE = "coolpuppy_tpu_torch.engine.pileup"

    def __enter__(self):
        engine = importlib.import_module(self.MODULE)
        self.saved = {k: getattr(engine, k) for k in self.values}
        for k, v in self.values.items():
            setattr(engine, k, v)

    def __exit__(self, *exc):
        engine = importlib.import_module(self.MODULE)
        for k, v in self.saved.items():
            setattr(engine, k, v)


class wires_off:
    """The card's runs in a block take no transfer wire, as the CPU's: for
    callers that cannot pass ``F32_WIRE`` (the CLI has no flag for it)."""

    MODULE = engine_patch.MODULE

    def __enter__(self):
        self.cls = importlib.import_module(self.MODULE).PileUpper
        self.saved = self.cls._on_accelerator
        self.cls._on_accelerator = lambda pu: False

    def __exit__(self, *exc):
        self.cls._on_accelerator = self.saved


def table_keys(table):
    """A pileup table's row keys: chrom/start/end of a by-window table,
    the group otherwise."""
    if "group" in table.columns:
        return list(table["group"])
    return list(zip(table["chrom"], table["start"], table["end"]))


def compare_tables(got, want, rtol, atol, what, stripe_tol=None):
    """Hold two pileup tables row by row: the group keys (in order), or a
    by-window table's chrom/start/end keys (rows matched on them), ``n``,
    ``control_n``, ``num`` and ``control_num`` exact; ``data`` within
    tolerance with NaN positions equal; stripe planes within ``stripe_tol``
    (rtol ``STRIPE_RTOL``, atol 0 unless given) with NaN positions equal and
    stripe coordinates exact. Returns the largest absolute ``data``
    difference."""
    stripe_tol = stripe_tol or dict(rtol=STRIPE_RTOL, atol=0)
    gk, wk = table_keys(got), table_keys(want)
    if "group" in want.columns:
        if gk != wk:
            raise AssertionError(f"{what}: groups {gk} != {wk}")
    else:
        if len(gk) != len(wk) or set(gk) != set(wk) or len(set(wk)) != len(wk):
            raise AssertionError(f"{what}: window keys differ")
        pos = {k: i for i, k in enumerate(gk)}
        got = got.iloc[[pos[k] for k in wk]]
    got = got.reset_index(drop=True)
    want = want.reset_index(drop=True)
    for col in ("n", "control_n"):
        if (col in got) != (col in want):
            raise AssertionError(f"{what}: column {col} on one side only")
        if col in want:
            np.testing.assert_array_equal(got[col].to_numpy(float),
                                          want[col].to_numpy(float),
                                          err_msg=f"{what}: {col}")
    stripes = "horizontal_stripe" in want
    if stripes != ("horizontal_stripe" in got):
        raise AssertionError(f"{what}: stripes on one side only")
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
        if stripes:
            for col in ("horizontal_stripe", "vertical_stripe"):
                np.testing.assert_allclose(
                    np.asarray(got[col].iloc[i], float),
                    np.asarray(want[col].iloc[i], float),
                    **stripe_tol, equal_nan=True,
                    err_msg=f"{what}: {col} of row {i}",
                )
            gc = np.asarray(got["coordinates"].iloc[i], object)
            wc = np.asarray(want["coordinates"].iloc[i], object)
            if gc.shape != wc.shape or not (gc == wc).all():
                raise AssertionError(f"{what}: coordinates of row {i}")
    return err


def compare_extras(got, want, keys, what, rtol=None):
    """Hold the extras columns ``keys`` of two pileup tables whose rows
    ``compare_tables`` matched: per row a list of the same length in the
    same order, equal element by element (values copied from frame columns),
    or within ``rtol`` (values a hook computed from window pixels; NaN
    positions equal)."""
    for key in keys:
        if key not in got or key not in want:
            raise AssertionError(f"{what}: no column {key}")
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            if (g is None) != (w is None):
                raise AssertionError(f"{what}: {key} of row {i} on one "
                                     "side only")
            if w is None:
                continue
            g, w = np.atleast_1d(g), np.atleast_1d(w)
            if g.shape != w.shape:
                raise AssertionError(f"{what}: {key} of row {i} holds "
                                     f"{g.shape} values, not {w.shape}")
            if rtol is None:
                if not (g == w).all():
                    raise AssertionError(f"{what}: {key} of row {i} differs")
            else:
                np.testing.assert_allclose(
                    g.astype(float), w.astype(float), rtol=rtol, atol=1e-7,
                    equal_nan=True, err_msg=f"{what}: {key} of row {i}")


# bench_cooler's maps of this process: (generator state before, sizes) ->
# (Cooler, generator state after)
BENCH_MAPS = {}


def bench_cooler(rng, n_bins=20_000, n_contacts=12_000_000, binsize=10_000):
    """The synthetic chromosome of ``bench.py``'s engine-level benches
    (``bench_engine``, ``_bench_cooler``), drawn from ``rng`` with their
    RNG calls, as an in-memory Cooler: zipf(1.35) distances, Poisson(3)+1
    counts, 3% NaN-weight bins. The tests of a process share one map: a
    later call from the same generator state returns the Cooler built first
    and leaves ``rng`` where drawing it would have."""
    from coolpuppy_tpu_torch import Cooler

    key = (repr(rng.bit_generator.state), n_bins, n_contacts, binsize)
    if key in BENCH_MAPS:
        clr, rng.bit_generator.state = BENCH_MAPS[key]
        return clr

    d = rng.zipf(1.35, 2 * n_contacts)
    d = d[d < n_bins][:n_contacts]
    i = rng.integers(0, n_bins, len(d))
    j = np.minimum(i + d, n_bins - 1)
    vals = rng.poisson(3.0, len(d)) + 1
    keep = i <= j
    weights = rng.uniform(0.5, 1.5, n_bins)
    weights[rng.random(n_bins) < 0.03] = np.nan
    clr = Cooler.from_arrays({"chr1": n_bins * binsize}, binsize,
                             (i[keep], j[keep], vals[keep]), weights=weights)
    BENCH_MAPS[key] = (clr, rng.bit_generator.state)
    return clr


def engine_workload(n_sites=20_000, n_bins=20_000, n_contacts=12_000_000,
                    binsize=10_000, seed=0):
    """``bench.py``'s ``bench_engine`` workload, with its RNG calls, as an
    in-memory Cooler: a 200 Mb chromosome at 10 kb, 12M zipf(1.35)
    contacts with Poisson(3)+1 counts, 3% NaN-weight bins, and ``n_sites``
    stranded 1 kb sites. Returns ``(Cooler, features)``."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    length = n_bins * binsize
    clr = bench_cooler(rng, n_bins, n_contacts, binsize)
    starts = np.sort(rng.choice(length - 10_000, n_sites, replace=False))
    feats = pd.DataFrame({
        "chrom": "chr1", "start": starts, "end": starts + 1_000,
        "name": ".", "score": 0,
        "strand": rng.choice(["+", "-"], n_sites),
    })
    return clr, feats


def modes_workload(n_sites=20_000, n_bins=20_000, n_contacts=12_000_000,
                   n_trans=1_500, trans_size=(10_000, 8_000, 3_000_000,
                                              2_000_000), seed=0):
    """``bench.py --modes``' inputs (``bench_modes``, bench.py:419-534)
    with its RNG calls: the engine map (``_bench_cooler``), ``n_sites``
    stranded 1 kb sites, 2M coordinate-sorted BEDPE pairs 12-199 bins apart,
    and 1,500 sites on each chromosome of the trans map
    (``trans_cooler``); the keywords cut it for tests. Returns ``(clr,
    feats, bedpe, clr2, tfeats)``."""
    import pandas as pd

    clr = bench_cooler(np.random.default_rng(0), n_bins, n_contacts)
    binsize = clr.binsize
    length = clr.n_bins * binsize
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(length - 10_000, n_sites, replace=False))
    feats = pd.DataFrame({
        "chrom": "chr1", "start": starts, "end": starts + 1_000,
        "name": ".", "score": 0,
        "strand": rng.choice(["+", "-"], n_sites),
    })
    n_pairs = min(2_000_000, n_sites * 100)
    a1 = rng.integers(0, clr.n_bins - 300, n_pairs)
    sep = rng.integers(12, 200, n_pairs)
    a2 = np.minimum(a1 + sep, clr.n_bins - 12)
    order = np.lexsort((a2, a1))
    a1, a2 = a1[order], a2[order]
    bedpe = pd.DataFrame({
        "chrom1": "chr1", "start1": a1 * binsize,
        "end1": a1 * binsize + 1_000,
        "chrom2": "chr1", "start2": a2 * binsize,
        "end2": a2 * binsize + 1_000,
    })
    clr2 = trans_cooler(*trans_size)
    n_t = n_trans
    t1 = np.sort(rng.choice(clr2.chromsizes["chr1"] - 10_000, n_t,
                            replace=False))
    t2 = np.sort(rng.choice(clr2.chromsizes["chr2"] - 10_000, n_t,
                            replace=False))
    tfeats = pd.DataFrame({
        "chrom": ["chr1"] * n_t + ["chr2"] * n_t,
        "start": np.concatenate([t1, t2]),
        "end": np.concatenate([t1, t2]) + 1_000,
    })
    return clr, feats, bedpe, clr2, tfeats


def trans_cooler(n1=10_000, n2=8_000, n_cis=3_000_000, n_trans=2_000_000,
                 binsize=10_000, seed=1):
    """``bench.py``'s ``_bench_cooler2`` with its RNG calls, in memory: two
    chromosomes of 10,000 and 8,000 bins, 3M zipf cis contacts each, 2M
    uniform trans contacts, 3% NaN-weight bins."""
    from coolpuppy_tpu_torch import Cooler

    rng = np.random.default_rng(seed)
    pix1, pix2, cnt = [], [], []
    for n, off in ((n1, 0), (n2, n1)):
        d = rng.zipf(1.35, 8 * n_cis // 3)
        d = d[d < n][:n_cis]
        i = rng.integers(0, n, len(d)) + off
        j = np.minimum(i + d, off + n - 1)
        pix1.append(i)
        pix2.append(j)
        cnt.append(rng.poisson(3.0, len(d)) + 1)
    pix1.append(rng.integers(0, n1, n_trans))
    pix2.append(rng.integers(n1, n1 + n2, n_trans))
    cnt.append(rng.poisson(1.0, n_trans) + 1)
    weights = rng.uniform(0.5, 1.5, n1 + n2)
    weights[rng.random(n1 + n2) < 0.03] = np.nan
    return Cooler.from_arrays(
        {"chr1": n1 * binsize, "chr2": n2 * binsize}, binsize,
        (np.concatenate(pix1), np.concatenate(pix2), np.concatenate(cnt)),
        weights=weights,
    )


def all_row(pups):
    """The 'all' row of a pileup table (by-window tables mark it in
    ``chrom``)."""
    key = "group" if "group" in pups.columns else "chrom"
    return pups.loc[pups[key] == "all"].iloc[0]


def engine_snips(pups):
    """ROI n + control_n of the 'all' row (bench_engine's count)."""
    row = pups.loc[pups["orientation"] == "all"].iloc[0]
    return int(row["n"]) + int(row["control_n"])


def toy_tads():
    """Toy TADs for the rescale modes: toy_features() 3 Mb wide (as
    tests/test_combo_matrix.py widens them)."""
    feats = toy_features()
    return feats.assign(end=feats["start"] + 3_000_000)


def toy_chrom_view(clr):
    """The toy map's whole chromosomes as a view, named after them."""
    import pandas as pd

    return pd.DataFrame({"chrom": list(clr.chromsizes),
                         "start": [0] * len(clr.chromsizes),
                         "end": list(clr.chromsizes.values()),
                         "name": list(clr.chromsizes)})


def rescale_wide_inputs(group, name, clr, dense, weights):
    """``(features, view, pileup() keywords)`` of one RESCALE_MODES or
    WIDE_MODES entry on the toy map."""
    if group == "rescale":
        kw = dict(RESCALE_KW, **RESCALE_MODES[name])
        features, view = toy_tads(), toy_regions()
    else:
        kw = dict(WIDE_KW, **WIDE_MODES[name])
        features, view = toy_features(), toy_chrom_view(clr)
    if kw.pop("features", None) == "bedpe":
        bp = toy_bedpe()
        features = bp.assign(end1=bp["start1"] + 2_000_000,
                             end2=bp["start2"] + 2_000_000)
        kw["features_format"] = "bedpe"
    if kw.get("expected_df") is True:
        kw["expected_df"] = toy_expected(clr, dense, weights, view)
    return features, view, kw


def rescale_workload(n_tads=2_000, n_bins=20_000, n_contacts=12_000_000,
                     seed=0):
    """``bench.py --rescale``'s inputs (``bench_rescale``) with its RNG
    calls: the engine map (``_bench_cooler``) and ``n_tads`` TADs 20-200
    bins wide at sorted distinct starts. Returns ``(Cooler, features)``."""
    import pandas as pd

    clr = bench_cooler(np.random.default_rng(0), n_bins, n_contacts)
    binsize = clr.binsize
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(np.arange(100, clr.n_bins - 300), n_tads,
                                replace=False)) * binsize
    widths = rng.integers(20, 200, n_tads) * binsize
    return clr, pd.DataFrame({"chrom": "chr1", "start": starts,
                              "end": starts + widths})


def resize_op32(n_in, R):
    """The area-overlap operator [R, n_in] built with the float32 steps of
    ``ops/rescale.resize_matrix`` (numpy float32 arithmetic), returned as
    float64. Where an output cell's edge falls on an input cell's edge,
    float32 rounding leaves an overlap of up to ~1e-5 that the exact
    operator (``area_resize_host``) does not have, and that overlap decides
    whether a NaN pixel there touches the output pixel: the host loop uses
    the device's operator so that counts compare exactly."""
    f32 = np.float32
    i = np.arange(R, dtype=f32)[:, None]
    k = np.arange(n_in, dtype=f32)[None, :]
    cell = f32(n_in) * (f32(1) / f32(R))
    overlap = np.maximum(f32(0), np.minimum((i + f32(1)) * cell, k + f32(1))
                         - np.maximum(i * cell, k))
    return (overlap / max(cell, f32(1e-30))).astype(np.float64)


def rescale_host_oracle(clr, feats, R, expected=None, ignore_diags=2):
    """``bench.py``'s reference-style host loop (bench.py:387-414) as the
    engine defines a rescaled local pileup: per TAD (``rescale_flank=1``)
    the CSR slice of the balanced map, bad bins and |diag| < ignore_diags
    NaN, division by the expected of each diagonal when ``expected`` (a
    by-distance table) is given, symmetrization, and the NaN-aware area
    resize in float64 with the engine's rules (``resize_op32``): an output
    pixel the resized NaN plane touches by more than 1e-6 adds nothing, an
    all-NaN snip adds 0 with count 1. Returns the per-pixel mean (then
    symmetrized, as the engine finalizes local pileups) and count."""
    import warnings

    from coolpuppy_tpu_torch.ops.rescale import TOUCH_EPS

    csr = clr.fetch_coo("chr1", balance="weight").tocsr()
    bad = clr.bad_bin_mask("chr1")
    evec = None
    if expected is not None:
        evec = np.full(clr.n_bins, np.nan)
        evec[expected["dist"].to_numpy(int)] = expected["balanced.avg"]
    total = np.zeros((R, R))
    count = np.zeros((R, R))
    bs = clr.binsize
    for st, en in zip(feats["start"] // bs, feats["end"] // bs):
        w = int(en - st)
        lo, hi = int(st) - w, int(en) + w
        if lo < 0 or hi > clr.n_bins:
            continue
        data = csr[lo:hi, lo:hi].toarray().astype(float)
        data[bad[lo:hi], :] = np.nan
        data[:, bad[lo:hi]] = np.nan
        d = np.abs(np.subtract.outer(np.arange(hi - lo), np.arange(hi - lo)))
        data[d < ignore_diags] = np.nan
        if evec is not None:
            with np.errstate(divide="ignore", invalid="ignore"):
                data = data / evec[d]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            data = np.nanmean(np.dstack((data, data.T)), 2)
        nans = ~np.isfinite(data)
        if nans.all():
            count += 1
            continue
        op = resize_op32(hi - lo, R)
        rs = op @ np.where(nans, 0.0, data) @ op.T
        touched = op @ nans.astype(float) @ op.T > TOUCH_EPS
        total += np.where(touched, 0.0, rs)
        count += ~touched
    with np.errstate(divide="ignore", invalid="ignore"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        mean = total / count
        mean = np.nanmean(np.dstack((mean, mean.T)), 2)
    return mean, count


def check_oracle(table, want, what):
    """The 'all' row of a pileup table against a host oracle's (mean,
    count): count and mean within ORACLE_RTOL, NaN positions equal."""
    row = all_row(table)
    mean, count = want
    np.testing.assert_allclose(np.asarray(row["num"], float), count,
                               rtol=ORACLE_RTOL, atol=0,
                               err_msg=f"{what}: count")
    np.testing.assert_allclose(np.asarray(row["data"], float), mean,
                               rtol=ORACLE_RTOL, atol=1e-9, equal_nan=True,
                               err_msg=f"{what}: mean")
    fin = np.isfinite(mean)
    err = float(np.abs(np.asarray(row["data"], float)[fin]
                       - mean[fin]).max(initial=0.0))
    return err, int(fin.sum())


def compare_wide(got, want, what, rtol=WIDE_RTOL, atol=1e-6):
    """The wide kernel's accumulators (and stripes) against the plain
    version's: ``num`` and ``poison`` exact, ``sum`` within tolerance,
    stripe planes bit for bit with NaN positions equal. Returns the largest
    absolute difference of the sums."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: keys {sorted(got)} vs {sorted(want)}")
    for k in ("num", "poison"):
        g, w = got[k].cpu().numpy(), want[k].cpu().numpy()
        if not np.array_equal(g, w):
            raise AssertionError(f"{what}: {k} differs at "
                                 f"{int((g != w).sum())} entries")
    gs, ws = got["sum"].cpu().numpy(), want["sum"].cpu().numpy()
    if not np.isfinite(gs).all() or not np.isfinite(ws).all():
        raise AssertionError(f"{what}: a sum is not finite")
    np.testing.assert_allclose(gs, ws, rtol=rtol, atol=atol, err_msg=what)
    for k in ("horizontal_stripe", "vertical_stripe"):
        if k in got:
            np.testing.assert_array_equal(got[k].cpu().numpy(),
                                          want[k].cpu().numpy(),
                                          err_msg=f"{what} {k}")
    return float(np.abs(gs - ws).max(initial=0.0))


def wide_case(W, seed, n_snips=60, groups=4, missing=2, long_run=0):
    """A wide-kernel input on the CPU: a normalized cis stack of W + 330
    bins with +inf poison (zero ``evec`` entries) and NaN-masked bins, a
    snip stream whose windows cross tile edges, a tile that holds snips of
    every group, ``long_run`` more snips in the first tile and the last
    group (a run cut into items at ``ITEM_MAX``), and ``missing`` tiles the
    windows touch removed from the map (slot 0, all NaN). Returns
    ``(stiles, tile_map, r1, r2, cid)`` as CPU tensors (int64 map and
    snips)."""
    from scipy import sparse as sp

    from coolpuppy_tpu_torch.ops.tiles import build_tile_stack, normalized_stack

    rng = np.random.default_rng(seed)
    n = W + 330
    dense = rng.gamma(1.0, 1.0, (n, n)) * (rng.random((n, n)) < 0.3)
    dense = np.triu(dense) + np.triu(dense, 1).T
    r1 = rng.integers(0, n - W + 1, n_snips)
    r2 = rng.integers(0, n - W + 1, n_snips)
    r1[:8], r2[:8] = 3 + np.arange(8), 5 + np.arange(8)  # one tile
    r1[8:12] = (0, 127, 128, n - W)
    cid = rng.integers(0, groups, n_snips)
    cid[:8] = np.arange(8) % groups
    # the long run's windows at offsets drawn in the first tile: one window
    # repeated a thousand times would add one value to itself in float32,
    # whose rounding error grows with the count in any order of adds
    r1 = np.r_[r1, rng.integers(0, B, long_run)]
    r2 = np.r_[r2, rng.integers(0, B, long_run)]
    cid = np.r_[cid, np.full(long_run, groups - 1)]
    ts = build_tile_stack(sp.coo_matrix(dense), B, r1=r1, r2=r2, window1=W,
                          window2=W)
    valid = np.zeros(n + 512, np.float32)
    valid[:n] = rng.random(n) > 0.05
    evec = np.full(n + 512, np.nan, np.float32)
    evec[:n] = 4.0 / (1.0 + np.arange(n))
    evec[rng.integers(3, n, 3)] = 0.0
    stiles = normalized_stack(ts, valid, valid, evec, "cpu", ooe=True,
                              cis=True, ignore_diags=2)
    tmap = np.asarray(ts.tile_map, np.int64).copy()
    used = np.flatnonzero(tmap.ravel())
    tmap.ravel()[rng.choice(used, missing, replace=False)] = 0
    return (stiles, *(torch.from_numpy(np.asarray(a, np.int64))
                      for a in (tmap, r1, r2, cid)))


def wide_kernel_cases():
    """The wide kernel's cases: ``(name, W, C, case)`` per WIDE_KERNEL_W, with
    ``case`` a ``wide_case`` of WIDE_CASE_SNIPS snips in 5 groups and 3
    missing tiles; at W = 201 and 401 a run of ``ITEM_MAX + 77`` more snips
    in one tile and group."""
    from coolpuppy_tpu_torch.ops.gather import ITEM_MAX

    for i, W in enumerate(WIDE_KERNEL_W):
        long_run = ITEM_MAX + 77 if W in (201, 401) else 0
        yield (f"W={W}", W, 8, wide_case(W, 300 + i, n_snips=WIDE_CASE_SNIPS,
                                          groups=5, missing=3,
                                          long_run=long_run))


def check_wide_case(name, W, C, case, dev):
    """One wide kernel case on ``dev``: ``generic_accumulate`` with stripes
    (the wide kernel on a card: it must launch once) against
    ``generic_accumulate_plain`` on the same tensors (``compare_wide``).
    Returns ``(max_abs_err, launches, want)``."""
    import coolpuppy_tpu_torch.ops.gather as ga

    args = tuple(x.to(dev) for x in case)
    want = ga.generic_accumulate_plain(*args, W, C, stripes=True)
    before = ga.LAUNCHES
    got = ga.generic_accumulate(*args, W, C, stripes=True)
    launches = ga.LAUNCHES - before
    if launches != 1:
        raise AssertionError(f"wide kernel {name}: {launches} launches; "
                             "the kernel did not run")
    err = compare_wide(got, want, what=f"wide kernel vs plain {name}")
    return err, launches, want


def center_snip(snip):
    """bench_extension's per-snip hook: the nansum of a central block (rows
    and columns 8:13 of a 21-bin window; the toy's whole 5-bin window)."""
    lo = 8 if snip["data"].shape[0] > 13 else 0
    snip["center"] = float(np.nansum(snip["data"][lo : lo + 5, lo : lo + 5]))
    yield snip


def center_batch(frame, data):
    """bench_extension's batch hook: ``center_snip`` for a whole chunk."""
    lo = 8 if data.shape[1] > 13 else 0
    frame = frame.copy(deep=False)
    frame["center"] = np.nansum(data[:, lo : lo + 5, lo : lo + 5],
                                axis=(1, 2))
    return frame


def domain_score(snip):
    from coolpuppy_tpu_torch.lib.numutils import get_domain_score

    snip["domain_score"] = get_domain_score(snip["data"], 1)
    return snip


def per_anchor(snip):
    """One copy of the snip per anchor, grouped by the anchor's window (the
    reference's per-snip ``group_by_region`` pattern)."""
    for side in ("1", "2"):
        yield dict(snip, group=tuple(
            snip[c + side] for c in ("chrom", "start", "end")))


def count_snips(acc, snip):
    """An opaque extra sum func: no ``accumulate_values`` partial, so the
    strictly per-snip host fold."""
    acc["snipcount"] = acc.get("snipcount", 0) + 1
    return acc


def hook_run_kwargs(run):
    """``pileupsWithControl`` keywords of a HOOK_MODES ``run`` entry, with
    the hooks and extras resolved by name."""
    from functools import partial

    from coolpuppy_tpu_torch.lib.puputils import (
        accumulate_values,
        group_by_region_frame,
    )

    hooks = {"group_by_region": group_by_region_frame, "noop": lambda s: s,
             "center_snip": center_snip, "center_batch": center_batch,
             "domain_score": domain_score, "per_anchor": per_anchor}
    kw = {k: hooks.get(v, v) if isinstance(v, str) else v
          for k, v in run.items() if k != "extras"}
    key = run.get("extras")
    if key == "count_snips":
        kw["extra_sum_funcs"] = {"snipcount": count_snips}
    elif key:
        kw["extra_sum_funcs"] = {key: partial(accumulate_values, key=key)}
    return kw


def hook_mode_table(name, clr, dense, weights, device):
    """One HOOK_MODES entry on the toy map on ``device``."""
    from coolpuppy_tpu_torch import CoordCreator, PileUpper

    spec = HOOK_MODES[name]
    kind = spec.get("features", "bed")
    if kind == "bed":
        features = toy_features().assign(score=[1.5, 2.5, 3.5, 4.5, 5.5, 6.5])
    elif kind == "tads":
        features = toy_tads()
    else:
        features = toy_bedpe()
        if kind == "bedpe_tads":
            features = features.assign(end1=features["start1"] + 2_000_000,
                                       end2=features["start2"] + 2_000_000)
    cc_kw = dict(features_format="bedpe" if "bedpe" in kind else "bed",
                 mindist=0, nshifts=0)
    cc_kw.update(spec.get("cc", {}))
    if "rescale_flank" not in cc_kw:
        cc_kw["flank"] = TOY_KW["flank"]
    pu_kw = dict(spec.get("pu", {}))
    if pu_kw.get("expected") is True:
        pu_kw["expected"] = toy_expected(clr, dense, weights, toy_regions())
    cc = CoordCreator(features, clr.binsize, **cc_kw)
    pu = PileUpper(clr, cc, view_df=toy_regions(),
                   control=cc_kw["nshifts"] > 0, device=device, **pu_kw,
                   **F32_WIRE)
    if spec.get("by_window"):
        return pu.pileupsByWindowWithControl()
    return pu.pileupsWithControl(**hook_run_kwargs(spec.get("run", {})))


def extension_workload(n_big=EXTENSION_SITES[0], n_small=EXTENSION_SITES[1],
                       n_bins=20_000, n_contacts=12_000_000, seed=0):
    """``bench.py:575`` ``bench_extension``'s inputs with its RNG calls: the
    engine map (``_bench_cooler``), then ``make_feats(20_000)`` and
    ``make_feats(6_000)`` from one generator: sorted distinct starts, a
    score in [0, 1) rounded to 4 places, a strand. Returns ``(Cooler,
    feats_big, feats_small)``."""
    import pandas as pd

    clr = bench_cooler(np.random.default_rng(0), n_bins, n_contacts)
    length = clr.n_bins * clr.binsize
    rng = np.random.default_rng(seed)

    def make_feats(n):
        starts = np.sort(rng.choice(length - 10_000, n, replace=False))
        return pd.DataFrame({
            "chrom": "chr1", "start": starts, "end": starts + 1_000,
            "name": ".", "score": rng.uniform(0, 1, n).round(4),
            "strand": rng.choice(["+", "-"], n),
        })

    return clr, make_feats(n_big), make_feats(n_small)


def extension_run(clr, feats, route, device, **wire):
    """One ``bench_extension`` run of ``route`` ("frame", "batch" or
    "snip"), with the wire keywords ``wire``: ``(PileUpper, table)``."""
    from coolpuppy_tpu_torch import CoordCreator, PileUpper

    run = {"frame": {"extras": "score1"},
           "batch": {"postprocess_batch_func": "center_batch",
                     "extras": "center"},
           "snip": {"postprocess_snip_func": "center_snip",
                    "extras": "center"}}[route]
    cc = CoordCreator(feats, clr.binsize, **EXTENSION_KW)
    pu = PileUpper(clr, cc, expected=False, control=False, device=device,
                   **wire)
    return pu, pu.pileupsWithControl(**hook_run_kwargs(run))


def kernel_run(what, run):
    """A checked run that must go through the quad kernel: the launch count
    set to 0 just before it and read just after. Returns ``(table,
    launches)``."""
    import coolpuppy_tpu_torch.ops.quad_gather as qg

    qg.LAUNCHES = 0
    table = run()
    launches = qg.LAUNCHES
    route = table["accumulate"].iloc[0]
    if launches < 1 or route != "cuda_kernel":
        raise AssertionError(f"{what}: {launches} launches, route {route!r}; "
                             "the kernel did not run")
    return table, launches


def plain_swapped(what, run, route="plain"):
    """``run`` with ``quad_accumulate`` swapped for the plain version: no
    launch, route ``route`` (``plain``; a run whose regions take other
    routes too names them all)."""
    import coolpuppy_tpu_torch.ops.quad_gather as qg

    kernel = qg.quad_accumulate
    qg.quad_accumulate = qg.quad_accumulate_plain
    try:
        qg.LAUNCHES = 0
        table = run()
        launches = qg.LAUNCHES
    finally:
        qg.quad_accumulate = kernel
    if launches != 0 or table["accumulate"].iloc[0] != route:
        raise AssertionError(f"{what}: plain-swapped run launched {launches}")
    return table


def bedpe_window_workload(clr, n_sites=BEDPE_WINDOW_SITES, seed=1):
    """``n_sites`` 1 kb sites on ``clr``'s chromosome and every pair of
    them whose centres lie within BEDPE_WINDOW_KW's ``maxdist``, first
    before second, as BEDPE rows in coordinate order. Returns ``(features,
    bedpe)``."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    length = clr.n_bins * clr.binsize
    starts = np.sort(rng.choice(length - 10_000, n_sites, replace=False))
    feats = pd.DataFrame({"chrom": "chr1", "start": starts,
                          "end": starts + 1_000})
    last = np.searchsorted(starts, starts + BEDPE_WINDOW_KW["maxdist"],
                           side="right")
    counts = last - np.arange(n_sites) - 1
    i = np.repeat(np.arange(n_sites), counts)
    j = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts,
                                            counts) + i + 1
    bedpe = pd.DataFrame({
        "chrom1": "chr1", "start1": starts[i], "end1": starts[i] + 1_000,
        "chrom2": "chr1", "start2": starts[j], "end2": starts[j] + 1_000,
    })
    return feats, bedpe


# the coolpup-torch CLI (``cli/coolpup_cli.pileup_from_args``): its flag
# sets on the toy map, card against CPU. Each set is the
# features argument and its flags; CLI_TOY_ARGS follow them. "{name}" is a
# file of write_cli_inputs, and "-" reads the BED file from standard input.
# The toy's windows are 5 bins wide, so every set but the rescaled one
# takes the quad kernel on the card (CLI_ROUTES)
CLI_TOY_ARGS = ("--view", "{regions}", "--flank", "2000000", "--mindist",
                "0", "--seed", "0")
CLI_FLAG_SETS = {
    "bed": ("{bed}",),
    "bed_header": ("{bed_header}",),
    "bedpe": ("{bedpe}", "--features_format", "bedpe"),
    "stdin": ("-", "--features_format", "bed"),
    "by_strand": ("{bed}", "--by_strand", "--nshifts", "1"),
    "expected_column": ("{bed}", "--expected", "{expected}::balanced.avg"),
    "expected_index": ("{bed}", "--expected", "{expected}::6"),
    "by_distance": ("{bed}", "--by_distance"),
    "by_distance_edges": ("{bed}", "--by_distance", "0", "4000000",
                          "50000000"),
    "groupby": ("{bed}", "--groupby", "name1", "name2"),
    "flip_negative_strand": ("{bed}", "--flip_negative_strand",
                             "--by_strand"),
    "by_window": ("{bed}", "--by_window"),
    "trans": ("{bed}", "--trans"),
    "store_stripes": ("{bed}", "--store_stripes"),
    "local_rescale": ("{tads}", "--local", "--rescale", "--rescale_size",
                      "9"),
    "coverage_norm": ("{bed}", "--coverage_norm", "--clr_weight_name"),
    "not_ooe": ("{bed}", "--expected", "{expected}", "--not_ooe"),
    "unbalanced": ("{bed}", "--clr_weight_name", "--nshifts", "2"),
}
CLI_ROUTES = {"local_rescale": "rescale_torch"}
# sets that both packages refuse, with the error: ``validate_csv`` turns a
# column index into an int that ``read_expected_from_file`` then looks up
# as a column name (the JAX package does the same)
CLI_REFUSED = {"expected_index": "expected lacks value column 6"}
# bench.py --engine's cell (ENGINE_KW) through the CLI's flags, without
# and with an expected file
CLI_ENGINE_ARGS = ("--flank", "100000", "--maxdist", "2000000", "--nshifts",
                   "1", "--seed", "0", "--by_strand")


def write_cli_inputs(d, clr, dense, weights):
    """Write the inputs of CLI_FLAG_SETS for the toy map into directory
    ``d``: the toy features (names alternating "a" and "b", distinct scores)
    as BED without and with a header line, the toy BEDPE rows, the toy TADs,
    the toy view and its expected table (TSV). Returns the paths by name;
    ``cool`` names the map (held in memory, not written)."""
    paths = {name: os.path.join(d, f) for name, f in (
        ("cool", "toy.cool"), ("bed", "features.bed"),
        ("bed_header", "features_header.bed"), ("bedpe", "loops.bedpe"),
        ("tads", "tads.bed"), ("regions", "regions.bed"),
        ("expected", "expected.tsv"))}
    feats = toy_features().assign(name=["a", "b"] * 3, score=np.arange(6))
    bed = dict(sep="\t", header=False, index=False)
    feats.to_csv(paths["bed"], **bed)
    feats.to_csv(paths["bed_header"], sep="\t", index=False)
    toy_bedpe().to_csv(paths["bedpe"], **bed)
    toy_tads().to_csv(paths["tads"], **bed)
    toy_regions().to_csv(paths["regions"], **bed)
    toy_expected(clr, dense, weights, toy_regions()).to_csv(
        paths["expected"], sep="\t", index=False)
    return paths


def cli_argv(name, paths):
    """The coolpup-torch arguments of one CLI_FLAG_SETS entry."""
    features, *flags = CLI_FLAG_SETS[name]
    return [a.format(**paths)
            for a in ("{cool}", features, *flags, *CLI_TOY_ARGS)]


def cli_pileup(argv, clr, stdin_path=None):
    """``pileup_from_args`` on the parsed ``argv`` and ``clr``: ``(pups,
    outname)``. Features given as "-" are read from ``stdin_path``."""
    from coolpuppy_tpu_torch.cli.coolpup_cli import (
        parse_args_coolpuppy,
        pileup_from_args,
    )

    args = parse_args_coolpuppy().parse_args(argv)
    if args.features != "-":
        return pileup_from_args(args, clr)
    stdin = sys.stdin
    with open(stdin_path) as f:
        sys.stdin = f
        try:
            return pileup_from_args(args, clr)
        finally:
            sys.stdin = stdin


class cli_probe:
    """During a block, record the keywords ``pileup_from_args`` passes to
    ``pileup()`` (``pileup_kw``)."""

    def __enter__(self):
        self.cli = importlib.import_module(
            "coolpuppy_tpu_torch.cli.coolpup_cli")
        self.inner = inner = self.cli.pileup
        probe = self

        def recording_pileup(**kw):
            probe.pileup_kw = kw
            return inner(**kw)

        self.cli.pileup = recording_pileup
        return self

    def __exit__(self, *exc):
        self.cli.pileup = self.inner


def cli_snips(pups):
    """ROI n + control_n of the 'all' orientation (``engine_snips``; no
    control_n without controls)."""
    row = pups.loc[pups["orientation"] == "all"].iloc[0]
    return int(row["n"]) + (int(row["control_n"])
                            if "control_n" in pups.columns else 0)


def genome_workload(n_chroms=20, bins_per=13_500, contacts_per=7_500_000,
                    n_sites=37_000, binsize=10_000, seed=0):
    """``bench.py:866`` ``bench_genome``'s map and sites with its RNG calls,
    as an in-memory Cooler: ``n_chroms`` chromosomes of ``bins_per`` bins
    at 10 kb, ``contacts_per`` zipf(1.35) contacts each (bench's 18M draws
    scale with it), Poisson(3)+1 counts, 3% NaN-weight bins; ``n_sites``
    stranded 1 kb sites, an equal share per chromosome at sampled bins. Each
    chromosome's pixels are sorted on their own, so ``from_arrays`` finds
    them in order (and skips its own sort). Returns ``(Cooler,
    features)``."""
    import pandas as pd

    from coolpuppy_tpu_torch import Cooler

    chroms = [f"chr{i + 1}" for i in range(n_chroms)]
    rng = np.random.default_rng(seed)
    pix1, pix2, cnt = [], [], []
    off = 0
    for _ in chroms:
        d = rng.zipf(1.35, contacts_per * 12 // 5)
        d = d[d < bins_per][:contacts_per]
        i = rng.integers(0, bins_per, len(d)) + off
        j = np.minimum(i + d, off + bins_per - 1)
        v = rng.poisson(3.0, len(d)) + 1
        if v.max(initial=0) >= 256:
            raise AssertionError("genome_workload: a count past 8 bits")
        # one sort of (bin1, bin2, count) packed in an int64 (4x faster than
        # an argsort); duplicate pixels end up ordered by count
        key = np.sort(((i - off) * bins_per + (j - off)) << 8 | v)
        ij = key >> 8
        pix1.append(ij // bins_per + off)
        pix2.append(ij % bins_per + off)
        cnt.append((key & 0xFF).astype(np.int32))
        off += bins_per
    weights = rng.uniform(0.5, 1.5, off)
    weights[rng.random(off) < 0.03] = np.nan
    clr = Cooler.from_arrays(
        {c: bins_per * binsize for c in chroms}, binsize,
        (np.concatenate(pix1), np.concatenate(pix2), np.concatenate(cnt)),
        weights=weights,
    )
    del pix1, pix2, cnt
    per = n_sites // n_chroms
    rng_f = np.random.default_rng(seed + 1)
    frames = []
    bins_ok = np.arange(1, bins_per - 2)
    for c in chroms:
        starts = np.sort(rng_f.choice(bins_ok, per, replace=False)) * binsize
        frames.append(pd.DataFrame({
            "chrom": c, "start": starts, "end": starts + 1_000,
            "name": ".", "score": 0,
            "strand": rng_f.choice(["+", "-"], per),
        }))
    return clr, pd.concat(frames, ignore_index=True)


def genome_run(clr, feats, dev, mesh=None, **kw):
    """One genome-cell run: the PileUpper that ``pileup(**GENOME_KW)``
    builds, by strand, on ``mesh`` where given. Returns ``(PileUpper,
    table)``."""
    from coolpuppy_tpu_torch import CoordCreator, PileUpper

    args = dict(GENOME_KW, **kw)
    del args["by_strand"]
    nshifts = args.pop("nshifts")
    cc = CoordCreator(feats, clr.binsize, nshifts=nshifts, **args)
    pu = PileUpper(clr, cc, control=nshifts > 0, device=dev, mesh=mesh)
    return pu, pu.pileupsByStrandWithControl()


class collected_path:
    """Every region on the collected two-phase path: no stream opens."""

    def __enter__(self):
        self.eng = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")
        self.saved = self.eng.PileUpper._maybe_open_stream
        self.eng.PileUpper._maybe_open_stream = lambda *a, **k: None
        return self

    def __exit__(self, *exc):
        self.eng.PileUpper._maybe_open_stream = self.saved


def scatter_f32_in_order(slab, tmap, B, K):
    """What the native scatter computes for an unmirrored slab where it adds
    in input order (its two-pass branch, past 2^19 pixels; any branch at
    one thread), in numpy: weights folded in float32 as ``v * (w[row] *
    w[col])``, each cell's pixels added in float32 in input order
    (``np.add.at``)."""
    n1, n2 = slab.shape
    rows, cols = slab.rows - slab.lo1, slab.cols - slab.lo2
    vals = slab.vals.astype(np.float32)
    if slab.weights is not None:
        w = slab.weights.astype(np.float32)
        vals = vals * (w[slab.rows] * w[slab.cols])
    inb = (rows >= 0) & (rows < n1) & (cols >= 0) & (cols < n2)
    rows, cols, vals = rows[inb], cols[inb], vals[inb]
    k = tmap[rows // B, cols // B].astype(np.int64)
    keep = k > 0
    flat = np.zeros((K + 1) * B * B, np.float32)
    np.add.at(flat, (k * B + rows % B)[keep] * B + (cols % B)[keep],
              vals[keep])
    return flat.reshape(K + 1, B, B)


# the mesh: per mode, the map ("toy": toy_cooler() with toy_features() in the toy
# view; "dry": the dry run's 1,408 + 704-bin map and its 72 sites,
# parallel/dryrun.py, whose chr1 bands over 2 and 4 devices), the pileup()
# keywords ("expected_df": True for the toy expected table), BEDPE rows
# (toy_bedpe()), engine constants for the mode (a block of 8 groups at
# W = 7), whether a region must band, and the route on the card
MESH_SIZES = (2, 4)
MESH_MODES = {
    "cis_banded": dict(map="dry", kw=dict(
        flank=3_000_000, mindist=0, maxdist=120_000_000, nshifts=1, seed=0,
        by_strand=True), banded=True),
    "cis_replicated": dict(map="toy", kw=dict(TOY_KW, nshifts=1, seed=0,
                                               by_strand=True)),
    "expected": dict(map="toy", kw=dict(TOY_KW, expected_df=True)),
    "coverage": dict(map="toy", kw=dict(TOY_KW, clr_weight_name=None,
                                        coverage_norm=True)),
    "trans": dict(map="dry", kw=dict(flank=3_000_000, nshifts=1, seed=0,
                                     trans=True), banded=True),
    "rescale": dict(map="toy", kw=dict(RESCALE_KW, local=True),
                    route="rescale_torch"),
    "wide_banded": dict(map="dry", kw=dict(
        flank=61_000_000, mindist=0, maxdist=200_000_000, nshifts=1, seed=0,
        by_strand=True), banded=True, route="generic"),
    "wide_replicated": dict(map="toy_whole", kw=dict(WIDE_KW, nshifts=1,
                                                      seed=0, by_strand=True),
                            route="generic"),
    "stripes_banded": dict(map="dry", kw=dict(
        flank=3_000_000, mindist=0, maxdist=60_000_000, store_stripes=True),
        banded=True),
    "stripes_replicated": dict(map="toy", kw=dict(TOY_KW,
                                                   store_stripes=True)),
    "by_window_blocked": dict(map="dry", kw=dict(
        flank=3_000_000, mindist=0, maxdist=60_000_000, nshifts=1, seed=0,
        by_window=True), patch={"_BLOCK_BYTES": 2 * 7 * 7 * 8 * 8},
        banded=True),
    "bedpe": dict(map="toy", kw=dict(TOY_KW, features_format="bedpe"),
                  bedpe=True),
}
# the genome cell on meshes of these sizes
GENOME_MESH_SIZES = (1, 2, 4)
# bench.py:673 bench_scaling's workload through the mesh session alone
SCALING_LOCI = 262_144
# two ranks on the card: each builds this genome map (the genome
# cell's chromosome size and sites per chromosome) and gets this long
RANK_WORKLOAD = dict(n_chroms=4, n_sites=7_400)
RANK_SECONDS = 600
RANK_RTOL = 1e-5


class last_upper:
    """The ``PileUpper`` whose ``pileupsWithControl`` runs last in a block
    (``pu``): ``pileup()`` builds its own, and its counters and
    ``mesh_stats`` are read after the call."""

    def __enter__(self):
        eng = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")
        self.cls = eng.PileUpper
        self.saved = inner = self.cls.pileupsWithControl
        self.pu = None
        outer = self

        def recording(pu, *args, **kw):
            outer.pu = pu
            return inner(pu, *args, **kw)

        self.cls.pileupsWithControl = recording
        return self

    def __exit__(self, *exc):
        self.cls.pileupsWithControl = self.saved


def mesh_maps():
    """The two maps of ``MESH_MODES``: name -> (Cooler, features, view,
    expected table)."""
    from coolpuppy_tpu_torch.parallel.dryrun import toy_map, toy_sites

    clr, dense, weights = toy_cooler()
    return {
        "toy": (clr, toy_features(), toy_regions(),
                toy_expected(clr, dense, weights, toy_regions())),
        "toy_whole": (clr, toy_features(), toy_chrom_view(clr), None),
        "dry": (toy_map(), toy_sites(), None, None),
    }


def mesh_mode_run(name, maps, device, mesh=None):
    """One ``MESH_MODES`` entry through ``pileup()`` on ``device`` (and
    ``mesh``). Returns ``(PileUpper, table)``."""
    from coolpuppy_tpu_torch import pileup

    spec = MESH_MODES[name]
    clr, feats, view, expected = maps[spec["map"]]
    kw = dict(spec["kw"])
    if kw.get("expected_df") is True:
        kw["expected_df"] = expected
    if spec.get("bedpe"):
        feats = toy_bedpe()
    with engine_patch(**spec.get("patch", {})), last_upper() as cap:
        table = pileup(clr, feats, view_df=view, device=device, mesh=mesh,
                       **kw, **F32_WIRE)
    return cap.pu, table


def scaling_workload(n_loci=SCALING_LOCI, **kw):
    """``bench.py:673`` ``bench_scaling``'s inputs at its size:
    ``make_workload`` at ``n_loci`` loci and W = 21 (``kw``: its other
    sizes), with the port's dense B=128 stack of the touched tiles. Returns
    ``(TileStack, r1, r2, cid, valid, evec)``, ``cid`` the group plus 4 for
    a flipped snip."""
    from bench import make_workload
    from coolpuppy_tpu_torch import build_tile_stack

    _, coo, r1, r2, gid, flip, valid, evec = make_workload(
        n_loci=n_loci, W=21, **kw)
    ts = build_tile_stack(coo, B, r1=r1, r2=r2, window1=21, window2=21)
    return ts, r1, r2, (gid + 4 * flip).astype(np.int32), valid, evec


def map_hash(clr, feats):
    """A sha256 of a map's pixels and weights and of the sites."""
    import hashlib

    h = hashlib.sha256()
    for a in clr.pixels_chunk(0, clr.n_pixels):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(np.ascontiguousarray(
        clr.bins_df()["weight"].to_numpy()).tobytes())
    h.update(feats.to_csv(index=False).encode())
    return h.hexdigest()


def rank_main(rank, port, out, device, workload):
    """One rank of a two-rank genome run: joins the gloo group of two
    ranks, builds the genome map of ``workload`` from seed 0, checks that
    both ranks hold the same map (their hashes over ``all_gather_object``),
    runs the genome cell on its loci mesh (``make_loci_mesh()`` on the
    card, one CPU device for ``device="cpu"``) and prints its region pairs;
    rank 0 writes its table's groups, ``n`` and ``data`` to ``out``."""
    import datetime

    import torch.distributed as dist

    from coolpuppy_tpu_torch.parallel import (
        LociMesh,
        init_distributed,
        local_region_pairs,
        make_loci_mesh,
    )

    init_distributed(init_method=f"tcp://localhost:{port}", world_size=2,
                     rank=rank, timeout=datetime.timedelta(
                         seconds=RANK_SECONDS // 2))
    try:
        clr, feats = genome_workload(**workload)
        hashes = [None, None]
        dist.all_gather_object(hashes, map_hash(clr, feats))
        if hashes[0] != hashes[1]:
            raise AssertionError(f"rank {rank}: the ranks' maps differ")
        mesh = (make_loci_mesh() if device == "cuda"
                else LociMesh([device]))
        pu, table = genome_run(clr, feats, mesh.devices[0], mesh=mesh)
        pairs = local_region_pairs(pu._region_pairs())
        print(f"rank {rank}: map {hashes[rank][:12]} equal on both ranks; "
              f"mesh {[str(d) for d in mesh.devices]}; region pairs {pairs} "
              f"({len(pairs)}); {engine_snips(table)} snips", flush=True)
        if rank == 0:
            np.savez(out, groups=np.asarray([str(g) for g in table["group"]]),
                     n=table["n"].to_numpy(float),
                     control_n=table["control_n"].to_numpy(float),
                     data=np.stack([np.asarray(d, float)
                                    for d in table["data"]]))
    finally:
        dist.destroy_process_group()


# the seeded fuzz search: FUZZ_CARD_SEEDS at FUZZ_ENGINE's scale through
# the reader's fetch path, tests/test_torch_fuzz.py's FUZZ_SEEDS at
# FUZZ_TOY's against the JAX package on the CPU. Scales: the chromosomes, the site
# count, the start range in units (plus 0 or half a unit), the flank range
# in flank units, TAD widths in units, the kinds of case drawn from, and
# keywords every case takes
FUZZ_SEEDS = tuple(range(1000, 1016))
FUZZ_CARD_SEEDS = FUZZ_SEEDS[:8]
FUZZ_KINDS = ("bed", "by_window", "bedpe", "trans", "local_rescale")
FUZZ_TOY = dict(chroms=("chr1", "chr2"), n=(6, 30), start=(101, 148),
                unit=1_000_000, flank=(2, 4), flank_unit=1_000_000,
                tad=(3, 8), kinds=FUZZ_KINDS, kw={})
# the engine map: one 200 Mb chromosome at 10 kb, 2,000-6,000 sites,
# flanks of 50-200 kb (W = 11-41), pairs within 1 Mb, TADs 20-200 bins
# wide; no trans kind on one chromosome
FUZZ_ENGINE = dict(chroms=("chr1",), n=(2_000, 6_001), start=(100, 19_900),
                   unit=10_000, flank=(5, 21), flank_unit=10_000,
                   tad=(20, 201),
                   kinds=tuple(k for k in FUZZ_KINDS if k != "trans"),
                   kw=dict(maxdist=1_000_000))
FUZZ_RTOL = 1e-4
FUZZ_TOL = dict(rtol=FUZZ_RTOL, atol=1e-7)
FUZZ_CPU_SITES = 300
# by-distance APA of the engine cell's sites through the notebook alias
# coolpuppy_tpu_torch.coolpup.pileup
BY_DISTANCE_KW = dict(ENGINE_KW, by_distance=True)


def fuzz_base(rng, expected_cis, scale=FUZZ_TOY):
    """The draws of tests/test_fuzz_parity.py::random_case, at FUZZ_TOY's
    scale the same numbers: ``(features, pileup keywords)`` of stranded
    sites, a flank, controls or an expected table or coverage
    normalization, by strand (flipped or not), stripes, by distance."""
    import pandas as pd

    n = int(rng.integers(*scale["n"]))
    chroms = rng.choice(list(scale["chroms"]), n)
    unit, half = scale["unit"], scale["unit"] // 2
    starts = (rng.integers(*scale["start"], n).astype(np.int64) * unit
              + rng.integers(0, 2, n) * half)
    feats = pd.DataFrame({
        "chrom": chroms, "start": starts,
        "end": starts + int(rng.integers(1, 3)) * half, "name": "f",
        "score": rng.uniform(0, 1, n).round(3),
        "strand": rng.choice(["+", "-"], n),
    }).sort_values(["chrom", "start"], kind="stable", ignore_index=True)
    kw = dict(features_format="bed", mindist=0,
              flank=int(rng.integers(*scale["flank"])) * scale["flank_unit"])
    mode = rng.integers(0, 4)
    if mode == 0:
        kw["nshifts"] = int(rng.integers(1, 3))
        kw["seed"] = int(rng.integers(0, 100))
    elif mode == 1:
        kw["expected_df"] = expected_cis
        kw["ooe"] = bool(rng.integers(0, 2))
    elif mode == 2:
        kw["clr_weight_name"] = None
        kw["coverage_norm"] = True
    if rng.integers(0, 2):
        kw["by_strand"] = True
        if rng.integers(0, 2):
            kw["flip_negative_strand"] = True
    if rng.integers(0, 3) == 0:
        kw["store_stripes"] = True
    if rng.integers(0, 3) == 0 and "expected_df" not in kw:
        kw["by_distance"] = True
    return feats, kw


def fuzz_case(rng, expected, scale=FUZZ_TOY):
    """One seeded case of the fuzz search: ``(features, pileup keywords)``.
    ``expected`` maps "cis" (and "trans", where ``scale`` draws trans cases)
    to expected tables of the map. ``fuzz_base``'s draws come first; the
    draws after them widen the flag space, each made whatever the case:
    the kind of case (``scale["kinds"]``: BED as drawn, by window, BEDPE
    rows of consecutive sites, trans, or local rescaled TADs), a class
    column to group by (with its order ignored or not) and ``min_diag``.
    What the packages refuse together gives way to the kind: by distance
    under trans or local, a groupby under by-window (which ignores it), an
    ignored group order under BEDPE or local."""
    import pandas as pd

    feats, kw = fuzz_base(rng, expected["cis"], scale)
    n, unit = len(feats), scale["unit"]
    kinds = scale["kinds"]
    kind = kinds[int(rng.integers(0, len(kinds)))]
    feats["cls"] = rng.choice(["a", "b", "c"], n)
    group = rng.integers(0, 3) == 0
    ignore_order = bool(rng.integers(0, 2)) and kind in ("bed", "trans")
    with_min_diag = rng.integers(0, 3) == 0
    min_diag = int(rng.integers(0, 4))
    rescale_size = 2 * int(rng.integers(4, 17)) + 1
    widths = rng.integers(*scale["tad"], n) * unit
    kw.update(scale["kw"])
    if kind == "by_window":
        kw["by_window"] = True
        group = False
    elif kind == "trans":
        kw["trans"] = True
        kw.pop("by_distance", None)
        if "expected_df" in kw:
            kw["expected_df"] = expected["trans"]
    elif kind == "local_rescale":
        kw.update(local=True, rescale=True, rescale_flank=1,
                  rescale_size=rescale_size)
        kw.pop("by_distance", None)
        feats["end"] = feats["start"] + widths
    elif kind == "bedpe":
        a = feats.iloc[:-1].reset_index(drop=True)
        b = feats.iloc[1:].reset_index(drop=True)
        same = (a["chrom"] == b["chrom"]).to_numpy()
        a, b = a[same], b[same]
        feats = pd.DataFrame({
            **{f"{c}1": a[c].to_numpy() for c in ("chrom", "start", "end")},
            **{f"{c}2": b[c].to_numpy() for c in ("chrom", "start", "end")},
            "strand1": a["strand"].to_numpy(),
            "strand2": b["strand"].to_numpy(),
            "cls1": a["cls"].to_numpy(), "cls2": b["cls"].to_numpy(),
        })
        kw["features_format"] = "bedpe"
    if group:
        kw["groupby"] = ["cls1", "cls2"]
        if ignore_order:
            kw["ignore_group_order"] = ["cls1", "cls2"]
    if with_min_diag:
        kw["min_diag"] = min_diag
    return feats, kw


def fuzz_flags(kw):
    """A case's keywords as one short line (an expected table by name)."""
    return " ".join(f"{k}={'table' if k == 'expected_df' else v}"
                    for k, v in kw.items() if k != "features_format") \
        + f" ({kw['features_format']})"


class CountingStore:
    """A ``Cooler`` store that records every read of a pixel column of the
    store it wraps (a file or arrays): ``reads`` holds ``(thread id,
    column, start, stop)``."""

    def __init__(self, inner):
        self.inner = inner
        self.filename = inner.filename
        self.group = inner.group
        self.reads = []
        self.lock = threading.Lock()

    @contextlib.contextmanager
    def open(self):
        with self.inner.open() as grp:
            yield _CountingGroup(grp, self)


class _CountingGroup:
    def __init__(self, grp, store):
        self._grp = grp
        self._store = store
        self.attrs = grp.attrs

    def keys(self):
        return self._grp.keys()

    def __getitem__(self, path):
        node = self._grp[path]
        if path.startswith("pixels/"):
            return _CountingColumn(node, path[len("pixels/"):], self._store)
        return node


class _CountingColumn:
    def __init__(self, column, name, store):
        self._column = column
        self._name = name
        self._store = store
        self.shape = column.shape
        self.dtype = column.dtype

    def __getitem__(self, rows):
        out = self._column[rows]
        with self._store.lock:
            self._store.reads.append((threading.get_ident(), self._name,
                                      rows.start, rows.stop))
        return out


class fetch_log:
    """Every ``fetch_slab`` of a ``Cooler`` read through a CountingStore
    during a block: ``fetches`` holds ``(row extent, column extent, reads,
    thread id)``, with the ``(column, start, stop)`` reads the fetch made on
    its own thread."""

    def __init__(self, clr):
        self.clr = clr

    def __enter__(self):
        clr, store = self.clr, self.clr.store
        inner = clr.fetch_slab
        self.fetches = fetches = []

        def logged(region1, region2=None, *args, **kw):
            tid = threading.get_ident()
            with store.lock:
                mark = len(store.reads)
            slab = inner(region1, region2, *args, **kw)
            with store.lock:
                mine = [r[1:] for r in store.reads[mark:] if r[0] == tid]
            fetches.append((clr.extent(region1), clr.extent(
                region2 if region2 is not None else region1), mine, tid))
            return slab

        clr.fetch_slab = logged
        return self

    def __exit__(self, *exc):
        del self.clr.fetch_slab


def fetch_spans(clr, fetches):
    """Hold each logged fetch to its row spans: every pixel column read
    once a span, exactly rows [bin1_offset[lo], bin1_offset[hi]) of it (a
    cis fetch one span, a rectangle of two extents both), an empty span not
    at all. Returns the pixels each fetch read."""
    from coolpuppy_tpu_torch.io.cool import PIXEL_COLUMNS

    off = clr.bin1_offset()
    read = []
    for ext1, ext2, reads, _ in fetches:
        spans = [ext1] if ext1 == ext2 else [ext1, ext2]
        want = [(int(off[lo]), int(off[hi])) for lo, hi in spans
                if off[hi] > off[lo]]
        for col in PIXEL_COLUMNS:
            got = [(a, b) for c, a, b in reads if c == col]
            if got != want:
                raise AssertionError(f"fetch of {ext1} x {ext2} read {col} "
                                     f"rows {got}, not its spans {want}")
        read.append(sum(b - a for a, b in want))
    return read


def table_snips(table):
    """ROI n + control_n of a pileup table's 'all' row, or of all its rows
    where it has none."""
    for key in ("orientation", "group", "chrom"):
        if key in table:
            rows = table.loc[table[key].astype(str) == "all"]
            if len(rows):
                table = rows.iloc[:1]
                break
    control = table["control_n"] if "control_n" in table else 0
    return int(np.nansum(table["n"].to_numpy(float))
               + np.nansum(np.asarray(control, float)))


# the transfer wires: each wire on the toy maps, the card against the CPU forced onto the
# same wire (``_tile_f16_mode`` replaced on the instance, as the reference's
# own tests force it, tests/test_pallas_modes.py:242-261); ``mode`` is what
# ``_tile_wire_plan`` must return on both sides, ``coo`` that the stack goes
# over the COO wire
WIRE_TOY = {
    "lossy": dict(mode="lossy"),
    "exact": dict(mode="exact", pu=dict(clr_weight_name=None)),
    "int8": dict(mode="int8", map="small_counts"),
    "coo_trans": dict(mode="lossy", cc=dict(trans=True), coo=True),
}
# the cells on the engine map (its 20,000 sites), wire on
# (the default) against off (F32_WIRE): keywords, the map ("int8": the
# engine map's counts clipped to 127), the plan's mode and the tolerance of
# ``data`` (the lossy wires: the reference's own bound for them,
# tests/test_pallas_modes.py:258-261; "exact" and int8: rtol 1e-4, the
# atomics' order); stripe planes within float16's half ulp (2^-11) or
# atol 6e-8 (its subnormals)
LOSSY_TOL = dict(rtol=2e-3, atol=1e-5)
WIRE_STRIPE_TOL = dict(rtol=2.0 ** -11, atol=6e-8)
WIRE_CELLS = {
    "engine": dict(kw=ENGINE_KW, mode="lossy", tol=LOSSY_TOL),
    "unbalanced": dict(kw=dict(ENGINE_KW, clr_weight_name=None),
                       mode="exact", tol=dict(rtol=1e-4, atol=1e-7)),
    "int8": dict(kw=ENGINE_KW, mode="int8", map="int8",
                 tol=dict(rtol=1e-4, atol=1e-7)),
    "by_window": dict(kw=MODES_CELLS["by_window"], mode="lossy",
                      tol=LOSSY_TOL, k9=True),
    "stripes": dict(kw=MODES_CELLS["stripes"], mode="lossy", tol=LOSSY_TOL,
                    stripe_tol=WIRE_STRIPE_TOL),
}


def small_counts_map(seed=23):
    """The reference's int8 test map (tests/test_pallas.py:591-622) in
    memory: 60 bins of 1 Mb on one chromosome, Poisson counts <= 127, 5%
    NaN-weight bins, 12 stranded sites; ``counts_are_int`` set (an
    in-memory map takes the int8 wire only where a caller sets it).
    Returns ``(Cooler, features)``."""
    import pandas as pd

    from coolpuppy_tpu_torch import Cooler

    rng = np.random.default_rng(seed)
    binsize, n = 1_000_000, 60
    i, j = np.triu_indices(n)
    vals = rng.poisson(10.0 / (1.0 + np.abs(i - j)) + 0.5)
    keep = vals > 0
    weights = rng.uniform(0.5, 1.5, n)
    weights[rng.random(n) < 0.05] = np.nan
    clr = Cooler.from_arrays({"chrT": n * binsize}, binsize,
                             (i[keep], j[keep], vals[keep]), weights=weights)
    clr.counts_are_int = True
    starts = np.sort(rng.choice(np.arange(5, n - 5), 12, replace=False))
    feats = pd.DataFrame({
        "chrom": "chrT", "start": starts * binsize,
        "end": (starts + 1) * binsize, "name": "x", "score": 0,
        "strand": rng.choice(["+", "-"], 12),
    })
    return clr, feats


def int8_map(clr):
    """The engine map with each pixel's count (its stored entries summed)
    clipped to 127, an integer the int8 wire ships exactly; the same
    weights, ``counts_are_int`` set."""
    from coolpuppy_tpu_torch import Cooler

    b1, b2, count = clr.pixels_chunk(0, clr.n_pixels)
    key, inv = np.unique(b1.astype(np.int64) * clr.n_bins + b2,
                         return_inverse=True)
    count = np.minimum(np.bincount(inv, weights=count), 127).astype(np.int64)
    out = Cooler.from_arrays(clr.chromsizes, clr.binsize,
                             (key // clr.n_bins, key % clr.n_bins, count),
                             weights=clr.bins_df()["weight"].to_numpy())
    out.counts_are_int = True
    return out


class wire_spy:
    """What the wires did in a block: the modes ``_tile_wire_plan``
    returned (``plans``), the dtype each tile upload shipped (``uploads``),
    the COO wire's ``f16_mode`` per build (``coo``), the ``f16`` of each
    flip-merged accumulator fetch (``merges``) and the dtypes of the stripe
    gathers (``stripes``). ``int8`` sets ``tile_int8`` on every PileUpper;
    ``forced`` makes every PileUpper take the card's wires (on the CPU)."""

    def __init__(self, int8=False, forced=False):
        self.int8, self.forced = int8, forced

    def __enter__(self):
        from coolpuppy_tpu_torch.ops import tiles

        eng = importlib.import_module(engine_patch.MODULE)
        qg = importlib.import_module("coolpuppy_tpu_torch.ops.quad_gather")
        self.plans, self.uploads, self.coo = [], [], []
        self.merges, self.stripes = [], set()
        saved = self.saved = []

        def patch(obj, name, new):
            saved.append((obj, name, obj.__dict__.get(name, saved)))
            setattr(obj, name, new)

        plan, upload = eng.PileUpper._tile_wire_plan, tiles.upload_tiles
        coo, merge = eng.build_tile_stack_coo, eng._stack_merge_fetch
        gather = qg.QuadPileupSession.stripes_device

        def plan_spy(pu, dev):
            out = plan(pu, dev)
            self.plans.append(out[0])
            return out

        def upload_spy(a, f16_mode, device):
            out = upload(a, f16_mode, device)
            self.uploads.append(str(out[0].dtype).replace("torch.", ""))
            return out

        def coo_spy(slab, B, want, f16_mode=False):
            self.coo.append(f16_mode)
            return coo(slab, B, want, f16_mode=f16_mode)

        def merge_spy(outs, half, **kw):
            self.merges.append(bool(kw.get("f16")))
            return merge(outs, half, **kw)

        def gather_spy(sess, r1, r2, f16=False):
            out = gather(sess, r1, r2, f16=f16)
            self.stripes.add(str(out.dtype).replace("torch.", ""))
            return out

        patch(eng.PileUpper, "_tile_wire_plan", plan_spy)
        patch(tiles, "upload_tiles", upload_spy)
        patch(eng, "build_tile_stack_coo", coo_spy)
        patch(eng, "_stack_merge_fetch", merge_spy)
        patch(qg.QuadPileupSession, "stripes_device", gather_spy)
        if self.int8:
            patch(eng.PileUpper, "tile_int8", True)
        if self.forced:
            patch(eng.PileUpper, "_on_accelerator", lambda pu: True)
        return self

    def __exit__(self, *exc):
        for obj, name, old in reversed(self.saved):
            if old is self.saved:  # the attribute was not there
                delattr(obj, name)
            else:
                setattr(obj, name, old)


def wire_toy_run(name, device, force):
    """One WIRE_TOY case on ``device``: ``(table, wire_spy)``; ``force``
    replaces ``_tile_f16_mode`` on the instance with the case's mode (the
    int8 case forces "lossy", from which the plan takes int8)."""
    from coolpuppy_tpu_torch import CoordCreator, PileUpper

    spec = WIRE_TOY[name]
    if spec.get("map") == "small_counts":
        clr, feats = small_counts_map()
        view, flank = None, 3_000_000
    else:
        clr, feats, view, flank = (toy_cooler()[0], toy_features(),
                                   toy_regions(), TOY_KW["flank"])
    cc = CoordCreator(feats, clr.binsize, features_format="bed", flank=flank,
                      mindist=0, nshifts=0, seed=0, **spec.get("cc", {}))
    pu = PileUpper(clr, cc, view_df=view, control=False, device=device,
                   **spec.get("pu", {}))
    if force:
        mode = "lossy" if spec["mode"] == "int8" else spec["mode"]
        pu._tile_f16_mode = lambda: mode
    with wire_spy(int8=spec["mode"] == "int8") as spy:
        table = pu.pileupsWithControl()
    return table, spy


