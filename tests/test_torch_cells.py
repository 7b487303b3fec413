"""The cells of ``bench.py`` through the port, on the card and on the CPU.

Each test takes a cell's workload (built in memory with bench's RNG calls,
``torch_cases``) through the port's ``pileup()`` and its layers and holds
the result against the plain version swapped in for the kernel, a host
oracle, the CPU, or a twin route (the collected path, a mesh, the BED
dual-anchor run, ``pileup()`` with the keywords the CLI resolved): keys
and counts exact, ``data`` within rtol 1e-4 (float32 atomics add in an
order that changes from run to run) unless a test names another bound.

Every test has two cases (``torch_cases.DEVICES``). ``cuda`` runs the
kernels at the cell's size and skips where there is no card; ``cpu`` runs
the same control flow and checks on a cut workload (a 1,500-bin map for
the engine cells), with ``quad_accumulate`` (and where a test says so the
wide kernel's entry) swapped for the plain version counting its calls as
launches, so that the engine records the kernel's route. The files that
compare against the JAX package skip on the card's machine (it has no
h5py, which that package imports), so these tests import the port and
``torch_cases`` only.

    python -m pytest -m cuda tests/test_torch_cells.py -q    # on a card
"""

import copy
import importlib

import numpy as np
import pandas as pd
import pytest
import torch

import coolpuppy_tpu_torch.ops.gather as ga
import coolpuppy_tpu_torch.ops.quad_gather as qg
import torch_cases as cases
from coolpuppy_tpu_torch import CoordCreator, PileUpper, pileup
from torch_cases import (
    DEVICES,
    ENGINE_KW,
    ENGINE_MODES_TOL,
    ENGINE_RTOL,
    F32_FETCH,
    F32_WIRE,
    all_row,
    compare,
    compare_extras,
    compare_tables,
    counted_plain,
    engine_snips,
    engine_workload,
    kernel_run,
    plain_swapped,
    table_snips,
    toy_cooler,
)

ENGINE = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")
# the CPU cases' engine map: bench's cut to 1,500 bins, 150k contacts
SMALL_MAP = dict(n_bins=1_500, n_contacts=150_000)
# the CPU cases' genome map: 3 chromosomes of 1,200 bins, 360 sites
SMALL_GENOME = dict(n_chroms=3, bins_per=1_200, contacts_per=50_000,
                    n_sites=360)
TABLE_TOL = dict(rtol=ENGINE_RTOL, atol=1e-7)


# -- the slice: the session at the loop-APA headline -------------------------


def _fake_staged(monkeypatch):
    """The staged launcher's stand-in on the CPU: the plain version, a
    launch counted where the launcher counts one, float32 and int32 out as
    the kernel's; the routed wrapper through it."""
    plain = qg.quad_accumulate_plain

    def staged(stiles, k, qstart, qcount, snips, W, C):
        assert qg.corner_layout(W).staged
        if k.shape[0]:
            qg.LAUNCHES += 1
        s, n = plain(stiles, k, qstart, qcount, snips, W, C)
        return s.to(torch.float32), n.to(torch.int32)

    def routed(*args):
        s, n = staged(*args)
        return s.to(torch.float64), n.to(torch.float64)

    monkeypatch.setattr(qg, "quad_accumulate_staged", staged)
    monkeypatch.setattr(qg, "quad_accumulate", routed)


@pytest.mark.parametrize("device", DEVICES)
def test_slice_headline(device, monkeypatch):
    """``bench.make_workload`` (card: 1M loci on a 20,000-bin chromosome,
    W = 21, observed-over-expected, 4 groups, 25% flips; CPU: 3,000 loci
    on 1,500 bins) through ``build_tile_stack_sym`` ->
    ``QuadPileupSession`` -> ``run_many`` -> ``finalize`` ->
    ``merge_flip_banks``: one staged launch; the session's accumulators and
    one more launch against the plain version (``num`` exact, poison
    equal, ``sum`` rtol 1e-4); the device-normalized stack and a subset of
    20,000 snips against the host oracle (``sum`` rtol 1e-5)."""
    from bench import make_workload
    from coolpuppy_tpu_torch.ops.gather import merge_flip_banks
    from coolpuppy_tpu_torch.ops.tiles import build_tile_stack_sym

    dev = cases.device(device)
    if dev.type == "cpu":
        _fake_staged(monkeypatch)
        workload = make_workload(n_bins=1_500, nnz_target=100_000,
                                 n_loci=3_000)
    else:
        workload = make_workload()
    _, coo, r1, r2, gid, flip, valid, evec = workload
    W, half, B = 21, 4, cases.B
    C = 2 * half + 8
    cid = (gid + half * flip).astype(np.int32)
    cfg_kw = dict(W=W, capacity=C, cis=True, ignore_diags=2, ooe=True)

    qg.LAUNCHES = 0
    ts = build_tile_stack_sym(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    sess = qg.QuadPileupSession(ts, valid, valid, evec, cfg_kw, dev)
    total = sess.finalize([sess.run_many(r1, r2, cid, fetch=False)])
    merged = merge_flip_banks(total, half)
    assert qg.LAUNCHES == 1
    for k in ("sum", "num", "poison"):
        assert merged[k].shape == (half, W, W), k
    assert np.isfinite(merged["sum"]).all() and not merged["poison"].any()
    assert int(merged["num"].sum()) > 0
    assert np.array_equal(total["poison"], np.isinf(total["sum"]))

    quads = qg.sort_quads(r1, r2, cid, ts.tile_map, B)
    args = (sess.stiles, *cases.variant_args(quads, "staged", dev), W, C)
    want = qg.quad_accumulate_plain(*args)
    session = tuple(torch.from_numpy(total[k]) for k in ("sum", "num"))
    compare(session, want, rtol=cases.HEADLINE_RTOL, atol=1e-6,
            what="session vs plain headline")
    compare(qg.quad_accumulate_staged(*args), want, rtol=cases.HEADLINE_RTOL,
            atol=1e-6, what="staged vs plain headline")

    n_sub = min(20_000, len(r1))
    s_r1, s_r2, s_cid = r1[:n_sub], r2[:n_sub], cid[:n_sub]
    stiles_h, want_s, want_m = cases.host_oracle(ts, s_r1, s_r2, s_cid, valid,
                                                 evec, W, C)
    st = sess.stiles.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(st), np.isnan(stiles_h))
    fin = ~np.isnan(stiles_h)
    np.testing.assert_allclose(st[fin], stiles_h[fin], rtol=1e-6, atol=1e-6)
    sub = sess.run_many(s_r1, s_r2, s_cid)
    np.testing.assert_array_equal(sub["num"], want_m)
    np.testing.assert_allclose(sub["sum"], want_s, rtol=1e-5, atol=0)


# -- the engine cells --------------------------------------------------------


@pytest.mark.parametrize("device", DEVICES)
def test_engine_cell(device, monkeypatch):
    """``bench.py --engine``'s cell (``ENGINE_KW``; card: 20,000 stranded
    sites on the 20,000-bin map; CPU: 200 sites): a checked run through
    the quad kernel against the plain-swapped run."""
    dev = cases.device(device)
    if dev.type == "cpu":
        counted_plain(monkeypatch)
        clr, feats = engine_workload(n_sites=200, **SMALL_MAP)
    else:
        clr, feats = engine_workload()

    def run():
        return pileup(clr, feats, device=dev, **ENGINE_KW)

    checked, launches = kernel_run("engine run", run)
    assert launches == 1 or dev.type == "cuda"
    data = np.stack(checked["data"].to_list())
    assert data.shape[1:] == (21, 21) and np.isfinite(data).any()
    assert engine_snips(checked) > 0
    compare_tables(checked, plain_swapped("engine", run),
                   what="engine kernel vs plain", **TABLE_TOL)


@pytest.mark.parametrize("device", DEVICES)
def test_w119_cell(device, monkeypatch):
    """119-bin windows (+-590 kb at 10 kb, ``W119_CELL_KW``) over the engine
    cell's sites, where the staged kernel runs two bands an item: a checked
    run against the plain-swapped run, and ``W119_SUBSET_SITES`` sites
    against the CPU (card: 20,000 sites; CPU: 60 sites, 30 in the
    subset)."""
    dev = cases.device(device)
    subset = cases.W119_SUBSET_SITES
    if dev.type == "cpu":
        counted_plain(monkeypatch)
        clr, feats = engine_workload(n_sites=60, **SMALL_MAP)
        subset = 30
    else:
        clr, feats = engine_workload()
    W = 2 * (cases.W119_CELL_KW["flank"] // clr.binsize) + 1
    assert W == 119 and qg.corner_layout(W).bands == 2

    def run(f, device=dev, **extra):
        return pileup(clr, f, device=device, **cases.W119_CELL_KW, **extra)

    checked, _ = kernel_run("w119 run", lambda: run(feats))
    data = np.stack(checked["data"].to_list())
    assert data.shape[1:] == (W, W) and np.isfinite(data).any()
    monkeypatch.setattr(qg, "PLAIN_CHUNK", 8192)  # the plain index tensors
    compare_tables(checked, plain_swapped("w119", lambda: run(feats)),
                   what="w119 kernel vs plain", **TABLE_TOL)
    sub = feats.iloc[:subset]
    compare_tables(run(sub, **F32_WIRE), run(sub, device="cpu"),
                   what="w119 subset card vs cpu", **TABLE_TOL)


def _stripe_sample(gathers, row, n_snips):
    """The stripes cell's stripe rows as the card gathered them (the chunks
    of one region's session), a sample of them against ``stripes_host`` on
    the fetched stack (cast to float16 where they came back on the float16
    stripe wire: bit for bit either way), and the table's planes against
    the gathered rows' count."""
    sessions = {id(g[0]) for g in gathers}
    assert gathers and len(sessions) == 1, (len(gathers), len(sessions))
    sess = gathers[0][0]
    r1, r2 = (np.concatenate([g[i] for g in gathers]) for i in (1, 2))
    hv = np.concatenate([g[3].cpu().numpy() for g in gathers])
    assert hv.shape == (n_snips, 2 * sess.W)
    assert row["horizontal_stripe"].shape == (n_snips, sess.W)
    rng = np.random.default_rng(0)
    pick = np.sort(rng.choice(len(r1), min(cases.STRIPE_SAMPLE, len(r1)),
                              replace=False))
    want = qg.stripes_host(sess.stiles.cpu().numpy(), sess.tile_stack.tile_map,
                           r1[pick], r2[pick], sess.W).astype(hv.dtype)
    np.testing.assert_array_equal(hv[pick], want,
                                  err_msg="stripes vs stripes_host")


@pytest.mark.parametrize("device", DEVICES)
def test_modes_cells(device, monkeypatch):
    """``bench.py --modes``' cells ``stripes``, ``by_window``, ``bedpe`` (2M
    sorted pairs) and ``trans`` (1,500 x 1,500 sites on the two-chromosome
    map) (CPU: 120 sites on a 1,200-bin map, 40 trans sites a chromosome):
    a checked run through the quad kernel against the plain-swapped run;
    the stripes cell's stripe rows against ``stripes_host``."""
    dev = cases.device(device)
    if dev.type == "cpu":
        counted_plain(monkeypatch)
        workload = cases.modes_workload(
            n_sites=120, n_bins=1_200, n_contacts=60_000, n_trans=40,
            trans_size=(600, 500, 30_000, 20_000))
    else:
        workload = cases.modes_workload()
    clr, feats, bedpe, clr2, tfeats = workload
    inputs = {"stripes": (clr, feats), "by_window": (clr, feats),
              "bedpe": (clr, bedpe), "trans": (clr2, tfeats)}
    for cell, kw in cases.MODES_CELLS.items():
        mclr, f = inputs[cell]
        # by_window's runs fetch float32 accumulators: both sides round to
        # float16 otherwise
        fetch = F32_FETCH if kw.get("by_window") else {}

        def run(mclr=mclr, f=f, kw=kw, fetch=fetch):
            return pileup(mclr, f, device=dev, **kw, **fetch)

        gathers = []
        gather = qg.QuadPileupSession.stripes_device

        def recording(self, r1, r2, f16=False):
            out = gather(self, r1, r2, f16=f16)
            gathers.append((self, r1, r2, out))
            return out

        monkeypatch.setattr(qg.QuadPileupSession, "stripes_device",
                            recording)
        checked, launches = kernel_run(f"modes {cell}", run)
        monkeypatch.setattr(qg.QuadPileupSession, "stripes_device", gather)
        assert launches == 1 or dev.type == "cuda", (cell, launches)
        row = all_row(checked)
        data = np.stack(checked["data"].to_list())
        assert data.shape[1:] == (21, 21) and np.isfinite(data).any(), cell
        if cell == "stripes":
            _stripe_sample(gathers, row, int(row["n"]))
        del gathers
        compare_tables(checked, plain_swapped(f"modes {cell}", run),
                       what=f"modes {cell} kernel vs plain", **TABLE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["engine", "2d", "rescale", "wide"])
def test_toy_modes_card_vs_cpu(group):
    """Every mode of a group on the toy map, the card against the plain
    version on the CPU (``ENGINE_MODES``, ``MODES_2D``, ``RESCALE_MODES``,
    ``WIDE_MODES``): ``compare_tables`` within rtol 1e-5, each side's route,
    and the wide kernel launched on the card's W = 123 route."""
    dev = cases.device("cuda")
    clr, dense, weights = toy_cooler()
    view = cases.toy_regions()
    if group == "engine":
        expected = cases.toy_expected(clr, dense, weights, view)
        runs = [(name, cases.toy_features(), view,
                 cases.mode_kwargs(name, expected), {})
                for name in cases.ENGINE_MODES]
    elif group == "2d":
        trans = cases.toy_trans_expected(clr, dense, weights, view)
        runs = []
        for name in cases.MODES_2D:
            features, kw = cases.mode_2d_inputs(name, trans)
            runs.append((name, features, view, kw,
                         cases.MODE_PATCHES.get(name, {})))
    else:
        modes = cases.RESCALE_MODES if group == "rescale" else \
            cases.WIDE_MODES
        runs = [(name, *cases.rescale_wide_inputs(group, name, clr, dense,
                                                  weights), {})
                for name in modes]
    want_routes = {"engine": ("cuda_kernel", "plain"),
                   "2d": ("cuda_kernel", "plain"),
                   "rescale": ("rescale_torch", "rescale_torch"),
                   "wide": ("generic_cuda", "generic_torch")}[group]
    for name, features, view_df, kw, patch in runs:
        with cases.engine_patch(**patch):
            ga.LAUNCHES = 0
            got = pileup(clr, features, view_df=view_df, device=dev, **kw,
                         **F32_WIRE)
            wide = ga.LAUNCHES
            want = pileup(clr, features, view_df=view_df, device="cpu", **kw)
        compare_tables(got, want, what=f"{group} mode {name}",
                       **ENGINE_MODES_TOL)
        routes = (got["accumulate"].iloc[0], want["accumulate"].iloc[0])
        assert routes == want_routes, (name, routes)
        assert (wide > 0) == (group == "wide"), (name, wide)


# -- rescale and wide windows ------------------------------------------------


@pytest.mark.parametrize("device", DEVICES)
def test_rescale_cell(device):
    """``bench.py --rescale`` (``rescale_workload``: 2,000 TADs 20-200 bins
    wide; CPU: 50 TADs on a 1,500-bin map, widths cut to a quarter so the
    extents stay within two 128-bin buckets), without and with the map's
    ``expected_cis`` table: a checked run (TF32 off, route
    ``rescale_torch``) and its first ``RESCALE_ORACLE_TADS`` TADs against
    ``rescale_host_oracle`` (count and mean rtol 1e-4)."""
    from coolpuppy_tpu_torch.expected import expected_cis

    dev = cases.device(device)
    if dev.type == "cpu":
        clr, feats = cases.rescale_workload(n_tads=50, **SMALL_MAP)
        bins = (feats["end"] - feats["start"]) // clr.binsize
        feats = feats.assign(end=feats["start"] + bins // 4 * clr.binsize)
    else:
        clr, feats = cases.rescale_workload()
    R = cases.RESCALE_CELL_KW["rescale_size"]
    exp = expected_cis(clr)

    def run(f, **kw):
        return pileup(clr, f, device=dev, **dict(cases.RESCALE_CELL_KW, **kw))

    for variant, kw in (("local", {}), ("local_ooe", {"expected_df": exp})):
        what = f"rescale {variant}"
        assert not torch.backends.cuda.matmul.allow_tf32
        checked = run(feats, **kw)
        data = np.asarray(all_row(checked)["data"], float)
        assert checked["accumulate"].iloc[0] == "rescale_torch", what
        assert str(dev) in checked["device"].iloc[0], what
        assert data.shape == (R, R) and np.isfinite(data).any(), what
        sub = feats.iloc[:cases.RESCALE_ORACLE_TADS]
        want = cases.rescale_host_oracle(clr, sub, R,
                                         expected=kw.get("expected_df"))
        cases.check_oracle(run(sub, **kw, **F32_WIRE), want, what)


def _fake_wide_kernel(monkeypatch):
    """The wide kernel's stand-in on the CPU: ``generic_accumulate``, in the
    gather module and where the engine looked it up, runs the plain
    version and counts a launch where the kernel's wrapper would. Returns
    the W of each launch, in order."""
    plain = ga.generic_accumulate_plain
    fired = []

    def launched(stiles, tile_map, r1, r2, cid, W, C, stripes=False,
                 block=None):
        if len(r1):
            ga.LAUNCHES += 1
            fired.append(W)
        return plain(stiles, tile_map, r1, r2, cid, W, C, stripes=stripes,
                     block=block)

    monkeypatch.setattr(ga, "generic_accumulate", launched)
    monkeypatch.setattr(ENGINE, "generic_accumulate", launched)
    return fired


@pytest.mark.parametrize("device", DEVICES)
def test_wide_cell(device, monkeypatch):
    """201-bin windows (+-1 Mb at 10 kb, ``WIDE_CELL_KW``) over 2,000
    stranded sites of the engine map (CPU: W = 123 over 200 sites through
    the wide kernel's stand-in): a checked run that must launch the wide
    kernel, each of its step calls against the plain version on the same
    inputs (counts exact, ``sum`` rtol 1e-4), the run with the plain version
    in the engine's step, and ``WIDE_SUBSET_SITES`` sites against the CPU.
    Then the wide kernel against its plain version at every W of
    ``WIDE_KERNEL_W`` (``wide_kernel_cases``; CPU: 40 snips a case, items
    of 30)."""
    dev = cases.device(device)
    kw = dict(cases.WIDE_CELL_KW)
    subset = cases.WIDE_SUBSET_SITES
    if dev.type == "cpu":
        fired = _fake_wide_kernel(monkeypatch)
        kw.update(flank=610_000, maxdist=1_500_000)
        clr, feats = engine_workload(n_sites=200, **SMALL_MAP)
        subset = 30
    else:
        clr, feats = engine_workload(n_sites=cases.WIDE_CELL_SITES)

    def run(f, device=dev):
        return pileup(clr, f, device=device, **kw)

    W = 2 * (kw["flank"] // clr.binsize) + 1
    calls = []
    step = ENGINE.generic_accumulate

    def recording(*args, **k):
        calls.append((args, k))
        return step(*args, **k)

    ga.LAUNCHES = 0
    monkeypatch.setattr(ENGINE, "generic_accumulate", recording)
    checked = run(feats)
    monkeypatch.setattr(ENGINE, "generic_accumulate", step)
    data = np.stack(checked["data"].to_list())
    assert ga.LAUNCHES >= 1 and data.shape[1:] == (W, W)
    assert np.isfinite(data).any()
    assert checked["accumulate"].iloc[0] == (
        "generic_cuda" if dev.type == "cuda" else "generic_torch")
    for args, k in calls:
        cases.compare_wide(ga.generic_accumulate(*args, **k),
                           ga.generic_accumulate_plain(*args, **k),
                           rtol=cases.HEADLINE_RTOL,
                           what="wide step call vs plain")
    del calls

    ga.LAUNCHES = 0
    monkeypatch.setattr(ENGINE, "generic_accumulate",
                        ga.generic_accumulate_plain)
    swapped = run(feats)
    monkeypatch.setattr(ENGINE, "generic_accumulate", step)
    assert ga.LAUNCHES == 0
    compare_tables(checked, swapped, what="wide kernel vs plain",
                   **TABLE_TOL)
    sub = feats.iloc[:subset]
    compare_tables(run(sub), run(sub, device="cpu"),
                   what="wide subset card vs cpu", **TABLE_TOL)

    if dev.type == "cpu":
        monkeypatch.setattr(cases, "WIDE_CASE_SNIPS", 40)
        monkeypatch.setattr(ga, "ITEM_MAX", 30)
        before = len(fired)
    for name, W, C, case in cases.wide_kernel_cases():
        _, launches, want = cases.check_wide_case(name, W, C, case, dev)
        assert launches == 1 and want["num"].sum() > 0
        long_run = ga.ITEM_MAX + 77 if W in (201, 401) else 0
        assert len(case[2]) == cases.WIDE_CASE_SNIPS + long_run
    if dev.type == "cpu":
        assert fired[before:] == list(cases.WIDE_KERNEL_W)


# -- the extension hooks and the CLI -----------------------------------------


@pytest.mark.parametrize("device", DEVICES)
def test_hook_modes(device):
    """Every route of the extension hooks and every by-window case that
    groups through the frame hook (``HOOK_MODES``) on the toy map, on the
    device against the CPU: ``compare_tables`` within rtol 1e-5, the extras
    columns equal (frame columns) or within rtol 1e-5 (computed), and the
    route each side took."""
    dev = cases.device(device)
    clr, dense, weights = toy_cooler()
    for name, spec in cases.HOOK_MODES.items():
        got = cases.hook_mode_table(name, clr, dense, weights, dev)
        want = cases.hook_mode_table(name, clr, dense, weights, "cpu")
        what = f"hook mode {name}"
        compare_tables(got, want, what=what, **ENGINE_MODES_TOL)
        keys, rtol = spec.get("extras", ([], None))
        compare_extras(got, want, keys, what, rtol=rtol)
        routes = (got["accumulate"].iloc[0], want["accumulate"].iloc[0])
        card, cpu = spec["routes"]
        assert routes == ((card, cpu) if dev.type == "cuda" else (cpu, cpu))
        if name == "frame_column_controls":
            # two regions of 3 pairs: extra funcs replace the merge of their
            # pups (the reference's sum_pups quirk), so n is one region's
            # and the lists are both regions'
            assert list(got["n"]) == [3]
            assert [len(v) for v in got["score1"]] == [6]
            assert [len(v) for v in got["control_score1"]] == [10]


@pytest.mark.parametrize("device", DEVICES)
def test_extension_cells(device, monkeypatch):
    """``bench.py:575`` ``bench_extension``'s three routes (card: 20,000
    sites for the frame column, 6,000 for the batch and snip hooks; CPU:
    300 and 120 on a 1,500-bin map): the frame-column run through the quad
    kernel against the plain-swapped run (``score1`` lists equal), the batch
    route on ``EXTENSION_CPU_SITES`` sites against the CPU (``center``
    rtol 1e-5), and the three routes on the same sites (``n`` equal,
    ``data`` against the kernel route's, the snip route's ``center`` list
    against the batch route's). Then by-window of every BEDPE pair within
    2 Mb of 5,000 sites (CPU: 150) through the staged kernel, against the
    plain-swapped run and window by window against the BED dual-anchor run
    over the same pairs."""
    dev = cases.device(device)
    cpu_sites = cases.EXTENSION_CPU_SITES
    bedpe_sites = cases.BEDPE_WINDOW_SITES
    if dev.type == "cpu":
        counted_plain(monkeypatch)
        clr, big, small = cases.extension_workload(n_big=300, n_small=120,
                                                   **SMALL_MAP)
        cpu_sites, bedpe_sites = 60, 150
    else:
        clr, big, small = cases.extension_workload()
    feats = {"frame": big, "batch": small, "snip": small}
    tables = {}
    for route in ("frame", "batch", "snip"):
        what = f"extension {route}"

        def run(f=feats[route], route=route, device=dev):
            return cases.extension_run(clr, f, route, device)[1]

        if route == "frame":
            checked, launches = kernel_run(what, run)
            assert launches == 1 or dev.type == "cuda"
            plain = plain_swapped(what, run)
            compare_tables(checked, plain, what=f"{what} kernel vs plain",
                           **TABLE_TOL)
            compare_extras(checked, plain, ["score1"], what)
            del plain
        else:
            checked = run()
            assert checked["accumulate"].iloc[0] == (
                "batch_hook" if route == "batch" else "host_stream")
            assert str(dev) in checked["device"].iloc[0]
        row = all_row(checked)
        key = "score1" if route == "frame" else "center"
        data = np.asarray(row["data"], float)
        assert data.shape == (21, 21) and np.isfinite(data).any(), what
        assert len(row[key]) == int(row["n"]), what
        tables[route] = checked
        if route == "batch":
            sub = feats[route].iloc[:cpu_sites]
            got, want = run(sub), run(sub, device="cpu")
            compare_tables(got, want, what=f"{what} card vs cpu",
                           **TABLE_TOL)
            compare_extras(got, want, ["center"], f"{what} card vs cpu",
                           rtol=cases.EXTRAS_RTOL)
    # the same sites through the three routes (the hook routes upload
    # float32, so the kernel route's run does too)
    frame = cases.extension_run(clr, small, "frame", dev, **F32_WIRE)[1]
    ns = {r: int(all_row(t)["n"]) for r, t in tables.items() if r != "frame"}
    ns["frame"] = int(all_row(frame)["n"])
    assert len(set(ns.values())) == 1, ns
    for route in ("batch", "snip"):
        compare_tables(tables[route], frame, what=f"extension {route} vs "
                       "frame", **TABLE_TOL)
    compare_extras(tables["snip"], tables["batch"], ["center"],
                   "extension snip vs batch", rtol=cases.EXTRAS_RTOL)

    sites, bedpe = cases.bedpe_window_workload(clr, bedpe_sites)
    what = "bedpe by-window"

    # float32 accumulator fetches: the sums differ by the atomics' order
    def rows():
        cc = CoordCreator(bedpe, clr.binsize, features_format="bedpe",
                          nshifts=0, **cases.BEDPE_WINDOW_KW)
        pu = PileUpper(clr, cc, device=dev, **F32_FETCH)
        return pu.pileupsByWindowWithControl()

    checked, launches = kernel_run(what, rows)
    assert launches == 1 or dev.type == "cuda"
    assert int(all_row(checked)["n"]) > 0
    compare_tables(checked, plain_swapped(what, rows),
                   what=f"{what} kernel vs plain", **TABLE_TOL)
    dual = pileup(clr, sites, features_format="bed", by_window=True,
                  device=dev, **cases.BEDPE_WINDOW_KW, **F32_FETCH)
    compare_tables(checked, dual, what=f"{what} vs the BED dual-anchor run",
                   **TABLE_TOL)


@pytest.mark.parametrize("device", DEVICES)
def test_cli_cells(device, monkeypatch, tmp_path):
    """The ``coolpup-torch`` CLI through ``pileup_from_args`` with the map in
    memory. Every flag set of ``CLI_FLAG_SETS`` on the toy map's files on
    the device against ``--device cpu`` (the same output name, the route;
    ``CLI_REFUSED``'s set refused alike), and a ``.txt`` round trip of one
    ``all`` row. Then ``bench.py --engine``'s cell through the CLI's flags
    (card: 20,000 sites; CPU: 200) without and with an expected file: a
    checked run through the quad kernel against the plain-swapped run and
    against ``pileup()`` called with the keywords the CLI resolved."""
    from coolpuppy_tpu_torch.expected import expected_cis
    from coolpuppy_tpu_torch.genomics.intervals import make_cooler_view
    from coolpuppy_tpu_torch.io import (
        load_array_with_header,
        save_array_with_header,
    )

    dev = cases.device(device)
    clr, dense, weights = toy_cooler()
    toy = tmp_path / "toy"
    toy.mkdir()
    paths = cases.write_cli_inputs(str(toy), clr, dense, weights)
    clr.filename = paths["cool"]
    tables = {}
    for name in cases.CLI_FLAG_SETS:
        argv = cases.cli_argv(name, paths)
        if name in cases.CLI_REFUSED:
            for side in (str(dev), "cpu"):
                with pytest.raises(ValueError) as e:
                    cases.cli_pileup(argv + ["--device", side], clr)
                assert str(e.value) == cases.CLI_REFUSED[name]
            continue
        with cases.wires_off():
            got, got_name = cases.cli_pileup(argv + ["--device", str(dev)],
                                             clr, paths["bed"])
        want, want_name = cases.cli_pileup(argv + ["--device", "cpu"], clr,
                                           paths["bed"])
        compare_tables(got, want, what=f"cli {name}", **ENGINE_MODES_TOL)
        assert got_name == want_name, name
        route = cases.CLI_ROUTES.get(name, "cuda_kernel")
        if dev.type == "cpu":
            route = route.replace("cuda_kernel", "plain")
        assert got["accumulate"].iloc[0] == route, name
        tables[name] = got
    assert list(tables["local_rescale"]["n"]) == [4]
    row = all_row(tables["groupby"])
    header = {k: row[k] for k in ("n", "flank", "resolution", "nshifts",
                                  "local", "maxdist", "clr_weight_name",
                                  "cooler", "features", "groupby")}
    path = str(tmp_path / "all.txt")
    save_array_with_header(row["data"], header, path)
    back = load_array_with_header(path)
    data = back.pop("data")
    assert data.dtype == row["data"].dtype
    assert np.array_equal(data, row["data"], equal_nan=True)
    assert back == header

    if dev.type == "cpu":
        counted_plain(monkeypatch)
        clr, feats = engine_workload(n_sites=200, **SMALL_MAP)
    else:
        clr, feats = engine_workload()
    clr = copy.copy(clr)  # the map other tests of the process share
    clr.filename = str(tmp_path / "engine.cool")
    sites, views, exp = (str(tmp_path / f) for f in (
        "sites.bed", "views.bed", "expected.tsv"))
    feats.to_csv(sites, sep="\t", header=False, index=False)
    # with its header line: the CLI's header sniffing (both packages')
    # takes the one line of a one-region view without it for a header
    view = make_cooler_view(clr)
    view.to_csv(views, sep="\t", index=False)
    expected_cis(clr, view).to_csv(exp, sep="\t", index=False)
    tail = ["--view", views, *cases.CLI_ENGINE_ARGS, "--device", str(dev)]
    snips = {}
    for variant, extra in (("controls", []),
                           ("expected", ["--expected",
                                         f"{exp}::balanced.avg"])):
        what = f"cli {variant}"
        argv = [clr.filename, sites, *tail, *extra]

        def run(argv=argv):
            return cases.cli_pileup(argv, clr)[0]

        with cases.cli_probe() as probe:
            checked, launches = kernel_run(what, run)
        assert launches == 1 or dev.type == "cuda"
        data = np.stack(checked["data"].to_list())
        assert data.shape[1:] == (21, 21) and np.isfinite(data).any()
        assert isinstance(probe.pileup_kw["expected_df"], pd.DataFrame) == (
            variant == "expected")
        compare_tables(checked, plain_swapped(what, run),
                       what=f"{what} kernel vs plain", **TABLE_TOL)
        compare_tables(checked, pileup(**probe.pileup_kw),
                       what=f"{what} vs pileup()", **TABLE_TOL)
        snips[variant] = cases.cli_snips(checked)
    # the expected file's run has no controls (nshifts 0)
    assert snips["controls"] > snips["expected"] > 0


# -- the genome cell and the mesh --------------------------------------------


def _native_checks(genome, engine, dev):
    """Each native host entry against its numpy branch on the cells' inputs:
    ``tile_scatter_wtri`` on the upper band tiles of one genome chromosome's
    slab and on the engine map's slab at the engine cell's touched tiles
    (bit for bit the float32 sums in input order, ``scatter_f32_in_order``;
    within ``NATIVE_RTOL`` the numpy branch's float64 sums), the two-pass
    ``sort_quads`` on the engine cell's words from a collected run (bit for
    bit the argsort), and ``enumerate_pairs`` on one chromosome's sites
    (equal, in order)."""
    from coolpuppy_tpu_torch import native
    from coolpuppy_tpu_torch.ops import tiles

    gclr, gfeats = genome
    eclr, efeats = engine
    B = cases.B
    W = 2 * cases.GENOME_KW["flank"] // gclr.binsize + 1

    def scatter(what, slab, want):
        n1 = -(-slab.shape[0] // B)
        _, utmap, _, _, _, Ku = tiles._sym_maps(want, n1, n1)
        got = tiles.scatter_slab(slab, utmap, B, Ku, False)
        np.testing.assert_array_equal(
            got, cases.scatter_f32_in_order(slab, utmap, B, Ku),
            err_msg=f"{what}: native vs float32 in input order")
        np.testing.assert_allclose(
            got, tiles.scatter_slab_plain(slab, utmap, B, Ku, False),
            rtol=cases.NATIVE_RTOL, atol=1e-6,
            err_msg=f"{what}: native vs numpy")

    slab = gclr.fetch_slab(gclr.chromnames[0], balance="weight")
    band = min(cases.GENOME_KW["maxdist"] // gclr.binsize + W + 8,
               slab.shape[0])
    scatter("genome chromosome", slab, tiles.band_tiles(band, B, slab.shape)[0])

    sorts = []
    sort = qg.sort_quads

    def recording(r1, r2, cid, tile_map, b):
        sorts.append((r1, r2, cid, tile_map))
        return sort(r1, r2, cid, tile_map, b)

    qg.sort_quads = recording
    try:
        with cases.collected_path():
            pileup(eclr, efeats, device=dev, **ENGINE_KW)
    finally:
        qg.sort_quads = sort
    assert len(sorts) == 1
    r1, r2, cid, tmap = sorts[0]
    eslab = eclr.fetch_slab(eclr.chromnames[0], balance="weight")
    scatter("engine map", eslab,
            tiles.touched_tiles(r1, r2, W, W, B, eslab.shape)[0])
    got = qg.sort_quads(r1, r2, cid, tmap, B)
    for g, w, name in zip(got, qg.sort_quads_plain(r1, r2, cid, tmap, B),
                          ("snips", "k", "qstart", "qcount")):
        np.testing.assert_array_equal(g, w, err_msg=f"sort_quads {name}")

    cc = CoordCreator(gfeats[gfeats["chrom"] == gclr.chromnames[0]],
                      gclr.binsize, features_format="bed",
                      flank=cases.GENOME_KW["flank"],
                      maxdist=cases.GENOME_KW["maxdist"])
    centers = cc.intervals["center"].to_numpy()
    li, ri = native.enumerate_pairs(centers, cc.mindist, cc.maxdist)
    lazy = type(cc).LAZY_PAIR_THRESHOLD
    type(cc).LAZY_PAIR_THRESHOLD = 0
    try:
        chunks = list(cc._iter_cis_pair_chunks(centers))
    finally:
        type(cc).LAZY_PAIR_THRESHOLD = lazy
    np.testing.assert_array_equal(li, np.concatenate([c[0] for c in chunks]))
    np.testing.assert_array_equal(ri, np.concatenate([c[1] for c in chunks]))


@pytest.mark.parametrize("device", DEVICES)
def test_genome_cell(device, monkeypatch):
    """``bench.py:866``'s genome cell (``genome_workload``: 20 chromosomes
    of 13,500 bins, 37,000 stranded sites, ``GENOME_KW``; CPU: 3
    chromosomes of 1,200 bins, 360 sites, stream chunks of 2,000 snips, one
    native thread, so the scatter adds in input order): the native host
    entries against their numpy branches, then a checked run that must
    stream every region (``stream_regions``, no abort) and launch the quad
    kernel once a chunk, against the plain-swapped run and the collected
    path."""
    from coolpuppy_tpu_torch import native

    dev = cases.device(device)
    if dev.type == "cpu":
        calls = counted_plain(monkeypatch)
        monkeypatch.setattr(ENGINE, "_STREAM_CHUNK", 2_000)
        threads = native.threads()
        native.set_threads(1)
        try:
            clr, feats = cases.genome_workload(**SMALL_GENOME)
            _native_checks((clr, feats),
                           engine_workload(n_sites=200, **SMALL_MAP), dev)
        finally:
            native.set_threads(threads)
        del calls[:]
    else:
        clr, feats = cases.genome_workload()
        _native_checks((clr, feats), engine_workload(), dev)
    pus = []

    def run():
        pu, table = cases.genome_run(clr, feats, dev)
        pus.append(pu)
        return table

    checked, launches = kernel_run("genome", run)
    counts = dict(pus[-1].timers.counts)
    assert counts.get("stream_regions") == len(clr.chromnames), counts
    assert counts.get("stream_aborts", 0) == 0, counts
    assert counts.get("stream_chunks") == launches, counts
    if dev.type == "cpu":
        assert launches > 3 and max(calls) == 2_000
    data = np.stack(checked["data"].to_list())
    assert data.shape[1:] == (21, 21) and np.isfinite(data).any()
    compare_tables(checked, plain_swapped("genome", run),
                   what="genome kernel vs plain", **TABLE_TOL)
    with cases.collected_path():
        collected = run()
    assert not pus[-1].timers.counts.get("stream_regions", 0)
    compare_tables(checked, collected, what="genome stream vs collected",
                   **TABLE_TOL)


@pytest.mark.parametrize("device", DEVICES)
def test_mesh_modes(device, monkeypatch):
    """Every mode of ``MESH_MODES`` on ``LociMesh([device] * n)`` for n in
    ``MESH_SIZES``, against the single-device run and the
    ``LociMesh(["cpu"] * n)`` run (``compare_tables`` within rtol 1e-5):
    the ``_rowshard_*`` counters equal to the CPU run's, the route, a quad
    launch on every device that holds snips, the wide kernel launched in
    the W = 123 modes on the card, a region banded where the mode bands,
    and the current CUDA device unchanged after the runs."""
    from coolpuppy_tpu_torch.parallel import LociMesh

    dev = cases.device(device)
    cuda = dev.type == "cuda"
    if not cuda:
        counted_plain(monkeypatch)
    current = torch.cuda.current_device() if cuda else None
    maps = cases.mesh_maps()
    launches, banded_generic = {}, []
    for name, spec in cases.MESH_MODES.items():
        _, single = cases.mesh_mode_run(name, maps, dev)
        for n in cases.MESH_SIZES:
            what = f"mesh mode {name} n={n}"
            qg.LAUNCHES = ga.LAUNCHES = 0
            pu, got = cases.mesh_mode_run(name, maps, dev, LociMesh([dev] * n))
            launched, wide = qg.LAUNCHES, ga.LAUNCHES
            cpu_pu, want = cases.mesh_mode_run(name, maps, "cpu",
                                               LociMesh(["cpu"] * n))
            # the quad route must launch on the card (and where the CPU
            # counts its plain version as launches); the generic route on
            # the card must launch the wide kernel
            route = spec.get("route") or (
                "cuda_kernel" if cuda or launched else "plain")
            if route == "generic":
                route = "generic_cuda" if cuda else "generic_torch"
                assert wide >= 1 or not cuda, what
            compare_tables(got, single, what=what + " vs one device",
                           **ENGINE_MODES_TOL)
            compare_tables(got, want, what=what + " vs the CPU",
                           **ENGINE_MODES_TOL)
            counters = (pu._rowshard_regions, pu._rowshard_fallbacks)
            assert counters == (cpu_pu._rowshard_regions,
                                cpu_pu._rowshard_fallbacks), what
            assert got["accumulate"].iloc[0] == route, what
            st = pu.mesh_stats
            if route == "cuda_kernel":
                assert sum(st["launches"]) == launched, what
                assert not any(s and not k for s, k in
                               zip(st["snips"], st["launches"])), what
            if spec.get("banded"):
                assert pu._rowshard_regions, what
                if route == "generic_torch":
                    banded_generic.append(counters[0])
            launches[name] = st["launches"]
    assert set(launches) == set(cases.MESH_MODES)
    assert all(k > 0 for k in launches["cis_banded"])
    if not cuda:
        assert launches["wide_banded"] == [0] * 4
        assert 2 in banded_generic
    assert (torch.cuda.current_device() if cuda else None) == current


@pytest.mark.parametrize("device", DEVICES)
def test_mesh_genome_and_session(device, monkeypatch):
    """The genome cell (CPU: 3 chromosomes of 1,200 bins) on
    ``LociMesh([device] * n)`` for n in ``GENOME_MESH_SIZES``, each against
    the single-device table (counts exact, ``data`` rtol 1e-4) with a quad
    launch on every device that holds snips; then
    ``QuadMeshSession.run_chunk`` at ``bench.py:673`` bench_scaling's size
    (262,144 loci, W = 21; CPU: 3,000 loci on 2,000 bins) on the same
    meshes against ``QuadPileupSession.run_many`` (``num`` exact, poison
    equal, ``sum`` rtol 1e-5)."""
    from coolpuppy_tpu_torch.parallel import (
        LociMesh,
        QuadMeshSession,
        build_row_partition,
        route_snips,
    )

    dev = cases.device(device)
    if dev.type == "cpu":
        counted_plain(monkeypatch)
        clr, feats = cases.genome_workload(**SMALL_GENOME)
        scaling = dict(n_loci=3_000, n_bins=2_000, nnz_target=100_000)
    else:
        clr, feats = cases.genome_workload()
        scaling = {}
    single = cases.genome_run(clr, feats, dev)[1]
    out = {}
    for n in cases.GENOME_MESH_SIZES:
        what = f"genome mesh of {n}"
        qg.LAUNCHES = 0
        pu, table = cases.genome_run(clr, feats, dev, mesh=LociMesh([dev] * n))
        compare_tables(table, single, what=what, **TABLE_TOL)
        assert table["accumulate"].iloc[0] == (
            "cuda_kernel" if dev.type == "cuda" or qg.LAUNCHES else "plain")
        st = pu.mesh_stats
        assert sum(st["launches"]) == qg.LAUNCHES, what
        assert not any(s and not k for s, k in
                       zip(st["snips"], st["launches"])), what
        out[n] = st["launches"]
    assert len(out[4]) == 4
    if dev.type == "cpu":
        assert out[1] == [3]
    del single, clr, feats

    ts, r1, r2, cid, valid, evec = cases.scaling_workload(**scaling)
    cfg = dict(W=21, capacity=8, ooe=True)
    want = qg.QuadPileupSession(ts, valid, valid, evec, cfg, dev).run_many(
        r1, r2, cid)
    pois = want["poison"] > 0
    for n in cases.GENOME_MESH_SIZES:
        what = f"mesh session n={n}"
        part = build_row_partition(ts, r1, n)
        order, counts = route_snips(part, r1)
        items = np.split(order, np.cumsum(counts)[:-1])
        session = QuadMeshSession(LociMesh([dev] * n), ts, part, valid, valid,
                                  evec, cfg)
        rows = [[a[it] for it in items] for a in (r1, r2, cid)]
        got = qg.QuadPileupSession.finalize([session.run_chunk(*rows)])
        np.testing.assert_array_equal(got["num"], want["num"], err_msg=what)
        np.testing.assert_array_equal(got["poison"] > 0, pois, err_msg=what)
        np.testing.assert_allclose(got["sum"][~pois], want["sum"][~pois],
                                   rtol=1e-5, atol=1e-5, err_msg=what)


# -- the reader's fetch path, the fuzz cases, by distance ---------------------


@pytest.mark.parametrize("device", DEVICES)
def test_reader_fuzz_and_by_distance_cells(device, monkeypatch):
    """On the engine map (card: 20,000 sites; CPU: 200 on 1,500 bins).
    The engine cell through a ``Cooler`` whose store counts its reads
    (``CountingStore``): the quad kernel launched, every fetch exactly its
    spans' rows (``fetch_spans``), at most ``_PREFETCH_MAX`` fetching
    threads, and the table against the same run on the map's own Cooler.
    The seeded fuzz cases ``FUZZ_CARD_SEEDS`` (``fuzz_case`` at
    ``FUZZ_ENGINE``'s scale; CPU: 40-80 sites) each through a counting
    reader of its own: the launches as the route says, every fetch its
    spans, against the plain-swapped run (rtol 1e-4, stripes too) and the
    first ``FUZZ_CPU_SITES`` features (CPU: 30) against the CPU (rtol
    1e-5). By-strand by-distance APA of the sites through the notebook
    alias ``coolpuppy_tpu_torch.coolpup.pileup`` against the plain-swapped
    run."""
    from coolpuppy_tpu_torch import Cooler
    from coolpuppy_tpu_torch.coolpup import pileup as alias
    from coolpuppy_tpu_torch.expected import expected_cis

    dev = cases.device(device)
    scale, cpu_sites = cases.FUZZ_ENGINE, cases.FUZZ_CPU_SITES
    if dev.type == "cpu":
        counted_plain(monkeypatch)
        clr, feats = engine_workload(n_sites=200, **SMALL_MAP)
        scale = dict(scale, n=(40, 80), start=(100, 1_400), tad=(5, 30))
        cpu_sites = 30
    else:
        clr, feats = engine_workload()

    reader = Cooler(cases.CountingStore(clr.store))
    with cases.fetch_log(reader) as log:
        table, _ = kernel_run("reader run", lambda: pileup(
            reader, feats, device=dev, **ENGINE_KW))
    per_fetch = cases.fetch_spans(reader, log.fetches)
    assert per_fetch and sum(per_fetch) > 0
    assert len({f[3] for f in log.fetches}) <= ENGINE._PREFETCH_MAX
    want = kernel_run("engine run", lambda: pileup(
        clr, feats, device=dev, **ENGINE_KW))[0]
    compare_tables(table, want, what="reader run vs the map's own Cooler",
                   **TABLE_TOL)

    exp = expected_cis(clr)
    for seed in cases.FUZZ_CARD_SEEDS:
        what = f"fuzz {seed}"
        f, kw = cases.fuzz_case(np.random.default_rng(seed), {"cis": exp},
                                scale)
        # a reader of its own a case: a coverage column one pileup stores
        # on its Cooler is reused by the next, whatever its min_diag
        reader = Cooler(cases.CountingStore(clr.store))
        # a by-window case's checked and plain-swapped runs fetch float32
        # accumulators; the CPU subset's device run takes no wire
        fetch = F32_FETCH if kw.get("by_window") else {}

        def run(f, device=dev, kw=kw, reader=reader, **extra):
            return pileup(reader, f, device=device, **kw, **extra)

        qg.LAUNCHES = 0
        with cases.fetch_log(reader) as log:
            checked = run(f, **fetch)
        route = checked["accumulate"].iloc[0]
        assert (qg.LAUNCHES >= 1) == ("cuda_kernel" in route), (what, route)
        assert table_snips(checked) > 0, what
        cases.fetch_spans(reader, log.fetches)
        plain = plain_swapped(what, lambda: run(f, **fetch),
                              route.replace("cuda_kernel", "plain"))
        compare_tables(checked, plain, what=f"{what} vs plain",
                       stripe_tol=cases.FUZZ_TOL, **cases.FUZZ_TOL)
        sub = f.iloc[:cpu_sites]
        compare_tables(run(sub, **F32_WIRE), run(sub, device="cpu"),
                       what=f"{what} subset card vs cpu", **ENGINE_MODES_TOL)

    def by_distance():
        return alias(clr, feats, device=dev, **cases.BY_DISTANCE_KW)

    checked, _ = kernel_run("by-distance run", by_distance)
    assert len(set(checked["distance_band"].astype(str)) - {"all"}) > 1
    compare_tables(checked, plain_swapped("by_distance", by_distance),
                   what="by-distance kernel vs plain", **TABLE_TOL)


# -- the transfer wires ------------------------------------------------------


@pytest.mark.parametrize("device", DEVICES)
def test_wire_cells(device, monkeypatch):
    """The transfer wires (the float16/int8 tile upload, the float16 stripe
    fetch, the flip-merged accumulator fetch; on by default on the card,
    forced on the CPU). ``WIRE_TOY``'s cases, the device against the CPU
    forced onto the same wire: the plan's mode on both sides, the COO wire,
    the uploads' dtypes, ``compare_tables`` within rtol 1e-5. Then
    ``WIRE_CELLS`` on the engine map (card: 20,000 sites; CPU: 200, the
    bank lowered to 8 groups so by_window's blocks take the float16 fetch),
    wire on against ``F32_WIRE``: the quad kernel launched, the plan's mode,
    the float16 fetches in by_window, the float16 stripe gathers in
    stripes, counts exact and ``data`` within the cell's bound."""
    dev = cases.device(device)
    forced = dev.type != "cuda"
    for name, spec in cases.WIRE_TOY.items():
        what = f"wire toy {name}"
        got, gspy = cases.wire_toy_run(name, dev, force=forced)
        want, wspy = cases.wire_toy_run(name, "cpu", force=True)
        for spy in (gspy, wspy):
            assert spy.plans and set(spy.plans) == {spec["mode"]}, what
            if spec.get("coo"):
                assert set(spy.coo) == {spec["mode"]}, what
        assert sorted(gspy.uploads) == sorted(wspy.uploads), what
        if spec["mode"] == "int8":
            assert set(gspy.uploads) == {"int8"}, what
        compare_tables(got, want, what=what, **ENGINE_MODES_TOL)

    if forced:
        counted_plain(monkeypatch)
        monkeypatch.setattr(ENGINE, "_bank_groups", lambda W: 8)
        clr, feats = engine_workload(n_sites=200, **SMALL_MAP)
    else:
        clr, feats = engine_workload()
    clr8 = cases.int8_map(clr)
    for cell, spec in cases.WIRE_CELLS.items():
        what = f"wire {cell}"
        mclr = clr8 if spec.get("map") == "int8" else clr
        int8 = spec["mode"] == "int8"
        runs = []
        for wire in ({}, F32_WIRE):
            qg.LAUNCHES = 0
            with cases.wire_spy(int8=int8, forced=forced) as spy:
                table = pileup(mclr, feats, device=dev, **spec["kw"], **wire)
            runs.append((table, spy, qg.LAUNCHES))
        (on, spy, n_on), (off, off_spy, _) = runs
        assert n_on >= 1 and (n_on == 1 or not forced), (what, n_on)
        assert on["accumulate"].iloc[0] == off["accumulate"].iloc[0], what
        assert spy.plans and set(spy.plans) == {spec["mode"]}, what
        assert set(off_spy.plans) == {False}, what
        if int8:
            assert set(spy.uploads) == {"int8"}, what
        if spec.get("k9"):
            assert spy.merges and all(spy.merges), what
            assert not any(off_spy.merges), what
        if spec.get("stripe_tol"):
            assert spy.stripes == {"float16"}, what
            assert off_spy.stripes == {"float32"}, what
        compare_tables(on, off, what=f"{what} on vs off",
                       stripe_tol=spec.get("stripe_tol"), **spec["tol"])
