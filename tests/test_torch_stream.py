"""The port's streamed multi-region path against its collected path and the
JAX package's ``pileup()``, on the CPU.

``pileup(device="cpu")`` streams every eligible region (``_QuadStream``:
the stack of a coordinate-free tile predicate built on the staging worker,
snip chunks accumulated while coordinates are made) and stages regions
ahead on the prefetch threads. Each case runs it with small stream chunks
(so the chunks' accumulators are summed), then with ``_maybe_open_stream``
patched to return None (the collected path), then through the reference:
group keys in the same order, ``n``/``num`` exact, ``data`` rtol 1e-4,
stripes rtol 1e-5. The phase timers' counts say which path ran:
``stream_regions``, ``stream_aborts``, ``stream_chunks``."""

import importlib
import os
import sys
import threading

import numpy as np
import pandas as pd
import pytest

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu as ref
import coolpuppy_tpu_torch as port
from coolpuppy_tpu_torch.expected import expected_cis
from coolpuppy_tpu_torch.ops import tiles
from fixtures import make_toy_cooler, toy_features, toy_regions
from torch_cases import (
    GENOME_KW,
    compare_tables,
    genome_workload,
    toy_bedpe,
    trans_cooler,
)

engine = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")
TOL = dict(rtol=1e-4, atol=1e-7)
TOY_KW = dict(mindist=0, flank=2_000_000, view_df=toy_regions())
# snips a stream launch here: several chunks a region of the toy map (tens
# of snips) and of the cut genome (~10,000)
TOY_CHUNK = 2
GENOME_CHUNK = 4_000


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch, request):
    genome = "genome" in request.fixturenames
    monkeypatch.setattr(engine, "_STREAM_CHUNK",
                        GENOME_CHUNK if genome else TOY_CHUNK)


@pytest.fixture
def runs(monkeypatch):
    """Every PileUpper that runs ``pileupsWithControl``, in order."""
    seen = []
    inner = engine.PileUpper.pileupsWithControl

    def recording(self, *a, **k):
        seen.append(self)
        return inner(self, *a, **k)

    monkeypatch.setattr(engine.PileUpper, "pileupsWithControl", recording)
    return seen


def collected(monkeypatch):
    monkeypatch.setattr(engine.PileUpper, "_maybe_open_stream",
                        lambda *a, **k: None)


def _write_cool(clr, path):
    """The port Cooler's pixels as a .cool file the reference reads."""
    from coolpuppy_tpu.io import write_cool

    b1, b2, count = clr.pixels_chunk(0, clr.n_pixels)
    write_cool(path, clr.chromsizes, clr.binsize,
               (b1, b2, count.astype(np.int64)),
               weights=clr.bins_df()["weight"].to_numpy())
    return ref.Cooler(path)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cool") / "toy.cool")
    ref_clr, _, _ = make_toy_cooler(path, seed=3)
    return ref_clr, port.Cooler.from_cool(path)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """``bench_genome``'s map cut to 5 chromosomes of 1,200 bins (40,000
    contacts each) and 500 sites, in memory and as a .cool file."""
    clr, feats = genome_workload(n_chroms=5, bins_per=1_200,
                                 contacts_per=40_000, n_sites=500)
    path = str(tmp_path_factory.mktemp("cool") / "genome.cool")
    return _write_cool(clr, path), clr, feats


def _three_ways(monkeypatch, runs, want_fn, got_fn, what):
    """The stream run, the collected run and the reference, compared.
    Returns the stream run's counts."""
    got = got_fn()
    counts = dict(runs[-1].timers.counts)
    with monkeypatch.context() as m:
        collected(m)
        plain = got_fn()
    assert runs[-1].timers.counts.get("stream_regions", 0) == 0
    compare_tables(got, plain, what=f"{what}: stream vs collected", **TOL)
    compare_tables(got, want_fn(), what=f"{what}: stream vs reference", **TOL)
    return counts


CIS_MODES = {
    "by_strand_controls": dict(by_strand=True, nshifts=2, seed=7),
    "expected_emission": dict(expected=True, ooe=False),
    "ooe_flip": dict(expected=True, by_strand=True,
                     flip_negative_strand=True),
    "coverage_norm": dict(clr_weight_name=None, coverage_norm=True),
    "distance_groups": dict(by_distance=True, nshifts=1, seed=2),
}


@pytest.mark.parametrize("mode", sorted(CIS_MODES))
def test_cis_bed_band_stream(toy, monkeypatch, runs, mode):
    ref_clr, clr = toy
    kw = dict(TOY_KW, **CIS_MODES[mode])
    if kw.pop("expected", False):
        kw["expected_df"] = expected_cis(clr, toy_regions())
    counts = _three_ways(
        monkeypatch, runs,
        lambda: ref.pileup(ref_clr, toy_features(), **kw),
        lambda: port.pileup(clr, toy_features(), device="cpu", **kw),
        mode)
    assert counts["stream_regions"] == len(toy_regions())
    # one launch per TOY_CHUNK snips of a region
    assert counts["stream_chunks"] >= -(-counts["snips"] // TOY_CHUNK) > 2
    assert counts.get("stream_aborts", 0) == 0


@pytest.mark.parametrize("nshifts", [0, 2])
def test_bedpe_rows_stream(toy, monkeypatch, runs, nshifts):
    """BEDPE rows stream on the tiles of their rectangles widened by the
    shift margin (``rect_tiles``)."""
    ref_clr, clr = toy
    kw = dict(TOY_KW, features_format="bedpe", nshifts=nshifts, seed=6)
    counts = _three_ways(
        monkeypatch, runs,
        lambda: ref.pileup(ref_clr, toy_bedpe(), **kw),
        lambda: port.pileup(clr, toy_bedpe(), device="cpu", **kw),
        f"bedpe nshifts={nshifts}")
    assert counts["stream_regions"] >= 2
    assert counts.get("stream_aborts", 0) == 0


def test_trans_stream_coo_wire(tmp_path, monkeypatch, runs):
    """A sparse trans rectangle streams through the COO wire: its stack,
    scatter-added from (index, value) pairs, equals the dense native stack
    of the same tiles (rtol 1e-6: float32 sums in either order), and the
    tables equal the collected path's (dense) and the reference's."""
    clr = trans_cooler(n1=600, n2=500, n_cis=20_000, n_trans=6_000)
    ref_clr = _write_cool(clr, str(tmp_path / "trans.cool"))
    rng = np.random.default_rng(4)
    feats = pd.DataFrame({
        "chrom": ["chr1"] * 40 + ["chr2"] * 40,
        "start": np.concatenate([np.sort(rng.choice(5_900_000, 40, False)),
                                 np.sort(rng.choice(4_900_000, 40, False))]),
    })
    feats["end"] = feats["start"] + 1_000
    built = []
    inner = engine.build_tile_stack_coo

    def recording(slab, B, want, **kw):
        built.append((slab, want, inner(slab, B, want, **kw)))
        return built[-1][2]

    monkeypatch.setattr(engine, "build_tile_stack_coo", recording)
    kw = dict(flank=50_000, trans=True, nshifts=1, seed=3)
    counts = _three_ways(
        monkeypatch, runs,
        lambda: ref.pileup(ref_clr, feats, **kw),
        lambda: port.pileup(clr, feats, device="cpu", **kw),
        "trans")
    assert counts["stream_regions"] == 1 and len(built) == 1
    slab, want, cts = built[0]
    dense = tiles.build_tile_stack_slab(slab, 128, want=want)
    np.testing.assert_array_equal(cts.tile_map, dense.tile_map)
    got = tiles.coo_tiles(cts, "cpu").numpy()
    assert got.shape == dense.tiles.shape and cts.nnz > 1_000
    np.testing.assert_allclose(got, dense.tiles, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got != 0, dense.tiles != 0)
    np.testing.assert_allclose(cts.expand_host(), dense.tiles, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kw", [dict(nshifts=2, seed=1), dict(local=True)],
                         ids=["controls", "local"])
def test_stripes_stream(toy, monkeypatch, runs, kw):
    """Stripe planes gathered per chunk and copied out as the stream goes,
    in stream order: equal to the collected path's and the reference's
    (rtol 1e-5, coordinates exact)."""
    ref_clr, clr = toy
    args = dict(TOY_KW, store_stripes=True, **kw)
    counts = _three_ways(
        monkeypatch, runs,
        lambda: ref.pileup(ref_clr, toy_features(), **args),
        lambda: port.pileup(clr, toy_features(), device="cpu", **args),
        "stripes")
    assert counts["stream_regions"] == len(toy_regions())


def _cc(pkg, feats, clr, **kw):
    args = dict(GENOME_KW, **kw)
    del args["by_strand"]
    return pkg.CoordCreator(feats, clr.binsize, **args)


def test_modify_func_off_the_predicate_aborts(genome, monkeypatch, runs):
    """A ``modify_2Dintervals_func`` that moves chr1's windows 600 bins off
    the diagonal band: chr1's stream aborts to the collected path, the
    other regions stream, and the results equal the reference's."""
    ref_clr, clr, feats = genome

    def far(frame):
        frame = frame.copy()
        move = ((frame["chrom1"].astype(str) == "chr1")
                & (frame["stBin2"] < 1_200 - 621))
        for side in ("stBin2", "endBin2"):
            frame.loc[move, side] += 600
        for side in ("start2", "end2"):
            frame.loc[move, side] += 600 * clr.binsize
        return frame

    def run(pkg, c):
        pu = pkg.PileUpper(c, _cc(pkg, feats, c), control=True,
                           **({"device": "cpu"} if pkg is port else {}))
        return pu.pileupsWithControl(modify_2Dintervals_func=far,
                                     groupby=["strand1", "strand2"])

    counts = _three_ways(monkeypatch, runs, lambda: run(ref, ref_clr),
                         lambda: run(port, clr), "modify func")
    assert counts["stream_aborts"] == 1
    assert counts["stream_regions"] == len(clr.chromnames) - 1


def test_more_groups_than_the_stream_bank(toy, monkeypatch, runs):
    """With the accumulator block cut to 2 groups, the stream's bank holds
    2: by strand with controls makes 8, so every stream aborts and the
    collected path runs in blocks of 2 groups."""
    ref_clr, clr = toy
    kw = dict(TOY_KW, by_strand=True, nshifts=1, seed=5)
    want = port.pileup(clr, toy_features(), device="cpu", **kw)
    monkeypatch.setattr(engine, "_BLOCK_BYTES", 2 * 2 * 5 * 5 * 8)
    assert engine._block_half(5) == 2
    got = port.pileup(clr, toy_features(), device="cpu", **kw)
    counts = runs[-1].timers.counts
    assert counts["stream_aborts"] == len(toy_regions())
    assert counts.get("stream_regions", 0) == 0
    compare_tables(got, want, what="blocked vs stream", **TOL)
    compare_tables(got, ref.pileup(ref_clr, toy_features(), **kw),
                   what="blocked vs reference", **TOL)


def test_genome_prefetch_nproc(genome, monkeypatch, runs):
    """The 5-chromosome genome with 1, 2 and 4 prefetch threads: the same
    table bit for bit, every region streamed; against the collected path
    and the reference."""
    ref_clr, clr, feats = genome
    tables = {}
    for nproc in (1, 2, 4):
        tables[nproc] = port.pileup(clr, feats, device="cpu", nproc=nproc,
                                    **GENOME_KW)
        counts = runs[-1].timers.counts
        assert counts["stream_regions"] == len(clr.chromnames)
        assert counts["stream_chunks"] > len(clr.chromnames)
    for nproc in (2, 4):
        compare_tables(tables[nproc], tables[1], rtol=0, atol=0,
                       what=f"nproc {nproc} vs 1")
    with monkeypatch.context() as m:
        collected(m)
        plain = port.pileup(clr, feats, device="cpu", nproc=4, **GENOME_KW)
    compare_tables(tables[4], plain, what="stream vs collected", **TOL)
    compare_tables(tables[4], ref.pileup(ref_clr, feats, **GENOME_KW),
                   what="stream vs reference", **TOL)


def test_checkpoint_resume_under_prefetch(genome, tmp_path, monkeypatch,
                                          runs):
    """Checkpointed regions are loaded, not staged: after two of five
    checkpoints are deleted, only those two regions are staged and
    streamed, and the table is the uninterrupted run's."""
    _, clr, feats = genome
    staged = []
    inner = engine.PileUpper._stage_region

    def recording(self, r1, r2, **kw):
        staged.append(r1)
        return inner(self, r1, r2, **kw)

    monkeypatch.setattr(engine.PileUpper, "_stage_region", recording)

    def run():
        cc = _cc(port, feats, clr)
        pu = port.PileUpper(clr, cc, control=True, nproc=4,
                            checkpoint_dir=str(tmp_path), device="cpu")
        return pu.pileupsByStrandWithControl()

    first = run()
    assert len(staged) == len(clr.chromnames)
    ckpts = sorted(tmp_path.glob("*.pkl"))
    assert len(ckpts) == len(clr.chromnames)
    for path in ckpts[1:3]:
        os.remove(path)
    staged.clear()
    second = run()
    assert sorted(staged) == sorted(p.name.split("__")[0]
                                    for p in ckpts[1:3])
    assert runs[-1].timers.counts["stream_regions"] == 2
    compare_tables(second, first, rtol=0, atol=0, what="resumed")
    assert second["accumulate"].iloc[0] == "plain"
    staged.clear()
    compare_tables(run(), first, rtol=0, atol=0, what="all resumed")
    assert staged == []


@pytest.mark.parametrize("where", ["quad-stage", "region-stage"])
def test_worker_errors_propagate(genome, monkeypatch, where):
    """An error on the staging worker (the stream's session build) or on a
    prefetch thread (the region's staging) fails the run with that error:
    it does not turn into an abort and the collected path."""
    _, clr, feats = genome
    if where == "quad-stage":
        cls, name = engine.quad_gather.QuadPileupSession, "__init__"
    else:
        cls, name = engine.PileUpper, "_stage_region"
    inner = getattr(cls, name)

    def failing(*a, **k):
        if threading.current_thread().name.startswith(where):
            raise RuntimeError(f"injected failure on {where}")
        return inner(*a, **k)

    monkeypatch.setattr(cls, name, failing)
    with pytest.raises(RuntimeError, match=f"injected failure on {where}"):
        port.pileup(clr, feats, device="cpu", nproc=2, **GENOME_KW)
    monkeypatch.setattr(cls, name, inner)
    table = port.pileup(clr, feats.iloc[:100], device="cpu", **GENOME_KW)
    assert int(table["n"].iloc[-1]) > 0


def test_phase_timers_across_threads():
    """The timers the prefetch threads and the staging worker share: counts
    from 16 threads at once lose no update, and a phase opened inside
    another on the same thread pauses it."""
    import time

    from coolpuppy_tpu_torch.observability import PhaseTimers

    timers = PhaseTimers()

    def work():
        for _ in range(2_000):
            timers.count("n")
            with timers.phase("outer"), timers.phase("inner"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert timers.counts["n"] == 32_000
    timers = PhaseTimers()
    with timers.phase("a"):
        time.sleep(0.05)
        with timers.phase("b"):
            time.sleep(0.05)
    assert 0.05 <= timers.seconds["a"] < 0.09
    assert 0.05 <= timers.seconds["b"] < 0.09
