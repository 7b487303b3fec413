"""The coordinates as integer blocks (``CoordCreator.blocks``) against the
frames (``CoordCreator.batches``), on the CPU.

Each kind of snip stream (cis BED pairs through the native and the lazy
sweep, unsorted centers, local, cis BEDPE, trans BED, trans BEDPE), with
and without controls, grouped over a string column with NaN, a
categorical, an int column, or nothing: the blocks' control shifts, and
their lowered ``r1``, ``r2``, ``h1``, ``w2``, ``dd0`` and cids (with the
order of ``cid_of``), equal the frames', array for array. Then whole
pileups on the toy genome: the block route's table equals the frame
route's that an identity ``postprocess_frame_func`` forces, the regions
counted on the route each run takes, and every hook that reads or
rewrites frames keeps the frames.
"""

import importlib
import types
from functools import partial

import numpy as np
import pandas as pd
import pytest

from coolpuppy_tpu_torch import CoordCreator, PileUpper
from coolpuppy_tpu_torch.coords import CoordBlock
from coolpuppy_tpu_torch.lib.puputils import accumulate_values
from coolpuppy_tpu_torch.observability import PhaseTimers
from torch_cases import compare_tables, genome_workload

engine = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")

RES = 10_000
CHROM_BINS = 2_000
W = 11  # flank 50 kb

GROUPBYS = {
    "none": [],
    "str_nan": ["strand1", "strand2"],
    "categorical": ["cat1", "cat2"],
    "int": ["score1", "score2"],
    "mixed": ["strand2", "cat1", "score1"],
    # more codes than a chunk has snips: cids through np.unique
    "wide": ["start1", "start2"],
}
KINDS = ["cis_native", "cis_lazy", "cis_unsorted", "local", "bedpe_cis",
         "trans_bed", "trans_bedpe"]


def _columns(rng, n):
    return {
        "strand": rng.choice(np.array(["+", "-", None], object), n),
        "cat": pd.Categorical(rng.choice(["a", "b", "c"], n),
                              categories=["c", "b", "a", "unused"]),
        "score": rng.integers(0, 3, n),
    }


def _bed(rng, unsorted=False):
    """120 sites a chromosome on two chromosomes of 2,000 bins; with
    ``unsorted``, every fifth one 300 kb long, so centers leave start
    order."""
    frames = []
    for chrom in ("chr1", "chr2"):
        n = 120
        start = np.sort(rng.choice(np.arange(5, CHROM_BINS - 40), n,
                                   replace=False)) * RES
        end = start + 1_000
        if unsorted:
            end[::5] += 300_000
        frames.append(pd.DataFrame({"chrom": chrom, "start": start,
                                    "end": end, **_columns(rng, n)}))
    return pd.concat(frames, ignore_index=True)


def _bedpe(rng, trans):
    """Rows of two 1 kb anchors 200 kb - 1.5 Mb apart; under ``trans``
    a third of them join the chromosomes, half of those chr2 first."""
    n = 300
    chrom1 = np.array(["chr1", "chr2"])[rng.integers(0, 2, n)]
    chrom2 = chrom1.copy()
    if trans:
        cross = rng.random(n) < 0.35
        chrom2[cross] = np.where(chrom1[cross] == "chr1", "chr2", "chr1")
    s1 = rng.integers(5, CHROM_BINS - 200, n) * RES
    s2 = s1 + rng.integers(20, 150, n) * RES
    side = {}
    for k in ("1", "2"):
        for name, col in _columns(rng, n).items():
            side[name + k] = col
    return pd.DataFrame({"chrom1": chrom1, "start1": s1, "end1": s1 + 1_000,
                         "chrom2": chrom2, "start2": s2, "end2": s2 + 1_000,
                         **side})


def _creator(kind, control, monkeypatch):
    rng = np.random.default_rng(sum(map(ord, kind)))
    kw = dict(flank=50_000, nshifts=3 if control else 0, seed=11,
              chunk_size=900, minshift=100_000, maxshift=1_000_000)
    if kind == "cis_lazy":
        monkeypatch.setattr(CoordCreator, "LAZY_PAIR_THRESHOLD", 10)
    if kind.startswith("cis"):
        feats = _bed(rng, unsorted=kind == "cis_unsorted")
        return CoordCreator(feats, RES, maxdist=1_500_000, **kw)
    if kind == "local":
        return CoordCreator(_bed(rng), RES, local=True, **kw)
    if kind == "trans_bed":
        return CoordCreator(_bed(rng), RES, trans=True, **kw)
    cc = CoordCreator(_bedpe(rng, kind == "trans_bedpe"), RES,
                      features_format="bedpe", trans=kind == "trans_bedpe",
                      **kw)
    if kind == "trans_bedpe":  # rows of either order: some are swapped
        (r1, r2), _ = _region_pairs(kind)
        assert len(cc._bedpe_rows(r1, r2)) and len(cc._bedpe_rows(r2, r1))
    return cc


def _region_pairs(kind):
    chr1 = ("chr1", 0, CHROM_BINS * RES)
    chr2 = ("chr2", 0, CHROM_BINS * RES)
    if kind.startswith("trans"):
        return [(chr1, chr2), (chr2, chr1)]
    return [(chr1, None), (chr2, None)]


def _dev(region1, region2):
    """Region offsets that cut a few windows at both ends of each side."""
    n = CHROM_BINS - 60
    return dict(min1=25, n1=n, min2=30 if region2 is not None else 25,
                n2=n)


def _lowered(chunks, dev):
    """Every chunk's raw bins and lowered arrays, and ``cid_of``'s order."""
    cid_of = {}

    def ensure_cid(kind, group):
        return cid_of.setdefault((kind, group), len(cid_of))

    host = types.SimpleNamespace(rescale=False)
    lut = (None, None)
    out = []
    for blk in chunks:
        raw = (blk.stBin1, blk.endBin1, blk.stBin2, blk.endBin2, blk.kind)
        low = engine.PileUpper._lower_block(host, blk, dev, W)
        if low is None:
            out.append((raw, None))
            continue
        inb, r1, r2, h1, w2, dd0, kind, group, flip = low
        assert flip is None
        if lut[0] is not blk.groups:
            lut = (blk.groups, None)
        cids, table = engine._block_cids(kind, group, blk.groups, ensure_cid,
                                         lut[1])
        lut = (blk.groups, table)
        out.append((raw, (inb, r1, r2, h1, w2, dd0, cids)))
    return out, list(cid_of)


@pytest.mark.parametrize("groupby", list(GROUPBYS))
@pytest.mark.parametrize("control", [False, True], ids=["roi", "controls"])
@pytest.mark.parametrize("kind", KINDS)
def test_blocks_lower_as_the_frames(kind, control, groupby, monkeypatch):
    cc = _creator(kind, control, monkeypatch)
    gb = GROUPBYS[groupby]
    assert cc.block_groups(gb) is not None
    n_chunks = cut = 0
    for region1, region2 in _region_pairs(kind):
        dev = _dev(region1, region2)
        frames = [CoordBlock.from_frame(f) for f in cc.batches(
            region1, region2, control=control, groupby=gb)]
        want, want_order = _lowered(frames, dev)
        got, got_order = _lowered(
            cc.blocks(region1, region2, control=control, groupby=gb), dev)
        assert len(got) == len(want)
        for (graw, glow), (wraw, wlow) in zip(got, want):
            # the bins before the region's cut: the control shifts
            for g, w in zip(graw, wraw):
                np.testing.assert_array_equal(g, w)
            assert (glow is None) == (wlow is None)
            if wlow is None:
                continue
            assert (glow[0] is None) == (wlow[0] is None)
            for g, w in zip(glow, wlow):
                if w is not None:
                    np.testing.assert_array_equal(g, w)
                    assert g.dtype == w.dtype
        assert got_order == want_order
        n_chunks += len(got)
        cut += sum(low is None or low[0] is not None for _, low in got)
    assert n_chunks > 0
    if control:
        assert cut  # controls shifted past the region's bins
    if kind in ("cis_native", "cis_lazy") and control:
        assert n_chunks > 2  # chunk boundaries, and the draws they key


def test_block_groups_refuse_what_controls_shift():
    cc = _creator("cis_native", True, None)
    assert cc.block_groups(["stBin1"]) is None
    assert cc.block_groups(["center2", "strand1"]) is None
    assert cc.block_groups(["distance"]) is None  # no feature column
    assert cc.block_groups(["strand1"]) is cc.block_groups(("strand1",))
    with pytest.raises(ValueError, match="needs the frames"):
        next(cc.blocks(("chr1", 0, CHROM_BINS * RES), groupby=["stBin1"]))
    cc = _creator("bedpe_cis", True, None)
    assert cc.block_groups(["exp_start1"]) is None
    assert cc.block_groups(["distance"]) is not None


# -- whole pileups on the toy genome --------------------------------------


@pytest.fixture
def one_thread():
    """The native scatter at one thread, which adds in input order: a
    team adds float32 in an order the threads' timing picks (atomics, or
    buffers summed in turn), so only one thread repeats a table bit for
    bit."""
    from coolpuppy_tpu_torch import native

    was = native.threads()
    native.set_threads(1)
    yield
    native.set_threads(was)


@pytest.fixture(scope="module")
def genome():
    return genome_workload(n_chroms=3, bins_per=600, contacts_per=20_000,
                           n_sites=300)


def _bedpe_sites(feats):
    """Every site joined to the third one after it on its chromosome."""
    rows = []
    for _, f in feats.groupby("chrom", sort=False):
        a, b = f.iloc[:-3].reset_index(drop=True), f.iloc[3:].reset_index(
            drop=True)
        rows.append(pd.DataFrame({
            "chrom1": a["chrom"], "start1": a["start"], "end1": a["end"],
            "chrom2": b["chrom"], "start2": b["start"], "end2": b["end"],
            "strand1": a["strand"], "strand2": b["strand"]}))
    return pd.concat(rows, ignore_index=True)


def _domains(feats):
    """Each site as a domain of 40-200 kb, for local rescaled windows."""
    feats = feats.copy()
    feats["end"] = feats["start"] + 40_000 * (1 + np.arange(len(feats)) % 5)
    return feats


JOBS = {
    # the pairs_by_strand cell's keywords
    "pairs_by_strand": (dict(flank=100_000, maxdist=2_000_000, nshifts=10),
                        ["strand1", "strand2"], "bed"),
    "local": (dict(flank=100_000, local=True, nshifts=3), ["strand1"],
              "bed"),
    "bedpe_controls": (dict(flank=100_000, nshifts=5), ["strand1"], "bedpe"),
    # windows of many sizes: the rescale route's h1 and w2
    "local_rescale": (dict(local=True, rescale_flank=1, nshifts=2),
                      ["strand1"], "domains"),
}


def _job(clr, feats, name, hook=None, **pu_kw):
    cc_kw, groupby, fmt = JOBS[name]
    cc_kw = dict(cc_kw, seed=7)
    if fmt == "bedpe":
        feats = _bedpe_sites(feats)
    elif fmt == "domains":
        feats, fmt = _domains(feats), "bed"
        pu_kw = dict(pu_kw, rescale=True, rescale_size=21)
    cc = CoordCreator(feats, clr.binsize, features_format=fmt, **cc_kw)
    timers = PhaseTimers()
    pu = PileUpper(clr, cc, control=cc_kw["nshifts"] > 0, device="cpu",
                   timers=timers, **pu_kw)
    return pu, pu.pileupsWithControl(groupby=groupby,
                                     postprocess_frame_func=hook)


@pytest.mark.parametrize("name", list(JOBS))
def test_block_route_tables_equal_the_frame_route(genome, name, one_thread):
    clr, feats = genome
    pu, got = _job(clr, feats, name)
    regions = len(pu.view_df)
    assert pu.timers.counts["coord_block_regions"] == regions
    assert pu.timers.counts["coord_frame_regions"] == 0
    pu, want = _job(clr, feats, name, hook=lambda frame: frame)
    assert pu.timers.counts["coord_frame_regions"] == regions
    assert pu.timers.counts["coord_block_regions"] == 0
    assert len(want) > 1 and want["n"].iloc[-1] > 0
    compare_tables(got, want, rtol=0, atol=0, what=name)


HOOKS = {
    "flip_negative_strand": lambda pu: pu.pileupsWithControl(),
    "by_distance": lambda pu: pu.pileupsByDistanceWithControl(),
    "store_stripes": lambda pu: pu.pileupsWithControl(),
    "by_window": lambda pu: pu.pileupsByWindowWithControl(),
    "extra_sum_funcs": lambda pu: pu.pileupsWithControl(extra_sum_funcs={
        "strand1": partial(accumulate_values, key="strand1")}),
}


@pytest.mark.parametrize("hook", list(HOOKS))
def test_hooks_keep_the_frames(genome, hook):
    clr, feats = genome
    cc = CoordCreator(feats, clr.binsize, flank=100_000, maxdist=1_000_000,
                      nshifts=2, seed=3)
    timers = PhaseTimers()
    pu = PileUpper(clr, cc, control=True, device="cpu", timers=timers,
                   flip_negative_strand=hook == "flip_negative_strand",
                   store_stripes=hook == "store_stripes")
    table = HOOKS[hook](pu)
    assert len(table) and pu.timers is timers
    assert timers.counts["coord_frame_regions"] == len(pu.view_df)
    assert timers.counts["coord_block_regions"] == 0
