"""The region fetch's column filter (``Cooler._fetch_rect_raw``, one native
pass, ``native.slab_select``) against its plain numpy version
(``Cooler._fetch_rect_raw_plain``), on the CPU.

Every case compares the raw fetches that ``fetch_slab`` makes, and the
slab, against the plain ones: ``rows``, ``cols`` and ``vals`` equal element
for element, in order and in dtype, and ``dropped`` equal. A fetch that
drops no pixel hands back read-only views of the store's columns. Each case
runs at one OpenMP thread and at four (several chunks, each written at its
prefix-summed offset). Then the engine's counters of the filter's path,
``fetch_views`` and ``fetch_dropped_pixels``, and a pileup on a map with
trans pixels equal to one through the plain filter."""

import numpy as np
import pandas as pd
import pytest

import coolpuppy_tpu_torch as port
from coolpuppy_tpu_torch import native
from coolpuppy_tpu_torch.observability import PhaseTimers

BINSIZE = 10_000
# chr3 holds no pixel: its row span is empty
CHROMSIZES = {"chr1": 6_000_000, "chr2": 4_000_000, "chr3": 3_000_000}
N_CIS = 300_000  # pixels a chromosome: several 2^16-pixel chunks
N_TRANS = 100_000


def _map(trans=False, counts="int", seed=3):
    """A map of zipf-distance cis pixels in chr1 and chr2, with uniform
    chr1 x chr2 pixels where ``trans``. ``counts``: ``"int"`` Poisson
    counts (stored int32), ``"big"`` int32 counts from 2^24 up, ``"float"``
    non-integer counts (stored float64)."""
    rng = np.random.default_rng(seed)
    n_bins = [-(-size // BINSIZE) for size in CHROMSIZES.values()]
    offsets = np.concatenate([[0], np.cumsum(n_bins)])
    b1, b2 = [], []
    for c in range(2):
        n, off = n_bins[c], offsets[c]
        i = rng.integers(0, n, N_CIS)
        b1.append(i + off)
        b2.append(np.minimum(i + rng.zipf(1.35, N_CIS) - 1, n - 1) + off)
    if trans:
        b1.append(rng.integers(0, n_bins[0], N_TRANS))
        b2.append(rng.integers(0, n_bins[1], N_TRANS) + offsets[1])
    b1, b2 = np.concatenate(b1), np.concatenate(b2)
    if counts == "big":
        cnt = rng.integers(1 << 24, (1 << 31) - 1, len(b1)).astype(np.int32)
    elif counts == "float":
        cnt = rng.gamma(2.0, 1.5, len(b1))
    else:
        cnt = rng.poisson(3.0, len(b1)) + 1
    weights = rng.uniform(0.5, 1.5, offsets[-1])
    weights[rng.random(offsets[-1]) < 0.03] = np.nan
    return port.Cooler.from_arrays(CHROMSIZES, BINSIZE, (b1, b2, cnt),
                                   weights=weights)


# case -> (map keywords, region1, region2, dtype, whether the fetch drops
# no pixel)
CASES = {
    "a_cis_map_same_extent": (dict(), "chr1", None, np.float32, True),
    "b_trans_map_cis_query": (dict(trans=True), "chr1", None, np.float32,
                              False),
    "c_sub_chromosome": (dict(), "chr1:1,000,000-3,000,000", None,
                         np.float32, False),
    "d_distinct_extents": (dict(trans=True), "chr1", "chr2", np.float32,
                           False),
    "e_empty_row_span": (dict(), "chr3", None, np.float32, True),
    "f_float64_counts_from_2_24": (dict(trans=True, counts="big"), "chr1",
                                   None, np.float64, False),
    "f_float64_counts_from_2_24_all_kept": (dict(counts="big"), "chr2",
                                            None, np.float64, True),
    "g_float64_stored_counts": (dict(trans=True, counts="float"), "chr1",
                                None, np.float32, False),
}


@pytest.fixture(params=[1, 4], ids=["1thread", "4threads"])
def team(request):
    before = native.threads()
    native.set_threads(request.param)
    yield request.param
    native.set_threads(before)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _plain_reader(clr):
    """The same map and store, every fetch through the plain filter."""
    plain = port.Cooler(clr.store)
    plain._fetch_rect_raw = plain._fetch_rect_raw_plain
    return plain


@pytest.mark.parametrize("case", list(CASES))
def test_fetch_matches_plain_filter(case, team):
    kw, region1, region2, dtype, keeps_all = CASES[case]
    clr = _map(**kw)
    lo1, hi1 = clr.extent(region1)
    lo2, hi2 = clr.extent(region2 or region1)
    raws = [(lo1, hi1, lo2, hi2)]
    if (lo1, hi1) != (lo2, hi2):
        raws.append((lo2, hi2, lo1, hi1))
    for rect in raws:
        got = clr._fetch_rect_raw(*rect, dtype)
        want = clr._fetch_rect_raw_plain(*rect, dtype)
        _assert_same(got[:3], want[:3])
        assert got[3] == want[3]
        assert got[2].dtype == dtype

    slab = clr.fetch_slab(region1, region2, dtype=dtype)
    plain = _plain_reader(clr).fetch_slab(region1, region2, dtype=dtype)
    _assert_same((slab.rows, slab.cols, slab.vals),
                 (plain.rows, plain.cols, plain.vals))
    assert (slab.lo1, slab.lo2, slab.shape, slab.mirror) == \
        (plain.lo1, plain.lo2, plain.shape, plain.mirror)
    np.testing.assert_array_equal(slab.weights, plain.weights)
    assert slab.dropped == plain.dropped
    assert (slab.dropped == 0) == keeps_all
    if case == "a_cis_map_same_extent":
        stored = clr.store.root["pixels"]
        assert slab.nnz > 2 * (1 << 16)
        for arr, col in ((slab.rows, "bin1_id"), (slab.cols, "bin2_id")):
            assert not arr.flags.writeable
            assert np.shares_memory(arr, stored[col])
            with pytest.raises(ValueError):
                arr[0] = 0
        assert stored["bin1_id"].flags.writeable
    if case == "e_empty_row_span":
        assert slab.nnz == 0
    if case.startswith("f_"):
        span = slice(clr.bin1_offset()[lo1], clr.bin1_offset()[hi1])
        stored = clr.store.root["pixels"]
        keep = stored["bin2_id"][span] < hi2
        assert slab.vals.min() >= 1 << 24
        np.testing.assert_array_equal(slab.vals,
                                      stored["count"][span][keep])
    if case == "c_sub_chromosome":
        assert slab.rows.min() >= lo1 and slab.cols.max() < hi2


def test_slab_select_refuses_bad_input():
    b = np.arange(10, dtype=np.int64)
    with pytest.raises(ValueError, match="float32 or float64"):
        native.slab_select(b, b, b, 0, 5, np.int64)
    with pytest.raises(ValueError, match="differ in length"):
        native.slab_select(b, b[:5], b, 0, 5, np.float32)
    # a count dtype read through a cast first: int64 counts
    rows, cols, vals, dropped = native.slab_select(b, b, b, 2, 7,
                                                   np.float32)
    np.testing.assert_array_equal(vals, np.arange(2, 7, dtype=np.float32))
    assert dropped == 5 and rows.dtype == cols.dtype == np.int64


def _features():
    rng = np.random.default_rng(11)
    rows = []
    for chrom in ("chr1", "chr2"):
        size = CHROMSIZES[chrom]
        for start in np.sort(rng.integers(300_000, size - 300_000, 25)):
            rows.append((chrom, int(start), int(start) + BINSIZE))
    return pd.DataFrame(rows, columns=["chrom", "start", "end"])


def _pileup(clr, timers=None):
    return port.pileup(clr, _features(), flank=100_000, nshifts=2,
                       mindist=0, seed=5, device="cpu", timers=timers)


@pytest.mark.parametrize("trans", [False, True], ids=["cis_map",
                                                      "trans_map"])
def test_fetch_counters(trans):
    clr = _map(trans=trans)
    slabs = []
    inner = clr.fetch_slab

    def spy(*a, **k):
        slabs.append(inner(*a, **k))
        return slabs[-1]

    clr.fetch_slab = spy
    timers = PhaseTimers()
    table = _pileup(clr, timers)
    assert len(slabs) >= 2
    dropped = sum(s.dropped for s in slabs)
    assert timers.counts["fetch_dropped_pixels"] == dropped
    assert timers.counts["fetch_views"] == sum(s.dropped == 0 for s in slabs)
    if not trans:
        assert timers.counts["fetch_views"] == len(slabs)
        assert dropped == 0
        return
    assert dropped > 0
    want = _pileup(_plain_reader(clr))
    assert list(table.columns) == list(want.columns)
    assert len(table) == len(want) > 0
    for col in want.columns:
        for got_cell, want_cell in zip(table[col], want[col]):
            np.testing.assert_array_equal(np.asarray(got_cell),
                                          np.asarray(want_cell),
                                          err_msg=col)
