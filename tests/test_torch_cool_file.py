"""The port's file-backed ``Cooler(uri)`` against the JAX package's reader,
on the CPU, on ``.cool`` files the JAX package's ``write_cool`` writes: the
toy map of ``tests/fixtures.py`` and a two-resolution file read as
``path::/resolutions/N``. Metadata, extents and bins equal; ``fetch_slab``
and ``matrix(...).fetch`` bit for bit; ``pileup()``, the expected tables and
coverage through ``Cooler(uri)`` and ``Cooler.from_cool`` equal to the
reference's. A recorder on the store (``torch_cases.CountingStore``) shows
that a fetch reads only its row span and that the object holds no array of
the whole pixel table; four threads fetching at once give the one-thread
results."""

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd
import pytest

# h5py, which this module and the JAX package it compares against import,
# is missing on the card's machine: there the module skips
h5py = pytest.importorskip("h5py")

import coolpuppy_tpu_torch as port
from coolpuppy_tpu import pileup as ref_pileup
from coolpuppy_tpu.coverage import coverage as ref_coverage
from coolpuppy_tpu.expected import expected_cis as ref_expected_cis
from coolpuppy_tpu.expected import expected_trans as ref_expected_trans
from coolpuppy_tpu.io import Cooler as RefCooler
from coolpuppy_tpu.io import write_cool as ref_write_cool
from coolpuppy_tpu_torch.coverage import coverage
from coolpuppy_tpu_torch.expected import expected_cis, expected_trans
from coolpuppy_tpu_torch.io.cool import FileStore, parse_cooler_uri
from fixtures import make_toy_cooler, toy_features, toy_regions
import torch_cases

REGIONS = [
    ("chr1", 100_000_000, 150_000_000),
    ("chr2", 0, 181_748_087),
    "chr1",
    "chr2:3,000,000-7,500,000",
]
QUERIES = {
    "cis": (("chr1", 100_000_000, 150_000_000), None),
    "off_diagonal": (("chr1", 20_000_000, 90_000_000),
                     ("chr1", 60_000_000, 120_000_000)),
    "trans": ("chr1", "chr2"),
    "transposed": ("chr2:3,000,000-47,500,000", ("chr1", 0, 20_000_000)),
}
TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The toy map as a plain ``.cool`` file, and a two-resolution file
    (the toy map at 1 Mb and its 2 Mb coarsening): ``name -> uri``."""
    d = tmp_path_factory.mktemp("cool_file")
    plain = str(d / "toy.cool")
    make_toy_cooler(plain, seed=11)
    sizes = {"chr1": 197_195_432, "chr2": 181_748_087}
    mcool = str(d / "toy.mcool")
    ref = RefCooler(plain)
    b1, b2, c = ref.pixels_chunk(0, ref.n_pixels)
    w = ref.bins_df()["weight"].to_numpy()
    for res in (1_000_000, 2_000_000):
        part = str(d / f"res{res}.cool")
        if res == 1_000_000:
            pixels, weights = (b1, b2, c.astype(np.int64)), w
        else:  # the same chromosomes binned twice as coarse
            off = np.array([ref.offset(ch) for ch in ref.chromnames])
            chrom = np.searchsorted(off, b1, side="right") - 1
            chrom2 = np.searchsorted(off, b2, side="right") - 1
            off2 = np.concatenate(
                [[0], np.cumsum([int(np.ceil(n / res)) for n in
                                 sizes.values()])])
            n1 = off2[chrom] + (b1 - off[chrom]) // 2
            n2 = off2[chrom2] + (b2 - off[chrom2]) // 2
            key = pd.DataFrame({"b1": n1, "b2": n2, "c": c}).groupby(
                ["b1", "b2"], as_index=False)["c"].sum()
            pixels = (key["b1"].to_numpy(), key["b2"].to_numpy(),
                      key["c"].to_numpy().astype(np.int64))
            rng = np.random.default_rng(3)
            weights = rng.uniform(0.5, 1.5, int(off2[-1]))
            weights[rng.random(len(weights)) < 0.05] = np.nan
        ref_write_cool(part, sizes, res, pixels, weights=weights,
                       group=f"/resolutions/{res}")
        with h5py.File(part, "r") as src, h5py.File(mcool, "a") as dst:
            src.copy(src[f"/resolutions/{res}"], dst,
                     name=f"/resolutions/{res}")
    return {"plain": plain,
            "res1M": mcool + "::/resolutions/1000000",
            "res2M": mcool + "::resolutions/2000000"}


@pytest.fixture(params=["plain", "res1M", "res2M"])
def uri(request, files):
    return files[request.param]


def _coo(m):
    m = m.tocoo()
    order = np.lexsort((m.col, m.row))
    return m.row[order], m.col[order], m.data[order]


def _pixel_arrays(obj, n, seen=None):
    """Names of the arrays of ``n`` rows that ``obj`` holds, searched
    through its attributes, dicts, lists and frames."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, np.ndarray):
        return ["array"] if obj.ndim and obj.shape[0] == n else []
    if isinstance(obj, (pd.DataFrame, pd.Series)):
        return ["frame"] if len(obj) == n else []
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (list, tuple)):
        items = enumerate(obj)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        items = vars(obj).items()
    else:
        return []
    return [f"{k}.{p}" for k, v in items for p in _pixel_arrays(v, n, seen)]


def test_parse_cooler_uri():
    from coolpuppy_tpu.io.cool import parse_cooler_uri as ref_parse

    for u in ("a.cool", "a.mcool::/resolutions/10", "a.mcool::resolutions/10",
              "dir/x.cool::"):
        assert parse_cooler_uri(u) == ref_parse(u)


def test_metadata_extent_and_bins(uri):
    clr, ref = port.Cooler(uri), RefCooler(uri)
    assert isinstance(clr.store, FileStore)
    for attr in ("uri", "filename", "group", "binsize", "chromnames",
                 "chromsizes", "n_bins", "n_pixels", "counts_are_int"):
        assert getattr(clr, attr) == getattr(ref, attr), attr
    for region in REGIONS:
        assert clr.extent(region) == ref.extent(region)
        assert clr.offset(region) == ref.offset(region)
        pd.testing.assert_frame_equal(clr.bins().fetch(region),
                                      ref.bins().fetch(region))
        for col in ("start", "weight"):
            pd.testing.assert_series_equal(clr.bins()[col].fetch(region),
                                           ref.bins()[col].fetch(region))
        np.testing.assert_array_equal(clr.bad_bin_mask(region),
                                      ref.bad_bin_mask(region))
    assert list(clr.bins().columns) == list(ref.bins().columns)
    pd.testing.assert_frame_equal(clr.bins_df(), ref.bins_df())
    np.testing.assert_array_equal(clr.bin1_offset(), ref.bin1_offset())


@pytest.mark.parametrize("balance", ["weight", False])
@pytest.mark.parametrize("query", list(QUERIES))
def test_fetches_bit_for_bit(uri, query, balance):
    clr, ref = port.Cooler(uri), RefCooler(uri)
    r1, r2 = QUERIES[query]
    got, want = clr.fetch_slab(r1, r2, balance=balance), \
        ref.fetch_slab(r1, r2, balance=balance)
    assert (got.lo1, got.lo2, got.shape, got.mirror) == (
        want.lo1, want.lo2, want.shape, want.mirror)
    for a in ("rows", "cols", "vals"):
        g, w = getattr(got, a), getattr(want, a)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if balance:
        np.testing.assert_array_equal(got.weights, want.weights)
    else:
        assert got.weights is None and want.weights is None
    sparse = clr.matrix(sparse=True, balance=balance).fetch(r1, r2)
    ref_sparse = ref.matrix(sparse=True, balance=balance).fetch(r1, r2)
    assert sparse.shape == ref_sparse.shape
    for g, w in zip(_coo(sparse), _coo(ref_sparse)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        clr.matrix(balance=balance).fetch(r1, r2),
        ref.matrix(balance=balance).fetch(r1, r2))


@pytest.mark.parametrize("reader", ["uri", "from_cool"])
def test_pileup_expected_coverage_match_reference(files, reader):
    uri = files["res1M"]
    ref = RefCooler(uri)
    clr = port.Cooler(uri) if reader == "uri" else port.Cooler.from_cool(uri)
    view = toy_regions()
    exp = ref_expected_cis(ref, view_df=view)
    pd.testing.assert_frame_equal(expected_cis(clr, view_df=view), exp)
    pd.testing.assert_frame_equal(expected_trans(clr, view_df=view),
                                  ref_expected_trans(ref, view_df=view))
    for g, w in zip(coverage(clr, chunksize=7_000),
                    ref_coverage(ref, chunksize=7_000)):
        np.testing.assert_array_equal(g, w)
    runs = {
        "by_strand_controls": dict(nshifts=2, seed=4, by_strand=True),
        "expected": dict(expected_df=exp),
        "trans_stripes": dict(trans=True, store_stripes=True),
    }
    for name, kw in runs.items():
        kw = dict(features_format="bed", view_df=view, mindist=0,
                  flank=2_000_000, **kw)
        got = port.pileup(clr, toy_features(), device="cpu", **kw)
        want = ref_pileup(ref, toy_features(), backend="xla", **kw)
        torch_cases.compare_tables(got, want, what=name, **TOL)
        assert got["cooler"].iloc[0] == want["cooler"].iloc[0] == "toy"


def test_cooler_column_matches_reference(files):
    for uri in files.values():
        kw = dict(features_format="bed", view_df=toy_regions(), mindist=0,
                  flank=2_000_000)
        got = port.pileup(port.Cooler(uri), toy_features(), device="cpu",
                          **kw)
        want = ref_pileup(RefCooler(uri), toy_features(), backend="xla", **kw)
        assert got["cooler"].iloc[0] == want["cooler"].iloc[0]
        assert got["clr"].iloc[0] == want["clr"].iloc[0]


def test_fetch_reads_only_its_span(files):
    clr = port.Cooler(files["res1M"])
    clr.store = torch_cases.CountingStore(clr.store)
    with torch_cases.fetch_log(clr) as log:
        for r1, r2 in QUERIES.values():
            clr.fetch_slab(r1, r2)
            clr.fetch_coo(r1, r2, balance=False)
    read = torch_cases.fetch_spans(clr, log.fetches)
    assert len(read) == 2 * len(QUERIES) and min(read) > 0
    # a rectangle across the two chromosomes reads both row spans, each
    # shorter than the table
    assert max(b - a for *_, a, b in clr.store.reads) < clr.n_pixels
    start = len(clr.store.reads)
    got = clr.pixels_chunk(100, 1_100)
    assert [r[1:] for r in clr.store.reads[start:]] == [
        ("bin1_id", 100, 1_100), ("bin2_id", 100, 1_100),
        ("count", 100, 1_100)]
    assert [len(a) for a in got] == [1_000] * 3


def test_no_whole_pixel_table_is_held(files):
    """After construction and after whole pileups (cis with controls and
    coverage normalization, trans) the object holds no array of the pixel
    table's length; every fetch of the pileups read rows shorter than the
    table (coverage streams the table in ``pixels_chunk`` chunks, held by
    nothing after)."""
    clr = port.Cooler(files["plain"])
    n = clr.n_pixels
    assert not _pixel_arrays(clr, n)
    clr.store = torch_cases.CountingStore(clr.store)
    kw = dict(features_format="bed", view_df=toy_regions(), mindist=0,
              flank=2_000_000, device="cpu")
    with torch_cases.fetch_log(clr) as log:
        port.pileup(clr, toy_features(), nshifts=1, seed=0, by_strand=True,
                    clr_weight_name=None, coverage_norm=True, **kw)
        port.pileup(clr, toy_features(), trans=True, **kw)
    assert not _pixel_arrays(clr, n)
    # two cis regions and one trans pair, each fetched once
    assert len(torch_cases.fetch_spans(clr, log.fetches)) == 3
    spans = [b - a for *_, reads, _ in log.fetches for _, a, b in reads]
    assert spans and max(spans) < n


def test_four_threads_fetch_as_one(files):
    """Four threads fetching at once from a fresh object (so that the bins
    table, the row index and the weights are first read under contention),
    with the interpreter switching threads every microsecond, give the
    single-thread results, bit for bit."""
    uri = files["res1M"]
    queries = [q for q in QUERIES.values() for _ in range(3)]
    one = port.Cooler(uri)
    want = [one.fetch_slab(*q) for q in queries]
    many = port.Cooler(uri)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(4) as pool:
            futures = [pool.submit(many.fetch_slab, *q) for q in queries]
            got = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    for g, w in zip(got, want):
        for a in ("rows", "cols", "vals", "weights"):
            np.testing.assert_array_equal(getattr(g, a), getattr(w, a))


def test_stored_column_survives_the_bins_read(files):
    """A column stored before the bins table is first read is in it
    afterwards (the reference's ``_extra_bin_cols``), so coverage
    normalization reads it."""
    uri = files["plain"]
    clr, ref = port.Cooler(uri), RefCooler(uri)
    cis, tot = coverage(clr)
    for c in (clr, ref):
        c.store_bin_column("cov_cis_raw", cis)
        c.store_bin_column("cov_tot_raw", tot)
        assert c._bins_df is None
    assert list(clr.bins().columns) == list(ref.bins().columns)
    pd.testing.assert_frame_equal(clr.bins_df(), ref.bins_df())
    with pytest.raises(ValueError, match="entries"):
        clr.store_bin_column("short", cis[:-1])


def test_bytes_chroms_and_float_counts(tmp_path):
    """A bins table whose ``chrom`` column holds names (bytes), and float
    counts of 2**24 and more: float64 exact on ``fetch_coo`` and
    ``pixels_chunk``, float32 on the slab, as the reference reads them."""
    path = str(tmp_path / "float.cool")
    sizes = {"chrA": 5_000, "chrB": 3_000}
    b1 = np.array([0, 0, 1, 2, 4, 5, 6])
    b2 = np.array([0, 3, 4, 7, 6, 7, 7])
    counts = np.array([2.0 ** 24 + 1, 3.5, 2.0 ** 25 + 3, 1.0, 7.0, 2.0, 9.25])
    ref_write_cool(path, sizes, 1_000, (b1, b2, counts))
    with h5py.File(path, "a") as f:
        chrom = f["bins/chrom"][:]
        del f["bins/chrom"]
        f["bins"].create_dataset(
            "chrom", data=np.array([b"chrA", b"chrB"])[chrom])
    clr, ref = port.Cooler(path), RefCooler(path)
    assert clr.counts_are_int is ref.counts_are_int is False
    pd.testing.assert_frame_equal(clr.bins_df(), ref.bins_df())
    for r1, r2 in (("chrA", None), ("chrA", "chrB"), ("chrB", "chrA")):
        for g, w in zip(_coo(clr.fetch_coo(r1, r2, balance=False)),
                        _coo(ref.fetch_coo(r1, r2, balance=False))):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            clr.fetch_slab(r1, r2, balance=False).vals,
            ref.fetch_slab(r1, r2, balance=False).vals)
    for g, w in zip(clr.pixels_chunk(0, 7), ref.pixels_chunk(0, 7)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert clr.fetch_coo("chrA", balance=False).toarray()[0, 0] == 2 ** 24 + 1
