"""The port's Cooler against the JAX package's .cool reader, on the CPU:
``Cooler(uri)`` and ``Cooler.from_cool`` on a file the reference fixtures
write, and ``Cooler.from_arrays`` on ``torch_cases``' in-memory build of the
same toy map, must agree with the reference ``Cooler`` on fetch_slab, extent,
offset, bad_bin_mask, bins() and coverage."""

import numpy as np
import pandas as pd
import pytest

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu_torch as port
from coolpuppy_tpu.coverage import coverage as ref_coverage
from coolpuppy_tpu_torch.coverage import coverage as port_coverage
from fixtures import make_toy_cooler, toy_expected, toy_regions
import torch_cases

REGIONS = [
    ("chr1", 100_000_000, 150_000_000),
    ("chr2", 0, 181_748_087),
    "chr1",
    "chr2:3,000,000-7,500,000",
]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cool") / "toy.cool")
    ref_clr, dense, weights = make_toy_cooler(path, seed=1)
    return path, ref_clr, dense, weights


@pytest.fixture(params=["uri", "from_cool", "from_arrays"])
def pair(request, toy):
    """(port cooler, reference cooler) over the same toy map."""
    path, ref_clr, _, _ = toy
    if request.param == "uri":
        return port.Cooler(path), ref_clr
    if request.param == "from_cool":
        return port.Cooler.from_cool(path), ref_clr
    return torch_cases.toy_cooler(seed=1)[0], ref_clr


def test_cooler_matches_reference(pair):
    clr, ref_clr = pair
    assert clr.binsize == ref_clr.binsize
    assert clr.chromnames == ref_clr.chromnames
    assert clr.chromsizes == ref_clr.chromsizes
    assert (clr.n_bins, clr.n_pixels) == (ref_clr.n_bins, ref_clr.n_pixels)
    for region in REGIONS:
        assert clr.extent(region) == ref_clr.extent(region)
        assert clr.offset(region) == ref_clr.offset(region)
        for w in ("weight", None):
            np.testing.assert_array_equal(clr.bad_bin_mask(region, w),
                                          ref_clr.bad_bin_mask(region, w))
        for col in ("start", "weight"):
            np.testing.assert_array_equal(
                clr.bins()[col].fetch(region).to_numpy(),
                ref_clr.bins()[col].fetch(region).to_numpy(),
            )
    cols = sorted(ref_clr.bins().columns)
    assert sorted(clr.bins().columns) == cols
    pd.testing.assert_frame_equal(
        clr.bins_df()[cols].reset_index(drop=True),
        ref_clr.bins_df()[cols].reset_index(drop=True), check_dtype=False,
    )
    np.testing.assert_array_equal(clr._clean_weights("weight"),
                                  ref_clr._clean_weights("weight"))


@pytest.mark.parametrize(
    "r1,r2",
    [
        (REGIONS[0], None),  # cis, stored triangle
        ("chr2", None),
        (REGIONS[0], ("chr2", 0, 60_000_000)),  # trans rectangle
        (("chr1", 20_000_000, 90_000_000), ("chr1", 60_000_000,
                                            120_000_000)),
    ],
)
@pytest.mark.parametrize("balance", ["weight", None])
def test_fetch_slab_matches_reference(pair, r1, r2, balance):
    clr, ref_clr = pair
    got = clr.fetch_slab(r1, r2, balance=balance)
    want = ref_clr.fetch_slab(r1, r2, balance=balance)
    assert (got.lo1, got.lo2, got.shape, got.mirror) == (
        want.lo1, want.lo2, want.shape, want.mirror
    )
    order_g = np.lexsort((got.cols, got.rows))
    order_w = np.lexsort((want.cols, want.rows))
    np.testing.assert_array_equal(got.rows[order_g], want.rows[order_w])
    np.testing.assert_array_equal(got.cols[order_g], want.cols[order_w])
    assert got.vals.dtype == want.vals.dtype == np.float32
    np.testing.assert_array_equal(got.vals[order_g], want.vals[order_w])
    if balance is None:
        assert got.weights is None and want.weights is None
    else:
        np.testing.assert_array_equal(got.weights, want.weights)


def test_coverage_matches_reference(pair):
    clr, ref_clr = pair
    got = port_coverage(clr, ignore_diags=2, chunksize=5_000)
    want = ref_coverage(ref_clr, ignore_diags=2, chunksize=5_000)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12)
    port_coverage(clr, store=True)
    assert {"cov_cis_raw", "cov_tot_raw"} <= set(clr.bins().columns)


def test_toy_expected_matches_fixture(toy):
    """``torch_cases``' expected table is tests/fixtures.py's."""
    _, ref_clr, dense, weights = toy
    clr = torch_cases.toy_cooler(seed=1)[0]
    got = torch_cases.toy_expected(clr, dense, weights, toy_regions())
    want = toy_expected(ref_clr, dense, toy_regions(), weights=weights)
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


def test_from_arrays_rejects_bad_pixels():
    sizes = {"chr1": 10_000}
    with pytest.raises(ValueError, match="upper-triangle"):
        port.Cooler.from_arrays(sizes, 1_000, ([3], [2], [1]))
    with pytest.raises(ValueError, match="upper-triangle"):
        port.Cooler.from_arrays(sizes, 1_000, ([0], [10], [1]))
    with pytest.raises(ValueError, match="weights"):
        port.Cooler.from_arrays(sizes, 1_000, ([0], [1], [1]),
                                weights=np.ones(3))
