"""The port's expected tables and ``Cooler.fetch_coo`` against the JAX
package's, on the CPU, on the toy maps: ``Cooler.from_cool`` on a file the
reference fixtures write and ``Cooler.from_arrays`` (``torch_cases``'
in-memory build of the same map). Tables and COO matrices must be equal."""

import numpy as np
import pandas as pd
import pytest

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu_torch as port
from coolpuppy_tpu.expected import expected_cis as ref_expected_cis
from coolpuppy_tpu.expected import expected_trans as ref_expected_trans
from coolpuppy_tpu_torch.expected import expected_cis, expected_trans
from fixtures import make_toy_cooler, toy_regions
import torch_cases

COO_QUERIES = [
    (("chr1", 100_000_000, 150_000_000), None),
    ("chr2", None),
    ("chr1", "chr2"),
    ("chr2:3,000,000-7,500,000", ("chr1", 0, 20_000_000)),
]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cool") / "toy.cool")
    ref_clr, _, _ = make_toy_cooler(path, seed=5)
    return path, ref_clr


@pytest.fixture(params=["from_cool", "from_arrays"])
def pair(request, toy):
    """(port cooler, reference cooler) over the same toy map."""
    path, ref_clr = toy
    if request.param == "from_cool":
        return port.Cooler.from_cool(path), ref_clr
    return torch_cases.toy_cooler(seed=5)[0], ref_clr


@pytest.mark.parametrize("balance", ["weight", False])
@pytest.mark.parametrize("query", COO_QUERIES,
                         ids=["cis_part", "cis_chrom", "trans_chroms",
                              "trans_parts"])
def test_fetch_coo_matches_reference(pair, query, balance):
    clr, ref_clr = pair
    got = clr.fetch_coo(*query, balance=balance).tocsr()
    want = ref_clr.fetch_coo(*query, balance=balance).tocsr()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.toarray(), want.toarray())


@pytest.mark.parametrize("weight", ["weight", None])
@pytest.mark.parametrize("view", ["chroms", "regions"])
def test_expected_cis_matches_reference(pair, weight, view):
    clr, ref_clr = pair
    view_df = toy_regions() if view == "regions" else None
    got = expected_cis(clr, view_df=view_df, clr_weight_name=weight)
    want = ref_expected_cis(ref_clr, view_df=view_df, clr_weight_name=weight)
    pd.testing.assert_frame_equal(got, want)
    assert np.isfinite(got["balanced.avg"]).sum() > 0


@pytest.mark.parametrize("weight", ["weight", None])
def test_expected_trans_matches_reference(pair, weight):
    clr, ref_clr = pair
    got = expected_trans(clr, clr_weight_name=weight)
    want = ref_expected_trans(ref_clr, clr_weight_name=weight)
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == 1 and got["balanced.avg"].iloc[0] > 0
