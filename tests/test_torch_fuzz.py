"""Seeded fuzz search of the port against the JAX package, on the CPU: 16
random flag sets (``torch_cases.fuzz_case`` at its toy scale, seeds
1000-1015) through the port's ``pileup(device="cpu")`` on ``Cooler(uri)``
and the JAX package's ``pileup(backend="xla")`` on its own reader of the
same file. Seeds 1000-1007 start from tests/test_fuzz_parity.py's own
draws; the draws after them widen its flag space with by-window, BEDPE
rows, trans, local rescaled TADs, a groupby over a BED column and
``min_diag``. Every output is held as that test holds its two backends:
keys, ``n``, ``control_n``, ``num`` and ``control_num`` exact, NaN positions
equal, ``data`` and stripes within rtol 1e-4 / atol 1e-7."""

import numpy as np
import pandas as pd
import pytest

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu_torch as port
from coolpuppy_tpu import pileup as ref_pileup
from coolpuppy_tpu.expected import expected_cis, expected_trans
from coolpuppy_tpu.io import Cooler as RefCooler
from fixtures import make_toy_cooler, toy_regions
from test_fuzz_parity import random_case
import torch_cases


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The JAX fuzz test's toy map (seed 202) as a file, the reference's
    reader of it, and its cis and trans expected tables."""
    path = str(tmp_path_factory.mktemp("cool") / "fuzz.cool")
    ref_clr = make_toy_cooler(path, seed=202)[0]
    exp = {"cis": expected_cis(ref_clr, view_df=toy_regions()),
           "trans": expected_trans(ref_clr, view_df=toy_regions())}
    return path, ref_clr, exp


@pytest.mark.parametrize("seed", torch_cases.FUZZ_SEEDS[:8])
def test_first_draws_are_the_jax_tests(toy, seed):
    """``fuzz_base`` draws what tests/test_fuzz_parity.py's ``random_case``
    draws, and ``fuzz_case`` starts from it."""
    exp = toy[2]
    feats, kw = torch_cases.fuzz_base(np.random.default_rng(seed), exp["cis"])
    want_feats, want_kw = random_case(np.random.default_rng(seed), exp["cis"])
    pd.testing.assert_frame_equal(feats, want_feats)
    assert kw.keys() == want_kw.keys()
    for k, v in want_kw.items():
        assert kw[k] is v if k == "expected_df" else kw[k] == v, k
    case_feats, _ = torch_cases.fuzz_case(np.random.default_rng(seed), exp)
    if "chrom" in case_feats:
        pd.testing.assert_frame_equal(
            case_feats[["chrom", "start", "name", "score", "strand"]],
            want_feats[["chrom", "start", "name", "score", "strand"]])


@pytest.mark.parametrize("seed", torch_cases.FUZZ_SEEDS)
def test_fuzz_port_matches_reference(toy, seed):
    path, _, exp = toy
    feats, kw = torch_cases.fuzz_case(np.random.default_rng(seed), exp)
    what = f"seed {seed}: {torch_cases.fuzz_flags(kw)}"
    # fresh readers on both sides: a coverage column that one pileup
    # stores on its Cooler is reused by the next, whatever its min_diag
    # (in both packages)
    got = port.pileup(port.Cooler(path), feats.copy(),
                      view_df=toy_regions(), device="cpu", **kw)
    want = ref_pileup(RefCooler(path), feats.copy(), view_df=toy_regions(),
                      backend="xla", **kw)
    assert len(want) > 0, what
    torch_cases.compare_tables(got, want, what=what,
                               stripe_tol=torch_cases.FUZZ_TOL,
                               **torch_cases.FUZZ_TOL)


def test_cases_cover_the_widened_space(toy):
    """The 16 cases draw every kind, a groupby, an ignored group order and
    ``min_diag``."""
    cases = [torch_cases.fuzz_case(np.random.default_rng(s), toy[2])[1]
             for s in torch_cases.FUZZ_SEEDS]
    assert any(kw.get("by_window") for kw in cases)
    assert any(kw["features_format"] == "bedpe" for kw in cases)
    assert any(kw.get("trans") for kw in cases)
    assert any(kw.get("rescale") for kw in cases)
    assert any("groupby" in kw for kw in cases)
    assert any("ignore_group_order" in kw for kw in cases)
    assert any("min_diag" in kw for kw in cases)
