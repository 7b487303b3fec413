"""The port's trans, BEDPE, by-window and stripes modes against the JAX
package's, on the CPU.

The same toy ``.cool`` file (``fixtures.make_toy_cooler``, seed 77) goes
through the reference ``coolpuppy_tpu.pileup`` and, read with
``coolpuppy_tpu_torch.Cooler.from_cool``, through the port's
``pileup(device="cpu")`` (the plain PyTorch version of the quad kernel), for
every non-rescale row of tests/test_combo_matrix.py and for trans
observed-over-expected: group keys (by-window rows on chrom/start/end),
``n``, ``control_n``, ``num`` and ``control_num`` exact, ``data`` within
rtol 1e-4 / atol 1e-7, stripe planes within rtol 1e-5 with NaN positions
equal, stripe coordinates exact (``torch_cases.compare_tables``). Then the
BEDPE and trans coordinate paths on their own.
"""

import numpy as np
import pandas as pd
import pytest

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu as ref
import coolpuppy_tpu_torch as port
from coolpuppy_tpu.coords import CoordCreator as RefCoordCreator
from coolpuppy_tpu.expected import expected_cis, expected_trans
from fixtures import make_toy_cooler, toy_features, toy_regions
from test_combo_matrix import BASE, COMBOS, bedpe_feats
from torch_cases import compare_tables, toy_bedpe, toy_trans_expected

ENGINE_TOL = dict(rtol=1e-4, atol=1e-7)

# every non-rescale combination of tests/test_combo_matrix.py, plus trans
# observed-over-expected with a trans expected table
PARITY = [(n, kw) for n, kw in COMBOS if "rescale" not in n] + [
    ("trans_ooe", dict(trans=True, use_expected="trans")),
]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cool") / "combo.cool")
    ref_clr, dense, weights = make_toy_cooler(path, seed=77)
    return ref_clr, port.Cooler.from_cool(path), dense, weights


def _trans_expected(ref_clr):
    """expected_trans of the toy map, with the view's region names."""
    name_of = {"chr1": "foo", "chr2": "bar"}
    exp = expected_trans(ref_clr)
    return exp.assign(region1=exp["region1"].map(name_of),
                      region2=exp["region2"].map(name_of))


@pytest.mark.parametrize("name,kw", PARITY, ids=[p[0] for p in PARITY])
def test_mode_matches_reference(toy, name, kw):
    ref_clr, clr, _, _ = toy
    kw = dict(kw)
    feats = toy_features()
    if kw.pop("features", None) == "bedpe":
        feats = bedpe_feats()
        kw["features_format"] = "bedpe"
    use_expected = kw.pop("use_expected", False)
    if use_expected == "trans":
        kw["expected_df"] = _trans_expected(ref_clr)
    elif use_expected:
        kw["expected_df"] = expected_cis(ref_clr, view_df=toy_regions())
    args = dict(BASE, **kw)
    want = ref.pileup(ref_clr, feats, view_df=toy_regions(), **args)
    got = port.pileup(clr, feats, view_df=toy_regions(), device="cpu",
                      **args)
    compare_tables(got, want, what=name, **ENGINE_TOL)
    assert got["accumulate"].iloc[0] == "plain"
    assert list(got["by_window"]) == list(want["by_window"])
    if kw.get("store_stripes"):
        assert "coordinates" in got


def test_trans_expected_table_matches_reference(toy):
    """``torch_cases``' toy trans expected (no jax) equals expected_trans
    on whole chromosomes."""
    ref_clr, _, dense, weights = toy
    view = pd.DataFrame({"chrom": ["chr1", "chr2"], "start": [0, 0],
                         "end": [ref_clr.chromsizes["chr1"],
                                 ref_clr.chromsizes["chr2"]],
                         "name": ["foo", "bar"]})
    got = toy_trans_expected(ref_clr, dense, weights, view)
    want = _trans_expected(ref_clr)
    assert list(got["region1"]) == list(want["region1"]) == ["foo"]
    np.testing.assert_allclose(got["balanced.avg"], want["balanced.avg"],
                               rtol=1e-12)
    assert list(got["n_valid"]) == list(want["n_valid"])


def test_bedpe_row_below_the_diagonal(toy):
    """A BEDPE row whose second anchor comes first windows below the
    diagonal (r1 > r2); the mirrored stack reads it like the reference."""
    ref_clr, clr, _, _ = toy
    feats = toy_bedpe()
    assert (feats["start2"] < feats["start1"]).any()
    for f in (feats, feats.iloc[[3]]):
        kw = dict(BASE, features_format="bedpe", nshifts=1, seed=3,
                  store_stripes=True)
        want = ref.pileup(ref_clr, f, view_df=toy_regions(), **kw)
        got = port.pileup(clr, f, view_df=toy_regions(), device="cpu", **kw)
        compare_tables(got, want, what="bedpe r1 > r2", **ENGINE_TOL)
        assert int(got["n"].iloc[0]) == len(f)


def _bedpe_trans():
    """Trans rows, the second one reversed (chr2 first); all three pass the
    automatic mindist, which BEDPE rows meet even across chromosomes."""
    return pd.DataFrame({
        "chrom1": ["chr1", "chr2", "chr1"],
        "start1": [102_000_000, 104_000_000, 120_000_000],
        "end1": [102_500_000, 104_500_000, 120_500_000],
        "chrom2": ["chr2", "chr1", "chr2"],
        "start2": [112_000_000, 110_000_000, 130_000_000],
        "end2": [112_500_000, 110_500_000, 130_500_000],
    })


def test_bedpe_trans_rows_swap_into_region_frame(toy):
    """Trans BEDPE rows either way round: the reversed row is swapped into
    the region-1 frame (the JAX package's departure from upstream), and the
    pileup matches the reference with controls."""
    ref_clr, clr, _, _ = toy
    feats = _bedpe_trans()
    kw = dict(features_format="bedpe", flank=2_000_000, trans=True,
              nshifts=2, seed=9)
    want_cc = RefCoordCreator(feats, 1_000_000, **kw)
    got_cc = port.CoordCreator(feats, 1_000_000, **kw)
    regions = (("chr1", 100_000_000, 150_000_000),
               ("chr2", 100_000_000, 150_000_000))
    want = want_cc.filter_bedpe_trans_pairs(*regions)
    got = got_cc.filter_bedpe_trans_pairs(*regions)
    pd.testing.assert_frame_equal(got[sorted(got.columns)],
                                  want[sorted(want.columns)])
    assert (got["chrom1"] == "chr1").all() and len(got) == 3
    want_b = list(want_cc.batches(*regions, control=True))
    got_b = list(got_cc.batches(*regions, control=True))
    assert len(got_b) == len(want_b) == 1
    for w, g in zip(want_b, got_b):
        for c in ("stBin1", "stBin2", "kind"):
            np.testing.assert_array_equal(g[c].to_numpy(), w[c].to_numpy())
    args = dict(kw, view_df=toy_regions())
    compare_tables(
        port.pileup(clr, feats, device="cpu", **args),
        ref.pileup(ref_clr, feats, **args), what="bedpe trans", **ENGINE_TOL,
    )


def test_trans_controls_draw_the_reference_shifts():
    """Trans controls shift side 2 by a second draw of the same keyed RNG:
    the port's frames carry the reference's bins, chunk for chunk."""
    feats = toy_features()
    kw = dict(features_format="bed", flank=2_000_000, trans=True, nshifts=3,
              seed=11, chunk_size=4)
    want_cc = RefCoordCreator(feats, 1_000_000, **kw)
    got_cc = port.CoordCreator(feats, 1_000_000, **kw)
    regions = (("chr1", 0, 197_195_432), ("chr2", 0, 181_748_087))
    want = list(want_cc.batches(*regions, control=True))
    got = list(got_cc.batches(*regions, control=True))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for c in ("stBin1", "endBin1", "stBin2", "endBin2", "exp_start2"):
            np.testing.assert_array_equal(g[c].to_numpy(), w[c].to_numpy())
        ctl = (g["kind"] == "control").to_numpy()
        assert ctl.any()
        # the two sides moved by different amounts
        d1 = g["stBin1"].to_numpy()[ctl]
        d2 = g["stBin2"].to_numpy()[ctl]
        assert not np.array_equal(d1 - d1.min(), d2 - d2.min())


def test_trans_argument_checks(toy):
    ref_clr, clr, _, _ = toy
    with pytest.warns(UserWarning, match="Ignoring mindist"):
        cc = port.CoordCreator(toy_features(), 1_000_000, trans=True,
                               mindist=0, maxdist=10**7)
    assert cc.mindist == 0 and cc.maxdist == np.inf
    one_chrom = toy_regions().iloc[[0]]
    with pytest.raises(ValueError, match="fewer than two chromosomes"):
        port.pileup(clr, toy_features(), view_df=one_chrom, trans=True,
                    flank=2_000_000, device="cpu")
    with pytest.raises(ValueError, match="Cannot do local with trans"):
        port.CoordCreator(toy_features(), 1_000_000, trans=True, local=True)
