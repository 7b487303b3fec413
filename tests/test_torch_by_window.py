"""The port's by-window pileups and the pieces they run on, on the CPU: the
group-blocked accumulation against the unblocked one, the vectorized 'all'
row against ``reduce(sum_pups)``, the coverage scatter-add against the
histogram, duplicate intervals, and whole by-window runs against the JAX
package's ``pileup()`` (counts exact, ``data`` rtol 1e-4 / atol 1e-7)."""

import importlib
from functools import reduce

import numpy as np
import pandas as pd
import pytest

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu as ref
import coolpuppy_tpu_torch as port
from coolpuppy_tpu_torch.lib.puputils import empty_pup, sum_pups
from coolpuppy_tpu_torch.ops.gather import (
    coverage_histogram_sums,
    coverage_scatter_sums,
)
from fixtures import make_toy_cooler, toy_features, toy_regions
from torch_cases import compare_tables

# the package's ``pileup`` function shadows the engine module's name
engine = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")
ENGINE_TOL = dict(rtol=1e-4, atol=1e-7)
KW = dict(features_format="bed", mindist=0, flank=2_000_000, by_window=True)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cool") / "toy.cool")
    ref_clr, _, _ = make_toy_cooler(path, seed=5)
    return ref_clr, port.Cooler.from_cool(path)


def _cap_for(half, W):
    """A block byte cap that makes ``_block_half(W)`` equal ``half``."""
    return 2 * half * W * W * 8


def test_block_half_sizes():
    assert engine._block_half(21) == 32_768
    assert engine._block_half(120) == 1_024
    assert engine._block_half(3) == port.ops.quad_gather.C_MAX // 2


@pytest.mark.parametrize("half", [2, 4])
def test_blocked_accumulate_equals_unblocked(toy, monkeypatch, half):
    """_quad_accumulate over 11 groups with flips: cid-sorted blocks of 2 or
    4 groups give the one-launch run's sums, with counts and poison
    exact."""
    _, clr = toy
    cc = port.CoordCreator(toy_features(), 1_000_000, features_format="bed",
                           flank=2_000_000, mindist=0)
    pu = port.PileUpper(clr, cc, view_df=toy_regions(), device="cpu")
    dev = pu._stage_region("foo", "foo")
    W, G, S = 5, 11, 3_000
    rng = np.random.default_rng(half)
    arr = {
        "r1": rng.integers(0, 45, S).astype(np.int32),
        "r2": rng.integers(0, 45, S).astype(np.int32),
        "cidl": rng.integers(0, G, S).astype(np.int32),
        "flip": rng.random(S) < 0.3,
    }
    arr["dd0"] = (arr["r1"] - arr["r2"]).astype(np.int32)
    stack = pu._build_tile_stack(dev, arr, W)
    want = pu._quad_accumulate(stack, dev, arr, W, G)
    monkeypatch.setattr(engine, "_BLOCK_BYTES", _cap_for(half, W))
    assert engine._block_half(W) == half
    got = pu._quad_accumulate(stack, dev, arr, W, G)
    np.testing.assert_array_equal(got["num"], want["num"])
    np.testing.assert_array_equal(got["poison"], want["poison"])
    np.testing.assert_allclose(got["sum"], want["sum"], rtol=1e-12, atol=0)
    assert want["num"].sum() > 0 and want["sum"].shape == (G, W, W)


@pytest.mark.parametrize("half", [2, 4])
def test_blocked_by_window_matches_reference(toy, monkeypatch, half):
    ref_clr, clr = toy
    kw = dict(KW, nshifts=1, seed=4, view_df=toy_regions())
    want = ref.pileup(ref_clr, toy_features(), **kw)
    unblocked = port.pileup(clr, toy_features(), device="cpu", **kw)
    monkeypatch.setattr(engine, "_BLOCK_BYTES", _cap_for(half, 5))
    got = port.pileup(clr, toy_features(), device="cpu", **kw)
    compare_tables(got, want, what=f"blocked {half}", **ENGINE_TOL)
    compare_tables(got, unblocked, what=f"blocked {half} vs unblocked",
                   rtol=1e-12, atol=0)


def _random_pups(n, seed):
    rng = np.random.default_rng(seed)
    pups = []
    for i in range(n):
        pups.append({
            # accumulator sums: finite (masked pixels add 0)
            "data": rng.random((5, 5)) * 100,
            "num": rng.integers(0, 9, (5, 5)).astype(float),
            "poison": (rng.random((5, 5)) < 0.05).astype(float),
            "n": int(rng.integers(1, 50)),
            "cov_start": rng.random(5), "cov_end": rng.random(5),
            "horizontal_stripe": [rng.random((2, 5))],
            "vertical_stripe": [rng.random((2, 5))],
            "coordinates": [np.full((2, 6), str(i), dtype=object)],
        })
    return pups


@pytest.mark.parametrize("n_groups", [10, 64, 65, 300])
def test_fast_all_equals_reduce_sum_pups(n_groups):
    pups = _random_pups(n_groups, n_groups)
    want = dict(reduce(sum_pups, pups, empty_pup((5, 5))))
    got = engine._fast_all(pups)
    assert got["n"] == want["n"]
    for k in ("data", "num", "poison", "cov_start", "cov_end"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    for k in ("horizontal_stripe", "vertical_stripe", "coordinates"):
        assert len(got[k]) == len(want[k]) == n_groups
        for a, b in zip(got[k], want[k]):
            assert (a == b).all()


def test_many_windows_match_reference(toy):
    """100 anchors on one chromosome: more than 64 groups per region, so
    the engine's 'all' rows come from _fast_all."""
    ref_clr, clr = toy
    starts = np.arange(100) * 1_900_000 + 3_000_000
    feats = pd.DataFrame({"chrom": "chr1", "start": starts,
                          "end": starts + 500_000})
    kw = dict(KW, nshifts=1, seed=2, maxdist=30_000_000)
    want = ref.pileup(ref_clr, feats, **kw)
    got = port.pileup(clr, feats, device="cpu", **kw)
    assert (got["chrom"] != "all").sum() == 100
    compare_tables(got, want, what="100 windows", **ENGINE_TOL)


def test_duplicate_intervals_share_one_window(toy):
    """tests/test_modes.py:439 on the port: a duplicated BED interval is
    one window group that accumulates both copies' snips."""
    ref_clr, clr = toy
    feats = toy_features()
    dup = pd.concat([feats, feats.iloc[[0]]], ignore_index=True)
    kw = dict(KW, view_df=toy_regions())
    got = port.pileup(clr, dup, device="cpu", **kw)
    body = got[got["chrom"] != "all"]
    keys = list(zip(body["chrom"], body["start"], body["end"]))
    assert len(keys) == len(set(keys)) == len(feats)
    base = port.pileup(clr, feats, device="cpu", **kw)
    first = body["start"] == body["start"].min()
    base_first = base[base["chrom"] != "all"]["start"] == body["start"].min()
    assert body[first]["n"].iloc[0] > base[base["chrom"] != "all"][
        base_first
    ]["n"].iloc[0]
    compare_tables(got, ref.pileup(ref_clr, dup, **kw), what="duplicates",
                   **ENGINE_TOL)


def test_coverage_scatter_matches_histogram():
    rng = np.random.default_rng(3)
    n, W, G, S = 700, 21, 37, 5_000
    cov1 = rng.gamma(2.0, 50.0, n).astype(np.float32)
    cov2 = rng.gamma(2.0, 50.0, n).astype(np.float32)
    cov1[rng.integers(0, n, 20)] = np.nan
    cov2[rng.integers(0, n, 5)] = np.inf
    cid = rng.integers(0, G, S).astype(np.int32)
    r1 = rng.integers(0, n - W, S).astype(np.int32)
    r2 = rng.integers(0, n - W, S).astype(np.int32)
    want = coverage_histogram_sums(cid, r1, r2, cov1, cov2, W, G)
    got = coverage_scatter_sums(cid, r1, r2, cov1, cov2, W, G, "cpu",
                                chunk=1_000)
    for g, w in zip(got, want):
        assert g.shape == (G, W) and g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)


def test_by_window_coverage_scatter_route_matches_reference(toy,
                                                             monkeypatch):
    """coverage_norm by window with the histogram bound at 0, so the engine
    takes the scatter-add route, against the reference."""
    ref_clr, clr = toy
    kw = dict(KW, clr_weight_name=None, coverage_norm=True,
              view_df=toy_regions())
    want = ref.pileup(ref_clr, toy_features(), **kw)
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return coverage_scatter_sums(*a, **k)

    monkeypatch.setattr(engine, "_COV_HIST_MAX", 0)
    monkeypatch.setattr(engine, "coverage_scatter_sums", counted)
    got = port.pileup(clr, toy_features(), device="cpu", **kw)
    assert len(calls) == 2  # one per region
    compare_tables(got, want, what="coverage scatter", **ENGINE_TOL)


def test_by_window_argument_checks(toy):
    _, clr = toy
    bedpe = pd.DataFrame({"chrom1": ["chr1"], "start1": [102_000_000],
                          "end1": [102_500_000], "chrom2": ["chr1"],
                          "start2": [110_000_000], "end2": [110_500_000]})
    with pytest.raises(ValueError, match="without making combinations"):
        port.pileup(clr, bedpe, **dict(KW, features_format="bedpe",
                                       device="cpu"))
    with pytest.raises(ValueError, match="local by-window"):
        port.pileup(clr, toy_features(), local=True, device="cpu",
                    **dict(KW, view_df=toy_regions()))
    with pytest.warns(UserWarning, match="additional groupby"):
        pups = port.pileup(clr, toy_features(), groupby=["strand1"],
                           device="cpu", **dict(KW, view_df=toy_regions()))
    assert pups["by_window"].all() and not pups["by_strand"].any()


def _all_pairs_bedpe(feats):
    """Every pair of features of one chromosome, first before second, as
    BEDPE rows."""
    rows = []
    for _, sub in feats.groupby("chrom", sort=False):
        sub = sub.reset_index(drop=True)
        i, j = np.triu_indices(len(sub), 1)
        rows.append(pd.DataFrame({
            "chrom1": sub["chrom"].values[i], "start1": sub["start"].values[i],
            "end1": sub["end"].values[i], "chrom2": sub["chrom"].values[j],
            "start2": sub["start"].values[j], "end2": sub["end"].values[j],
        }))
    return pd.concat(rows, ignore_index=True)


BEDPE_BY_WINDOW = {
    "plain": (dict(), dict()),
    "controls": (dict(nshifts=2, seed=8), dict(control=True)),
    "stripes": (dict(), dict(store_stripes=True)),
    "coverage_norm": (dict(), dict(clr_weight_name=None,
                                   coverage_norm=True)),
    "rescale": (dict(rescale_flank=1), dict(rescale=True, rescale_size=9)),
}


@pytest.mark.parametrize("mode", list(BEDPE_BY_WINDOW))
def test_by_window_of_bedpe_rows_matches_reference(toy, mode):
    """``pileupsByWindowWithControl`` on BEDPE rows (no shared anchor index:
    grouped through the frame-doubling ``group_by_region_frame`` hook, with
    (chrom, start, end) tuples as groups) against the reference's, window
    by window."""
    ref_clr, clr = toy
    cc_kw, pu_kw = BEDPE_BY_WINDOW[mode]
    feats = toy_features()
    if "rescale_flank" in cc_kw:
        feats = feats.assign(end=feats["start"] + 2_000_000)
    else:
        cc_kw = dict(cc_kw, flank=2_000_000)
    bedpe = _all_pairs_bedpe(feats)
    tables = []
    for pkg, c, kw in ((port, clr, {"device": "cpu"}), (ref, ref_clr, {})):
        cc = pkg.CoordCreator(bedpe, 1_000_000, features_format="bedpe",
                              mindist=0, **cc_kw)
        pu = pkg.PileUpper(c, cc, expected=False, view_df=toy_regions(),
                           **pu_kw, **kw)
        tables.append(pu.pileupsByWindowWithControl())
    got, want = tables
    compare_tables(got, want, what=f"bedpe by window {mode}", **ENGINE_TOL)
    assert len(got) == 7 and list(got["n"])[:6] == [2] * 6
    assert got["accumulate"].iloc[0] == (
        "rescale_torch" if mode == "rescale" else "plain")


@pytest.mark.parametrize("mode", ["plain", "controls", "rescale"])
def test_frame_hook_grouping_equals_dual_anchor(toy, mode):
    """``postprocess_frame_func=group_by_region_frame`` on BED features
    gives the dual-anchor by-window run's groups and pups (the reference's
    own check, tests/test_modes.py), and the reference's; under rescale,
    where ``pileup(by_window=True)`` takes the hook, it gives the
    reference's."""
    ref_clr, clr = toy
    if mode == "rescale":
        feats = toy_features().assign(
            end=toy_features()["start"] + 3_000_000)
        kw = dict(features_format="bed", mindist=0, by_window=True,
                  rescale=True, rescale_flank=1, rescale_size=9,
                  view_df=toy_regions())
        got = port.pileup(clr, feats, device="cpu", **kw)
        compare_tables(got, ref.pileup(ref_clr, feats, **kw),
                       what="by window under rescale", **ENGINE_TOL)
        assert got["accumulate"].iloc[0] == "rescale_torch"
        return
    cc_kw = dict(features_format="bed", flank=2_000_000, mindist=0)
    if mode == "controls":
        cc_kw.update(nshifts=1, seed=4)
    from coolpuppy_tpu.lib.puputils import group_by_region_frame as ref_hook
    from coolpuppy_tpu_torch.lib.puputils import group_by_region_frame

    def run(pkg, c, hook, **kw):
        cc = pkg.CoordCreator(toy_features(), 1_000_000, **cc_kw)
        pu = pkg.PileUpper(c, cc, expected=False, view_df=toy_regions(),
                           control=mode == "controls", **kw)
        if hook is None:
            return pu.pileupsByWindowWithControl()
        pups = pu.pileupsWithControl(postprocess_frame_func=hook)
        keys = [("all", -1, -1) if g == "all" else tuple(g)
                for g in pups["group"]]
        pups = pups.drop(columns="group")
        for pos, col in enumerate(("chrom", "start", "end")):
            pups.insert(pos, col, [k[pos] for k in keys])
        return pups

    hooked = run(port, clr, group_by_region_frame, device="cpu")
    dual = run(port, clr, None, device="cpu")
    assert hooked["accumulate"].iloc[0] == "plain"
    compare_tables(hooked, dual, what="frame hook vs dual anchor",
                   rtol=1e-6, atol=1e-9)
    compare_tables(hooked, run(ref, ref_clr, ref_hook),
                   what="frame hook vs reference", **ENGINE_TOL)


def test_group_cids_take_tuple_groups():
    """The cids of a frame ``group_by_region_frame`` doubled
    (``frame_codes``, ``_block_cids``): tuple groups get cids in
    first-appearance order, per kind."""
    from coolpuppy_tpu_torch.coords import frame_codes
    from coolpuppy_tpu_torch.lib.puputils import group_by_region_frame

    frame = pd.DataFrame({
        "chrom1": ["chr1"] * 4, "start1": [10, 10, 30, 10],
        "end1": [15, 15, 35, 15], "chrom2": ["chr1"] * 4,
        "start2": [50, 30, 50, 50], "end2": [55, 35, 55, 55],
        "kind": pd.Categorical(["ROI", "ROI", "ROI", "control"]),
    })
    doubled = group_by_region_frame(frame)
    cid_of = {}

    def ensure_cid(kind, group):
        return cid_of.setdefault((kind, group), len(cid_of))

    engine = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")
    cids, _ = engine._block_cids(*frame_codes(doubled), ensure_cid)
    a, b, c = ("chr1", 10, 15), ("chr1", 30, 35), ("chr1", 50, 55)
    # side-1 groups of the four rows, then their side-2 groups
    assert list(cid_of) == [("ROI", a), ("ROI", b), ("control", a),
                            ("ROI", c), ("control", c)]
    assert cids.tolist() == [0, 0, 1, 2, 3, 1, 3, 4]
