"""The port's extension hooks against the JAX package's, on the CPU.

The same toy ``.cool`` file (``fixtures.make_toy_cooler``, seed 11, as
tests/test_extension.py) goes through ``coolpuppy_tpu.PileUpper`` and, read
with ``coolpuppy_tpu_torch.Cooler.from_cool``, through the port's
``PileUpper(device="cpu")``, with the same hooks; each package gets its own
``accumulate_values`` and ``get_domain_score``. Group keys, ``n``, ``num``
and ``control_n`` are exact, ``data`` within rtol 1e-4 / atol 1e-7 with NaN
positions equal (``torch_cases.compare_tables``); extras copied from frame
columns are equal in the same order, extras a hook computed from pixels
within rtol 1e-5 in the same order (``torch_cases.compare_extras``).
``stream_snips`` is held snip by snip: ``data`` within rtol 1e-6 with NaN
and +inf positions equal.
"""

import sys
from functools import partial

import numpy as np
import pandas as pd
import pytest
import torch

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu as ref
import coolpuppy_tpu_torch as port
from coolpuppy_tpu.expected import expected_trans
from coolpuppy_tpu.lib import numutils as ref_num
from coolpuppy_tpu.lib import puputils as ref_pup
from coolpuppy_tpu_torch.lib import numutils as port_num
from coolpuppy_tpu_torch.lib import puputils as port_pup
from fixtures import make_toy_cooler, toy_expected, toy_features, toy_regions
from torch_cases import compare_extras, compare_tables

BINSIZE = 1_000_000
ENGINE_TOL = dict(rtol=1e-4, atol=1e-7)
LIBS = {ref: (ref_pup, ref_num), port: (port_pup, port_num)}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cool") / "toy_ext.cool")
    ref_clr, dense, weights = make_toy_cooler(path, seed=11)
    exp = toy_expected(ref_clr, dense, toy_regions(), weights=weights)
    return {ref: ref_clr, port: port.Cooler.from_cool(path), "exp": exp}


def tad_features():
    starts = np.array([101, 109, 118, 126, 133]) * BINSIZE
    ends = starts + np.array([5, 6, 4, 5, 7]) * BINSIZE
    return pd.DataFrame({"chrom": "chr1", "start": starts, "end": ends})


def stranded(n, seed=5):
    starts = np.array([102, 104, 107, 110, 113, 117][:n]) * BINSIZE
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "chrom": ["chr1"] * n, "start": starts, "end": starts + 500_000,
        "strand": ["+", "-", "+", "-", "+", "-"][:n],
        "score": rng.uniform(0, 10, n).round(3),
    })


def piler(pkg, toy, feats, cc_kw, pu_kw=None):
    """A ``PileUpper`` of ``pkg`` over the toy map (the port's on the
    CPU)."""
    cc = pkg.CoordCreator(feats, BINSIZE, **cc_kw)
    pu_kw = dict(pu_kw or {})
    if pu_kw.get("expected") is True:
        pu_kw["expected"] = toy["exp"]
    pu_kw.setdefault("expected", False)
    pu_kw.setdefault("control", cc_kw.get("nshifts", 0) > 0)
    if pkg is port:
        pu_kw["device"] = "cpu"
    return pkg.PileUpper(toy[pkg], cc, **pu_kw)


def both(toy, feats, cc_kw, pu_kw, hooks, method="pileupsWithControl"):
    """``(port table, reference table)`` of one run; ``hooks(pup, num)``
    builds the hook keywords from a package's own lib modules."""
    out = []
    for pkg in (port, ref):
        pu = piler(pkg, toy, feats, cc_kw, pu_kw)
        out.append(getattr(pu, method)(**hooks(*LIBS[pkg])))
    return out


def values_of(key):
    """The ``extra_sum_funcs`` keyword collecting ``key``, built from a
    package's own ``accumulate_values``."""
    return lambda pup, num: {"extra_sum_funcs": {
        key: partial(pup.accumulate_values, key=key)}}


BED = dict(features_format="bed", nshifts=0)


def test_domain_score_pattern(toy):
    """The TAD domain-score walkthrough: a local rescaled pileup whose snip
    hook scores each snip into an output column."""
    def hooks(pup, num):
        def add_domain_score(snip):
            snip["domain_score"] = num.get_domain_score(snip["data"], 1)
            return snip
        return dict(postprocess_snip_func=add_domain_score,
                    **values_of("domain_score")(pup, num))

    got, want = both(toy, tad_features(),
                     dict(BED, local=True, rescale_flank=1, mindist=0),
                     dict(rescale=True, rescale_size=33), hooks)
    compare_tables(got, want, what="domain score", **ENGINE_TOL)
    compare_extras(got, want, ["domain_score"], "domain score", rtol=1e-5)
    row = got.set_index("group").loc["all"]
    assert len(row["domain_score"]) == row["n"] == len(tad_features())
    assert all(np.isfinite(s) for s in row["domain_score"])
    assert row["data"].shape == (33, 33)
    assert got["accumulate"].iloc[0] == "host_stream"


def test_hostpath_matches_device_path(toy):
    """A no-op snip hook gives the reference's host-stream table, and the
    port's own accumulate route on the same features."""
    cc_kw = dict(BED, flank=3 * BINSIZE)
    got, want = both(toy, stranded(4), cc_kw, None,
                     lambda pup, num: dict(postprocess_snip_func=lambda s: s))
    compare_tables(got, want, what="no-op snip hook", **ENGINE_TOL)
    direct = piler(port, toy, stranded(4), cc_kw).pileupsWithControl()
    assert got["accumulate"].iloc[0] == "host_stream"
    assert direct["accumulate"].iloc[0] == "plain"
    compare_tables(got, direct, what="host stream vs accumulate route",
                   rtol=1e-5, atol=1e-8)


def test_snip_hook_multiplies_groups(toy):
    """A generator hook that yields one copy per group."""
    def hooks(pup, num):
        def duplicate(snip):
            for side in ("left", "right"):
                yield dict(snip, group=side)
        return dict(postprocess_snip_func=duplicate)

    got, want = both(toy, stranded(3),
                     dict(BED, flank=2 * BINSIZE, mindist=0), None, hooks)
    compare_tables(got, want, what="duplicating hook", **ENGINE_TOL)
    by_group = got.set_index("group")
    assert list(by_group.index) == ["left", "right", "all"]
    assert by_group.loc["all", "n"] == 2 * by_group.loc["left", "n"] > 0


@pytest.mark.parametrize("nshifts", [0, 2], ids=["roi", "controls"])
def test_frame_column_route_stays_on_the_accumulate_route(toy, monkeypatch,
                                                          nshifts):
    """accumulate_values over a FRAME column: no host stream, route
    ``plain`` on the CPU, the lists equal to the reference's and to the
    host stream's, per strand group, in stream order."""
    cc_kw = dict(BED, flank=3 * BINSIZE, mindist=0, nshifts=nshifts, seed=3)
    run = dict(groupby=["strand1", "strand2"])
    pu = piler(port, toy, stranded(6), cc_kw)
    entered = []
    stream = port.PileUpper.stream_snips
    monkeypatch.setattr(
        port.PileUpper, "stream_snips",
        lambda self, *a, **k: entered.append(1) or stream(self, *a, **k))
    got = pu.pileupsWithControl(**values_of("score1")(port_pup, None), **run)
    assert not entered and got["accumulate"].iloc[0] == "plain"
    want = piler(ref, toy, stranded(6), cc_kw).pileupsWithControl(
        **values_of("score1")(ref_pup, None), **run)
    keys = ["score1"] + (["control_score1"] if nshifts else [])
    compare_tables(got, want, what="frame column", **ENGINE_TOL)
    compare_extras(got, want, keys, "frame column")
    host = piler(port, toy, stranded(6), cc_kw).pileupsWithControl(
        postprocess_snip_func=lambda s: s,
        **values_of("score1")(port_pup, None), **run)
    assert entered and host["accumulate"].iloc[0] == "host_stream"
    # ('all' replicates the reference's sum_pups quirk on either route)
    compare_tables(got, host, what="frame column vs host stream",
                   rtol=1e-5, atol=1e-8)
    compare_extras(got, host, keys, "frame column vs host stream")
    assert sum(len(v) for v in got["score1"][:-1]) == sum(got["n"][:-1])


def test_frame_keys_are_this_package_s_accumulate_values():
    engine = sys.modules["coolpuppy_tpu_torch.engine.pileup"]
    keys = engine._accumulate_values_frame_keys
    own = partial(port_pup.accumulate_values, key="score1")
    assert keys({"s": own}) == {"s": "score1"}
    assert keys({"s": own, "t": lambda a, b: a}) is None
    assert keys({"s": partial(ref_pup.accumulate_values, key="score1")}) \
        is None
    assert keys({"s": partial(port_pup.accumulate_values, {}, key="k")}) \
        is None
    assert keys({"s": partial(port_pup.accumulate_values)}) is None
    assert keys(None) == {}


def test_frame_key_that_is_no_column_falls_back_to_the_host_stream(toy):
    """A key no frame has sends the region to the host stream on its first
    chunk, where a snip without the key fails ``accumulate_values`` in
    both packages."""
    for pkg in (ref, port):
        pu = piler(pkg, toy, stranded(3),
                   dict(BED, flank=2 * BINSIZE, mindist=0))
        with pytest.raises(AssertionError, match="nowhere not in dict2"):
            pu.pileupsWithControl(**values_of("nowhere")(LIBS[pkg][0], None))


def test_opaque_extra_sum_func_falls_back_to_host(toy):
    """An extra func that is no accumulate_values partial runs on the
    host stream with the strictly per-snip fold."""
    def hooks(pup, num):
        def count_snips(acc, snip):
            acc["snipcount"] = acc.get("snipcount", 0) + 1
            acc["seen_n"] = acc.get("seen_n", []) + [acc["n"]]
            return acc
        return dict(extra_sum_funcs={"snipcount": count_snips})

    got, want = both(toy, stranded(3),
                     dict(BED, flank=2 * BINSIZE, mindist=0), None, hooks)
    compare_tables(got, want, what="opaque extra", **ENGINE_TOL)
    compare_extras(got, want, ["snipcount"], "opaque extra")
    row = got.set_index("group").loc["all"]
    assert row["snipcount"] == row["n"] > 0
    assert got["accumulate"].iloc[0] == "host_stream"


def center_hooks(mid):
    """tests/test_extension.py's pair of hooks: the sum of the central 3x3
    pixels, one snip at a time and one chunk at a time."""
    def snip_post(snip):
        snip["center"] = float(
            np.nansum(snip["data"][mid - 1 : mid + 2, mid - 1 : mid + 2]))
        yield snip

    def batch_post(frame, data):
        frame = frame.copy(deep=False)
        frame["center"] = np.nansum(
            np.nan_to_num(data[:, mid - 1 : mid + 2, mid - 1 : mid + 2],
                          posinf=np.inf), axis=(1, 2))
        return frame

    return snip_post, batch_post


BATCH_MODES = {
    "balanced": (dict(), dict()),
    "by_strand_flip": (dict(), dict(flip_negative_strand=True)),
    "controls": (dict(nshifts=2, seed=1), dict()),
    "coverage_norm": (dict(), dict(clr_weight_name=None,
                                   coverage_norm=True)),
    "ooe": (dict(), dict(expected=True)),
    "trans": (dict(trans=True), dict()),
}


@pytest.mark.parametrize("mode", list(BATCH_MODES))
def test_batch_hook_matches_snip_hook(toy, mode):
    """postprocess_batch_func against the reference's, and against the
    port's per-snip hook, with the computed column collected in stream
    order."""
    cc_extra, pu_kw = BATCH_MODES[mode]
    cc_kw = dict(BED, flank=3 * BINSIZE, mindist=0, **cc_extra)
    if cc_extra.get("trans"):
        del cc_kw["mindist"]
    pu_kw = dict(pu_kw, view_df=toy_regions())
    run = dict(groupby=["strand1", "strand2"]) if "strand" in mode else {}
    snip_post, batch_post = center_hooks(3)

    def hooks(kind):
        hook = {"postprocess_snip_func": snip_post} if kind == "snip" \
            else {"postprocess_batch_func": batch_post}
        return lambda pup, num: dict(hook, **run,
                                     **values_of("center")(pup, num))

    keys = ["center"] + (["control_center"] if "nshifts" in cc_extra else [])
    got, want = both(toy, toy_features(), cc_kw, pu_kw, hooks("batch"))
    compare_tables(got, want, what=f"batch hook {mode}", **ENGINE_TOL)
    compare_extras(got, want, keys, f"batch hook {mode}", rtol=1e-5)
    assert got["accumulate"].iloc[0] == "batch_hook"
    assert int(got["n"].iloc[0]) > 0
    snip = piler(port, toy, toy_features(), cc_kw, pu_kw).pileupsWithControl(
        **hooks("snip")(port_pup, port_num))
    compare_tables(got, snip, what=f"batch vs snip hook {mode}", rtol=1e-5,
                   atol=1e-6)
    compare_extras(got, snip, keys, f"batch vs snip hook {mode}", rtol=1e-5)


def test_extras_under_expected_emission_take_the_host_stream(toy):
    """expected without ooe: the synthetic expected snips pass through the
    extras too, so a frame-column extra runs on the host stream."""
    got, want = both(toy, stranded(6),
                     dict(BED, flank=2 * BINSIZE, mindist=0),
                     dict(expected=True, ooe=False, view_df=toy_regions()),
                     values_of("score1"))
    compare_tables(got, want, what="extras under emission", **ENGINE_TOL)
    compare_extras(got, want, ["score1"], "extras under emission")
    assert got["accumulate"].iloc[0] == "host_stream"
    assert "control_num" in got and int(got["n"].iloc[0]) > 0


@pytest.mark.parametrize("route", ["snip", "batch"])
def test_zero_expected_poisons_with_inf_like_the_reference(toy, route):
    """OOE with a zero in the expected: +inf rides in ``data`` on the host
    routes (they carry no poison plane) and comes out NaN at the same
    pixels as the reference's."""
    exp = toy["exp"].copy()
    exp.loc[exp["dist"] == 3, "balanced.avg"] = 0.0
    snip_post, batch_post = center_hooks(2)
    hook = {"postprocess_snip_func": snip_post} if route == "snip" else \
        {"postprocess_batch_func": batch_post}
    got, want = both(
        toy, toy_features(), dict(BED, flank=2 * BINSIZE, mindist=0),
        dict(expected=exp, view_df=toy_regions()),
        lambda pup, num: dict(hook, **values_of("center")(pup, num)))
    compare_tables(got, want, what=f"poison {route}", **ENGINE_TOL)
    compare_extras(got, want, ["center"], f"poison {route}", rtol=1e-5)
    data = got["data"].iloc[0]
    assert np.isnan(data).any() and np.isfinite(data).any()
    assert np.isinf(np.asarray(got["center"].iloc[0], float)).any()


STREAMS = {
    "controls": (dict(nshifts=1, seed=2), dict()),
    "ooe_flip": (dict(), dict(expected=True, flip_negative_strand=True)),
    "expected_emission": (dict(), dict(expected=True, ooe=False)),
    "coverage_norm": (dict(), dict(clr_weight_name=None,
                                   coverage_norm=True)),
    "stripes": (dict(), dict(store_stripes=True)),
    "trans_emission": (dict(trans=True), dict(expected="trans", ooe=False)),
    "rescale": (dict(rescale_flank=1), dict(rescale=True, rescale_size=9)),
    "rescale_local_stripes": (
        dict(rescale_flank=1, local=True),
        dict(rescale=True, rescale_size=9, store_stripes=True)),
    "rescale_emission_coverage": (
        dict(rescale_flank=1),
        dict(rescale=True, rescale_size=9, expected=True, ooe=False)),
}


def _trans_expected(ref_clr):
    name_of = {"chr1": "foo", "chr2": "bar"}
    exp = expected_trans(ref_clr)
    return exp.assign(region1=exp["region1"].map(name_of),
                      region2=exp["region2"].map(name_of))


@pytest.mark.parametrize("mode", list(STREAMS))
def test_stream_snips_matches_reference(toy, mode):
    """``PileUpper.stream_snips`` snip by snip: the same keys in the same
    order, every frame column equal, ``data`` within rtol 1e-6 with NaN and
    +inf at the same pixels, unflipped with the ``flip`` mark, expected
    snips after their ROI snip, stripes and the coordinate string."""
    cc_extra, pu_kw = STREAMS[mode]
    feats = toy_features()
    if "rescale" in mode:
        feats = feats.assign(end=feats["start"] + 3_000_000)
    cc_kw = dict(BED, mindist=0, **cc_extra)
    if "rescale" not in mode:
        cc_kw["flank"] = 2 * BINSIZE
    if cc_extra.get("trans"):
        del cc_kw["mindist"]
    pu_kw = dict(pu_kw, view_df=toy_regions())
    if pu_kw.get("expected") == "trans":
        pu_kw["expected"] = _trans_expected(toy[ref])
    regions = ("foo", "bar") if cc_extra.get("trans") else ("foo",)
    streams = []
    for pkg in (port, ref):
        pu = piler(pkg, toy, feats, cc_kw, pu_kw)
        if "flip" in mode:
            pu.ignore_group_order = False
            modify = pu._compose_modify_func("strand", None)
        else:
            modify = None
        streams.append(list(pu.stream_snips(
            *regions, modify_2Dintervals_func=modify)))
    got, want = streams
    assert len(got) == len(want) > 0
    kinds = [s["kind"] for s in got]
    if "emission" in mode:
        assert kinds[:2] == ["ROI", "control"]
    if "controls" in mode:
        assert "control" in kinds
    if "flip" in mode:
        assert any(s["flip"] for s in got)
    for i, (g, w) in enumerate(zip(got, want)):
        assert list(g) == list(w), i
        for k in w:
            if k in ("data", "cov_start", "cov_end", "horizontal_stripe",
                     "vertical_stripe"):
                gv, wv = np.asarray(g[k], float), np.asarray(w[k], float)
                assert gv.shape == wv.shape, (i, k)
                assert np.array_equal(np.isnan(gv), np.isnan(wv)), (i, k)
                assert np.array_equal(np.isinf(gv), np.isinf(wv)), (i, k)
                fin = np.isfinite(wv)
                np.testing.assert_allclose(gv[fin], wv[fin], rtol=1e-6,
                                           atol=0, err_msg=f"{i} {k}")
            else:
                assert g[k] == w[k] or (g[k] != g[k] and w[k] != w[k]), \
                    (i, k, g[k], w[k])
    if "stripes" in mode:
        assert got[0]["coordinates"].count(".") == 5
        assert got[0]["horizontal_stripe"].shape == (got[0]["data"].shape[1],)


def test_stream_stripes_and_rescale_through_the_host_route(toy):
    """The host stream's joined coordinate strings and the accumulate
    route's [n, 6] blocks finalize into the same table; with rescale and
    stripes the host route matches the reference's."""
    cc_kw = dict(BED, flank=2 * BINSIZE, mindist=0, nshifts=1, seed=4)
    pu_kw = dict(store_stripes=True, view_df=toy_regions())
    noop = lambda pup, num: dict(postprocess_snip_func=lambda s: s)
    got, want = both(toy, toy_features(), cc_kw, pu_kw, noop)
    compare_tables(got, want, what="host stream stripes", **ENGINE_TOL)
    direct = piler(port, toy, toy_features(), cc_kw,
                   pu_kw).pileupsWithControl()
    compare_tables(got, direct, what="stripes: host stream vs blocks",
                   rtol=1e-5, atol=1e-8)
    tads = toy_features().assign(end=toy_features()["start"] + 3_000_000)
    got, want = both(toy, tads, dict(BED, mindist=0, rescale_flank=1,
                                     local=True),
                     dict(rescale=True, rescale_size=33, store_stripes=True,
                          view_df=toy_regions()), noop)
    compare_tables(got, want, what="host stream rescale stripes",
                   **ENGINE_TOL)


def test_batch_hook_data_is_not_reused_and_edits_are_honoured(toy):
    """A hook may keep ``data`` across chunks (the engine hands it a fresh
    array per chunk), and the fold honours its in-place edits."""
    kept = []

    def keeper(frame, data):
        kept.append((data, data.copy()))
        return None

    cc_kw = dict(BED, flank=2 * BINSIZE, mindist=0, chunk_size=2)
    pu = piler(port, toy, toy_features(), cc_kw, dict(view_df=toy_regions()))
    plain = pu.pileupsWithControl(postprocess_batch_func=keeper)
    assert len(kept) > 1
    for data, copy in kept:
        assert data.dtype == np.float32 and data.shape[1:] == (5, 5)
        np.testing.assert_array_equal(data, copy)
    assert sum(len(d) for d, _ in kept) == int(plain["n"].iloc[0])

    def ones(frame, data):
        data[:] = 1.0

    pu = piler(port, toy, toy_features(), cc_kw, dict(view_df=toy_regions()))
    edited = pu.pileupsWithControl(postprocess_batch_func=ones)
    np.testing.assert_array_equal(edited["data"].iloc[0], np.ones((5, 5)))
    np.testing.assert_array_equal(edited["num"].iloc[0],
                                  np.full((5, 5), edited["n"].iloc[0]))


def test_hook_that_yields_one_dict_twice_folds_each_state(toy):
    """A snip hook that yields the SAME dict twice, rebinding ``group`` and
    an extras key in between: the batched fold gives the strictly per-snip
    fold (``_add_snip`` on every yield, as it comes)."""
    def twice(snip):
        snip["group"], snip["tag"] = "left", 1.0
        yield snip
        snip["group"], snip["tag"] = "right", 2.0
        snip["data"] = snip["data"] * 2
        yield snip

    funcs = values_of("tag")(port_pup, None)["extra_sum_funcs"]
    cc_kw = dict(BED, flank=2 * BINSIZE, mindist=0)
    pu = piler(port, toy, stranded(6), cc_kw)
    got = pu.pileup_region("chr1", postprocess_snip_func=twice,
                           extra_sum_funcs=funcs)["ROI"]
    want = {}
    pu = piler(port, toy, stranded(6), cc_kw)
    for snip in pu.stream_snips("chr1"):
        for s in twice(snip):
            port_pup._add_snip(want, s["group"], s, extra_funcs=funcs)
    assert set(got) == {"left", "right", "all"}
    for g in ("left", "right"):
        assert got[g]["n"] == want[g]["n"] > 1
        assert got[g]["tag"] == want[g]["tag"]
        np.testing.assert_array_equal(got[g]["num"], want[g]["num"])
        np.testing.assert_allclose(got[g]["data"], want[g]["data"],
                                   rtol=1e-12)
    assert set(got["left"]["tag"]) == {1.0}
    assert set(got["right"]["tag"]) == {2.0}
    np.testing.assert_allclose(got["right"]["data"],
                               2 * got["left"]["data"], rtol=1e-12)


def _noop_batch(frame, data):
    return None


ERRORS = {
    "batch_and_snip": (dict(), dict(postprocess_snip_func=lambda s: s),
                       "mutually exclusive"),
    "batch_rescale": (dict(rescale=True, rescale_size=9), dict(),
                      "does not support"),
    "batch_stripes": (dict(store_stripes=True), dict(), "does not support"),
    "batch_expected_emission": (dict(expected=True, ooe=False), dict(),
                                "does not support"),
    "batch_by_window": (dict(), dict(dual_anchor=True), "does not support"),
    "batch_opaque_extras": (dict(), dict(extra_sum_funcs={
        "x": lambda acc, snip: acc}), "accumulate_values-style"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_hook_argument_errors_match_reference(toy, case):
    pu_kw, run_kw, message = ERRORS[case]
    cc_kw = dict(BED, mindist=0)
    feats = toy_features()
    if pu_kw.get("rescale"):
        cc_kw["rescale_flank"] = 1
        feats = feats.assign(end=feats["start"] + 3_000_000)
    else:
        cc_kw["flank"] = 2 * BINSIZE
    for pkg in (ref, port):
        pu = piler(pkg, toy, feats, cc_kw,
                   dict(pu_kw, view_df=toy_regions()))
        with pytest.raises(ValueError, match=message):
            pu.pileupsWithControl(postprocess_batch_func=_noop_batch,
                                  **run_kw)


@pytest.mark.parametrize("route", ["stream_snips", "batch_hook",
                                   "host_stream"])
def test_hook_routes_do_not_carry_on_without_a_card(toy, monkeypatch, route):
    """``device="cuda"`` without a card: the ``PileUpper`` cannot be built,
    and one whose device was set to the card afterwards fails at its first
    upload; no route quietly runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cc = port.CoordCreator(toy_features(), BINSIZE, flank=2 * BINSIZE,
                           **BED)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.PileUpper(toy[port], cc, device="cuda")
    pu = port.PileUpper(toy[port], cc, device="cpu", view_df=toy_regions())
    pu.device = torch.device("cuda", 0)
    with pytest.raises((RuntimeError, AssertionError)):
        if route == "stream_snips":
            next(pu.stream_snips("foo"))
        elif route == "batch_hook":
            pu.pileupsWithControl(postprocess_batch_func=_noop_batch)
        else:
            pu.pileupsWithControl(postprocess_snip_func=lambda s: s)


def test_fetch_windows_blocks_and_flip(monkeypatch):
    """``fetch_windows`` under a byte cap of a few windows: the blocks tile
    the stream, each a fresh float32 array equal to ``cut_windows``, a
    flagged window anti-transposed; with logical sizes the h x w corner is
    the window."""
    from coolpuppy_tpu_torch.ops import tiles
    from coolpuppy_tpu_torch.ops.tiles import cut_windows, fetch_windows

    rng = np.random.default_rng(0)
    B, W, n = 8, 5, 11
    stiles = torch.from_numpy(rng.random((10, B, B)).astype(np.float32))
    stiles[0] = torch.nan
    tmap = torch.from_numpy(rng.integers(0, 10, (4, 4)))
    r1 = rng.integers(0, 3 * B - W, n)
    r2 = rng.integers(0, 3 * B - W, n)
    flip = rng.random(n) < 0.4
    whole = cut_windows(stiles, tmap, torch.from_numpy(r1),
                        torch.from_numpy(r2), W).numpy()
    want = np.where(flip[:, None, None],
                    np.flip(whole, axis=(1, 2)).transpose(0, 2, 1), whole)
    monkeypatch.setattr(tiles, "FETCH_BYTES", 3 * 4 * W * W)
    blocks = list(fetch_windows(stiles, tmap, r1, r2, W, flip=flip))
    assert [(lo, hi) for lo, hi, _ in blocks] == [(0, 3), (3, 6), (6, 9),
                                                  (9, 11)]
    for lo, hi, block in blocks:
        assert block.dtype == np.float32
        np.testing.assert_array_equal(block, want[lo:hi])
        assert not any(np.shares_memory(block, other)
                       for _, _, other in blocks if other is not block)
    monkeypatch.undo()
    h1, w2 = rng.integers(1, W + 1, n), rng.integers(1, W + 1, n)
    (lo, hi, block), = fetch_windows(stiles, tmap, r1, r2, W, h1=h1, w2=w2)
    assert (lo, hi) == (0, n)
    for i in range(n):
        np.testing.assert_array_equal(block[i, :h1[i], :w2[i]],
                                      whole[i, :h1[i], :w2[i]])
    assert list(fetch_windows(stiles, tmap, r1[:0], r2[:0], W)) == []
