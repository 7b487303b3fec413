"""Every function of the port's ``lib/numutils.py`` and ``lib/puputils.py``
against the JAX package's function of the same name, on seeded arrays (NaNs
and +inf present): the results are equal, not merely close, since both are
the same numpy calls."""

import warnings
from functools import partial

import numpy as np
import pandas as pd
import pytest

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

from coolpuppy_tpu.lib import numutils as ref_num
from coolpuppy_tpu.lib import puputils as ref_pup
from coolpuppy_tpu_torch.lib import numutils as port_num
from coolpuppy_tpu_torch.lib import puputils as port_pup


def same(got, want, path="result"):
    """Recursive equality: dicts and Series key by key, lists item by item,
    arrays with NaN positions equal."""
    if isinstance(want, pd.DataFrame):
        assert list(got.columns) == list(want.columns), path
        for c in want.columns:
            same(list(got[c]), list(want[c]), f"{path}[{c!r}]")
    elif isinstance(want, (dict, pd.Series)):
        assert list(got.keys()) == list(want.keys()), path
        for k in want.keys():
            same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) or np.isscalar(want):
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype, f"{path}: {g.dtype} != {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=path)
    else:
        assert got == want, path


def amap(seed, n=15):
    rng = np.random.default_rng(seed)
    a = rng.gamma(2.0, 1.0, (n, n))
    a[rng.random((n, n)) < 0.1] = np.nan
    return a


def test_modules_hold_the_reference_functions():
    """Thirteen functions and one alias in puputils, eight in numutils."""
    for ref, port in ((ref_num, port_num), (ref_pup, port_pup)):
        names = [n for n, v in vars(ref).items()
                 if callable(v) and getattr(v, "__module__", "") == ref.__name__]
        assert len({id(getattr(ref, n)) for n in names}) in (8, 13)
        for n in names:
            assert callable(getattr(port, n)), n
            assert getattr(port, n).__module__ == port.__name__
    assert port_pup.group_by_region is port_pup.group_by_region_frame


NUM_CASES = {
    "fill_diag_main": ("fill_diag", lambda: (amap(0), 7.0, 0)),
    "fill_diag_upper": ("fill_diag", lambda: (amap(1), np.nan, 2)),
    "fill_diag_lower": ("fill_diag", lambda: (amap(2), -1.0, -3)),
    "copy_array_halves": ("_copy_array_halves", lambda: (amap(3)[:4],)),
    "copy_array_halves_one_row": ("_copy_array_halves",
                                  lambda: (amap(3)[:1, :7],)),
    "corner_cv": ("corner_cv", lambda: (amap(4),)),
    "corner_cv_i2": ("corner_cv", lambda: (amap(4), 2)),
    "norm_cis": ("norm_cis", lambda: (amap(5),)),
    "norm_cis_off": ("norm_cis", lambda: (amap(5), 0)),
    "get_enrichment_1": ("get_enrichment", lambda: (amap(6), 1)),
    "get_enrichment_3": ("get_enrichment", lambda: (amap(6), 3)),
    "get_local_enrichment": ("get_local_enrichment", lambda: (amap(7), 1)),
    "get_local_enrichment_f2": ("get_local_enrichment",
                                lambda: (amap(7), 2)),
    "get_domain_score": ("get_domain_score", lambda: (amap(8), 1)),
    "get_domain_score_f2": ("get_domain_score", lambda: (amap(8), 2)),
    "get_insulation_strength": ("get_insulation_strength",
                                lambda: (amap(9),)),
    "get_insulation_strength_c3": ("get_insulation_strength",
                                   lambda: (amap(9), 3, 1)),
}


@pytest.mark.parametrize("name", list(NUM_CASES))
def test_numutils_match_reference(name):
    func, make = NUM_CASES[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = getattr(ref_num, func)(*make())
        got = getattr(port_num, func)(*make())
    same(got, want)
    assert np.isfinite(np.asarray(want, float)).any()


def test_numutils_argument_errors():
    for mod in (ref_num, port_num):
        with pytest.raises(ValueError, match="too large"):
            mod.get_enrichment(amap(0, 5), 3)
        with pytest.raises(ValueError, match="odd"):
            mod.get_insulation_strength(amap(0), 2)
        with pytest.raises(AssertionError):
            mod.get_domain_score(amap(0, 16), 1)
    a = amap(1)
    assert port_num.fill_diag(a, 0.0, copy=False) is a


def pup(seed, shape=(5, 5), stripes=0, extras=None, poison=False):
    rng = np.random.default_rng(seed)
    data = rng.gamma(2.0, 1.0, shape)
    data[rng.random(shape) < 0.2] = np.nan
    out = {
        "data": data,
        "num": rng.integers(0, 9, shape),
        "n": int(rng.integers(1, 9)),
        "cov_start": rng.random(shape[0]),
        "cov_end": rng.random(shape[1]),
        "horizontal_stripe": [rng.random(shape[1]) for _ in range(stripes)],
        "vertical_stripe": [rng.random(shape[0]) for _ in range(stripes)],
        "coordinates": [f"chr1.{i}.{i + 1}.chr1.{i}.{i + 1}"
                        for i in range(stripes)],
    }
    if poison:
        out["poison"] = (rng.random(shape) < 0.1).astype(float)
    out.update(extras or {})
    return out


def test_empty_pup_and_norm_coverage():
    same(port_pup.empty_pup((3, 4)), ref_pup.empty_pup((3, 4)))
    same(port_pup.norm_coverage(pup(0)), ref_pup.norm_coverage(pup(0)))


@pytest.mark.parametrize("case", ["plain", "stripes", "poison_one_side",
                                  "snips_without_n", "extra_funcs",
                                  "two_extra_funcs"])
def test_sum_pups_matches_reference(case):
    def args(mod):
        if case == "plain":
            return (pup(1), pup(2)), {}
        if case == "stripes":
            return (pup(1, stripes=2), pup(2, stripes=3)), {}
        if case == "poison_one_side":
            return (pup(1, poison=True), pup(2)), {}
        if case == "snips_without_n":
            a, b = pup(1), pup(2)
            for p in (a, b):
                del p["n"], p["num"]
            a["data"][0, 0] = np.inf
            return (a, b), {}
        funcs = {"score": partial(mod.accumulate_values, key="score")}
        extras1, extras2 = {"score": [1.5, 2.5]}, {"score": [4.0]}
        if case == "two_extra_funcs":
            funcs["tag"] = partial(mod.accumulate_values, key="tag")
            extras1["tag"] = ["a"]
            extras2["tag"] = "b"
        return ((pup(1, extras=extras1), pup(2, extras=extras2)),
                {"extra_funcs": funcs})

    a, kw = args(ref_pup)
    want = ref_pup.sum_pups(*a, **kw)
    a, kw = args(port_pup)
    got = port_pup.sum_pups(*a, **kw)
    assert isinstance(got, pd.Series)
    same(got, want)
    if "extra_funcs" in case:
        # the reference's quirk, replicated: the extras REPLACE the merge
        assert got["n"] == a[0]["n"] and got["score"] == [1.5, 2.5, 4.0]


@pytest.mark.parametrize("kind", ["offdiagonal", "local_rescaled", "local"])
def test_get_score_matches_reference(kind):
    row = {"data": amap(3), "local": kind != "offdiagonal",
           "rescale": kind == "local_rescaled", "rescale_flank": 1}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = ref_pup.get_score(row, center=3, ignore_central=3)
        got = port_pup.get_score(row, center=3, ignore_central=3)
    same(got, want)
    assert np.isfinite(got)


def _table(seed, stripes=None, coords=("a", "b"), **meta):
    rng = np.random.default_rng(seed)
    row = {"group": "all", "data": rng.gamma(2.0, 1.0, (5, 5)),
           "n": int(rng.integers(1, 9)), "num": rng.integers(1, 9, (5, 5)),
           "clr": f"map{seed}.cool", "resolution": 1000, "flank": 2000,
           "seed": seed, **meta}
    if stripes:
        row["horizontal_stripe"] = rng.random((len(coords), 5))
        row["vertical_stripe"] = rng.random((len(coords), 5))
        row["vertical_stripe"][0, 0] = 0.0
        row["coordinates"] = np.array(coords, dtype=object)
    return pd.DataFrame([row])


@pytest.mark.parametrize("case", ["plain", "stripes", "stripes_differ",
                                  "metadata_differs"])
def test_divide_pups_matches_reference(case):
    if case == "plain":
        a, b = _table(1), _table(2)
    elif case == "stripes":
        a, b = _table(1, stripes=True), _table(2, stripes=True)
    elif case == "stripes_differ":
        a = _table(1, stripes=True)
        b = _table(2, stripes=True, coords=("a", "c"))
    else:
        a, b = _table(1), _table(2, flank=3000)
    outs = []
    for mod in (ref_pup, port_pup):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs.append(mod.divide_pups(a, b))
        assert (len(caught) == 1) == (case == "metadata_differs")
    same(outs[1], outs[0])
    assert ("vertical_stripe" in outs[1]) == (case == "stripes")
    for mod in (ref_pup, port_pup):
        with pytest.raises(ValueError, match="multiple conditions"):
            mod.divide_pups(pd.concat([a, a]), b)


def _frame():
    return pd.DataFrame({
        "chrom1": ["chr1", "chr1", "chr2"], "start1": [10, 20, 30],
        "end1": [15, 25, 35], "chrom2": ["chr1", "chr1", "chr2"],
        "start2": [100, 20, 300], "end2": [105, 25, 305],
        "distance": [90, 0, 270_000], "group": ["all"] * 3,
    })


@pytest.mark.parametrize("edges", ["default", [0, 100, 1000, 10**6]])
def test_distance_bands_match_reference(edges):
    same(port_pup.bin_distance_frame(_frame(), edges),
         ref_pup.bin_distance_frame(_frame(), edges))
    for dist in (0, 90, 60_000, 270_000):
        same(port_pup.bin_distance({"distance": dist}, edges),
             ref_pup.bin_distance({"distance": dist}, edges))


def test_group_by_region_frame_matches_reference():
    want = ref_pup.group_by_region_frame(_frame())
    got = port_pup.group_by_region(_frame())
    same(got, want)
    assert len(got) == 6 and got["group"].iloc[3] == ("chr1", 100, 105)


def test_accumulate_values_matches_reference_and_never_aliases():
    for mod in (ref_pup, port_pup):
        assert mod._as_list(3) == [3] and mod._as_list([3]) == [3]
        acc, incoming = {}, {"score": [1.0, 2.0]}
        acc = mod.accumulate_values(acc, incoming, "score")
        assert acc["score"] == [1.0, 2.0]
        assert acc["score"] is not incoming["score"]
        held = acc["score"]
        acc = mod.accumulate_values(acc, {"score": 3.0}, "score")
        assert acc["score"] is held and held == [1.0, 2.0, 3.0]
        assert incoming["score"] == [1.0, 2.0]
        scalar = mod.accumulate_values({"score": 0.5}, {"score": [1.0]},
                                       "score")
        assert scalar["score"] == [0.5, 1.0]
        with pytest.raises(AssertionError, match="not in dict2"):
            mod.accumulate_values({}, {}, "score")


def _snips(seed, n, shapes=((5, 5),)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        shape = shapes[i % len(shapes)]
        data = rng.gamma(2.0, 1.0, shape)
        data[rng.random(shape) < 0.2] = np.nan
        if i == 1:
            data[0, 0] = np.inf
        out.append({
            "data": data, "cov_start": rng.random(shape[0]),
            "cov_end": rng.random(shape[1]), "horizontal_stripe": data[2],
            "vertical_stripe": data[:, 2], "coordinates": f"c{i}",
            "score": float(i),
        })
    return out


@pytest.mark.parametrize("n", [1, 2, 7])
def test_add_snip_folds_match_reference(n):
    """_add_snip chained, and _add_snip_batch in two flushes, in both
    packages: one accumulator, a one-snip group keeping its NaNs."""
    outs = []
    for mod in (ref_pup, port_pup):
        funcs = {"score": partial(mod.accumulate_values, key="score")}
        chained, batched = {}, {}
        for s in _snips(5, n):
            mod._add_snip(chained, "g", s, extra_funcs=funcs)
        snips = _snips(5, n)
        mod._add_snip_batch(batched, "g", snips[:3], extra_funcs=funcs)
        if snips[3:]:
            mod._add_snip_batch(batched, "g", snips[3:], extra_funcs=funcs)
        outs.append((chained, batched))
    same(outs[1], outs[0])
    chained, batched = outs[1]
    assert chained["g"]["n"] == batched["g"]["n"] == n
    assert batched["g"]["score"] == [float(i) for i in range(n)]
    np.testing.assert_array_equal(chained["g"]["num"], batched["g"]["num"])
    np.testing.assert_allclose(chained["g"]["data"], batched["g"]["data"],
                               rtol=1e-12)
    assert np.isnan(chained["g"]["data"]).any() == (n == 1)


def test_add_snip_batch_on_mixed_shapes():
    """Snips of several shapes in one group leave the stacked fill for the
    per-snip fold, which cannot add them either: both packages raise."""
    for mod in (ref_pup, port_pup):
        with pytest.raises(ValueError):
            mod._add_snip_batch({}, "g", [
                dict(_snips(7, 1)[0], data=np.ones((3, 3))),
                _snips(7, 1)[0]])


def test_collapse_snips_matches_reference():
    a, b, c = {"k": 1}, pd.Series({"k": 2}), {"k": 3}

    def nested():
        yield a
        yield [b, (x for x in [c])]

    for mod in (ref_pup, port_pup):
        got = list(mod.collapse_snips(nested()))
        assert [g["k"] for g in got] == [1, 2, 3]
        assert list(mod.collapse_snips(a)) == [a]
