"""The port's pileup() against the frozen goldens (read, never written),
by-window pileups under rescale against the reference's, the hook
keywords, and its device, trace and checkpoint plumbing, on the CPU."""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu as ref
import coolpuppy_tpu_torch as port
from fixtures import make_toy_cooler, toy_expected, toy_features, toy_regions
from test_golden_modes import many_features
from torch_cases import compare_tables

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_TOL = dict(rtol=1e-5, atol=1e-8)  # tests/test_property.py:81


@pytest.fixture(scope="module")
def golden_toy(tmp_path_factory):
    """tests/test_golden_modes.py's toy map (seed 321), read by the port."""
    path = str(tmp_path_factory.mktemp("cool") / "golden_toy.cool")
    clr, dense, weights = make_toy_cooler(path, seed=321)
    exp = toy_expected(clr, dense, toy_regions(), weights=weights)
    return port.Cooler.from_cool(path), exp


@pytest.fixture(scope="module")
def property_toy(tmp_path_factory):
    """tests/test_property.py's toy map (seed 123), read by the port."""
    path = str(tmp_path_factory.mktemp("cool") / "toy.cool")
    make_toy_cooler(path, seed=123)
    return port.Cooler.from_cool(path)


# golden name -> (pileup keywords beyond the common ones, keys it stores);
# the keywords are those of tests/test_golden_modes.py
GOLDEN_MODES = {
    "mode_ooe": (dict(expected_df="toy", ooe=True, mindist=0,
                      flank=3_000_000), ("data", "num", "n")),
    "mode_expected_emission": (
        dict(expected_df="toy", ooe=False, mindist=0, flank=3_000_000),
        ("data", "num", "n", "control_num"),
    ),
    "mode_coverage_norm": (
        dict(clr_weight_name=None, coverage_norm=True, mindist=0,
             flank=3_000_000), ("data", "num", "n"),
    ),
    "mode_local": (dict(local=True, flank=3_000_000), ("data", "n")),
    "mode_controls": (dict(nshifts=2, seed=42, mindist=0, flank=3_000_000),
                      ("data", "n", "control_n")),
    "mode_stripes": (dict(store_stripes=True, mindist=0, flank=3_000_000),
                     ("data", "n", "horizontal_stripe", "vertical_stripe",
                      "coordinates")),
    "mode_trans": (dict(trans=True, flank=3_000_000), ("data", "num", "n")),
    "mode_bedpe": (dict(features_format="bedpe", mindist=0, flank=3_000_000),
                   ("data", "num", "n")),
    "mode_by_window": (dict(by_window=True, mindist=0, flank=3_000_000),
                       None),
    # many_features() as 4 Mb TADs (tests/test_golden_modes.py:153-165)
    "mode_rescale": (dict(local=True, rescale=True, rescale_flank=1,
                          rescale_size=33, mindist=0, tad_width=4_000_000),
                     ("data", "n")),
}


def _golden_bedpe():
    """tests/test_golden_modes.py::test_golden_bedpe's rows: each chr1
    anchor paired with the one 4 positions later."""
    f = many_features()
    f1 = f[f["chrom"] == "chr1"].reset_index(drop=True)
    k = 4
    return pd.DataFrame({
        "chrom1": "chr1", "start1": f1["start"].values[:-k],
        "end1": f1["end"].values[:-k], "chrom2": "chr1",
        "start2": f1["start"].values[k:], "end2": f1["end"].values[k:],
    })


def _golden_values(pup, keys):
    """The stored keys of a golden: the 'all' row's (stripe coordinates as
    'chrom1.start1...' strings), or by window the per-window counts and
    starts and the first three windows' data, rows sorted like
    tests/test_golden_modes.py:236-252."""
    if keys is None:
        body = pup[pup["chrom"] != "all"].sort_values(
            ["chrom", "start"], kind="stable"
        )
        got = {"n_per_window": body["n"].values.astype(np.int64),
               "starts": body["start"].values.astype(np.int64)}
        for i in range(3):
            got[f"data_{i}"] = body["data"].iloc[i]
        return got
    row = pup[pup["group"] == "all"].iloc[0]
    got = {k: row[k] for k in keys}
    if "coordinates" in got:
        got["coordinates"] = np.array(
            [".".join(map(str, c)) for c in got["coordinates"]], dtype="U80"
        )
    return got


def _check_golden(name, got):
    want = np.load(os.path.join(GOLDEN, name + ".npz"))
    assert sorted(want.files) == sorted(got), name
    for k in want.files:
        if want[k].dtype.kind in "US":
            np.testing.assert_array_equal(np.asarray(got[k]).astype("U80"),
                                          want[k].astype("U80"),
                                          err_msg=f"{name}/{k}")
            continue
        np.testing.assert_allclose(np.asarray(got[k], float), want[k],
                                   equal_nan=True, err_msg=f"{name}/{k}",
                                   **GOLDEN_TOL)


@pytest.mark.parametrize("name", list(GOLDEN_MODES))
def test_golden_modes(golden_toy, name):
    clr, exp = golden_toy
    kw, keys = GOLDEN_MODES[name]
    kw = dict(kw)
    if kw.get("expected_df") == "toy":
        kw["expected_df"] = exp
    kw.setdefault("features_format", "bed")
    feats = _golden_bedpe() if kw["features_format"] == "bedpe" else (
        many_features()
    )
    if "tad_width" in kw:
        feats = feats.assign(end=feats["start"] + kw.pop("tad_width"))
    pup = port.pileup(clr, feats, view_df=toy_regions(), device="cpu", **kw)
    _check_golden(name, _golden_values(pup, keys))


def test_golden_bystrand_controls(property_toy):
    """tests/test_property.py::test_golden_regression on the port."""
    pup = port.pileup(
        property_toy, toy_features(), features_format="bed",
        view_df=toy_regions(), mindist=0, flank=2_000_000, nshifts=2,
        seed=7, by_strand=True, device="cpu",
    )
    got = {f"data_{o}": d for o, d in zip(pup["orientation"], pup["data"])}
    got["n"] = pup.sort_values("orientation")["n"].values.astype(np.int64)
    _check_golden("bystrand_controls", got)


_KW = dict(features_format="bed", view_df=toy_regions(), mindist=0,
           flank=2_000_000, device="cpu")


def _bedpe(feats):
    """BEDPE rows pairing each toy feature with itself."""
    return feats.rename(columns={"chrom": "chrom1", "start": "start1",
                                 "end": "end1"}).assign(
        chrom2=feats["chrom"], start2=feats["start"], end2=feats["end"])


@pytest.fixture(scope="module")
def property_toy_ref(tmp_path_factory):
    """The same map (seed 123) for the JAX package."""
    path = str(tmp_path_factory.mktemp("cool") / "toy_ref.cool")
    return make_toy_cooler(path, seed=123)[0]


@pytest.mark.parametrize("kind", ["bed", "bedpe"],
                         ids=["rescale", "rescale_bedpe"])
def test_out_of_slice_modes_raise(property_toy, property_toy_ref, kind):
    """By-window pileups under rescale, once outside the port and raising:
    they group through the ``group_by_region_frame`` frame hook, for BED
    features and for BEDPE rows, and match the reference's window by window
    (counts exact, ``data`` rtol 1e-4)."""
    feats = toy_features()
    feats = feats.assign(end=feats["start"] + 3_000_000)
    tables = []
    for pkg, clr, kw in ((port, property_toy, {"device": "cpu"}),
                         (ref, property_toy_ref, {})):
        cc = pkg.CoordCreator(feats if kind == "bed" else _bedpe(feats),
                              1_000_000, features_format=kind,
                              rescale_flank=1, mindist=0)
        pu = pkg.PileUpper(clr, cc, rescale=True, rescale_size=9,
                           expected=False, view_df=toy_regions(), **kw)
        tables.append(pu.pileupsByWindowWithControl())
    got, want = tables
    compare_tables(got, want, rtol=1e-4, atol=1e-7,
                   what=f"by-window rescale {kind}")
    assert got["accumulate"].iloc[0] == "rescale_torch"
    assert len(got) == 5 and np.asarray(got["data"].iloc[0]).shape == (9, 9)
    assert int(got.loc[got["chrom"] == "all", "n"].iloc[0]) > 0


def test_bedpe_and_hooks_raise(property_toy):
    """``rescale_flank`` gives the reference's expanded intervals; every
    hook keyword of ``pileupsWithControl`` is accepted, and by-window
    pileups of BEDPE rows run (none of them raises any more)."""
    feats = toy_features()
    bedpe = _bedpe(feats)
    for f, fmt, cols in ((feats, "bed", ["exp_start", "exp_end"]),
                         (bedpe, "bedpe", ["exp_start1", "exp_end1",
                                           "exp_start2", "exp_end2"])):
        got = port.CoordCreator(f, 1_000_000, features_format=fmt,
                                rescale_flank=1.5, mindist=0).intervals
        want = ref.CoordCreator(f, 1_000_000, features_format=fmt,
                                rescale_flank=1.5, mindist=0).intervals
        pd.testing.assert_frame_equal(got[cols], want[cols])
    cc = port.CoordCreator(feats, 1_000_000, features_format="bed",
                           flank=2_000_000, mindist=0)
    # one region: extra funcs replace the merge of two regions' pups (the
    # reference's sum_pups quirk)
    pu = port.PileUpper(property_toy, cc, view_df=toy_regions().iloc[[0]],
                        device="cpu")
    plain = pu.pileupsWithControl()
    hooks = {
        "postprocess_frame_func": (lambda frame: frame, "plain"),
        "postprocess_snip_func": (lambda snip: snip, "host_stream"),
        "postprocess_batch_func": (lambda frame, data: frame, "batch_hook"),
        "extra_sum_funcs": ({"n_seen": lambda acc, snip: acc},
                            "host_stream"),
    }
    for hook, (func, route) in hooks.items():
        got = pu.pileupsWithControl(**{hook: func})
        assert got["accumulate"].iloc[0] == route, hook
        assert int(got["n"].iloc[0]) == int(plain["n"].iloc[0]) > 0
        np.testing.assert_allclose(got["data"].iloc[0], plain["data"].iloc[0],
                                   rtol=1e-5, atol=1e-8, equal_nan=True)
    cc = port.CoordCreator(bedpe, 1_000_000, features_format="auto",
                           flank=2_000_000, mindist=0)
    assert cc.kind == "bedpe"
    pu = port.PileUpper(property_toy, cc, view_df=toy_regions(),
                        device="cpu")
    by_window = pu.pileupsByWindowWithControl()
    assert len(by_window) == len(feats) + 1
    assert list(by_window["n"]) == [2] * len(feats) + [2 * len(feats)]


def test_cuda_without_a_card_raises(property_toy, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.pileup(property_toy, toy_features(),
                    **dict(_KW, device="cuda"))


def test_trace_and_checkpoint_resume(property_toy, tmp_path):
    """trace_dir writes a chrome trace, with the run's phases as
    ``program_span`` events on their threads; a second run with the same
    checkpoint_dir reads the region pickles and gives the same table."""
    cc = port.CoordCreator(toy_features(), 1_000_000, features_format="bed",
                           flank=2_000_000, mindist=0, nshifts=1, seed=3)
    kw = dict(view_df=toy_regions(), control=True, device="cpu",
              checkpoint_dir=str(tmp_path / "ckpt"))
    first = port.PileUpper(property_toy, cc, trace_dir=str(tmp_path / "tr"),
                           **kw).pileupsWithControl()
    traces = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert events
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert {"ingest", "ingest/fetch", "coords", "tiles", "device"} <= {
        e["name"] for e in spans}
    assert all(e["ph"] == "X" and e["dur"] >= 0 and isinstance(e["tid"], int)
               for e in spans)
    regions = {e["args"]["region"] for e in spans if e["name"] == "ingest"}
    assert regions == {0, 1}
    assert len(list((tmp_path / "ckpt").glob("*.pkl"))) == 2
    again = port.PileUpper(property_toy, cc, **kw).pileupsWithControl()
    row1, row2 = first.iloc[0], again.iloc[0]
    assert row1["n"] == row2["n"] and row1["control_n"] == row2["control_n"]
    np.testing.assert_array_equal(row1["data"], row2["data"])
    # the resumed run keeps the routes its checkpoints were computed on
    assert first["accumulate"].iloc[0] == "plain"
    assert again["accumulate"].iloc[0] == "plain"
