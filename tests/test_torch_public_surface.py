"""The port's public surface against the JAX package's, on the CPU: the
reference notebooks' import lines rewritten to the port's aliases
(``coolpuppy_tpu_torch.coolpup``, ``.plotpup``, ``.lib.io``,
``.lib.numutils``, ``.lib.puputils``, ``.lib.util``; the twin of
``tests/test_compat_shim.py``), each alias holding the names of its
``coolpuppy/`` counterpart; ``CoordCreator.bedpe2bed``,
``read_chromsizes_table``, ``assign_groups`` and ``bin_distance_intervals``
equal to the reference's on the same inputs; the top-level and
``genomics`` names."""

import importlib

import numpy as np
import pandas as pd
import pytest

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu_torch as port
from coolpuppy import coolpup as ref_coolpup
from coolpuppy_tpu import Cooler as RefCooler
from coolpuppy_tpu.genomics import intervals as ref_intervals
from fixtures import make_toy_cooler, toy_features, toy_regions

ALIASES = ["coolpup", "plotpup", "lib.io", "lib.numutils", "lib.puputils",
           "lib.util"]


def _bedpe():
    rng = np.random.default_rng(5)
    s1 = rng.integers(0, 50, 12) * 1_000
    s2 = s1 + rng.integers(5, 40, 12) * 1_000
    return pd.DataFrame({
        "chrom1": rng.choice(["chr2", "chr1"], 12), "start1": s1,
        "end1": s1 + 700, "chrom2": "chr1", "start2": s2, "end2": s2 + 900,
        "score": rng.uniform(0, 1, 12),
    })


def test_reference_notebook_imports(tmp_path):
    from coolpuppy_tpu_torch import coolpup
    from coolpuppy_tpu_torch import plotpup
    from coolpuppy_tpu_torch.lib import numutils
    from coolpuppy_tpu_torch.lib.puputils import divide_pups, accumulate_values
    from coolpuppy_tpu_torch.lib.numutils import get_domain_score
    from coolpuppy_tpu_torch.lib.io import save_pileup_df, load_pileup_df

    assert coolpup.pileup is port.pileup
    assert coolpup.CoordCreator is port.CoordCreator
    assert coolpup.PileUpper is port.PileUpper
    assert callable(plotpup.plot) and callable(plotpup.plot_stripes)
    for f in (numutils.get_enrichment, divide_pups, accumulate_values,
              get_domain_score):
        assert callable(f)

    path = str(tmp_path / "shim.cool")
    make_toy_cooler(path, seed=31)
    kw = dict(features_format="bed", view_df=toy_regions(), mindist=0,
              flank=2_000_000)
    pup = coolpup.pileup(port.Cooler(path), toy_features(), device="cpu",
                         **kw)
    want = ref_coolpup.pileup(RefCooler(path), toy_features(), **kw)
    assert int(pup.loc[pup["group"] == "all", "n"].iloc[0]) == \
        int(want.loc[want["group"] == "all", "n"].iloc[0]) > 0
    np.testing.assert_allclose(pup["data"].iloc[0], want["data"].iloc[0],
                               rtol=1e-5, atol=1e-7, equal_nan=True)
    out = tmp_path / "shim.clpy"
    save_pileup_df(str(out), pup)
    back = load_pileup_df(str(out))
    np.testing.assert_allclose(
        np.asarray(back["data"].iloc[0]),
        np.asarray(pup["data"].iloc[0]),
        rtol=1e-6, atol=1e-9, equal_nan=True,
    )


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_holds_the_shims_names(alias):
    ref = importlib.import_module("coolpuppy." + alias)
    got = importlib.import_module("coolpuppy_tpu_torch." + alias)
    names = {n for n in dir(ref) if not n.startswith("__")
             and (callable(getattr(ref, n)) or n.startswith("_"))}
    missing = sorted(n for n in names if not hasattr(got, n))
    assert not missing, missing


def test_lib_imports_its_four_modules():
    import coolpuppy_tpu_torch.lib as lib

    for name in ("io", "numutils", "puputils", "util"):
        assert getattr(lib, name).__name__ == f"coolpuppy_tpu_torch.lib.{name}"


@pytest.mark.parametrize("how", ["ends", "center", "outer", "inner"])
def test_bedpe2bed_matches_reference(how):
    from coolpuppy_tpu.coords import CoordCreator as RefCC

    feats = toy_features()
    kw = dict(ends=True) if how == "ends" else dict(ends=False, how=how)
    got = port.CoordCreator(feats, 1_000_000, features_format="bed",
                            flank=2_000_000).bedpe2bed(_bedpe(), **kw)
    want = RefCC(feats, 1_000_000, features_format="bed",
                 flank=2_000_000).bedpe2bed(_bedpe(), **kw)
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("source", ["path", "frame"])
def test_read_chromsizes_table_matches_reference(source, tmp_path):
    from coolpuppy_tpu_torch.genomics.intervals import read_chromsizes_table

    frame = pd.DataFrame({"chrom": ["chr1", "chr2", "chrX", 7],
                          "length": [197_195_432, 181_748_087, 166_650_296,
                                     1_000]})
    arg = frame
    if source == "path":
        arg = str(tmp_path / "sizes.tsv")
        frame.to_csv(arg, sep="\t", header=False, index=False)
    got = read_chromsizes_table(arg)
    want = ref_intervals.read_chromsizes_table(arg)
    assert got == want and list(got) == list(want)
    assert {type(v) for v in got.values()} == {type(v) for v in want.values()}


@pytest.mark.parametrize("groupby", [None, ["strand1"], ["strand1", "cls"]])
def test_assign_groups_matches_reference(groupby):
    from coolpuppy_tpu.coords import assign_groups as ref_assign

    rng = np.random.default_rng(2)
    frame = pd.DataFrame({"strand1": rng.choice(["+", "-"], 40),
                          "cls": rng.choice([1, 2, 3], 40)})
    got = port.assign_groups(frame.copy(), groupby)
    want = ref_assign(frame.copy(), groupby)
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("edges", ["default", [0, 100_000, 1_000_000]])
def test_bin_distance_intervals_matches_reference(edges):
    from coolpuppy_tpu.coords import bin_distance_intervals as ref_bin

    rng = np.random.default_rng(4)
    frame = pd.DataFrame({"distance": rng.integers(0, 5_000_000, 60)})
    got = port.bin_distance_intervals(frame.copy(), edges)
    want = ref_bin(frame.copy(), edges)
    pd.testing.assert_frame_equal(got, want)


def test_top_level_and_genomics_names():
    import coolpuppy_tpu
    import coolpuppy_tpu.genomics as ref_genomics
    import coolpuppy_tpu_torch.genomics as genomics
    from coolpuppy_tpu_torch.genomics import intervals

    assert port.write_cool is port.io.write_cool
    assert port.assign_groups is importlib.import_module(
        "coolpuppy_tpu_torch.coords").assign_groups
    ref_names = {n for n in vars(coolpuppy_tpu) if not n.startswith("_")
                 and callable(getattr(coolpuppy_tpu, n))}
    assert not sorted(n for n in ref_names if not hasattr(port, n))
    names = [n for n in vars(ref_genomics) if not n.startswith("_")
             and callable(getattr(ref_genomics, n))]
    assert len(names) == 9
    for n in names:
        assert getattr(genomics, n) is getattr(intervals, n), n
