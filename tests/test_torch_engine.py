"""The port's pileup() against the JAX package's, on the CPU.

The same toy ``.cool`` file (``fixtures.make_toy_cooler``) goes through the
reference ``coolpuppy_tpu.pileup`` and, read with
``coolpuppy_tpu_torch.Cooler.from_cool``, through the port's
``pileup(device="cpu")`` (the plain PyTorch version of the quad kernel), in
every mode of the port (``torch_cases.ENGINE_MODES``): group keys, ``n``,
``control_n``, ``num`` and ``control_num`` exact, ``data`` within rtol 1e-4 /
atol 1e-7 with NaN positions equal (the reference's engine-level tolerance,
tests/test_pallas_modes.py). Then the reference's own count vectors
(tests/test_engine.py) on the port's PileUpper.
"""

import numpy as np
import pandas as pd
import pytest

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu as ref
import coolpuppy_tpu_torch as port
from fixtures import make_toy_cooler, toy_expected, toy_features, toy_regions
from torch_cases import (
    ENGINE_KW,
    ENGINE_MODES,
    compare_tables,
    engine_snips,
    engine_workload,
    mode_kwargs,
)

ENGINE_TOL = dict(rtol=1e-4, atol=1e-7)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cool") / "toy.cool")
    clr, dense, weights = make_toy_cooler(path, seed=1)
    exp = toy_expected(clr, dense, toy_regions(), weights=weights)
    return clr, port.Cooler.from_cool(path), exp


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_pileup_matches_reference(toy, mode):
    ref_clr, clr, exp = toy
    kw = mode_kwargs(mode, exp)
    want = ref.pileup(ref_clr, toy_features(), view_df=toy_regions(), **kw)
    got = port.pileup(clr, toy_features(), view_df=toy_regions(),
                      device="cpu", **kw)
    compare_tables(got, want, what=mode, **ENGINE_TOL)
    assert len(got) == len(want)
    assert got["accumulate"].iloc[0] == "plain"
    assert got["backend"].iloc[0] == "torch"
    assert got["clr"].iloc[0] == want["clr"].iloc[0]
    assert got["cooler"].iloc[0] == want["cooler"].iloc[0]


def test_engine_workload_matches_reference(tmp_path):
    """``torch_cases``' bench_engine workload cut to 4,000 bins, 400k
    contacts and 1,500 sites (~194k snips, shifted controls crossing the
    chromosome ends): the port on its from_arrays cooler against the
    reference on the same pixels written to a .cool file."""
    from coolpuppy_tpu.io import write_cool

    clr, feats = engine_workload(n_sites=1500, n_bins=4000,
                                 n_contacts=400_000)
    b1, b2, count = clr.pixels_chunk(0, clr.n_pixels)
    path = str(tmp_path / "engine.cool")
    write_cool(path, clr.chromsizes, clr.binsize,
               (b1, b2, count.astype(np.int64)),
               weights=clr.bins_df()["weight"].to_numpy())
    want = ref.pileup(ref.Cooler(path), feats, **ENGINE_KW)
    got = port.pileup(clr, feats, device="cpu", **ENGINE_KW)
    compare_tables(got, want, what="engine workload", **ENGINE_TOL)
    assert engine_snips(got) > 100_000


@pytest.mark.parametrize("ref_sweep", ["eager", "lazy"])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_cis_pair_chunks_match_reference(monkeypatch, order, ref_sweep):
    """The port's one chunked pair sweep yields the reference's pair
    sequence and chunk boundaries (they fix the keyed control RNG's draws),
    whichever of its sweeps the reference takes; unsorted centers are swept
    to the end."""
    from coolpuppy_tpu.coords import CoordCreator as RefCoordCreator

    rng = np.random.default_rng(7)
    centers = np.sort(rng.choice(200_000_000, 800, replace=False)).astype(
        float
    )
    feats = pd.DataFrame(
        {"chrom": "chr1", "start": centers - 500, "end": centers + 500}
    )
    kw = dict(features_format="bed", flank=50_000, mindist=150_000,
              maxdist=30_000_000, nshifts=0, chunk_size=4096)
    want_cc = RefCoordCreator(feats, 10_000, **kw)
    got_cc = port.CoordCreator(feats, 10_000, **kw)
    c = want_cc.intervals["center"].values
    if order == "unsorted":
        c = c[rng.permutation(len(c))]
    if ref_sweep == "lazy":
        monkeypatch.setattr(RefCoordCreator, "LAZY_PAIR_THRESHOLD", 0)
    want = list(want_cc._iter_cis_pair_chunks(c))
    got = list(got_cc._iter_cis_pair_chunks(c))
    assert len(got) == len(want) > 1
    for (g1, g2), (w1, w2) in zip(got, want):
        np.testing.assert_array_equal(g1, w1)
        np.testing.assert_array_equal(g2, w2)


def _cc(**kwargs):
    kw = dict(features_format="bed", local=False, flank=2_000_000, mindist=0)
    kw.update(kwargs)
    return port.CoordCreator(toy_features(), 1_000_000, **kw)


def _counts(pup, cols=("orientation",)):
    return list(pup.sort_values(list(cols))["n"].values)


def test_bystrand_counts_with_expected(toy):
    """tests/test_engine.py:34-67 on the port."""
    _, clr, exp = toy
    regions = toy_regions()
    cc = _cc()
    runs = [
        dict(expected=exp, view_df=regions, ooe=True),
        dict(expected=exp, view_df=regions, ooe=False),
        dict(expected=False, ooe=False),
        dict(expected=False, ooe=False, clr_weight_name=None,
             coverage_norm=True),
    ]
    for kw in runs:
        pu = port.PileUpper(clr, cc, device="cpu", **kw)
        assert _counts(pu.pileupsByStrandWithControl()) == [1, 3, 1, 1, 6]
    pu = port.PileUpper(clr, cc, expected=False, ooe=False, control=False,
                        device="cpu")
    pup = pu.pileupsByStrandWithControl(ignore_group_order=True)
    assert not pup[pup["orientation"] == "+-"].empty
    assert pup[pup["orientation"] == "-+"].empty
    assert _counts(pup) == [1, 4, 1, 6]


def test_bystrand_counts_with_controls(toy):
    """tests/test_engine.py:70-76 on the port."""
    _, clr, _ = toy
    pu = port.PileUpper(clr, _cc(seed=0), expected=False,
                        view_df=toy_regions(), control=True, device="cpu")
    assert _counts(pu.pileupsByStrandWithControl()) == [1, 3, 1, 1, 6]


@pytest.mark.parametrize(
    "by_distance", [True, np.append([0], 50000 * 2 ** np.arange(30))]
)
def test_bystrand_bydistance_counts(toy, by_distance):
    """tests/test_engine.py:79-114 on the port."""
    _, clr, _ = toy
    pup = port.pileup(
        clr, toy_features(), features_format="bed", view_df=toy_regions(),
        mindist=0, flank=2_000_000, nshifts=1, by_strand=True,
        by_distance=by_distance, seed=0, device="cpu",
    )
    assert _counts(pup, ("orientation", "distance_band")) == [
        1, 2, 1, 1, 1, 6
    ]
