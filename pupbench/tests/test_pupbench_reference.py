"""The plain reference: against a pileup worked out by hand, and against
the program's plain PyTorch version on tiny copies of every cell."""

import numpy as np
import pandas as pd
import pytest

from conftest import BIG_SEED, CELLS, tiny
from pupbench import compare, harness, reference
from pupbench.gen import contact_map
from pupbench.gen.features import job_seed
from pupbench.reference import coords
from pupbench.reference.pileup import reference_pileup

N, RES = 40, 10_000


def parts(source="bed", groups="all", windows="square"):
    return reference.parts(dict(source=source, groups=groups, values="cis",
                                windows=windows, table="groups"))


def hand_map():
    """One chromosome of 40 bins: every pixel with j - i <= 10, count
    1 + (i + j) % 3, weight 1 + i / 100, bin 5 NaN."""
    i, j = np.triu_indices(N)
    keep = j - i <= 10
    i, j = i[keep], j[keep]
    w = 1 + np.arange(N) / 100
    w[5] = np.nan
    return contact_map.ContactMap(
        chroms=["chr1"], bins_per=N, binsize=RES, bin1=i.astype(np.int64),
        bin2=j.astype(np.int64), count=(1 + (i + j) % 3).astype(np.int32),
        weights=w, chrom_pixel_offset=np.array([0, len(i)]))


def hand_value(r, c, evec=None):
    a, b = min(r, c), max(r, c)
    w = 1 + np.arange(N) / 100
    if 5 in (r, c) or abs(r - c) < 2 or b - a > 10:
        return np.nan if (5 in (r, c) or abs(r - c) < 2) else 0.0
    v = (1 + (a + b) % 3) * w[r] * w[c]
    return v / evec[abs(r - c)] if evec is not None else v


def test_one_pair_by_hand():
    """Two sites 80 kb apart (bins 4 and 12), flank 20 kb: one window of
    5 x 5 at rows 2..6, columns 10..14; its data is the window itself."""
    cmap = hand_map()
    feats = pd.DataFrame({"chrom": "chr1", "start": [40_000, 120_000],
                          "end": [41_000, 121_000], "strand": ["+", "-"]})
    kw = {"features_format": "bed", "flank": 20_000}
    rows = reference_pileup(cmap, feats, kw, "cpu", parts())
    want = np.array([[hand_value(r, c) for c in range(10, 15)]
                     for r in range(2, 7)])
    got = rows["all"]
    assert got["n"] == 1
    np.testing.assert_array_equal(got["num"], np.isfinite(want))
    np.testing.assert_allclose(got["data"], want, rtol=1e-12)


def test_local_by_hand_with_expected():
    """Local windows of sites at bins 8 and 20 (flank 20 kb), over an
    expected of 2 + d: the data is the mean of the two windows, with a
    pixel's mean over the windows where it is finite."""
    cmap = hand_map()
    evec = 2.0 + np.arange(N)
    exp = pd.DataFrame({"region1": "chr1", "region2": "chr1",
                        "dist": np.arange(N), "balanced.avg": evec})
    feats = pd.DataFrame({"chrom": "chr1", "start": [80_000, 200_000],
                          "end": [81_000, 201_000]})
    kw = {"features_format": "bed", "flank": 20_000, "local": True}
    rows = reference_pileup(cmap, feats, kw, "cpu", parts(), expected=exp)
    wins = [np.array([[hand_value(r, c, evec) for c in range(s, s + 5)]
                      for r in range(s, s + 5)]) for s in (6, 18)]
    fin = [np.isfinite(w) for w in wins]
    num = fin[0].astype(int) + fin[1]
    with np.errstate(invalid="ignore"):
        mean = (np.nan_to_num(wins[0]) + np.nan_to_num(wins[1])) / num
    got = rows["all"]
    assert got["n"] == 2
    np.testing.assert_array_equal(got["num"], num)
    np.testing.assert_allclose(got["data"], mean, rtol=1e-12)


def test_pairs_and_controls():
    """The superdiagonal order, the distance band and the shifted copies:
    each control is a ROI window moved along the diagonal by a whole
    number of bins within [minshift, maxshift]."""
    c = np.array([0.0, 1.0, 2.5, 10.0])
    li, ri = coords.superdiagonal_pairs(c, 1.0, 3.0)
    assert list(zip(li, ri)) == [(0, 1), (1, 2), (0, 2)]
    feats = pd.DataFrame({"chrom": "chr1",
                          "start": np.arange(5, 200, 9) * RES,
                          "end": np.arange(5, 200, 9) * RES + 1000,
                          "strand": "+"})
    kw = {"features_format": "bed", "flank": 30_000, "maxdist": 600_000,
          "nshifts": 3, "seed": BIG_SEED}
    job = coords.JobSnips(feats, kw, ["chr1"], 400, RES, parts())
    s = job.blocks["chr1", "chr1"]
    roi, ctrl = s.kind == 0, s.kind == 1
    assert roi.sum() and ctrl.sum()
    shift = s.st1[ctrl] - s.st2[ctrl]
    assert set(shift) <= set(s.st1[roi] - s.st2[roi])
    again = coords.JobSnips(feats, kw, ["chr1"], 400, RES,
                            parts()).blocks["chr1", "chr1"]
    np.testing.assert_array_equal(s.st1, again.st1)


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_program_on_tiny_cells(name):
    """The comparison's numbers of the program (plain PyTorch, float32, no
    wire) against the reference on a tiny copy of each cell."""
    cfg, cell = tiny(name)
    c = harness.Cell(name, BIG_SEED, "cpu", cfg, cell)
    table = c.run(c.pool[1], job_seed(BIG_SEED, 1))
    ref = reference_pileup(c.cmap, c.pool[1], c.job_kw(1), "cpu", c.parts,
                           expected=c.expected)
    got = compare.program_rows(table, c.parts)
    nums = compare.compare(got, ref)
    assert nums["rows"] == nums["n_gap"] == nums["num_gap"] == 0
    assert nums["nan_gap"] == 0
    assert nums["data_gap"] < 1e-5
    assert got["all"]["n"] > 0
