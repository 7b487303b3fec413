"""The feature pools and the map are made from (seed, job) alone."""

import numpy as np
import pandas as pd
import pytest

from conftest import BIG_SEED, CELLS, tiny
from pupbench.gen import contact_map, features


@pytest.mark.parametrize("name", CELLS)
def test_pool_reproducible(name):
    cfg, cell = tiny(name)
    a = features.Pool(cfg, cell, BIG_SEED, 3)
    b = features.Pool(cfg, cell, BIG_SEED, 1)
    for j in range(4):  # job 3 lies past the first pool: drawn on demand
        pd.testing.assert_frame_equal(a[j], b[j])
    assert not a[0].equals(a[1])
    assert len(a[0]) == len(a[1]) == len(a[3])
    assert features.job_seed(BIG_SEED, 2) == features.job_seed(BIG_SEED, 2)
    assert features.job_seed(BIG_SEED, 2) != features.job_seed(BIG_SEED, 3)
    assert not a.warmup().equals(a[0])


def test_sites_and_domains_sizes():
    cfg, cell = tiny("ctcf_sites_10kb.pairs_by_strand")
    f = features.job_features(cfg, cell, 7, 0)
    assert (f.groupby("chrom").size() == 40).all()
    assert set(f["strand"]) == {"+", "-"}
    assert (f["end"] - f["start"] == 1000).all()
    cfg, cell = tiny("tads_10kb.local_rescale")
    f = features.job_features(cfg, cell, 7, 0)
    assert list(f.groupby("chrom").size()) == [13, 12, 12]  # 37 in all
    w = (f["end"] - f["start"]) // 10_000
    assert w.min() >= 4 and w.max() <= 60
    cfg, cell = tiny("tads_10kb.corners_expected")
    f = features.job_features(cfg, cell, 7, 0)
    assert list(f.columns) == ["chrom1", "start1", "end1", "chrom2",
                               "start2", "end2"]
    assert (f["end1"] - f["start1"] == 10_000).all()


def test_domain_widths_follow_the_configuration():
    """The log-normal's quantiles about the median, clipped to the range,
    the same set on every chromosome of every job, in another order."""
    cfg = {"median_width_bp": 185_000, "width_log_sigma": 0.72,
           "min_width_bp": 40_000, "max_width_bp": 3_000_000}
    from pupbench.gen.kinds import domains
    w = domains.widths(cfg, 2001, 10_000)
    assert w.min() == 4 and w.max() <= 300 and np.median(w) == 18
    q1, q3 = np.log(w[500]), np.log(w[1500])
    assert abs((q3 - q1) / 1.349 - 0.72) < 0.04
    start = np.zeros(147, np.int64)
    a, _ = domains.draw(cfg, start, 10_000, np.random.default_rng(1))
    b, _ = domains.draw(cfg, start, 10_000, np.random.default_rng(2))
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(np.sort(a), np.sort(b))


def test_a_new_kind_and_form_are_found_by_name(monkeypatch):
    """A kind and a form are modules of their own: adding one edits no
    file of the generator."""
    import sys
    import types

    kind = types.ModuleType("pupbench.gen.kinds.points")
    kind.draw = lambda cfg, start, res, rng: (start + 1, {"score": 1.0})
    form = types.ModuleType("pupbench.gen.forms.scored")
    form.form = lambda frame, binsize: frame.assign(score=frame["score"] * 2)
    monkeypatch.setitem(sys.modules, kind.__name__, kind)
    monkeypatch.setitem(sys.modules, form.__name__, form)
    cfg, cell = tiny("ctcf_sites_10kb.pairs_by_strand")
    cfg["features"] = dict(cfg["features"], kind="points")
    cell = dict(cell, features={"as": "scored"})
    f = features.job_features(cfg, cell, 7, 0)
    assert (f["end"] - f["start"] == 1).all() and (f["score"] == 2.0).all()


def test_map_reproducible_and_sorted():
    cfg, _ = tiny("ctcf_sites_10kb.pairs_by_strand")
    a = contact_map.draw(cfg["map"], BIG_SEED, "cpu")
    b = contact_map.draw(cfg["map"], BIG_SEED, "cpu")
    c = contact_map.draw(cfg["map"], BIG_SEED + 1, "cpu")
    np.testing.assert_array_equal(a.bin1, b.bin1)
    np.testing.assert_array_equal(a.count, b.count)
    np.testing.assert_array_equal(a.weights, b.weights)
    assert not np.array_equal(a.bin2, c.bin2)
    assert len(a.bin1) == 3 * 150_000
    key = a.bin1 * 10**6 + a.bin2
    assert (np.diff(key) >= 0).all() and (a.bin1 <= a.bin2).all()
    n = cfg["map"]["bins_per_chromosome"]
    assert ((a.bin1 // n) == (a.bin2 // n)).all()
    assert 0.01 < np.isnan(a.weights).mean() < 0.06
    assert a.count.min() >= 1
