"""The roofline counts: against a hand count, and unchanged when the same
windows come in another order or another split."""

import itertools

import numpy as np
import pytest

from conftest import BIG_SEED, tiny
from pupbench import reference, roofline
from pupbench.gen.features import job_features, job_seed
from pupbench.reference.coords import JobSnips


def hand_pixels(n, wins, W):
    cells = set()
    for r0, c0 in wins:
        for r, c in itertools.product(range(r0, r0 + W), range(c0, c0 + W)):
            cells.add((min(r, c), max(r, c)))
    return len(cells)


def test_hand_count():
    """Two overlapping 3 x 3 windows off the diagonal (14 pixels) and one
    on it (6 stored pixels of its 9)."""
    w = roofline.Work(20)
    w.add("chr1", [0, 1], [10, 11], 3, [0, 1])
    assert w.pixels() == 9 + 9 - 4
    w.add("chr1", [15], [15], 3, [0])
    assert w.pixels() == 14 + 6
    assert w.snips == 3 and w.ops() == 2 * 3 * 9
    assert w.bytes() == 4 * 20 + 12 * 3 + 8 * 2 * 9
    seconds, by = w.bound_s()
    assert by == "bytes" and seconds == pytest.approx(w.bytes() / 3.35e12)


def test_random_windows_against_hand_count():
    rng = np.random.default_rng(3)
    n, W = 60, 7
    wins = rng.integers(0, n - W + 1, (40, 2))
    w = roofline.Work(n)
    w.add("c", wins[:, 0], wins[:, 1], W, np.zeros(40, int))
    assert w.pixels() == hand_pixels(n, wins, W)


@pytest.mark.parametrize("split", [1, 2, 7])
def test_unchanged_under_another_tiling(split):
    """A job's windows permuted and cut into ``split`` calls a chromosome
    count the same bytes and operations."""
    cfg, cell = tiny("ctcf_sites_10kb.pairs_by_strand")
    kw = dict(cell["pileup"], seed=job_seed(BIG_SEED, 0))
    job = JobSnips(job_features(cfg, cell, BIG_SEED, 0), kw,
                   ["chr1", "chr2", "chr3"], 700, 10_000,
                   reference.parts(cell["reference"]))
    whole = roofline.job_work(job)
    rng = np.random.default_rng(split)
    parts = roofline.Work(700)
    G = len(job.labels)
    for block, s in job.blocks.items():
        order = rng.permutation(len(s))
        for idx in np.array_split(order, split):
            parts.add(block, s.st1[idx], s.st2[idx], 21,
                      (s.kind * G + s.group)[idx])
    assert parts.pixels() == whole.pixels() > 0
    assert parts.bytes() == whole.bytes()
    assert parts.ops() == whole.ops()
