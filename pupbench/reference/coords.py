"""The snips of a pileup job, from its features and keywords.

The semantics are coolpuppy's, as the program states them: windows of
``2 * flank / res + 1`` bins, at distances of ``mindist`` to ``maxdist``
(``mindist="auto"``: ``2 * flank + 2 * res``), cut into chunks of
``CHUNK`` windows; where they lie is the cell's ``source`` module's
(``reference/source/``), their groups its ``groups`` module's. With
``nshifts``, each chunk adds ``nshifts`` copies shifted along the diagonal
by amounts drawn from a generator keyed by the job's seed and the region
(``region_rng``): the controls. Windows that leave the chromosome are
dropped, controls included.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

CHUNK = 262_144  # pairs a chunk: the control draws are made per chunk


@dataclass
class Snips:
    """The windows of one chromosome: top-left bins (``st1`` rows, ``st2``
    columns), extents (``h``: W for square windows, the rescaled extent
    otherwise), ``kind`` (0 ROI, 1 control) and ``group`` (an index into
    the job's group labels)."""

    st1: np.ndarray
    st2: np.ndarray
    h: np.ndarray
    kind: np.ndarray
    group: np.ndarray

    def __len__(self):
        return len(self.st1)


def region_rng(seed, region):
    """The generator of a region's control shifts: entropy (seed, crc32 of
    "chrom|start|end|none", 0)."""
    chrom, start, end = region
    tag = f"{chrom}|{int(start)}|{int(end)}|none"
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed), zlib.crc32(tag.encode()), 0]))


def superdiagonal_pairs(centers, mindist, maxdist):
    """(left, right) index pairs of sorted ``centers`` whose distance lies
    in [mindist, maxdist], diagonal by diagonal."""
    n = len(centers)
    ls, rs = [], []
    for k in range(1, n):
        li = np.arange(n - k)
        d = centers[li + k] - centers[li]
        if d.min() > maxdist:
            break
        keep = (mindist <= np.abs(d)) & (np.abs(d) <= maxdist)
        ls.append(li[keep])
        rs.append(li[keep] + k)
    if not ls:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(ls), np.concatenate(rs)


def center_bins(start, end, res):
    return (start.astype(np.int64) + end) // (2 * res)


def rescaled_bins(start, end, res, rescale_flank):
    pad = rescale_flank * (end - start).astype(np.float64)
    lo = np.floor(np.round(start - pad) / res).astype(np.int64)
    hi = np.ceil(np.round(end + pad) / res).astype(np.int64)
    return lo, hi - lo


def chunked(size, st1, st2, h, group):
    """The windows as a list of chunks of ``size``."""
    return [(st1[a:a + size], st2[a:a + size], h[a:a + size],
             group[a:a + size]) for a in range(0, len(st1), size)]


class JobSnips:
    """Every window of one job, by block (a pair of chromosomes), and its
    group labels."""

    def __init__(self, features, kw, chroms, bins_per, res, parts):
        self.kw, self.res, self.n = kw, int(res), int(bins_per)
        self.chroms, self.parts = list(chroms), parts
        self.flank_bins = int(kw.get("flank", 100_000)) // self.res
        self.W = 2 * self.flank_bins + 1
        self.rescale = bool(kw.get("rescale", False))
        mindist = kw.get("mindist", "auto")
        self.mindist = (2 * int(kw.get("flank", 100_000)) + 2 * self.res
                        if mindist in (None, "auto") else mindist)
        maxdist = kw.get("maxdist")
        self.maxdist = np.inf if maxdist is None else float(maxdist)
        self.nshifts = int(kw.get("nshifts", 0))
        self.minshift = int(kw.get("minshift", 100_000))
        self.maxshift = int(kw.get("maxshift", 1_000_000))
        self.labels = []
        self.blocks = {}
        for block, region, chunks in parts.source.blocks(self, features):
            self.blocks[block] = self._with_controls(chunks, region)

    def groups(self, left, right):
        """Group indices of windows whose anchors have the columns
        ``left`` and ``right`` ({"strand", "center"}: arrays)."""
        keys = np.asarray(self.parts.groups.keys(self, left, right))
        uniq, inv = np.unique(keys, return_inverse=True)
        first = np.unique(inv, return_index=True)[1]
        ids = np.zeros(len(uniq), np.int64)
        for u in np.argsort(first, kind="stable"):  # labels in window order
            ids[u] = self.label(str(uniq[u]))
        return ids[inv].astype(np.int64)

    def label(self, key):
        if key not in self.labels:
            self.labels.append(key)
        return self.labels.index(key)

    def _with_controls(self, chunks, region):
        rng = region_rng(self.kw.get("seed"), region) if self.nshifts else None
        out = {k: [] for k in ("st1", "st2", "h", "kind", "group")}
        for st1, st2, h, group in chunks:
            n = len(st1)
            parts = [(st1, st2, np.zeros(n, np.int64))]
            if self.nshifts:
                m = n * self.nshifts
                shift = (rng.integers(self.minshift, self.maxshift, m)
                         * rng.choice([-1, 1], m))
                bsh = np.round(shift / self.res).astype(np.int64)
                parts.append((np.tile(st1, self.nshifts) + bsh,
                              np.tile(st2, self.nshifts) + bsh,
                              np.ones(m, np.int64)))
            reps = 1 + (self.nshifts if self.nshifts else 0)
            for a, b, kind in parts:
                out["st1"].append(a)
                out["st2"].append(b)
                out["kind"].append(kind)
            out["h"].append(np.tile(h, reps))
            out["group"].append(np.tile(group, reps))
        if not out["st1"]:
            return Snips(*(np.zeros(0, np.int64) for _ in range(5)))
        arr = {k: np.concatenate(v).astype(np.int64) for k, v in out.items()}
        inb = ((arr["st1"] >= 0) & (arr["st1"] + arr["h"] <= self.n)
               & (arr["st2"] >= 0) & (arr["st2"] + arr["h"] <= self.n))
        return Snips(**{k: v[inb] for k, v in arr.items()})
