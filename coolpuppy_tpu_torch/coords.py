"""Vectorized coordinate engine (counterpart of ``coolpuppy_tpu/coords.py``,
copied as pandas/numpy).

``CoordCreator`` yields *batches* of snip coordinates — DataFrames built by
vectorized numpy/pandas ops — which the engine lowers to integer index
arrays, or, where no hook reads a frame, *blocks* (``CoordBlock``): the
same snips as integer arrays with group codes taken once per feature table
(``blocks``). BED pairs are enumerated by the k-th-superdiagonal sweep of the
reference with early termination once a diagonal's smallest pair distance
exceeds ``maxdist``: up to ``LAZY_PAIR_THRESHOLD`` pairs of sorted centers
by the native C++ sweep (``native.enumerate_pairs``) in one go, larger or
unsorted streams by the numpy sweep, vectorized per diagonal. Both yield the
identical pair sequence and chunk boundaries, so the keyed control RNG draws
the same shifts.

It covers BED features (cis, local and trans feature products) and BEDPE
rows (cis and trans). Two departures of the JAX package from upstream
coolpuppy are copied as they are: trans controls shift side 2 by its own
amount, and reversed BEDPE trans rows are swapped into the region-1 frame.
``rescale_flank`` scales every interval by ``2*rescale_flank + 1`` about its
center (rescaled pileups) in place of the fixed ``flank``.
"""

from __future__ import annotations

import contextlib
import math
import warnings
import zlib

import numpy as np
import pandas as pd

from . import native
from .genomics.intervals import (
    expand_intervals,
    expand_intervals_2d,
    natsorted,
)

DEFAULT_BAND_EDGES = np.append([0], 50000 * 2 ** np.arange(30))


def _chrom_as_str_categorical(col):
    """Chromosome column -> categorical with python-str categories in
    LEXICOGRAPHIC order: equivalent to the reference's ``astype(str)``
    (coolpup.py:270, 276) for every downstream consumer, but O(unique)
    instead of O(rows). Distinct values whose str() forms collide (e.g. 1
    and "1") fall back to the elementwise cast."""
    if isinstance(col.dtype, pd.CategoricalDtype):
        cat = col
    else:
        cat = col.astype("category")
    cats = list(cat.cat.categories)
    strcats = [x if isinstance(x, str) else str(x) for x in cats]
    if len(set(strcats)) != len(strcats):
        return col.astype(str).astype("category")
    if strcats != cats:
        cat = cat.cat.rename_categories(strcats)
    if strcats != sorted(strcats):
        cat = cat.cat.reorder_categories(sorted(strcats))
    return cat


def bin_distance_intervals(intervals, band_edges="default"):
    """Annotate a 'distance_band' (lo, hi) tuple per row from 'distance'
    (reference coolpup.py:28–51)."""
    if isinstance(band_edges, str) and band_edges == "default":
        band_edges = DEFAULT_BAND_EDGES
    band_edges = np.asarray(band_edges)
    edge_ids = np.searchsorted(band_edges, intervals["distance"], side="right")
    # band tuples materialized per unique edge only (vs one per row)
    uniq, inv = np.unique(edge_ids, return_inverse=True)
    categories = [tuple(band_edges[i - 1 : i + 1]) for i in uniq]
    intervals["distance_band"] = pd.Categorical.from_codes(
        inv, categories=pd.Index(categories, tupleize_cols=False)
    )
    return intervals


def assign_groups(intervals, groupby=None):
    """Add a 'group' column — 'all' or the tuple of groupby values
    (reference coolpup.py:54–75), stored as a categorical whose tuples are
    built once per unique value combination."""
    if not groupby:
        intervals["group"] = pd.Categorical.from_codes(
            np.zeros(len(intervals), np.int8), categories=["all"]
        )
        return intervals
    codes, uniques = zip(
        *(
            pd.factorize(intervals[col], use_na_sentinel=False)
            for col in groupby
        )
    )
    sizes = [len(u) for u in uniques]
    combined = np.ravel_multi_index([np.asarray(c) for c in codes], sizes)
    ucomb, inv = np.unique(combined, return_inverse=True)
    percol = np.unravel_index(ucomb, sizes)
    categories = [
        tuple(uniques[d][percol[d][i]] for d in range(len(groupby)))
        for i in range(len(ucomb))
    ]
    intervals["group"] = pd.Categorical.from_codes(
        inv, categories=pd.Index(categories, tupleize_cols=False)
    )
    return intervals


def flip_mark_intervals(intervals, flipby, flip_negative_strand):
    """Mark snips to flip: negative strand1, or group order
    ``flipby1 > flipby2`` (reference coolpup.py:118–125)."""
    if flip_negative_strand:
        intervals["flip"] = intervals["strand1"] == "-"
    else:
        intervals["flip"] = intervals[f"{flipby}1"] > intervals[f"{flipby}2"]
    return intervals


def swap_paired_columns_for_flipped(intervals, exclude_bases=()):
    """For rows marked flip=True, swap every paired column base1/base2 (the
    vectorized snip-dict swap of reference coolpup.py:128–147). Bin
    coordinates used for gathering are excluded: the gather uses the
    original orientation plus the flip-bank anti-transpose."""
    flip = intervals["flip"].values.astype(bool)
    if not flip.any():
        return intervals
    cols = set(intervals.columns)
    bases = sorted(
        {
            c[:-1]
            for c in cols
            if c.endswith("1")
            and (c[:-1] + "2") in cols
            and c[:-1] not in exclude_bases
        }
    )
    for base in bases:
        a = intervals[base + "1"].values.copy()
        b = intervals[base + "2"].values.copy()
        av, bv = a.copy(), b.copy()
        av[flip], bv[flip] = b[flip], a[flip]
        intervals[base + "1"] = av
        intervals[base + "2"] = bv
    return intervals


def _codes(col):
    """(codes, uniques) of a frame column. Categorical codes are used
    directly; columns with NaN go through factorize(use_na_sentinel=False)
    so NaN stays a real category (the -1 sentinel would alias another
    code)."""
    if isinstance(col.dtype, pd.CategoricalDtype):
        codes = col.cat.codes.to_numpy()
        if not (codes < 0).any():
            return codes, col.cat.categories
    return pd.factorize(col, use_na_sentinel=False)


# a block's kind codes name these kinds
KINDS = ("ROI", "control")
# columns that control copies shift: groups over them keep the frames
_SHIFTED_BASES = frozenset(
    ("exp_start", "exp_end", "center", "stBin", "endBin"))


class GroupTable:
    """Group code -> group: ``"all"`` without groupby columns, else the
    tuple of the columns' values, each from the column's uniques in the
    raveled code (``np.ravel_multi_index`` over ``sizes``)."""

    def __init__(self, uniques):
        self.uniques = list(uniques)
        self.sizes = [len(u) for u in self.uniques]

    def __len__(self):
        return math.prod(self.sizes)

    def __getitem__(self, code):
        if not self.uniques:
            return "all"
        at = np.unravel_index(int(code), self.sizes)
        return tuple(u[i] for u, i in zip(self.uniques, at))


class CoordBlock:
    """One chunk of snips as integer arrays: the bins of both sides, the
    kind code (0 ROI, 1 control; ``KINDS``), the group code and its
    ``groups`` table (anything with ``len`` and ``[code]``), and ``flip``
    (bool, or None for no flipped snip). ``CoordCreator.blocks`` puts a
    chunk's ROI snips first and their control copies after, as
    ``control_regions`` does."""

    __slots__ = ("stBin1", "endBin1", "stBin2", "endBin2", "kind", "group",
                 "groups", "flip")

    def __init__(self, stBin1, endBin1, stBin2, endBin2, kind, group,
                 groups, flip=None):
        self.stBin1, self.endBin1 = stBin1, endBin1
        self.stBin2, self.endBin2 = stBin2, endBin2
        self.kind, self.group, self.groups = kind, group, groups
        self.flip = flip

    @classmethod
    def from_frame(cls, frame):
        """The block of a coordinate frame, its groups the frame's own."""
        kind, group, groups = frame_codes(frame)
        flip = frame["flip"].to_numpy().astype(bool) if (
            "flip" in frame.columns) else None
        return cls(*(frame[c].to_numpy() for c in ("stBin1", "endBin1",
                                                   "stBin2", "endBin2")),
                   kind, group, groups, flip)


def frame_codes(frame):
    """(kind codes as in ``KINDS``, group codes, group uniques) of a
    frame's 'kind' and 'group' columns."""
    kcode, kuniq = _codes(frame["kind"])
    kmap = np.array([KINDS.index(k) for k in kuniq], np.int8)
    gcode, guniq = _codes(frame["group"])
    return kmap[kcode], gcode, guniq


class CoordCreator:
    """Same constructor surface as the reference CoordCreator
    (reference coolpup.py:151–257), plus ``timers``: the job's
    ``PhaseTimers``, whose span log then holds the detail spans
    ``coords/sweep`` (the cis pair enumeration) and ``coords/frames``
    (``_finalize``: controls, the modify function, groups; on blocks, the
    control copies and group codes)."""

    def __init__(
        self,
        features,
        resolution,
        *,
        features_format="auto",
        flank=100000,
        rescale_flank=None,
        chroms="all",
        minshift=10**5,
        maxshift=10**6,
        nshifts=10,
        mindist="auto",
        maxdist=None,
        local=False,
        subset=0,
        trans=False,
        seed=None,
        chunk_size=262_144,
        timers=None,
    ):
        self.timers = timers
        self.intervals = features.copy()
        self.resolution = int(resolution)
        self.features_format = features_format
        self.flank = flank
        self.rescale_flank = rescale_flank
        self.chroms = chroms
        self.minshift = minshift
        self.maxshift = maxshift
        self.nshifts = nshifts
        self.trans = trans
        self.chunk_size = int(chunk_size)
        if mindist == "auto":
            self.mindist = 2 * self.flank + 2 * self.resolution
        else:
            self.mindist = mindist
            if self.trans:
                warnings.warn("Ignoring mindist when using trans", stacklevel=2)
                self.mindist = 0
        if maxdist is None or maxdist == np.inf:
            self.maxdist = np.inf
        else:
            self.maxdist = maxdist
            if self.trans:
                warnings.warn("Ignoring maxdist when using trans", stacklevel=2)
                self.maxdist = np.inf
        self.local = local
        self.subset = subset
        self.seed = seed
        self.process()

    # -- preprocessing (reference coolpup.py:259–385) ----------------------

    def process(self):
        # group codes of the feature table, per groupby (``_group_codes``)
        self._group_cache = {}
        if self.features_format in (None, "auto"):
            cols = set(self.intervals.columns)
            if {"chrom1", "start1", "end1", "chrom2", "start2",
                    "end2"}.issubset(cols):
                self.kind = "bedpe"
            elif {"chrom", "start", "end"}.issubset(cols):
                self.kind = "bed"
            else:
                raise ValueError(
                    "Can't determine kind of input; name columns "
                    "chrom/start/end (bed) or chrom1/.../end2 (bedpe)"
                )
        else:
            self.kind = self.features_format
        if self.kind not in ("bed", "bedpe"):
            raise ValueError(f"unknown features_format {self.kind!r}")

        if self.subset > 0 and self.subset < len(self.intervals):
            self.intervals = self.intervals.sample(
                self.subset, random_state=self.seed
            )

        if self.kind == "bed":
            if not {"chrom", "start", "end"}.issubset(self.intervals.columns):
                raise ValueError("BED features need chrom/start/end columns")
            self.intervals["chrom"] = _chrom_as_str_categorical(
                self.intervals["chrom"]
            )
            self.intervals["center"] = (
                self.intervals["start"] + self.intervals["end"]
            ) / 2
            self.intervals = expand_intervals(
                self.intervals, self.flank, self.resolution, self.rescale_flank
            )
        else:
            if not {"chrom1", "start1", "end1", "chrom2", "start2",
                    "end2"}.issubset(self.intervals.columns):
                raise ValueError(
                    "BEDPE features need chrom1/start1/end1/chrom2/start2/"
                    "end2 columns"
                )
            for c in ("chrom1", "chrom2"):
                self.intervals[c] = _chrom_as_str_categorical(
                    self.intervals[c]
                )
            # sort while the frame holds only the input columns; the
            # derived columns are row-wise, so sorting first is identical
            self.intervals = self._lex_sorted(
                self.intervals, ["chrom1", "chrom2", "start1", "start2"]
            )
            self.intervals["center1"] = (
                self.intervals["start1"] + self.intervals["end1"]
            ) / 2
            self.intervals["center2"] = (
                self.intervals["start2"] + self.intervals["end2"]
            ) / 2
            self.intervals["distance"] = (
                self.intervals["center2"] - self.intervals["center1"]
            )
            dist = self.intervals["distance"].abs()
            keep = (self.mindist <= dist) & (dist <= self.maxdist)
            if not keep.all():
                self.intervals = self.intervals[keep].reset_index(drop=True)
            self.intervals = expand_intervals_2d(
                self.intervals, self.flank, self.resolution, self.rescale_flank
            )

        if self.intervals.shape[0] == 0:
            warnings.warn(
                "No regions in features (maybe all below mindist?), "
                "returning empty output",
                stacklevel=2,
            )
            self.final_chroms = []
            self.empty = True
            return
        self.empty = False

        if self.kind == "bed":
            basechroms = set(self.intervals["chrom"].unique())
        else:
            if self.local:
                raise ValueError(
                    "Can't make local with both sides of loops defined"
                )
            if self.trans:
                basechroms = set(self.intervals["chrom1"].unique()) | set(
                    self.intervals["chrom2"].unique()
                )
            else:
                basechroms = set(self.intervals["chrom1"].unique()) & set(
                    self.intervals["chrom2"].unique()
                )
        self.basechroms = natsorted(basechroms)
        if self.chroms == "all":
            self.final_chroms = natsorted(basechroms)
        else:
            self.final_chroms = natsorted(set(self.chroms) & set(self.basechroms))
        if len(self.final_chroms) == 0:
            raise ValueError(
                "No chromosomes are in common between the coordinate "
                "file and the cooler file"
            )
        if self.trans and self.local:
            raise ValueError("Cannot do local with trans=True")

        self.intervals = self._binnify(self.intervals)
        if self.kind == "bed":
            # integer anchor id for by-window grouping; DUPLICATE intervals
            # share one id, so by-window merges them into one window group
            key = (
                self.intervals["chrom"].astype(str)
                + ":"
                + self.intervals["start"].astype(str)
                + "-"
                + self.intervals["end"].astype(str)
            )
            codes, _ = pd.factorize(key)
            self.intervals = self.intervals.assign(
                anchor_idx=codes.astype(np.int64)
            )

    def bedpe2bed(self, df, ends=True, how="center"):
        """Collapse BEDPE rows to BED (reference coolpup.py:463–487):
        ``ends=True`` stacks both anchors, sorted; otherwise one interval a
        pair, from the anchors' centers (``how="center"``), their outer
        (``"outer"``) or inner (``"inner"``) coordinates."""
        if ends:
            df1 = df[["chrom1", "start1", "end1"]].copy()
            df1.columns = ["chrom", "start", "end"]
            df2 = df[["chrom2", "start2", "end2"]].copy()
            df2.columns = ["chrom", "start", "end"]
            return (
                pd.concat([df1, df2])
                .sort_values(["chrom", "start", "end"])
                .reset_index(drop=True)
            )
        df = df.copy()
        if how == "center":
            df["chrom"] = df["chrom1"]
            df["start"] = ((df["start1"] + df["end1"]) // 2).astype(int)
            df["end"] = ((df["start2"] + df["end2"]) // 2).astype(int)
        elif how == "outer":
            df = df[["chrom1", "start1", "end2"]]
            df.columns = ["chrom", "start", "end"]
        elif how == "inner":
            df = df[["chrom1", "end1", "start2"]]
            df.columns = ["chrom", "start", "end"]
        return df[["chrom", "start", "end"]]

    @staticmethod
    def _lex_sorted(intervals, cols):
        """sort_values(cols) via raw arrays: an O(n) already-sorted check
        first, else np.lexsort + one positional take. Categorical chroms
        sort by category code."""
        keys = []
        for c in cols:
            col = intervals[c]
            if isinstance(col.dtype, pd.CategoricalDtype):
                keys.append(col.cat.codes.to_numpy())
            else:
                keys.append(col.to_numpy())
        n = len(intervals)
        if n <= 1:
            return intervals.reset_index(drop=True)
        # lexicographically sorted iff at each boundary the first
        # non-tied key increases
        tie = np.ones(n - 1, bool)
        unsorted = False
        for k in keys:
            a, b = k[:-1], k[1:]
            if not tie.any():
                break
            if ((a > b) & tie).any():
                unsorted = True
                break
            tie &= a == b
        if not unsorted:
            return intervals.reset_index(drop=True)
        order = np.lexsort(tuple(reversed(keys)))
        return intervals.take(order).reset_index(drop=True)

    def _binnify(self, intervals):
        """Snap expanded intervals to the bin grid (reference
        coolpup.py:489–527)."""
        res = self.resolution

        def _floor_div(col):
            a = col.to_numpy()
            if a.dtype.kind in "iu":  # int // == floor for any sign
                return a.astype(np.int64) // res
            return np.floor(a / res).astype(int)

        def _ceil_div(col):
            a = col.to_numpy()
            if a.dtype.kind in "iu":
                return -((-a.astype(np.int64)) // res)
            return np.ceil(a / res).astype(int)

        if self.kind == "bed":
            intervals = self._lex_sorted(intervals, ["chrom", "start"])
            intervals["stBin"] = _floor_div(intervals["exp_start"])
            intervals["endBin"] = _ceil_div(intervals["exp_end"])
            intervals["exp_start"] = intervals["stBin"] * res
            intervals["exp_end"] = intervals["endBin"] * res
            return intervals
        intervals = self._lex_sorted(
            intervals, ["chrom1", "chrom2", "start1", "start2"]
        )
        for side in ("1", "2"):
            intervals[f"stBin{side}"] = _floor_div(intervals[f"exp_start{side}"])
            intervals[f"endBin{side}"] = _ceil_div(intervals[f"exp_end{side}"])
            intervals[f"exp_start{side}"] = intervals[f"stBin{side}"] * res
            intervals[f"exp_end{side}"] = intervals[f"endBin{side}"] * res
        return intervals

    # -- control shifts (reference coolpup.py:387–453) ---------------------

    def _rng(self, region_tag, salt=0):
        """Deterministic RNG keyed by (seed, region, salt) — the same keys as
        the JAX package, so both draw identical control shifts."""
        def _norm(tag):
            if tag is None:
                return "none"
            if isinstance(tag, (tuple, list)):
                return "|".join(_norm(t) for t in tag)
            if isinstance(tag, (int, np.integer)):
                return str(int(tag))
            return str(tag)

        if self.seed is None:
            return np.random.default_rng()
        entropy = [
            int(self.seed),
            zlib.crc32(_norm(region_tag).encode()),
            int(salt),
        ]
        return np.random.default_rng(np.random.SeedSequence(entropy))

    def _draw_shifts(self, n_ctrl, rng):
        """Signed bp shifts of ``n_ctrl`` control copies: side 1's, and
        side 2's (its own draw under trans, else side 1's). Frames and
        blocks draw them in these calls, in this order, per chunk."""
        shift = rng.integers(self.minshift, self.maxshift, n_ctrl) * rng.choice(
            [-1, 1], n_ctrl
        )
        if self.trans:
            shift2 = rng.integers(
                self.minshift, self.maxshift, n_ctrl
            ) * rng.choice([-1, 1], n_ctrl)
        else:
            shift2 = shift
        return shift, shift2

    def control_regions(self, intervals2d, nshifts=0, rng=None):
        """Tag ROI rows; append nshifts shifted control copies. Cis controls
        shift both anchors by one signed bp amount; trans controls draw a
        second amount for side 2 from the same RNG (reference
        coolpup.py:387–453, as the JAX package departs from it: upstream
        shifts side 2's bins by side 1's amount)."""
        res = self.resolution
        if nshifts <= 0:
            # shallow copy: only a column is ADDED; downstream hooks must
            # assign whole columns, never mutate cells in place
            intervals2d = intervals2d.copy(deep=False)
            intervals2d["kind"] = pd.Categorical.from_codes(
                np.zeros(len(intervals2d), np.int8),
                categories=["ROI", "control"],
            )
            return intervals2d
        if rng is None:
            rng = self._rng("anon")
        # ROI + nshifts control copies in ONE positional take per column
        n = len(intervals2d)
        n_ctrl = n * nshifts
        reps = np.concatenate([np.arange(n), np.tile(np.arange(n), nshifts)])
        shift, shift2 = self._draw_shifts(n_ctrl, rng)
        pad = np.zeros(n)
        sh1 = np.concatenate([pad, shift])
        sh2 = np.concatenate([pad, shift2])
        bsh1 = np.concatenate(
            [pad.astype(int), np.round(shift / res).astype(int)]
        )
        bsh2 = np.concatenate(
            [pad.astype(int), np.round(shift2 / res).astype(int)]
        )
        shifted = {
            "exp_start1": sh1, "exp_end1": sh1, "center1": sh1,
            "exp_start2": sh2, "exp_end2": sh2, "center2": sh2,
            "stBin1": bsh1, "endBin1": bsh1,
            "stBin2": bsh2, "endBin2": bsh2,
        }
        data = {}
        for c in intervals2d.columns:
            col = intervals2d[c]
            if c in shifted:
                data[c] = np.asarray(col).take(reps) + shifted[c]
            elif isinstance(col.dtype, np.dtype):
                data[c] = col.to_numpy().take(reps)
            else:
                data[c] = col.array.take(reps)
        data["kind"] = pd.Categorical.from_codes(
            np.repeat(np.array([0, 1], np.int8), [n, n_ctrl]),
            categories=["ROI", "control"],
        )
        return pd.DataFrame(data)

    # -- region filtering (reference coolpup.py:529–596) -------------------

    def _bed_rows(self, region):
        chrom, start, end = region
        iv = self.intervals
        return np.flatnonzero(
            (iv["chrom"] == chrom) & (iv["start"] >= start) & (iv["end"] < end)
        )

    def _bedpe_rows(self, region1, region2):
        """Rows with side 1 in ``region1`` and side 2 in ``region2``."""
        (chrom1, start1, end1), (chrom2, start2, end2) = region1, region2
        iv = self.intervals
        return np.flatnonzero(
            (iv["chrom1"] == chrom1)
            & (iv["chrom2"] == chrom2)
            & (iv["start1"] >= start1)
            & (iv["end1"] < end1)
            & (iv["start2"] >= start2)
            & (iv["end2"] < end2)
        )

    def filter_bed_region(self, region):
        return self.intervals.take(self._bed_rows(region)).reset_index(
            drop=True)

    def filter_bedpe_region(self, region):
        return self.intervals.take(
            self._bedpe_rows(region, region)).reset_index(drop=True)

    def filter_bedpe_trans_pairs(self, region1, region2):
        """Rows joining ``region1`` and ``region2`` either way round;
        reversed rows have their paired columns swapped so side 1 always
        lies in region 1 (the reference concatenates them unswapped,
        coolpup.py:565–587; the JAX package swaps, and so does the port)."""
        iv = self.intervals
        fwd = iv.take(self._bedpe_rows(region1, region2)).reset_index(
            drop=True)
        rev = iv.take(self._bedpe_rows(region2, region1)).reset_index(
            drop=True)
        if len(rev):
            cols = set(rev.columns)
            mapping = {}
            for c in cols:
                if c.endswith("1") and (c[:-1] + "2") in cols:
                    mapping[c] = c[:-1] + "2"
                    mapping[c[:-1] + "2"] = c
            rev = rev.rename(columns=mapping)
        return pd.concat([fwd, rev]).reset_index(drop=True)

    # -- batch generation (replaces pos_stream, reference coolpup.py:598–749)

    def batches(
        self,
        region1,
        region2=None,
        control=False,
        groupby=None,
        modify_2Dintervals_func=None,
        columns=None,
    ):
        """Yield vectorized snip DataFrames for a region (cis: ``region2``
        is None or ``region1``) or, under ``trans``, a region pair.

        Each frame carries chrom/start/end/center/exp_*/stBin/endBin for both
        sides plus 'kind', 'group' and any feature annotations; ``columns``
        (suffixed names) limits the feature columns materialized. The union
        of all frames is the reference's pos_stream output
        (coolpup.py:598–746)."""
        groupby = groupby or []
        if self.empty:
            return
        use = self._column_subset(columns)
        if self.kind == "bedpe":
            yield from self._batches_bedpe(
                region1, region2, control, groupby,
                modify_2Dintervals_func, use,
            )
        elif self.local:
            yield from self._batches_local(
                region1, control, groupby, modify_2Dintervals_func, use
            )
        elif self.trans:
            yield from self._batches_trans_bed(
                region1, region2, control, groupby,
                modify_2Dintervals_func, use,
            )
        else:
            yield from self._batches_cis_bed(
                region1, control, groupby, modify_2Dintervals_func, use
            )

    def _column_subset(self, columns):
        """Resolve a suffixed-column hint to the BASE interval columns each
        side must materialize; None -> all columns."""
        if columns is None:
            return None
        if self.kind == "bedpe":
            # bedpe rows carry suffixed columns already; 'distance' is a
            # stored column here (by-distance grouping reads it)
            base = {c for c in columns if c in self.intervals.columns}
            base |= {"stBin1", "endBin1", "stBin2", "endBin2", "distance"}
            return [c for c in self.intervals.columns if c in base]
        base = {
            c[:-1]
            for c in columns
            if c and c[-1] in "12" and c[:-1] in self.intervals.columns
        }
        base |= {"stBin", "endBin"}
        return [c for c in self.intervals.columns if c in base]

    def _detail(self, name):
        timers = self.timers
        return timers.detail(name) if timers else contextlib.nullcontext()

    def _finalize(self, frame, control, groupby, modify_func, rng):
        with self._detail("coords/frames"):
            frame = self.control_regions(frame, self.nshifts if control else 0,
                                         rng=rng)
            if modify_func is not None:
                frame = modify_func(frame)
            return assign_groups(frame, groupby)

    def _batches_bedpe(self, region1, region2, control, groupby,
                       modify_func, use=None):
        if self.trans and region2 is not None and region1[0] != region2[0]:
            iv = self.filter_bedpe_trans_pairs(region1, region2)
        else:
            iv = self.filter_bedpe_region(region1)
        if use is not None:
            iv = iv[use]
        rng = self._rng((region1, region2))
        for lo in range(0, len(iv), self.chunk_size):
            yield self._finalize(
                iv.iloc[lo : lo + self.chunk_size].reset_index(drop=True),
                control, groupby, modify_func, rng,
            )

    def _batches_trans_bed(self, region1, region2, control, groupby,
                           modify_func, use=None):
        """The full product of region 1's and region 2's features, chunked
        over the left side, from raw-array takes of repeat/tile indices."""
        left = self.filter_bed_region(region1)
        right = self.filter_bed_region(region2)
        if len(left) == 0 or len(right) == 0:
            return
        rng = self._rng((region1, region2))
        nr = len(right)
        rows_per_chunk = max(1, self.chunk_size // nr)
        cols = list(left.columns) if use is None else use

        def raw(df):
            return {
                c: (
                    df[c].to_numpy()
                    if isinstance(df[c].dtype, np.dtype)
                    else df[c].array
                )
                for c in cols
            }

        larrs, rarrs = raw(left), raw(right)
        for lo in range(0, len(left), rows_per_chunk):
            nl = min(lo + rows_per_chunk, len(left)) - lo
            li = np.repeat(np.arange(lo, lo + nl), nr)
            ri = np.tile(np.arange(nr), nl)
            data = {c + "1": larrs[c].take(li) for c in cols}
            data.update({c + "2": rarrs[c].take(ri) for c in cols})
            yield self._finalize(
                pd.DataFrame(data), control, groupby, modify_func, rng
            )

    def _batches_local(self, region1, control, groupby, modify_func,
                       use=None):
        iv = self.filter_bed_region(region1)
        if len(iv) == 0:
            return
        if use is not None:
            iv = iv[use]
        merged = pd.merge(
            iv, iv, left_index=True, right_index=True, suffixes=["1", "2"]
        )
        rng = self._rng((region1, None))
        for lo in range(0, len(merged), self.chunk_size):
            yield self._finalize(
                merged.iloc[lo : lo + self.chunk_size].reset_index(drop=True),
                control,
                groupby,
                modify_func,
                rng,
            )

    # pairs of sorted centers up to this many come from the native sweep in
    # one go; past it the numpy sweep streams them per diagonal in bounded
    # memory (eager index arrays would hold GBs)
    LAZY_PAIR_THRESHOLD = 32_000_000

    def _count_cis_pairs(self, centers):
        """Exact in-band pair count for SORTED centers, O(n log n)."""
        n = len(centers)
        maxd = float(self.maxdist) if np.isfinite(self.maxdist) else np.inf
        idx = np.arange(n)
        if np.isfinite(maxd):
            hi = np.searchsorted(centers, centers + maxd, side="right")
        else:
            hi = np.full(n, n)
        lo = np.searchsorted(centers, centers + float(self.mindist),
                             side="left")
        return int(np.maximum(hi - np.maximum(lo, idx + 1), 0).sum())

    def _iter_cis_pair_chunks(self, centers):
        """Yield (li, ri) pair-index chunks of exactly ``chunk_size`` (last
        partial): all pairs with |center[ri]-center[li]| in the distance
        band, in the canonical k-superdiagonal order. Small streams come
        from the eager enumeration (``_enumerate_cis_pairs``); large ones
        are swept lazily per diagonal with bounded memory, stopped early on
        sorted centers. Both give the identical sequence and chunk
        boundaries, which fix the keyed control RNG's draws (made per
        chunk)."""
        n = len(centers)
        centers_sorted = bool(np.all(np.diff(centers) >= 0))
        if (
            not centers_sorted
            or self._count_cis_pairs(centers) <= self.LAZY_PAIR_THRESHOLD
        ):
            li, ri = self._enumerate_cis_pairs(centers)
            for lo in range(0, len(li), self.chunk_size):
                yield (
                    li[lo : lo + self.chunk_size],
                    ri[lo : lo + self.chunk_size],
                )
            return
        maxd = float(self.maxdist) if np.isfinite(self.maxdist) else 1e300
        buf_l, buf_r, buffered = [], [], 0
        for k in range(1, n):
            li = np.arange(0, n - k)
            d = centers[li + k] - centers[li]
            if d.min() > maxd:
                break
            keep = (self.mindist <= np.abs(d)) & (np.abs(d) <= maxd)
            if keep.any():
                buf_l.append(li[keep])
                buf_r.append(li[keep] + k)
                buffered += int(keep.sum())
            while buffered >= self.chunk_size:
                ls = np.concatenate(buf_l)
                rs = np.concatenate(buf_r)
                yield ls[: self.chunk_size], rs[: self.chunk_size]
                buf_l = [ls[self.chunk_size :]]
                buf_r = [rs[self.chunk_size :]]
                buffered = len(buf_l[0])
        if buffered:
            yield np.concatenate(buf_l), np.concatenate(buf_r)

    def _enumerate_cis_pairs(self, centers):
        """All (li, ri) index pairs with |center[ri]-center[li]| in the
        distance band, in k-superdiagonal order: the native C++ sweep for
        sorted centers (it stops once a diagonal's least distance passes
        ``maxdist``), the numpy sweep over every diagonal for unsorted
        ones. Both produce the identical pair sequence."""
        n = len(centers)
        centers_sorted = bool(np.all(np.diff(centers) >= 0))
        maxd = float(self.maxdist) if np.isfinite(self.maxdist) else 1e300
        if centers_sorted:
            return native.enumerate_pairs(
                np.asarray(centers, np.float64), float(self.mindist), maxd
            )
        parts_l, parts_r = [], []
        for k in range(1, n):
            li = np.arange(0, n - k)
            d = centers[li + k] - centers[li]
            keep = (self.mindist <= np.abs(d)) & (np.abs(d) <= maxd)
            if keep.any():
                parts_l.append(li[keep])
                parts_r.append(li[keep] + k)
        if not parts_l:
            empty = np.array([], dtype=np.int64)
            return empty, empty
        return np.concatenate(parts_l), np.concatenate(parts_r)

    def _batches_cis_bed(self, region1, control, groupby, modify_func,
                         use=None):
        iv = self.filter_bed_region(region1)
        n = len(iv)
        if n < 2:
            return
        cols = list(iv.columns) if use is None else use
        centers = iv["center"].values
        rng = self._rng((region1, None))
        # raw-array view per column ONCE (Series.take drags index machinery
        # through every column)
        arrs = {
            c: (
                iv[c].to_numpy()
                if isinstance(iv[c].dtype, np.dtype)
                else iv[c].array
            )
            for c in cols
        }
        pairs = self._iter_cis_pair_chunks(centers)
        while True:
            with self._detail("coords/sweep"):
                got = next(pairs, None)
            if got is None:
                return
            ls, rs = got
            data = {c + "1": arrs[c].take(ls) for c in cols}
            data.update({c + "2": arrs[c].take(rs) for c in cols})
            data["distance"] = centers[rs] - centers[ls]
            combo = pd.DataFrame(data)
            yield self._finalize(combo, control, groupby, modify_func, rng)

    # -- integer blocks: the frames' snips with no DataFrame a chunk -------

    def block_groups(self, groupby=None):
        """The ``GroupTable`` that ``blocks`` codes ``groupby`` with, or
        None where a column is not one a block can code: one the control
        copies shift or that is no feature column (the frames keep such
        runs)."""
        got = self._group_codes(tuple(groupby or ()))
        return None if got is None else got[0]

    def _factorized(self, *cols):
        """(codes, uniques) of feature columns factorized together over the
        feature table, NaN a category of its own; a pair's codes share one
        space (side 1's rows first)."""
        iv = self.intervals
        col = (iv[cols[0]] if len(cols) == 1 else
               pd.concat([iv[c] for c in cols], ignore_index=True))
        codes, uniques = pd.factorize(col, use_na_sentinel=False)
        return codes.astype(np.int64).reshape(len(cols), len(iv)), uniques

    def _group_codes(self, groupby):
        """``(table, side1, side2)`` for ``groupby``, once per feature table:
        per feature row, side 1's and side 2's terms of the raveled group
        code. BED: a column ``<base>1``/``<base>2`` takes the base column of
        the side's feature, and a snip's code is ``side1[i1] + side2[i2]``.
        BEDPE: the row's columns; ``side1`` codes a row as it stands,
        ``side2`` a reversed trans row, whose paired columns are swapped.
        None where a column cannot be coded (``block_groups``)."""
        if groupby in self._group_cache:
            return self._group_cache[groupby]
        iv = self.intervals
        n = len(iv)
        terms = []  # ((side1's codes, side2's codes), uniques); None: no term
        for c in groupby:
            base = c[:-1]
            if self.kind == "bed":
                if (c[-1:] not in ("1", "2") or base not in iv.columns
                        or base in _SHIFTED_BASES):
                    terms = None
                    break
                codes, uniques = self._factorized(base)
                sides = (codes[0], None) if c[-1] == "1" else (None, codes[0])
                terms.append((sides, uniques))
                continue
            if (c not in iv.columns or base in _SHIFTED_BASES
                    or c in ("kind", "group", "flip")):
                terms = None
                break
            partner = {"1": base + "2", "2": base + "1"}.get(c[-1:])
            if self.trans and partner in iv.columns:
                codes, uniques = self._factorized(c, partner)
                terms.append(((codes[0], codes[1]), uniques))
            else:
                codes, uniques = self._factorized(c)
                terms.append(((codes[0], codes[0]), uniques))
        got = None
        if terms is not None:
            table = GroupTable(u for _, u in terms)
            if math.prod(table.sizes) <= 2**62:
                strides = [math.prod(table.sizes[d + 1:])
                           for d in range(len(terms))]
                side1 = np.zeros(n, np.int64)
                side2 = np.zeros(n, np.int64)
                for ((a, b), _), stride in zip(terms, strides):
                    if a is not None:
                        side1 += a * stride
                    if b is not None:
                        side2 += b * stride
                got = table, side1, side2
        self._group_cache[groupby] = got
        return got

    def blocks(self, region1, region2=None, control=False, groupby=None):
        """Yield ``CoordBlock``s of a region (pair): the snips of
        ``batches`` without a modify function, chunk for chunk, with the
        same control shifts (``_draw_shifts``, in the same calls per
        chunk), group codes taken from the feature table
        (``_group_codes``). Raises where ``block_groups(groupby)`` is
        None."""
        if self.empty:
            return
        got = self._group_codes(tuple(groupby or ()))
        if got is None:
            raise ValueError(f"groupby {groupby!r} needs the frames "
                             "(CoordCreator.batches)")
        table, side1, side2 = got
        nshifts = self.nshifts if control else 0
        iv = self.intervals
        if self.kind == "bedpe":
            if (self.trans and region2 is not None
                    and region1[0] != region2[0]):
                fwd = self._bedpe_rows(region1, region2)
                rev = self._bedpe_rows(region2, region1)
                rows = np.concatenate([fwd, rev])
                swap = np.arange(len(rows)) >= len(fwd)
            else:
                rows = self._bedpe_rows(region1, region1)
                swap = np.zeros(len(rows), bool)
            cols = [iv[c].to_numpy() for c in ("stBin1", "endBin1", "stBin2",
                                               "endBin2")]
            rng = self._rng((region1, region2))
            for lo in range(0, len(rows), self.chunk_size):
                r = rows[lo : lo + self.chunk_size]
                sw = swap[lo : lo + self.chunk_size]
                s1, e1, s2, e2 = (c[r] for c in cols)
                g = side1[r]
                if sw.any():
                    s1, s2 = np.where(sw, s2, s1), np.where(sw, s1, s2)
                    e1, e2 = np.where(sw, e2, e1), np.where(sw, e1, e2)
                    g = np.where(sw, side2[r], g)
                yield self._block(s1, e1, s2, e2, g, nshifts, rng, table)
            return
        st, en = iv["stBin"].to_numpy(), iv["endBin"].to_numpy()
        rows = self._bed_rows(region1)
        if self.local:
            rng = self._rng((region1, None))
            for lo in range(0, len(rows), self.chunk_size):
                r = rows[lo : lo + self.chunk_size]
                yield self._block(st[r], en[r], st[r], en[r],
                                  side1[r] + side2[r], nshifts, rng, table)
            return
        if self.trans:
            right = self._bed_rows(region2)
            if len(rows) == 0 or len(right) == 0:
                return
            rng = self._rng((region1, region2))
            nr = len(right)
            rows_per_chunk = max(1, self.chunk_size // nr)
            for lo in range(0, len(rows), rows_per_chunk):
                i1 = np.repeat(rows[lo : lo + rows_per_chunk], nr)
                i2 = np.tile(right, len(i1) // nr)
                yield self._block(st[i1], en[i1], st[i2], en[i2],
                                  side1[i1] + side2[i2], nshifts, rng, table)
            return
        if len(rows) < 2:
            return
        rng = self._rng((region1, None))
        pairs = self._iter_cis_pair_chunks(iv["center"].to_numpy()[rows])
        while True:
            with self._detail("coords/sweep"):
                got = next(pairs, None)
            if got is None:
                return
            i1, i2 = rows[got[0]], rows[got[1]]
            yield self._block(st[i1], en[i1], st[i2], en[i2],
                              side1[i1] + side2[i2], nshifts, rng, table)

    def _block(self, s1, e1, s2, e2, group, nshifts, rng, table):
        """The block of a chunk's ROI snips and, with ``nshifts``, their
        control copies after them: copy k of snip i at ``k * n + i``,
        shifted by ``round(shift / resolution)`` bins."""
        with self._detail("coords/frames"):
            n = len(s1)
            if nshifts <= 0:
                return CoordBlock(s1, e1, s2, e2, np.zeros(n, np.int8),
                                  group, table)
            shift, shift2 = self._draw_shifts(n * nshifts, rng)
            b1 = np.round(shift / self.resolution).astype(np.int64)
            b2 = (b1 if shift2 is shift else
                  np.round(shift2 / self.resolution).astype(np.int64))

            def copies(a, b):
                out = np.tile(a, nshifts + 1)
                out[n:] += b
                return out

            kind = np.ones(n * (nshifts + 1), np.int8)
            kind[:n] = 0
            return CoordBlock(copies(s1, b1), copies(e1, b1),
                              copies(s2, b2), copies(e2, b2), kind,
                              np.tile(group, nshifts + 1), table)
