"""Host-side genomic interval algebra (counterpart of
``coolpuppy_tpu/genomics/intervals.py``): natural sort, interval expansion,
viewframes and expected-table checks, copied as pandas/numpy.
"""

from __future__ import annotations

import re

import numpy as np
import pandas as pd

_NAT_RE = re.compile(r"(\d+)")


def natsort_key(s):
    """Natural-order sort key: 'chr2' < 'chr10', like natsort.natsorted."""
    return tuple(
        int(part) if part.isdigit() else part
        for part in _NAT_RE.split(str(s))
    )


def natsorted(seq):
    return sorted(seq, key=natsort_key)


def expand_intervals(intervals, flank, resolution, rescale_flank=None):
    """Pad bed intervals by ``flank`` around the bin of their center
    (reference coolpup.py:78–91). With ``rescale_flank`` set, scale each
    interval by ``2*rescale_flank + 1`` about its center instead
    (bioframe.expand(scale=...) semantics)."""
    # shallow: only NEW exp_* columns are assigned
    intervals = intervals.copy(deep=False)
    if rescale_flank is not None:
        scale = 2 * rescale_flank + 1
        pad = (scale - 1) / 2 * (intervals["end"] - intervals["start"])
        intervals["exp_start"] = np.round(intervals["start"] - pad)
        intervals["exp_end"] = np.round(intervals["end"] + pad)
        return intervals
    s = intervals["start"].to_numpy()
    e = intervals["end"].to_numpy()
    if s.dtype.kind in "iu" and e.dtype.kind in "iu":
        # integer closed form of floor(center/res)*res -/+ flank:
        # floor(((s+e)/2)/res) == (s+e)//(2*res), exact at any coordinate
        fc = (s.astype(np.int64) + e) // (2 * int(resolution))
        intervals["exp_start"] = fc * int(resolution) - int(flank)
        intervals["exp_end"] = (fc + 1) * int(resolution) + int(flank)
    else:
        intervals["exp_start"] = (
            np.floor(intervals["center"] / resolution) * resolution - flank
        )
        intervals["exp_end"] = (
            np.floor(intervals["center"] / resolution + 1) * resolution
            + flank
        )
    return intervals


def expand_intervals_2d(intervals, flank, resolution, rescale_flank=None):
    """2D (bedpe) version of ``expand_intervals``: each side padded around
    the bin of its own center, or scaled about it under ``rescale_flank``
    (reference coolpup.py:94–115)."""
    intervals = intervals.copy(deep=False)  # only adds exp_* columns
    if rescale_flank is not None:
        scale = 2 * rescale_flank + 1
        for side in ("1", "2"):
            st, en = intervals[f"start{side}"], intervals[f"end{side}"]
            pad = (scale - 1) / 2 * (en - st)
            intervals[f"exp_start{side}"] = np.round(st - pad)
            intervals[f"exp_end{side}"] = np.round(en + pad)
        return intervals
    for side in ("1", "2"):
        s = intervals[f"start{side}"].to_numpy()
        e = intervals[f"end{side}"].to_numpy()
        if s.dtype.kind in "iu" and e.dtype.kind in "iu":
            fc = (s.astype(np.int64) + e) // (2 * int(resolution))
            intervals[f"exp_start{side}"] = fc * int(resolution) - int(flank)
            intervals[f"exp_end{side}"] = (
                (fc + 1) * int(resolution) + int(flank)
            )
        else:
            center = intervals[f"center{side}"]
            intervals[f"exp_start{side}"] = (
                np.floor(center / resolution) * resolution - flank
            )
            intervals[f"exp_end{side}"] = (
                np.floor(center / resolution + 1) * resolution + flank
            )
    return intervals


def sort_bedframe(df, view_df=None, cols=("chrom", "start", "end")):
    """Sort a bedframe by view-region order then start
    (bioframe.sort_bedframe as used at reference coolpup.py:1752); chroms
    outside the view sort last."""
    df = df.copy()
    chrom_col, start_col, _ = cols
    if view_df is not None:
        order = {c: i for i, c in enumerate(pd.unique(view_df["chrom"]))}
        key = df[chrom_col].map(lambda c: order.get(c, len(order)))
    else:
        key = df[chrom_col].map(natsort_key)
    df["_sortkey"] = key
    df = df.sort_values(["_sortkey", start_col], kind="stable").drop(
        columns="_sortkey"
    )
    return df.reset_index(drop=True)


def make_viewframe(view_df, check_bounds=None):
    """Normalize a region table into a (chrom, start, end, name) viewframe.

    Accepts 3 or 4+ column DataFrames (bioframe.make_viewframe semantics used
    at reference coolpup.py:860). ``check_bounds`` is a chrom→length mapping.
    """
    view_df = pd.DataFrame(view_df).copy().reset_index(drop=True)
    cols = list(view_df.columns)
    if not {"chrom", "start", "end"}.issubset(cols):
        if len(cols) >= 4:
            view_df = view_df.iloc[:, :4]
            view_df.columns = ["chrom", "start", "end", "name"]
        elif len(cols) == 3:
            view_df.columns = ["chrom", "start", "end"]
        else:
            raise ValueError("view must have at least 3 columns")
    if "name" not in view_df.columns or view_df["name"].isna().any():
        view_df["name"] = [
            f"{c}:{s}-{e}"
            for c, s, e in zip(view_df["chrom"], view_df["start"], view_df["end"])
        ]
    view_df["chrom"] = view_df["chrom"].astype(str)
    view_df["start"] = view_df["start"].astype(np.int64)
    view_df["end"] = view_df["end"].astype(np.int64)
    if view_df["name"].duplicated().any():
        raise ValueError("view region names must be unique")
    if (view_df["start"] < 0).any() or (view_df["end"] <= view_df["start"]).any():
        raise ValueError("invalid region coordinates in view")
    if check_bounds is not None:
        sizes = dict(check_bounds)
        for _, row in view_df.iterrows():
            if row["chrom"] not in sizes:
                raise ValueError(f"region chrom {row['chrom']} not in chromsizes")
            if row["end"] > sizes[row["chrom"]]:
                raise ValueError(
                    f"region {row['name']} exceeds chromosome "
                    f"{row['chrom']} length {sizes[row['chrom']]}"
                )
    return view_df[["chrom", "start", "end", "name"]]


def make_cooler_view(clr):
    """Whole-chromosome view from a cooler (cooltools.lib.common.make_cooler_view
    as used at reference coolpup.py:856–858)."""
    chromsizes = clr.chromsizes
    return pd.DataFrame(
        {
            "chrom": list(chromsizes.keys()),
            "start": 0,
            "end": list(chromsizes.values()),
            "name": list(chromsizes.keys()),
        }
    )


def is_compatible_viewframe(view_df, clr, check_sorting=False, raise_errors=True):
    """Validate a view against a cooler (cooltools.lib.checks counterpart,
    reference coolpup.py:2127–2132)."""
    try:
        view_df = make_viewframe(view_df, check_bounds=clr.chromsizes)
        if check_sorting:
            order = {c: i for i, c in enumerate(clr.chromnames)}
            chrom_idx = view_df["chrom"].map(order)
            if chrom_idx.isna().any():
                raise ValueError("view chrom not in cooler")
            key = list(zip(chrom_idx, view_df["start"]))
            if key != sorted(key):
                raise ValueError("view not sorted by chromosome/start")
    except ValueError:
        if raise_errors:
            raise
        return False
    return True


def is_valid_expected(
    expected_df,
    kind,
    view_df=None,
    verify_cooler=None,
    expected_value_cols=("balanced.avg",),
    raise_errors=True,
):
    """Validate a by-distance (cis) or by-region-pair (trans) expected table
    (cooltools.lib.checks counterpart, reference coolpup.py:873–906)."""
    try:
        required = {"region1", "region2"}
        if kind == "cis":
            required |= {"dist"}
        if not required.issubset(expected_df.columns):
            raise ValueError(
                f"expected must have columns {sorted(required)}"
            )
        for col in expected_value_cols:
            if col not in expected_df.columns:
                raise ValueError(f"expected lacks value column {col}")
        if view_df is not None:
            names = set(make_viewframe(view_df)["name"])
            regions = set(expected_df["region1"]) | set(expected_df["region2"])
            if not regions & names:
                raise ValueError("expected regions do not match view names")
        if kind == "cis" and verify_cooler is not None:
            cis = expected_df[expected_df["region1"] == expected_df["region2"]]
            counts = cis.groupby("region1", observed=True)["dist"].count()
            if view_df is not None:
                vf = make_viewframe(view_df).set_index("name")
                binsize = verify_cooler.binsize
                for name, cnt in counts.items():
                    if name not in vf.index:
                        continue
                    n_bins = int(
                        np.ceil(vf.loc[name, "end"] / binsize)
                        - np.floor(vf.loc[name, "start"] / binsize)
                    )
                    if cnt < n_bins:
                        raise ValueError(
                            f"expected for region {name} covers {cnt} diagonals, "
                            f"region has {n_bins} bins"
                        )
    except ValueError:
        if raise_errors:
            raise
        return False
    return True


def read_chromsizes_table(df_or_path):
    """``{chrom: length}`` of a chromsizes table: a headerless two-column
    TSV path (chrom, length) or a frame with those columns."""
    if isinstance(df_or_path, (str,)):
        df = pd.read_csv(
            df_or_path, sep="\t", header=None, names=["chrom", "length"]
        )
    else:
        df = df_or_path
    return dict(zip(df["chrom"].astype(str), df["length"].astype(np.int64)))
