"""The comparison that decides ``correct``: a job's table as the program
produced it against the reference's, row by row.

Numbers, each the worst over the job's rows:

- ``rows``: rows present on one side only;
- ``n_gap``: the largest difference in ``n`` or ``control_n``;
- ``num_gap``: the largest difference in a pixel's ``num`` or
  ``control_num`` (counts of finite values);
- ``nan_gap``: pixels of ``data`` NaN on one side only;
- ``data_gap``: the largest ``|data - ref| / max(|ref|, 1e-3 * m)`` over the
  pixels finite on both sides, with ``m`` the row's median ``|ref|``;
- ``data_mean_gap``: the mean of that relative gap over a row's pixels
  finite on both sides, the largest over the rows.

A cell's ``limits`` name the numbers that ``judge`` holds it to.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("rows", "n_gap", "num_gap", "nan_gap", "data_gap",
           "data_mean_gap")


def program_rows(table, parts):
    """{row key: row} of the program's table, numpy arrays, as the cell's
    ``table`` module (``reference/table/``) reads it."""
    return parts.table.program_rows(table)


def compare(got, ref):
    """The numbers of ``got`` (``program_rows``) against ``ref``
    (``reference_pileup``): rows of the same keys and fields."""
    res = dict.fromkeys(NUMBERS, 0.0)
    res["rows"] = float(len(set(got) ^ set(ref)))
    for key in set(got) & set(ref):
        g, r = got[key], ref[key]
        for k in ("n", "control_n"):
            if (k in g) != (k in r):
                res["n_gap"] = np.inf
            elif k in r:
                res["n_gap"] = max(res["n_gap"], abs(float(g[k]) - r[k]))
        for k in ("num", "control_num"):
            if k in r and k in g:
                res["num_gap"] = max(res["num_gap"], float(
                    np.abs(g[k] - r[k]).max(initial=0.0)))
        gd, rd = g["data"], r["data"]
        if gd.shape != rd.shape:
            res["nan_gap"] = np.inf
            continue
        gn, rn = np.isnan(gd), np.isnan(rd)
        res["nan_gap"] += float((gn != rn).sum())
        both = ~gn & ~rn
        if both.any():
            m = np.median(np.abs(rd[both]))
            den = np.maximum(np.abs(rd[both]), 1e-3 * m)
            gap = np.abs(gd[both] - rd[both]) / np.where(den > 0, den, 1.0)
            res["data_gap"] = max(res["data_gap"], float(gap.max()))
            res["data_mean_gap"] = max(res["data_mean_gap"],
                                       float(gap.mean()))
    return res


def judge(numbers, limits):
    """(correct, [[name, number, limit], ...]) of the numbers that
    ``limits`` names, in ``NUMBERS`` order."""
    checks = [[k, numbers[k], float(limits[k])] for k in NUMBERS
              if k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in checks)
    return bool(ok), checks


def worst(many):
    """The largest of each number over several jobs' comparisons."""
    return {k: max(m[k] for m in many) for k in NUMBERS}
