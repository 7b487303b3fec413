"""One row a group, and the ``all`` row over every group, in coolpuppy's
order under ``coverage_norm``: each side's window ``sum`` (``+inf`` where
poisoned) is divided by ``outer(cov_start, cov_end) / nanmean(outer)``,
NaN then 0 (``norm_coverage``); then by ``num``; then the ROI by the
control, normalized the same way; +inf then NaN. ``n``/``control_n`` the
windows in each group. Rows are keyed as ``groups`` keys them."""

import numpy as np

from .groups import program_rows, snips  # noqa: F401


def norm_coverage(s, cov_start, cov_end):
    """``s`` over the coverage's outer product scaled to a mean of 1, NaN
    set to 0."""
    cov = np.outer(cov_start, cov_end)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = s / (cov / np.nanmean(cov))
    return np.where(np.isnan(out), 0.0, out)


def side(acc, ix):
    """(sum / coverage / num, num) of the accumulator rows ``ix``."""
    s = acc["sum"][ix].sum(0)
    s = np.where(acc["poison"][ix].sum(0) > 0, np.inf, s)
    s = norm_coverage(s, acc["cov_start"][ix].sum(0),
                      acc["cov_end"][ix].sum(0))
    num = acc["num"][ix].sum(0)
    with np.errstate(divide="ignore", invalid="ignore"):
        return s / num, num


def finalize(acc, n, labels, kw):
    if kw.get("local"):
        raise ValueError("coverage_groups has no local symmetrization")
    nshifts = int(kw.get("nshifts", 0))
    G = len(labels)
    groups = {lab: (g, g + G) for g, lab in enumerate(labels) if n[g] > 0}
    keys = list(groups)
    if "all" not in groups and keys:
        keys.append("all")
    rows = {}
    for key in keys:
        ids = groups.get(key) or (
            [groups[k][0] for k in groups], [groups[k][1] for k in groups])
        roi, ctrl = (np.atleast_1d(i) for i in ids)
        data, num = side(acc, roi)
        row = {"n": int(n[roi].sum()), "num": num}
        if nshifts:
            cdata, cnum = side(acc, ctrl)
            with np.errstate(divide="ignore", invalid="ignore"):
                data = data / cdata
            row["control_n"] = int(n[ctrl].sum())
            row["control_num"] = cnum
        row["data"] = np.where(np.isposinf(data), np.nan, data)
        rows[key] = row
    return rows
