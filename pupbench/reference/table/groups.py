"""One row a group, and the ``all`` row over every group: ``data = (sum /
num) / (control sum / control num)`` (``sum`` set to +inf where poisoned),
+inf then NaN, local pileups symmetrized by the NaN-mean of the data and
its transpose; ``n``/``control_n`` the windows in each group. Rows are
keyed by the group ("all", or the orientation under ``by_strand``)."""

import warnings

import numpy as np


def finalize(acc, n, labels, kw):
    nshifts, local = int(kw.get("nshifts", 0)), bool(kw.get("local"))
    G = len(labels)
    groups = {lab: (g, g + G) for g, lab in enumerate(labels)
              if n[g] > 0}
    rows = {}
    keys = list(groups)
    if "all" not in groups and keys:
        keys.append("all")
    for key in keys:
        ids = groups.get(key) or (
            [groups[k][0] for k in groups], [groups[k][1] for k in groups])
        roi, ctrl = (np.atleast_1d(i) for i in ids)
        s = acc["sum"][roi].sum(0)
        num = acc["num"][roi].sum(0)
        s = np.where(acc["poison"][roi].sum(0) > 0, np.inf, s)
        with np.errstate(divide="ignore", invalid="ignore"):
            data = s / num
            row = {"n": int(n[roi].sum()), "num": num}
            if nshifts:
                cs = acc["sum"][ctrl].sum(0)
                cnum = acc["num"][ctrl].sum(0)
                cs = np.where(acc["poison"][ctrl].sum(0) > 0, np.inf, cs)
                data = data / (cs / cnum)
                row["control_n"] = int(n[ctrl].sum())
                row["control_num"] = cnum
        data = np.where(np.isposinf(data), np.nan, data)
        if local:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                data = np.nanmean(np.dstack((data, data.T)), 2)
        row["data"] = data
        rows[key] = row
    return rows


def row_key(row):
    if "orientation" in row:
        return str(row["orientation"])
    g = row["group"]
    return g if isinstance(g, str) else "".join(map(str, g))


def program_rows(table):
    """{row key: row} of the program's table, numpy arrays."""
    out = {}
    for _, row in table.iterrows():
        r = {"n": row["n"], "num": np.asarray(row["num"], float),
             "data": np.asarray(row["data"], float)}
        if "control_n" in row:
            r["control_n"] = row["control_n"]
            r["control_num"] = np.asarray(row["control_num"], float)
        out[row_key(row)] = r
    return out


def snips(table):
    """The job's snips: ROI ``n`` + ``control_n`` of the 'all' row."""
    key = "orientation" if "orientation" in table else "group"
    row = table.loc[table[key] == "all"].iloc[0]
    n = int(row["n"])
    if "control_n" in table.columns and np.isfinite(row["control_n"]):
        n += int(row["control_n"])
    return n
