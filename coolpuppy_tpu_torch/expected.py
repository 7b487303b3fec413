"""By-distance (cis) and by-region-pair (trans) expected tables (counterpart
of ``coolpuppy_tpu/expected.py``, copied as numpy/pandas).

The reference consumes ``cooltools compute-expected`` output (reference
CLI.py:484–508); this module computes it from the in-memory ``Cooler``: per
view region, balanced pixel sums are bincounted by diagonal in one pass over
the pixels (``Cooler.fetch_coo``), and the per-diagonal valid-pair counts
come from an FFT autocorrelation of the valid-bin mask.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from .genomics.intervals import make_cooler_view, make_viewframe


def _valid_pairs_per_diag(valid):
    """n_valid[d] = sum_i valid[i] * valid[i+d] via FFT autocorrelation."""
    n = len(valid)
    size = 1 << int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(valid.astype(np.float64), size)
    corr = np.fft.irfft(f * np.conj(f), size)[:n]
    return np.round(corr).astype(np.int64)


def expected_cis(
    clr, view_df=None, clr_weight_name="weight", ignore_diags=2,
    expected_value_col="balanced.avg",
):
    """Per-region by-diagonal expected (cooltools expected-cis counterpart).

    Returns columns region1, region2, dist, n_valid, count.sum,
    balanced.sum, <expected_value_col>.
    """
    view_df = (
        make_cooler_view(clr) if view_df is None else make_viewframe(view_df)
    )
    rows = []
    for _, reg in view_df.iterrows():
        region = (reg["chrom"], reg["start"], reg["end"])
        lo, hi = clr.extent(region)
        n = hi - lo
        raw = clr.fetch_coo(region, balance=False)
        if clr_weight_name:
            w = clr.bins_df()[clr_weight_name].values[lo:hi]
            valid = ~np.isnan(w)
            wts = np.nan_to_num(w)
            bal_vals = raw.data * wts[raw.row] * wts[raw.col]
        else:
            valid = np.ones(n, dtype=bool)
            bal_vals = raw.data.astype(np.float64)

        d = raw.col - raw.row
        upper = d >= 0  # count each unordered pair once
        d_u = d[upper]
        count_sum = np.bincount(d_u, weights=raw.data[upper], minlength=n)
        bal_sum = np.bincount(d_u, weights=bal_vals[upper], minlength=n)
        n_valid = _valid_pairs_per_diag(valid.astype(np.float64))

        for dist in range(n):
            nv = int(n_valid[dist])
            bs = bal_sum[dist]
            masked = dist < ignore_diags
            rows.append(
                {
                    "region1": reg["name"],
                    "region2": reg["name"],
                    "dist": dist,
                    "n_valid": nv,
                    "count.sum": count_sum[dist] if not masked else np.nan,
                    "balanced.sum": bs if not masked else np.nan,
                    expected_value_col: (
                        bs / nv if (nv > 0 and not masked) else np.nan
                    ),
                }
            )
    return pd.DataFrame(rows)


def expected_trans(
    clr, view_df=None, clr_weight_name="weight",
    expected_value_col="balanced.avg",
):
    """Per-region-pair scalar expected for trans contacts."""
    view_df = (
        make_cooler_view(clr) if view_df is None else make_viewframe(view_df)
    )
    rows = []
    regions = list(view_df.iterrows())
    for i, (_, r1) in enumerate(regions):
        for _, r2 in regions[i + 1 :]:
            if r1["chrom"] == r2["chrom"]:
                continue
            reg1 = (r1["chrom"], r1["start"], r1["end"])
            reg2 = (r2["chrom"], r2["start"], r2["end"])
            lo1, hi1 = clr.extent(reg1)
            lo2, hi2 = clr.extent(reg2)
            raw = clr.fetch_coo(reg1, reg2, balance=False)
            if clr_weight_name:
                w = clr.bins_df()[clr_weight_name].values
                w1, w2 = w[lo1:hi1], w[lo2:hi2]
                v1, v2 = ~np.isnan(w1), ~np.isnan(w2)
                bal = raw.data * np.nan_to_num(w1)[raw.row] * np.nan_to_num(
                    w2
                )[raw.col]
            else:
                v1 = np.ones(hi1 - lo1, bool)
                v2 = np.ones(hi2 - lo2, bool)
                bal = raw.data.astype(np.float64)
            nv = int(v1.sum()) * int(v2.sum())
            rows.append(
                {
                    "region1": r1["name"],
                    "region2": r2["name"],
                    "n_valid": nv,
                    "count.sum": float(raw.data.sum()),
                    "balanced.sum": float(bal.sum()),
                    expected_value_col: float(bal.sum()) / nv if nv else np.nan,
                }
            )
    return pd.DataFrame(rows)
