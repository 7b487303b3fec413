"""The ``expected_cis`` table of a map, in plain numpy: per chromosome and
diagonal ``d``, ``balanced.avg`` = the sum of balanced counts on the
diagonal over the number of its pixels whose two bins have a weight
(``n_valid``); NaN on the ``ignore_diags`` first diagonals, as cooltools'
``expected_cis`` leaves them."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd


def valid_pairs(good):
    """n_valid[d] = #{i : good[i] and good[i + d]}, exact (FFT, rounded)."""
    n = len(good)
    size = 1 << int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(good.astype(np.float64), size)
    corr = np.fft.irfft(f * np.conj(f), size)[:n]
    return np.rint(corr).astype(np.int64)


def expected_cis(cmap, ignore_diags=2, threads=8):
    """The table of every chromosome, chromosomes in threads (numpy
    releases the interpreter lock in its gathers and sums)."""
    n = cmap.bins_per

    def one(k):
        b1, b2, cnt = cmap.chrom_pixels(k)
        w = cmap.chrom_weights(k)
        bal = cnt * w[b1] * w[b2]
        total = np.bincount(b2 - b1, weights=np.where(np.isnan(bal), 0.0,
                                                      bal), minlength=n)
        n_valid = valid_pairs(np.isfinite(w))
        with np.errstate(divide="ignore", invalid="ignore"):
            avg = total / n_valid
        avg[:ignore_diags] = np.nan
        return pd.DataFrame({
            "region1": cmap.chroms[k], "region2": cmap.chroms[k],
            "dist": np.arange(n), "n_valid": n_valid, "balanced.sum": total,
            "balanced.avg": avg,
        })

    with ThreadPoolExecutor(threads) as pool:
        frames = list(pool.map(one, range(len(cmap.chroms))))
    return pd.concat(frames, ignore_index=True)


def view(cmap):
    """The view of every chromosome, named after it."""
    return pd.DataFrame({"chrom": cmap.chroms, "start": 0,
                         "end": cmap.bins_per * cmap.binsize,
                         "name": cmap.chroms})
