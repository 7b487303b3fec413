"""Per-bin coverage (marginals), copied from ``coolpuppy_tpu/coverage.py``;
replaces the cooltools.api.coverage call at reference coolpup.py:955–963.

cov_cis_raw[i] = sum of raw counts of cis pixels in row i of the full
symmetric matrix (diagonal counted once), excluding the first ``ignore_diags``
diagonals; cov_tot_raw additionally includes trans pixels. Streamed over pixel
chunks with vectorized bincounts.
"""

from __future__ import annotations

import numpy as np


def coverage(clr, ignore_diags=2, chunksize=10_000_000, store=False):
    n = clr.n_bins
    # bin -> chrom id for cis detection
    offsets = np.array(
        [clr.offset(c) for c in clr.chromnames] + [n], dtype=np.int64
    )
    cov_cis = np.zeros(n)
    cov_tot = np.zeros(n)
    for start in range(0, clr.n_pixels, chunksize):
        b1, b2, c = clr.pixels_chunk(start, min(start + chunksize, clr.n_pixels))
        chrom1 = np.searchsorted(offsets, b1, side="right") - 1
        chrom2 = np.searchsorted(offsets, b2, side="right") - 1
        cis = chrom1 == chrom2
        keep = ~(cis & (np.abs(b1 - b2) < ignore_diags))
        b1k, b2k, ck = b1[keep], b2[keep], c[keep]
        cisk = cis[keep]
        offdiag = b1k != b2k
        cov_tot += np.bincount(b1k, weights=ck, minlength=n)
        cov_tot += np.bincount(
            b2k[offdiag], weights=ck[offdiag], minlength=n
        )
        cov_cis += np.bincount(b1k[cisk], weights=ck[cisk], minlength=n)
        cov_cis += np.bincount(
            b2k[cisk & offdiag], weights=ck[cisk & offdiag], minlength=n
        )
    if store:
        clr.store_bin_column("cov_cis_raw", cov_cis)
        clr.store_bin_column("cov_tot_raw", cov_tot)
    return cov_cis, cov_tot
