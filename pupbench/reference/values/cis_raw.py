"""Window values of one chromosome of an unbalanced map: pixel (r, c) holds
the raw count (the map is symmetric: the upper-triangle pixels mirrored,
duplicates summed), NaN where ``|r - c| < min_diag``; no weights, no
expected.

The values carry ``cov``, the chromosome's total coverage as coolpuppy's
``coverage_norm=True`` reads it (cooltools' ``cov_tot_raw`` with
``ignore_diags = min_diag``): each bin's row sum of the symmetric raw map
without the diagonals ``|r - c| < min_diag``, the diagonal counted once,
worked out again from the map's own arrays. The benchmark's maps hold cis
pixels alone, so a chromosome's pixels give its total coverage.
``precision`` lowers the window values and the coverage alike."""

import torch

from ..pileup import lower
from .cis import chrom_counts


def coverage(counts, min_diag):
    """Row sums of the symmetric count matrix ``counts`` [n, n] without
    the diagonals ``|r - c| < min_diag``, float64 [n]."""
    cov = counts.sum(1, dtype=torch.float64)
    for d in range(-min_diag + 1, min_diag):
        band = torch.diagonal(counts, d).double()
        lo = max(0, -d)  # the band's first row
        cov[lo:lo + len(band)] -= band
    return cov


class RawValues:
    """Raw window values of one chromosome at given rows and columns, and
    its coverage ``cov``."""

    def __init__(self, counts, min_diag, precision):
        self.counts, self.min_diag = counts, min_diag
        self.precision = precision
        self.device = counts.device
        self.cov = lower(coverage(counts, min_diag), precision)

    def __call__(self, rows, cols):
        """rows [b, H], cols [b, H] -> values [b, H, H], float64."""
        r, c = rows[:, :, None], cols[:, None, :]
        v = self.counts[r, c].double()
        v = torch.where((r - c).abs() < self.min_diag, torch.nan, v)
        return lower(v, self.precision)


def make(cmap, block, kw, expected, precision, device):
    chrom, other = block
    if chrom != other:
        raise ValueError(f"cis values of a trans block {block}")
    if expected is not None:
        raise ValueError("raw values over coverage take no expected table")
    k = cmap.chroms.index(chrom)
    return RawValues(chrom_counts(cmap, k, device),
                     int(kw.get("min_diag", 2)), precision)
