"""Window values of one chromosome: pixel (r, c) holds ``count(r, c) *
w[r] * w[c]`` (the map is symmetric: the upper-triangle pixels mirrored,
duplicates summed), NaN where a weight is NaN or ``|r - c| < min_diag``,
divided by ``expected[|r - c|]`` where the job has an expected table."""

import torch

from ..pileup import lower


def chrom_counts(cmap, k, device):
    """The chromosome's symmetric count matrix [n, n], float32 (integer
    sums below 2^24 are exact)."""
    b1, b2, cnt = cmap.chrom_pixels(k)
    n = cmap.bins_per
    b1 = torch.from_numpy(b1).to(device)
    b2 = torch.from_numpy(b2).to(device)
    cnt = torch.from_numpy(cnt).to(device, torch.float32)
    mat = torch.zeros(n * n, dtype=torch.float32, device=device)
    mat.index_add_(0, b1 * n + b2, cnt)
    off = b1 != b2
    mat.index_add_(0, b2[off] * n + b1[off], cnt[off])
    return mat.view(n, n)


class Values:
    """Window values of one chromosome at given rows and columns."""

    def __init__(self, counts, weights, evec, min_diag, precision):
        self.counts, self.w, self.evec = counts, weights, evec
        self.min_diag, self.precision = min_diag, precision
        self.device = counts.device

    def __call__(self, rows, cols):
        """rows [b, H], cols [b, H] -> values [b, H, H], float64."""
        r, c = rows[:, :, None], cols[:, None, :]
        v = self.counts[r, c].double() * self.w[r] * self.w[c]
        d = (r - c).abs()
        v = torch.where(d < self.min_diag, torch.nan, v)
        if self.evec is not None:
            v = v / self.evec[d]
        return lower(v, self.precision)


def make(cmap, block, kw, expected, precision, device):
    chrom, other = block
    if chrom != other:
        raise ValueError(f"cis values of a trans block {block}")
    k = cmap.chroms.index(chrom)
    evec = None
    if expected is not None:
        e = expected[expected["region1"] == chrom].sort_values("dist")
        evec = torch.from_numpy(
            e["balanced.avg"].to_numpy("float64").copy()).to(device)
    w = torch.from_numpy(cmap.chrom_weights(k).copy()).to(device)
    return Values(chrom_counts(cmap, k, device), w, evec,
                  int(kw.get("min_diag", 2)), precision)
