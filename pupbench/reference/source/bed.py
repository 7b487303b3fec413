"""BED features: windows around each feature's center (rescaled: the
interval scaled by ``2 * rescale_flank + 1`` about its center, floored and
ceiled to bins), at cis pairs of features whose centers lie ``mindist`` to
``maxdist`` apart, enumerated per chromosome along the k-th superdiagonals
of the sorted features, or, ``local``, at each feature with itself."""

import numpy as np

from ..coords import (CHUNK, center_bins, chunked, rescaled_bins,
                      superdiagonal_pairs)


def blocks(job, features):
    for chrom in job.chroms:
        yield (chrom, chrom), (chrom, 0, job.n * job.res), chunks(
            job, features, chrom)


def chunks(job, features, chrom):
    f = features[(features["chrom"] == chrom) & (features["start"] >= 0)
                 & (features["end"] < job.n * job.res)]
    f = f.sort_values("start", kind="stable")
    start, end = f["start"].to_numpy(), f["end"].to_numpy()
    strand = (f["strand"].to_numpy() if "strand" in f
              else np.full(len(f), "."))
    center = (start + end) / 2
    if job.rescale:
        st, h = rescaled_bins(start, end, job.res,
                              job.kw.get("rescale_flank", 1))
    else:
        st = center_bins(start, end, job.res) - job.flank_bins
        h = np.full(len(f), job.W)
    if job.kw.get("local"):
        li = ri = np.arange(len(f))
    else:
        if len(f) < 2:
            return []
        li, ri = superdiagonal_pairs(center, job.mindist, job.maxdist)
    group = job.groups({"strand": strand[li], "center": center[li]},
                       {"strand": strand[ri], "center": center[ri]})
    return chunked(CHUNK, st[li], st[ri], h[li], group)
