"""BEDPE rows of one chromosome whose anchor centers lie ``mindist`` to
``maxdist`` apart: a window around each anchor's center bin."""

import numpy as np

from ..coords import CHUNK, center_bins, chunked


def blocks(job, features):
    for chrom in job.chroms:
        yield (chrom, chrom), (chrom, 0, job.n * job.res), chunks(
            job, features, chrom)


def chunks(job, features, chrom):
    f = features[(features["chrom1"] == chrom)
                 & (features["chrom2"] == chrom)]
    f = f.sort_values(["start1", "start2"], kind="stable")
    c1 = (f["start1"] + f["end1"]).to_numpy() / 2
    c2 = (f["start2"] + f["end2"]).to_numpy() / 2
    d = np.abs(c2 - c1)
    lim = job.n * job.res
    keep = ((job.mindist <= d) & (d <= job.maxdist)
            & (f["start1"] >= 0).to_numpy() & (f["end1"] < lim).to_numpy()
            & (f["start2"] >= 0).to_numpy() & (f["end2"] < lim).to_numpy())
    f, c1, c2 = f[keep], c1[keep], c2[keep]
    st1 = center_bins(f["start1"].to_numpy(), f["end1"].to_numpy(),
                      job.res) - job.flank_bins
    st2 = center_bins(f["start2"].to_numpy(), f["end2"].to_numpy(),
                      job.res) - job.flank_bins
    dot = np.full(len(f), ".")
    group = job.groups(
        {"strand": f["strand1"].to_numpy() if "strand1" in f else dot,
         "center": c1},
        {"strand": f["strand2"].to_numpy() if "strand2" in f else dot,
         "center": c2})
    return chunked(CHUNK, st1, st2, np.full(len(f), job.W), group)
