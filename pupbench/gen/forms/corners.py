"""Each domain's corner as a BEDPE row: one bin at its start and one bin
ending at its end."""

import pandas as pd


def form(frame, binsize):
    return pd.DataFrame({
        "chrom1": frame["chrom"], "start1": frame["start"],
        "end1": frame["start"] + binsize,
        "chrom2": frame["chrom"], "start2": frame["end"] - binsize,
        "end2": frame["end"],
    })
