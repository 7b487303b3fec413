"""Writer for `.cool` (HDF5) files.

The reference depends on binary test coolers that are not redistributable
(reference .MISSING_LARGE_BLOBS); this writer lets tests synthesize compatible
fixtures and lets users convert matrices. Schema follows the cooler v3 layout
(chroms/bins/pixels/indexes + attrs) that `io/cool.py` reads. Counterpart
of ``coolpuppy_tpu/io/coolwrite.py``; h5py is imported inside ``write_cool``.
"""

from __future__ import annotations

import numpy as np


def write_cool(
    path,
    chromsizes,
    binsize,
    pixels,
    weights=None,
    extra_bin_cols=None,
    group="/",
    assembly="unknown",
):
    """Write a .cool file.

    Parameters
    ----------
    chromsizes : dict chrom -> length (bp), in desired chromosome order.
    binsize : int
    pixels : (bin1_id, bin2_id, count) arrays in *global* bin ids, upper
        triangle (bin1_id <= bin2_id). Will be sorted (bin1, bin2).
    weights : optional per-bin balancing weight array (NaN = bad bin).
    extra_bin_cols : optional dict of name -> per-bin array (e.g. coverage).
    """
    import h5py

    chroms = list(chromsizes.keys())
    lengths = np.array([chromsizes[c] for c in chroms], dtype=np.int64)
    n_bins_per_chrom = np.ceil(lengths / binsize).astype(np.int64)
    chrom_offset = np.concatenate([[0], np.cumsum(n_bins_per_chrom)])
    n_bins = int(chrom_offset[-1])

    chrom_ids = np.repeat(np.arange(len(chroms)), n_bins_per_chrom)
    starts = np.concatenate(
        [np.arange(n) * binsize for n in n_bins_per_chrom]
    ).astype(np.int64)
    ends = np.minimum(starts + binsize, lengths[chrom_ids]).astype(np.int64)

    bin1, bin2, count = (np.asarray(a) for a in pixels)
    assert np.all(bin1 <= bin2), "pixels must be upper-triangle (bin1 <= bin2)"
    order = np.lexsort((bin2, bin1))
    bin1, bin2, count = bin1[order], bin2[order], count[order]
    nnz = len(bin1)

    bin1_offset = np.searchsorted(bin1, np.arange(n_bins + 1)).astype(np.int64)

    with h5py.File(path, "w") as f:
        grp = f if group in ("/", "") else f.create_group(group)
        grp.attrs["format"] = "HDF5::Cooler"
        grp.attrs["format-version"] = 3
        grp.attrs["bin-type"] = "fixed"
        grp.attrs["bin-size"] = int(binsize)
        grp.attrs["storage-mode"] = "symmetric-upper"
        grp.attrs["nchroms"] = len(chroms)
        grp.attrs["nbins"] = n_bins
        grp.attrs["nnz"] = nnz
        grp.attrs["genome-assembly"] = assembly
        grp.attrs["generated-by"] = "coolpuppy-tpu-torch"

        g = grp.create_group("chroms")
        g.create_dataset(
            "name", data=np.array(chroms, dtype=h5py.string_dtype())
        )
        g.create_dataset("length", data=lengths)

        g = grp.create_group("bins")
        g.create_dataset("chrom", data=chrom_ids.astype(np.int32))
        g.create_dataset("start", data=starts)
        g.create_dataset("end", data=ends)
        if weights is not None:
            g.create_dataset("weight", data=np.asarray(weights, dtype=np.float64))
        for name, arr in (extra_bin_cols or {}).items():
            g.create_dataset(name, data=np.asarray(arr))

        g = grp.create_group("pixels")
        g.create_dataset("bin1_id", data=bin1.astype(np.int64))
        g.create_dataset("bin2_id", data=bin2.astype(np.int64))
        if np.issubdtype(np.asarray(count).dtype, np.integer):
            g.create_dataset("count", data=count.astype(np.int32))
        else:
            g.create_dataset("count", data=count.astype(np.float64))

        g = grp.create_group("indexes")
        g.create_dataset("chrom_offset", data=chrom_offset)
        g.create_dataset("bin1_offset", data=bin1_offset)
    return path
