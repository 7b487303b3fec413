"""A contact matrix held in numpy arrays, with the slice of the cooler API
the engine reads (counterpart of ``coolpuppy_tpu/io/cool.py``).

The reference reads ``.cool`` (HDF5) files on every fetch. The port holds the
whole matrix in memory: the upper-triangle pixels sorted by (bin1, bin2), a
``bin1_offset`` row index into them, and the bins table. Two constructors
fill it:

- ``Cooler.from_arrays(chromsizes, binsize, (bin1, bin2, count), weights)``
  takes the pixels from the caller, with the layout ``write_cool`` of the
  JAX package stores (upper triangle, duplicates kept, integer counts as
  int32);
- ``Cooler.from_cool(uri)`` reads a ``.cool`` file (``path`` or
  ``path::group``) with h5py, imported inside that function only: the
  package itself does not need h5py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pandas as pd


@dataclass
class PixelSlab:
    """Stored-triangle pixels of a region fetch, before mirroring/balancing.
    ``rows``/``cols`` are GLOBAL bin ids; the logical rectangle is rows in
    [lo1, lo1+shape[0]), cols in [lo2, lo2+shape[1]). ``mirror`` means the
    symmetric transpose of every off-diagonal pixel also belongs to the
    rectangle (cis same-extent fetches; the consumer applies it).
    ``weights`` is the GLOBAL per-bin balancing vector with NaNs cleaned to
    0, or None for unbalanced."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray  # float32
    lo1: int
    lo2: int
    shape: tuple
    mirror: bool
    weights: np.ndarray | None

    @property
    def nnz(self):
        return len(self.rows)


class _BinsAccessor:
    """``clr.bins()[col].fetch(region)`` and ``col in clr.bins().columns``
    (reference coolpup.py:950–957, 1081–1098)."""

    def __init__(self, clr):
        self._clr = clr

    @property
    def columns(self):
        return self._clr.bins_df().columns

    def __getitem__(self, col):
        return _BinsColumn(self._clr, col)


class _BinsColumn:
    def __init__(self, clr, col):
        self._clr = clr
        self._col = col

    def fetch(self, region):
        lo, hi = self._clr.extent(region)
        return self._clr.bins_df()[self._col].iloc[lo:hi]


def _bins_table(chromnames, lengths, binsize):
    """(chrom_offset, bins DataFrame with chrom/start/end) of a fixed-size
    bin grid, as ``write_cool`` lays it out."""
    n_per = np.ceil(lengths / binsize).astype(np.int64)
    chrom_offset = np.concatenate([[0], np.cumsum(n_per)])
    chrom_ids = np.repeat(np.arange(len(chromnames)), n_per)
    starts = np.concatenate(
        [np.arange(n) * binsize for n in n_per]
    ).astype(np.int64)
    ends = np.minimum(starts + binsize, lengths[chrom_ids]).astype(np.int64)
    bins = pd.DataFrame({
        "chrom": np.asarray(chromnames, dtype=object)[chrom_ids],
        "start": starts,
        "end": ends,
    })
    return chrom_offset, bins


def _sorted_pairs(bin1, bin2):
    """Whether pixels are already in (bin1, bin2) order."""
    d1 = np.diff(bin1)
    return bool((d1 >= 0).all() and ((d1 > 0) | (np.diff(bin2) >= 0)).all())


class Cooler:
    """An in-memory contact matrix. Build it with ``from_arrays`` or
    ``from_cool``."""

    def __init__(self, chromnames, lengths, binsize, chrom_offset, bins,
                 bin1, bin2, count, filename=None):
        self.binsize = int(binsize)
        self.chromnames = list(chromnames)
        self.chromsizes = dict(zip(self.chromnames,
                                   np.asarray(lengths, np.int64)))
        self.filename = filename
        self._chrom_offset = np.asarray(chrom_offset, np.int64)
        self._bins_df = bins
        self.n_bins = len(bins)
        self._bin1 = np.asarray(bin1, np.int64)
        self._bin2 = np.asarray(bin2, np.int64)
        self._count = count
        self.n_pixels = len(self._bin1)
        self._bin1_offset = np.searchsorted(
            self._bin1, np.arange(self.n_bins + 1)
        ).astype(np.int64)
        self._weights_clean_cache = {}

    @classmethod
    def from_arrays(cls, chromsizes, binsize, pixels, weights=None):
        """A cooler from upper-triangle pixels in GLOBAL bin ids: ``pixels``
        is ``(bin1, bin2, count)`` with ``bin1 <= bin2``; ``chromsizes`` maps
        chrom -> length in bp, in the matrix's chromosome order; ``weights``
        is the per-bin balancing vector (NaN = bad bin), stored as the
        ``weight`` column. Pixels are sorted by (bin1, bin2) (a stable sort,
        skipped when they come in that order); integer counts are kept as
        int32, others as float64."""
        chromnames = list(chromsizes.keys())
        lengths = np.array([chromsizes[c] for c in chromnames], np.int64)
        chrom_offset, bins = _bins_table(chromnames, lengths, int(binsize))
        bin1, bin2, count = (np.asarray(a) for a in pixels)
        if not (len(bin1) == len(bin2) == len(count)):
            raise ValueError("from_arrays: bin1, bin2 and count differ in "
                             "length")
        if len(bin1) and (np.any(bin1 > bin2) or bin1.min() < 0
                          or bin2.max() >= len(bins)):
            raise ValueError("from_arrays: pixels must be upper-triangle "
                             "(bin1 <= bin2) global bin ids in "
                             f"[0, {len(bins)})")
        if np.issubdtype(count.dtype, np.integer):
            count = count.astype(np.int32)
        else:
            count = count.astype(np.float64)
        if not _sorted_pairs(bin1, bin2):
            order = np.lexsort((bin2, bin1))
            bin1, bin2, count = bin1[order], bin2[order], count[order]
        if weights is not None:
            weights = np.asarray(weights, np.float64)
            if weights.shape != (len(bins),):
                raise ValueError(f"from_arrays: weights must have {len(bins)} "
                                 f"entries, got {weights.shape}")
            bins["weight"] = weights
        return cls(chromnames, lengths, binsize, chrom_offset, bins,
                   bin1, bin2, count)

    @classmethod
    def from_cool(cls, uri):
        """Read a ``.cool`` file (``path`` or ``path::group``) into memory."""
        import h5py

        path, _, group = str(uri).partition("::")
        group = (group if group.startswith("/") else "/" + group) if group \
            else "/"
        with h5py.File(path, "r") as f:
            grp = f[group]
            binsize = int(grp.attrs["bin-size"])
            chromnames = [c.decode() if isinstance(c, bytes) else str(c)
                          for c in grp["chroms/name"][:]]
            lengths = grp["chroms/length"][:].astype(np.int64)
            chrom_offset = grp["indexes/chrom_offset"][:].astype(np.int64)
            cols = {c: grp["bins"][c][:] for c in grp["bins"].keys()}
            bin1 = grp["pixels/bin1_id"][:]
            bin2 = grp["pixels/bin2_id"][:]
            count = grp["pixels/count"][:]
        chrom = cols["chrom"]
        if chrom.dtype.kind in "iu":
            cols["chrom"] = np.asarray(chromnames, dtype=object)[chrom]
        else:
            cols["chrom"] = np.array(
                [c.decode() if isinstance(c, bytes) else str(c)
                 for c in chrom], dtype=object,
            )
        return cls(chromnames, lengths, binsize, chrom_offset,
                   pd.DataFrame(cols), bin1, bin2, count, filename=path)

    # -- bins --------------------------------------------------------------

    def bins_df(self):
        """Full bins table as a DataFrame (chrom as string)."""
        return self._bins_df

    def bins(self):
        return _BinsAccessor(self)

    def store_bin_column(self, name, values):
        """Attach a computed per-bin column (e.g. coverage)."""
        values = np.asarray(values)
        if values.shape != (self.n_bins,):
            raise ValueError(f"store_bin_column: {name} must have "
                             f"{self.n_bins} entries, got {values.shape}")
        self._bins_df[name] = values

    def _clean_weights(self, balance):
        """Global per-bin balancing weights with NaN -> 0 (cached; threads
        that fill the cache at once all get the first copy stored)."""
        balance = "weight" if balance is True else balance
        w = self._weights_clean_cache.get(balance)
        if w is None:
            w = self._weights_clean_cache.setdefault(balance, np.nan_to_num(
                self._bins_df[balance].values.astype(np.float32)
            ))
        return w

    def bad_bin_mask(self, region, weight_name="weight"):
        """Boolean per-bin mask of NaN-weight (unbalanceable) bins in region
        (the ``isnan1``/``isnan2`` vectors of reference
        coolpup.py:1081–1094)."""
        lo, hi = self.extent(region)
        if not weight_name:
            return np.zeros(hi - lo, dtype=bool)
        w = self._bins_df[weight_name].values[lo:hi].astype(np.float64)
        return np.isnan(w)

    # -- region arithmetic -------------------------------------------------

    def _parse_region(self, region):
        """Accept (chrom, start, end) tuples, pandas rows, or 'chrom' /
        'chrom:start-end' strings. Returns (chrom, start, end)."""
        if isinstance(region, pd.Series):
            return (
                str(region.iloc[0]),
                int(region.iloc[1]),
                int(region.iloc[2]),
            )
        if isinstance(region, str):
            if ":" in region:
                chrom, _, rng = region.partition(":")
                start, _, end = rng.partition("-")
                return (chrom, int(start.replace(",", "")),
                        int(end.replace(",", "")))
            return region, 0, int(self.chromsizes[region])
        chrom, start, end = region[0], region[1], region[2]
        return str(chrom), int(start), int(end)

    def offset(self, chrom):
        """Global bin index of the first bin of ``chrom`` (or of a region)."""
        chrom, start, _ = self._parse_region(chrom)
        cix = self.chromnames.index(chrom)
        return int(self._chrom_offset[cix] + start // self.binsize)

    def extent(self, region):
        """(lo, hi) global bin range of a region."""
        chrom, start, end = self._parse_region(region)
        cix = self.chromnames.index(chrom)
        off = self._chrom_offset[cix]
        lo = off + start // self.binsize
        hi = off + int(np.ceil(end / self.binsize))
        return int(lo), int(hi)

    # -- pixels ------------------------------------------------------------

    def _fetch_rect_raw(self, lo1, hi1, lo2, hi2, dtype=np.float32):
        """Stored (upper-triangle) pixels with bin1 in [lo1,hi1), bin2 in
        [lo2,hi2), counts as ``dtype``."""
        p_lo = int(self._bin1_offset[lo1])
        p_hi = int(self._bin1_offset[hi1])
        bin1 = self._bin1[p_lo:p_hi]
        bin2 = self._bin2[p_lo:p_hi]
        count = self._count[p_lo:p_hi].astype(dtype)
        if lo2 <= 0 and hi2 >= self.n_bins:
            return bin1, bin2, count
        mask = (bin2 >= lo2) & (bin2 < hi2)
        return bin1[mask], bin2[mask], count[mask]

    def fetch_slab(self, region1, region2=None, balance="weight",
                   dtype=np.float32):
        """Stored-triangle pixels of the query rectangle as a PixelSlab. A
        cis same-extent query keeps the stored triangle (``mirror``);
        distinct extents read both row spans."""
        lo1, hi1 = self.extent(region1)
        lo2, hi2 = self.extent(region2 if region2 is not None else region1)
        weights = self._clean_weights(balance) if balance else None
        if (lo1, hi1) == (lo2, hi2):
            rows, cols, vals = self._fetch_rect_raw(lo1, hi1, lo2, hi2, dtype)
            mirror = True
        else:
            r1, c1, v1 = self._fetch_rect_raw(lo1, hi1, lo2, hi2, dtype)
            # transpose of stored pixels landing in the rectangle the other
            # way; the stored diagonal is excluded against double counting
            r2, c2, v2 = self._fetch_rect_raw(lo2, hi2, lo1, hi1, dtype)
            keep = r2 != c2
            rows = np.concatenate([r1, c2[keep]])
            cols = np.concatenate([c1, r2[keep]])
            vals = np.concatenate([v1, v2[keep]])
            mirror = False
        return PixelSlab(
            rows=rows, cols=cols, vals=vals, lo1=lo1, lo2=lo2,
            shape=(hi1 - lo1, hi2 - lo2), mirror=mirror, weights=weights,
        )

    def fetch_coo(self, region1, region2=None, balance="weight"):
        """Sparse COO of the query rectangle with both triangles present,
        optionally balanced (counterpart of the reference's ``fetch_coo``,
        ``clr.matrix(sparse=True, balance=...).fetch(r1, r2)``): counts in
        float64, bad-bin (NaN-weight) products mapped to 0."""
        from scipy import sparse as sp

        slab = self.fetch_slab(region1, region2, balance=balance,
                               dtype=np.float64)
        rows, cols, vals = slab.rows, slab.cols, slab.vals
        if slab.weights is not None:
            balance = "weight" if balance is True else balance
            w = np.nan_to_num(self._bins_df[balance].values.astype(np.float64))
            vals = vals * w[rows] * w[cols]
        if slab.mirror:
            off = rows != cols
            rows, cols, vals = (
                np.concatenate([rows, cols[off]]),
                np.concatenate([cols, rows[off]]),
                np.concatenate([vals, vals[off]]),
            )
        return sp.coo_matrix(
            (vals, (rows - slab.lo1, cols - slab.lo2)), shape=slab.shape
        )

    def pixels_chunk(self, start, stop):
        """Raw pixels [start, stop) as (bin1, bin2, count float64)."""
        return (
            self._bin1[start:stop],
            self._bin2[start:stop],
            self._count[start:stop].astype(np.float64),
        )
