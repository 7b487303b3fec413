"""The ``.cool`` reader of the port (counterpart of
``coolpuppy_tpu/io/cool.py``): the slice of the cooler API the engine,
``expected.py`` and ``coverage.py`` read.

A ``Cooler`` reads the cooler schema from a *store*: something whose
``open()`` yields a group in which ``pixels/bin1_id``, ``pixels/bin2_id``
and ``pixels/count`` are sliced by row range, beside ``bins/*``,
``chroms/*``, ``indexes/*`` and the ``bin-size`` attribute. At construction
it reads the metadata only; the bins table and the ``bin1_offset`` index
are read at first use and kept; every fetch reads the row span of its
query and nothing else, under a lock (the region prefetch reads from up to
four threads). Three ways to build one, all on the same fetch code:

- ``Cooler(uri)`` reads a ``.cool`` file, ``path`` or ``path::group``
  (``x.mcool::/resolutions/10000``), through a ``FileStore``: h5py opens the
  file for each read, as the reference does, so the object holds one
  fetch's rows at a time;
- ``Cooler.from_arrays(chromsizes, binsize, (bin1, bin2, count), weights)``
  takes the pixels from the caller into an ``ArrayStore`` (numpy arrays in
  the cooler schema; how the card, which has no h5py, builds its maps);
- ``Cooler.from_cool(uri)`` reads a whole file into an ``ArrayStore``.

h5py is imported inside the functions that open a file: the package itself
does not need it.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import pandas as pd

from .. import native

PIXEL_COLUMNS = ("bin1_id", "bin2_id", "count")


@dataclass
class PixelSlab:
    """Stored-triangle pixels of a region fetch, before mirroring/balancing.
    ``rows``/``cols`` are GLOBAL bin ids; the logical rectangle is rows in
    [lo1, lo1+shape[0]), cols in [lo2, lo2+shape[1]). ``mirror`` means the
    symmetric transpose of every off-diagonal pixel also belongs to the
    rectangle (cis same-extent fetches; the consumer applies it).
    ``weights`` is the GLOBAL per-bin balancing vector with NaNs cleaned to
    0, or None for unbalanced. ``dropped``: the pixels of the fetched row
    spans whose column lies outside the rectangle. ``rows``/``cols`` may
    be read-only views of the store's own columns (a fetch that dropped
    none): readers never write into a slab's arrays."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray  # float32
    lo1: int
    lo2: int
    shape: tuple
    mirror: bool
    weights: np.ndarray | None
    dropped: int = 0

    @property
    def nnz(self):
        return len(self.rows)


def parse_cooler_uri(uri):
    """``(path, group)`` of a cooler URI ``path`` or ``path::group``."""
    path, _, group = str(uri).partition("::")
    return path, (group if group.startswith("/") else "/" + group) if group \
        else "/"


# -- stores ----------------------------------------------------------------


class FileStore:
    """A ``.cool`` file (or one group of an ``.mcool``), opened with h5py for
    each read."""

    def __init__(self, filename, group="/"):
        self.filename = str(filename)
        self.group = group

    @contextmanager
    def open(self):
        import h5py

        with h5py.File(self.filename, "r") as f:
            yield f[self.group]


class ArrayGroup:
    """A nested dict of numpy arrays read as an h5py group is:
    ``grp["pixels/count"][lo:hi]``, ``grp["bins"].keys()``, ``grp.attrs``."""

    def __init__(self, tree, attrs=None):
        self._tree = tree
        self.attrs = attrs or {}

    def __getitem__(self, path):
        node = self._tree
        for part in path.strip("/").split("/"):
            node = node[part]
        return ArrayGroup(node) if isinstance(node, dict) else node

    def keys(self):
        return self._tree.keys()


class ArrayStore:
    """The cooler schema held in numpy arrays: ``tree`` maps ``chroms``,
    ``bins``, ``pixels`` and ``indexes`` to dicts of arrays, ``attrs`` holds
    ``bin-size``. ``filename`` and ``group`` name the file it was read from,
    if any."""

    def __init__(self, tree, attrs, filename=None, group="/"):
        self.root = ArrayGroup(tree, attrs)
        self.filename = filename
        self.group = group

    @contextmanager
    def open(self):
        yield self.root


# -- accessors -------------------------------------------------------------


class _BinsAccessor:
    """``clr.bins()[col].fetch(region)``, ``clr.bins().fetch(region)`` and
    ``col in clr.bins().columns`` (reference coolpup.py:950–957,
    1081–1098)."""

    def __init__(self, clr):
        self._clr = clr

    @property
    def columns(self):
        return self._clr._bin_columns()

    def __getitem__(self, col):
        return _BinsColumn(self._clr, col)

    def fetch(self, region):
        lo, hi = self._clr.extent(region)
        return self._clr.bins_df().iloc[lo:hi]


class _BinsColumn:
    def __init__(self, clr, col):
        self._clr = clr
        self._col = col

    def fetch(self, region):
        lo, hi = self._clr.extent(region)
        return self._clr.bins_df()[self._col].iloc[lo:hi]


class _MatrixSelector:
    """``clr.matrix(sparse=..., balance=...).fetch(region1, region2)``."""

    def __init__(self, clr, balance, sparse_out):
        self._clr = clr
        self._balance = balance
        self._sparse = sparse_out

    def fetch(self, region1, region2=None):
        coo = self._clr.fetch_coo(region1, region2, balance=self._balance)
        if self._sparse:
            return coo
        return np.asarray(coo.todense())


def _bin_grid(lengths, binsize):
    """(chrom_offset, chrom ids, starts, ends) of a fixed-size bin grid, as
    ``write_cool`` lays it out."""
    n_per = np.ceil(lengths / binsize).astype(np.int64)
    chrom_offset = np.concatenate([[0], np.cumsum(n_per)]).astype(np.int64)
    chrom_ids = np.repeat(np.arange(len(lengths)), n_per)
    starts = np.concatenate(
        [np.arange(n) * binsize for n in n_per]
    ).astype(np.int64)
    ends = np.minimum(starts + binsize, lengths[chrom_ids]).astype(np.int64)
    return chrom_offset, chrom_ids.astype(np.int32), starts, ends


def _sorted_pairs(bin1, bin2):
    """Whether pixels are already in (bin1, bin2) order."""
    d1 = np.diff(bin1)
    return bool((d1 >= 0).all() and ((d1 > 0) | (np.diff(bin2) >= 0)).all())


def _empty_rect(dtype):
    """``_fetch_rect_raw``'s answer for an empty row span."""
    empty = np.array([], dtype=np.int64)
    return empty, empty, np.array([], dtype=dtype), 0


def _read_only(a):
    """A read-only view of ``a`` (the store's own array stays as it is)."""
    view = a.view()
    view.flags.writeable = False
    return view


def _names(values):
    return [c.decode() if isinstance(c, bytes) else str(c) for c in values]


class Cooler:
    """A contact matrix read from a store: ``Cooler(uri)`` for a ``.cool``
    file (``path`` or ``path::group``), or ``Cooler(store)`` for a store
    built elsewhere (``from_arrays``, ``from_cool``)."""

    def __init__(self, uri):
        if isinstance(uri, (str, os.PathLike)):
            self.uri = str(uri)
            store = FileStore(*parse_cooler_uri(uri))
        else:
            self.uri = None
            store = uri
        self.store = store
        self.filename = store.filename
        self.group = store.group
        self._lock = threading.Lock()
        self._extra_bin_cols = {}
        with self._lock, self.store.open() as grp:
            self.binsize = int(grp.attrs["bin-size"])
            self.chromnames = _names(grp["chroms/name"][:])
            lengths = np.asarray(grp["chroms/length"][:], np.int64)
            self.chromsizes = dict(zip(self.chromnames, lengths))
            self._chrom_offset = np.asarray(grp["indexes/chrom_offset"][:],
                                            np.int64)
            self.n_bins = int(grp["bins/start"].shape[0])
            self.n_pixels = int(grp["pixels/bin1_id"].shape[0])
            # integer counts (the standard schema) stay exact up to 2^24 on
            # the float32 slab read
            self.counts_are_int = grp["pixels/count"].dtype.kind in "iu"
        self._bins_df = None
        self._bin1_offset = None
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
        chrom_offset, chrom_ids, starts, ends = _bin_grid(lengths,
                                                          int(binsize))
        n_bins = len(starts)
        bin1, bin2, count = (np.asarray(a) for a in pixels)
        if not (len(bin1) == len(bin2) == len(count)):
            raise ValueError("from_arrays: bin1, bin2 and count differ in "
                             "length")
        if len(bin1) and (np.any(bin1 > bin2) or bin1.min() < 0
                          or bin2.max() >= n_bins):
            raise ValueError("from_arrays: pixels must be upper-triangle "
                             "(bin1 <= bin2) global bin ids in "
                             f"[0, {n_bins})")
        if np.issubdtype(count.dtype, np.integer):
            count = count.astype(np.int32)
        else:
            count = count.astype(np.float64)
        bin1 = bin1.astype(np.int64, copy=False)
        bin2 = bin2.astype(np.int64, copy=False)
        if not _sorted_pairs(bin1, bin2):
            order = np.lexsort((bin2, bin1))
            bin1, bin2, count = bin1[order], bin2[order], count[order]
        bins = {"chrom": chrom_ids, "start": starts, "end": ends}
        if weights is not None:
            weights = np.asarray(weights, np.float64)
            if weights.shape != (n_bins,):
                raise ValueError(f"from_arrays: weights must have {n_bins} "
                                 f"entries, got {weights.shape}")
            bins["weight"] = weights
        tree = {
            "chroms": {"name": np.array(chromnames, dtype=object),
                       "length": lengths},
            "bins": bins,
            "pixels": {"bin1_id": bin1, "bin2_id": bin2, "count": count},
            "indexes": {
                "chrom_offset": chrom_offset,
                "bin1_offset": np.searchsorted(
                    bin1, np.arange(n_bins + 1)).astype(np.int64),
            },
        }
        return cls(ArrayStore(tree, {"bin-size": int(binsize)}))

    @classmethod
    def from_cool(cls, uri):
        """Read a whole ``.cool`` file (``path`` or ``path::group``) into an
        ``ArrayStore``."""
        with FileStore(*parse_cooler_uri(uri)).open() as grp:
            tree = {
                name: {k: grp[name][k][:] for k in grp[name].keys()}
                for name in ("chroms", "bins", "pixels", "indexes")
            }
            attrs = {"bin-size": int(grp.attrs["bin-size"])}
        clr = cls(ArrayStore(tree, attrs, *parse_cooler_uri(uri)))
        clr.uri = str(uri)
        return clr

    # -- bins --------------------------------------------------------------

    def _bin_columns(self):
        with self._lock, self.store.open() as grp:
            cols = list(grp["bins"].keys())
        return pd.Index(cols + list(self._extra_bin_cols))

    def bins_df(self):
        """Full bins table as a DataFrame (chrom as string), read once."""
        if self._bins_df is None:
            with self._lock:
                if self._bins_df is None:
                    with self.store.open() as grp:
                        bins = {c: grp["bins"][c][:]
                                for c in grp["bins"].keys()}
                    chrom = bins["chrom"]
                    if chrom.dtype.kind in "iu":
                        chrom = np.asarray(self.chromnames,
                                           dtype=object)[chrom]
                    else:
                        chrom = np.array(_names(chrom), dtype=object)
                    bins["chrom"] = chrom
                    df = pd.DataFrame(bins)
                    for col, arr in self._extra_bin_cols.items():
                        df[col] = arr
                    self._bins_df = df
        return self._bins_df

    def bins(self):
        return _BinsAccessor(self)

    def store_bin_column(self, name, values):
        """Attach a computed per-bin column (e.g. coverage). It lives on the
        object, not in the store (a file may be read-only), and is kept in
        the bins table whether that was read before or after."""
        values = np.asarray(values)
        if values.shape != (self.n_bins,):
            raise ValueError(f"store_bin_column: {name} must have "
                             f"{self.n_bins} entries, got {values.shape}")
        with self._lock:
            self._extra_bin_cols[name] = values
            if self._bins_df is not None:
                self._bins_df[name] = values

    def bin1_offset(self):
        """The ``indexes/bin1_offset`` row index (read once): the pixels of
        bin rows [lo, hi) are rows [bin1_offset[lo], bin1_offset[hi])."""
        if self._bin1_offset is None:
            with self._lock:
                if self._bin1_offset is None:
                    with self.store.open() as grp:
                        self._bin1_offset = np.asarray(
                            grp["indexes/bin1_offset"][:], np.int64)
        return self._bin1_offset

    def _clean_weights(self, balance):
        """Global per-bin balancing weights with NaN -> 0 (cached; threads
        that fill the cache at once all get the first copy stored)."""
        balance = "weight" if balance is True else balance
        w = self._weights_clean_cache.get(balance)
        if w is None:
            w = self._weights_clean_cache.setdefault(balance, np.nan_to_num(
                self.bins_df()[balance].values.astype(np.float32)
            ))
        return w

    def bad_bin_mask(self, region, weight_name="weight"):
        """Boolean per-bin mask of NaN-weight (unbalanceable) bins in region
        (the ``isnan1``/``isnan2`` vectors of reference
        coolpup.py:1081–1094)."""
        lo, hi = self.extent(region)
        if not weight_name:
            return np.zeros(hi - lo, dtype=bool)
        w = self.bins_df()[weight_name].values[lo:hi].astype(np.float64)
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

    def _read_pixels(self, start, stop):
        """Rows [start, stop) of the three pixel columns, as stored, in one
        open of the store under the lock."""
        with self._lock, self.store.open() as grp:
            return tuple(grp["pixels/" + c][start:stop]
                         for c in PIXEL_COLUMNS)

    def _row_span(self, lo1, hi1):
        """The pixels of bin rows [lo1, hi1), one read of the rows
        [bin1_offset[lo1], bin1_offset[hi1]): bins as int64 (the stored
        arrays where they are), counts as stored; None where it is
        empty."""
        b1off = self.bin1_offset()
        p_lo, p_hi = int(b1off[lo1]), int(b1off[hi1])
        if p_hi <= p_lo:
            return None
        bin1, bin2, count = self._read_pixels(p_lo, p_hi)
        return (bin1.astype(np.int64, copy=False),
                bin2.astype(np.int64, copy=False), count)

    def _fetch_rect_raw(self, lo1, hi1, lo2, hi2, dtype=np.float32):
        """Stored (upper-triangle) pixels with bin1 in [lo1,hi1), bin2 in
        [lo2,hi2), counts as ``dtype``, and the row span's pixels dropped
        for a bin2 outside: ``(bin1, bin2, count, dropped)``. float32 is
        the hot tile-scatter path; the exact compat path (fetch_coo,
        expected) reads float64 so that counts >= 2**24 stay exact. One
        native pass filters the row span (``native.slab_select``); where it
        drops nothing, ``bin1``/``bin2`` are the store's arrays as read,
        as read-only views, and only the counts are new. Equal, element
        for element and in dtype, to ``_fetch_rect_raw_plain``."""
        span = self._row_span(lo1, hi1)
        if span is None:
            return _empty_rect(dtype)
        bin1, bin2, count = span
        if lo2 <= 0 and hi2 >= self.n_bins:  # full column span
            return _read_only(bin1), _read_only(bin2), count.astype(dtype), 0
        rows, cols, vals, dropped = native.slab_select(bin1, bin2, count,
                                                       lo2, hi2, dtype)
        if not dropped:
            rows, cols = _read_only(rows), _read_only(cols)
        return rows, cols, vals, dropped

    def _fetch_rect_raw_plain(self, lo1, hi1, lo2, hi2, dtype=np.float32):
        """Plain numpy version of ``_fetch_rect_raw`` (the tests hold the
        native filter against it): a mask and three boolean takes."""
        span = self._row_span(lo1, hi1)
        if span is None:
            return _empty_rect(dtype)
        bin1, bin2, count = span
        count = count.astype(dtype)
        if lo2 <= 0 and hi2 >= self.n_bins:
            return bin1, bin2, count, 0
        mask = (bin2 >= lo2) & (bin2 < hi2)
        return (bin1[mask], bin2[mask], count[mask],
                len(mask) - int(np.count_nonzero(mask)))

    def fetch_slab(self, region1, region2=None, balance="weight",
                   dtype=np.float32):
        """Stored-triangle pixels of the query rectangle as a PixelSlab. A
        cis same-extent query is one read of its row span (``mirror``: the
        consumer applies the transpose), whose ``rows``/``cols`` are
        read-only views of the store's columns where no pixel of the span
        lies outside the rectangle (``_fetch_rect_raw``); distinct extents
        read both row spans into new arrays. ``dropped`` counts the row
        spans' pixels outside the rectangle."""
        lo1, hi1 = self.extent(region1)
        lo2, hi2 = self.extent(region2 if region2 is not None else region1)
        weights = self._clean_weights(balance) if balance else None
        if (lo1, hi1) == (lo2, hi2):
            rows, cols, vals, dropped = self._fetch_rect_raw(lo1, hi1, lo2,
                                                             hi2, dtype)
            mirror = True
        else:
            r1, c1, v1, d1 = self._fetch_rect_raw(lo1, hi1, lo2, hi2, dtype)
            # transpose of stored pixels landing in the rectangle the other
            # way; the stored diagonal is excluded against double counting
            r2, c2, v2, d2 = self._fetch_rect_raw(lo2, hi2, lo1, hi1, dtype)
            keep = r2 != c2
            rows = np.concatenate([r1, c2[keep]])
            cols = np.concatenate([c1, r2[keep]])
            vals = np.concatenate([v1, v2[keep]])
            mirror, dropped = False, d1 + d2
        return PixelSlab(
            rows=rows, cols=cols, vals=vals, lo1=lo1, lo2=lo2,
            shape=(hi1 - lo1, hi2 - lo2), mirror=mirror, weights=weights,
            dropped=dropped,
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
            w = np.nan_to_num(self.bins_df()[balance].values.astype(
                np.float64))
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

    def matrix(self, sparse=False, balance="weight"):
        return _MatrixSelector(self, balance=balance, sparse_out=sparse)

    def pixels_chunk(self, start, stop):
        """Raw pixels [start, stop) as (bin1, bin2, count float64), read
        from the store (whole-genome streaming: coverage, expected)."""
        bin1, bin2, count = self._read_pixels(start, stop)
        return (bin1.astype(np.int64, copy=False),
                bin2.astype(np.int64, copy=False),
                count.astype(np.float64))
