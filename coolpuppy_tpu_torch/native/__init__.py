"""The host ingest in C++ (counterpart of ``coolpuppy_tpu/native``): the
column filter of a region fetch, the COO -> tile-stack scatters, the
float16 cast of the tile upload wire and its scan, the stable counting
sort of snip words by tile quad, and the sorted-center pair sweep, bound
with ``ctypes``.

The library is built from ``_ingest.cpp`` at the first call
(``native/build.py``) and loaded once. A failed build or load raises: the
port has no fallback. The numpy versions of these entries stay beside their
callers as the plain versions the tests hold them against
(``io/cool.Cooler._fetch_rect_raw_plain``, ``ops/tiles.scatter_plain`` and
``scatter_slab_plain``, ``ops/tiles.cast_slab_f16_plain``,
``ops/quad_gather.sort_quads_plain``, ``coords.CoordCreator``'s numpy
sweep); ``abs_max`` is held against numpy's ``nanmax``.

Every entry but ``enumerate_pairs`` runs an OpenMP team (``cast_f16`` and
``abs_max`` only on 2^20 values or more). At load its size
is set once to ``max(1, os.cpu_count() - 1)``, one core left for the
engine's main thread, unless ``OMP_NUM_THREADS`` is set, whose value the
OpenMP runtime then takes; ``set_threads`` changes it. The process
environment is not touched. The entries release the GIL (ctypes does), so
a scatter on a worker thread overlaps the main thread's Python.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None

_i32 = ctypes.POINTER(ctypes.c_int32)
_i64 = ctypes.POINTER(ctypes.c_int64)
_f32 = ctypes.POINTER(ctypes.c_float)
_f64 = ctypes.POINTER(ctypes.c_double)
_c64 = ctypes.c_int64


def _bind(lib):
    scatter = [_c64, _i32, _c64, _c64, _c64, _f32]
    lib.tile_scatter.argtypes = [_i64, _i64, _f64, *scatter]
    lib.tile_scatter_i32f32.argtypes = [_i32, _i32, _f32, *scatter]
    lib.tile_scatter_i32f64.argtypes = [_i32, _i32, _f64, *scatter]
    lib.tile_scatter_wtri.argtypes = [
        _i64, _i64, _f32, _c64, _c64, _c64, _c64, _c64, _f32, _i32, _c64,
        _c64, _c64, ctypes.c_int32, _f32,
    ]
    lib.slab_count.restype = ctypes.c_int64
    lib.slab_count.argtypes = [_i64, _c64, _c64, _c64, _c64, _i64]
    lib.slab_select.argtypes = [
        _i64, _i64, ctypes.c_void_p, ctypes.c_int32, _c64, _c64, _c64, _c64,
        _i64, _i64, _i64, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.cast_f16.restype = ctypes.c_int32
    lib.cast_f16.argtypes = [_f32, _c64, ctypes.c_float, ctypes.c_float,
                             ctypes.c_int32, ctypes.POINTER(ctypes.c_uint16)]
    lib.abs_max.restype = ctypes.c_float
    lib.abs_max.argtypes = [_f32, _c64]
    lib.quad_sort.argtypes = [_i32, _i32, _c64, _c64, _i32, _i64]
    lib.enumerate_pairs.restype = ctypes.c_int64
    lib.enumerate_pairs.argtypes = [_f64, _c64, ctypes.c_double,
                                    ctypes.c_double, _i64, _i64, _c64]
    lib.ingest_set_threads.argtypes = [ctypes.c_int]
    lib.ingest_set_threads.restype = ctypes.c_int


def lib():
    """The loaded library, built at the first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            from .build import build

            loaded = ctypes.CDLL(str(build()))
            _bind(loaded)
            if "OMP_NUM_THREADS" not in os.environ:
                loaded.ingest_set_threads(max(1, (os.cpu_count() or 2) - 1))
            _LIB = loaded
        return _LIB


def set_threads(n):
    """Set the OpenMP team size of every entry; returns the size in
    effect."""
    return int(lib().ingest_set_threads(int(n)))


def threads():
    """The OpenMP team size of the entries."""
    return int(lib().ingest_set_threads(0))


def _ptr(a, kind):
    return a.ctypes.data_as(kind)


def _check_range(name, a, lo, hi):
    """Raise unless every entry of ``a`` lies in [lo, hi): the C loops index
    with them unchecked."""
    if len(a) and (a.min() < lo or a.max() >= hi):
        raise ValueError(f"native: {name} outside [{lo}, {hi})")


def _check_stack(tile_map, K, B, n1, n2):
    if (tile_map.shape[0] * B < n1 or tile_map.shape[1] * B < n2
            or tile_map.min(initial=0) < 0 or tile_map.max(initial=0) > K):
        raise ValueError(
            f"native: tile map {tile_map.shape} with slots up to "
            f"{tile_map.max(initial=0)} does not cover {n1} x {n2} bins in "
            f"{K} tiles of {B}"
        )


# the count dtypes ``slab_select`` reads as they are (its ``count_kind``)
_COUNT_KINDS = {np.dtype(np.int32): 0, np.dtype(np.float32): 1,
                np.dtype(np.float64): 2}
# pixels a chunk of the filter's passes holds at least
_SLAB_CHUNK = 1 << 16


def slab_select(bin1, bin2, count, lo2, hi2, dtype):
    """The pixels of a row span whose ``bin2`` lies in [lo2, hi2), in input
    order, counts cast to ``dtype`` (float32 or float64): ``(bin1, bin2,
    vals, dropped)``, ``dropped`` the pixels left out. Where none is left
    out, ``bin1`` and ``bin2`` come back as the int64 arrays they came in
    as, and only the counts are cast; otherwise the three columns are
    compacted into new arrays. int32, float32 and float64 counts are read
    as they are; others are cast to ``dtype`` first."""
    bin1 = np.ascontiguousarray(bin1, np.int64)
    bin2 = np.ascontiguousarray(bin2, np.int64)
    count = np.ascontiguousarray(count)
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise ValueError(f"native.slab_select: counts cast to float32 or "
                         f"float64, not {dtype}")
    if not len(bin1) == len(bin2) == len(count):
        raise ValueError("native.slab_select: bin1, bin2, count differ in "
                         "length")
    if count.dtype not in _COUNT_KINDS:
        count = count.astype(dtype)
    n = len(bin2)
    L = lib()
    kept = np.zeros(max(1, min(threads(), n // _SLAB_CHUNK)), np.int64)
    total = L.slab_count(_ptr(bin2, _i64), n, int(lo2), int(hi2), len(kept),
                         _ptr(kept, _i64))
    vals = np.empty(total, dtype)
    if total == n:
        rows, cols, out1, out2 = bin1, bin2, _i64(), _i64()
    else:
        rows, cols = np.empty(total, np.int64), np.empty(total, np.int64)
        out1, out2 = _ptr(rows, _i64), _ptr(cols, _i64)
    L.slab_select(_ptr(bin1, _i64), _ptr(bin2, _i64), count.ctypes.data,
                  _COUNT_KINDS[count.dtype], n, int(lo2), int(hi2),
                  len(kept), _ptr(kept, _i64), out1, out2, vals.ctypes.data,
                  int(dtype == np.float64))
    return rows, cols, vals, n - total


def tile_scatter(rows, cols, vals, tile_map, B, K):
    """COO pixels -> [K+1, B, B] float32 tile stack through ``tile_map``
    ((tile_row, tile_col) -> slot, 0 = dropped). int32 indices with float32
    or float64 values (scipy's COO dtypes) scatter without conversion
    copies; anything else goes through the int64/float64 entry."""
    rows = np.ascontiguousarray(rows)
    cols = np.ascontiguousarray(cols)
    vals = np.ascontiguousarray(vals)
    tm = np.ascontiguousarray(tile_map, np.int32)
    if not len(rows) == len(cols) == len(vals):
        raise ValueError("native.tile_scatter: rows, cols, vals differ in "
                         "length")
    _check_range("tile_scatter rows", rows, 0, tm.shape[0] * B)
    _check_range("tile_scatter cols", cols, 0, tm.shape[1] * B)
    _check_stack(tm, K, B, 0, 0)
    out = np.zeros((K + 1, B, B), np.float32)
    L = lib()
    if rows.dtype == np.int32 and cols.dtype == np.int32:
        it = _i32
        if vals.dtype == np.float32:
            fn, vt = L.tile_scatter_i32f32, _f32
        else:
            vals = np.ascontiguousarray(vals, np.float64)
            fn, vt = L.tile_scatter_i32f64, _f64
    else:
        rows = np.ascontiguousarray(rows, np.int64)
        cols = np.ascontiguousarray(cols, np.int64)
        vals = np.ascontiguousarray(vals, np.float64)
        fn, vt, it = L.tile_scatter, _f64, _i64
    fn(_ptr(rows, it), _ptr(cols, it), _ptr(vals, vt), len(rows),
       _ptr(tm, _i32), tm.shape[1], B, K, _ptr(out, _f32))
    return out


def tile_scatter_wtri(rows, cols, vals, lo1, lo2, n1, n2, weights, tile_map,
                      B, K, mirror):
    """Stored-triangle pixels (GLOBAL bin ids) of the rectangle rows [lo1,
    lo1+n1) x cols [lo2, lo2+n2) -> [K+1, B, B] float32 tile stack, the
    balancing ``weights`` (global, NaN cleaned to 0; None for raw counts)
    folded in float32 and, with ``mirror``, each off-diagonal pixel's
    transpose scattered too."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float32)
    tm = np.ascontiguousarray(tile_map, np.int32)
    if not len(rows) == len(cols) == len(vals):
        raise ValueError("native.tile_scatter_wtri: rows, cols, vals differ "
                         "in length")
    _check_stack(tm, K, B, n1, n2)
    if weights is not None:
        weights = np.ascontiguousarray(weights, np.float32)
        _check_range("tile_scatter_wtri rows", rows, 0, len(weights))
        _check_range("tile_scatter_wtri cols", cols, 0, len(weights))
        wptr = _ptr(weights, _f32)
    else:
        wptr = _f32()
    out = np.zeros((K + 1, B, B), np.float32)
    lib().tile_scatter_wtri(
        _ptr(rows, _i64), _ptr(cols, _i64), _ptr(vals, _f32), len(rows),
        int(lo1), int(lo2), int(n1), int(n2), wptr, _ptr(tm, _i32),
        tm.shape[1], B, K, 1 if mirror else 0, _ptr(out, _f32),
    )
    return out


def cast_f16(src, scale, inv, exact, out):
    """The float16 wire of float32 ``src`` written into ``out`` (float16,
    C-contiguous, ``src``'s size): ``f16(src * scale)``, rounded to nearest
    even, numpy's bits. ``exact`` also checks that ``f32(out) * inv``
    gives ``src`` back (NaN for NaN) and returns False at the first value
    that does not (``out`` then holds part of the cast); True otherwise."""
    src = np.ascontiguousarray(src, np.float32)
    if out.dtype != np.float16 or not out.flags.c_contiguous \
            or not out.flags.writeable or out.size != src.size:
        raise ValueError(
            f"native.cast_f16: out must be a writable C-contiguous float16 "
            f"array of {src.size} values, not {out.dtype} {out.shape}")
    return bool(lib().cast_f16(
        _ptr(src, _f32), src.size, float(scale), float(inv),
        1 if exact else 0, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))))


def abs_max(a):
    """The largest ``|a|`` of float32 values, NaN skipped: inf where one is
    infinite, 0.0 where none is a number or ``a`` is empty."""
    a = np.ascontiguousarray(a, np.float32)
    return float(lib().abs_max(_ptr(a, _f32), a.size))


def quad_sort(keys, payload, nbuckets):
    """Stable counting sort of int32 ``payload`` by int32 ``keys`` in
    [0, nbuckets). Returns ``(sorted payload, counts)``, ``counts`` the
    int64 histogram of the keys."""
    keys = np.ascontiguousarray(keys, np.int32)
    payload = np.ascontiguousarray(payload, np.int32)
    if len(keys) != len(payload):
        raise ValueError("native.quad_sort: keys and payload differ in length")
    _check_range("quad_sort keys", keys, 0, nbuckets)
    out = np.empty(len(keys), np.int32)
    counts = np.zeros(int(nbuckets), np.int64)
    lib().quad_sort(_ptr(keys, _i32), _ptr(payload, _i32), len(keys),
                    int(nbuckets), _ptr(out, _i32), _ptr(counts, _i64))
    return out, counts


def enumerate_pairs(centers, mindist, maxdist, cap=None):
    """All pairs (i, j), i < j, of SORTED ``centers`` with distance in
    [mindist, maxdist], in k-th-superdiagonal order, stopped once a
    diagonal's least distance passes ``maxdist``. The output buffers start
    at ``cap`` pairs and grow fourfold until they hold them all. Returns
    int64 ``(i, j)``."""
    centers = np.ascontiguousarray(centers, np.float64)
    n = len(centers)
    cap = max(1024, n * 64) if cap is None else int(cap)
    L = lib()
    while True:
        out_i = np.empty(cap, np.int64)
        out_j = np.empty(cap, np.int64)
        cnt = L.enumerate_pairs(_ptr(centers, _f64), n, float(mindist),
                                float(maxdist), _ptr(out_i, _i64),
                                _ptr(out_j, _i64), cap)
        if cnt >= 0:
            return out_i[:cnt], out_j[:cnt]
        cap *= 4
