"""Quad-sorted window gather + accumulate: the counterpart of
``coolpuppy_tpu/ops/pallas_gather.py``.

The reference runs a Pallas TPU kernel over snips sorted by their tile quad
(the 2x2 block of B=128 tiles a window touches). This module keeps the same
semantics on PyTorch tensors:

1. ``QuadPileupSession`` expands and normalizes the region's tile stack on
   the device into ONE NaN-encoded stack (``ops/tiles.py``): masked-out
   pixels are NaN, division-by-zero poison stays +inf.
2. ``sort_quads`` sorts the packed snip words (``pack_snips``) on the host by
   (quad, group) with two passes of the native counting sort, so each quad's
   snips form one run per group. Work items
   are cut from that order: ``split_items`` cuts a quad into items of at
   most ``ITEM_MAX`` snips whatever their groups.
3. ``quad_accumulate`` adds every snip's W×W window into per-group
   accumulators: ``sum[g] += where(v==v, v, 0)`` and
   ``num[g] += (v==v) & (|v| != inf)``. On a CUDA tensor it launches the
   staged kernel of ``csrc/quad_accumulate.cu`` (``quad_accumulate_staged``)
   over all items in one launch: each item's block copies the corner of the
   quad that windows can reach into shared memory, or, where that corner
   does not fit a block (W > 110), each of its ``corner_layout(W).bands``
   blocks copies the rows one band of window rows reaches. On a CPU tensor
   it runs the plain PyTorch version ``quad_accumulate_plain``.

``QuadPileupSession.run_stripes`` gathers each snip's centre row and
centre column (the stripe planes) from the same normalized stack as torch
ops; ``stripes_host`` is its numpy oracle. Flips are handled by the caller
with the flip-bank trick (``ops/gather.merge_flip_banks``). The reference's
fixed call shapes (Q_CAP=128 quads, 131072-snip chunks) only pinned Mosaic
compiles and are not ported: the card takes one launch over all items.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from ..device import resolve_device

B_TILE = 128  # tile size; the packed word's 7-bit offsets require it
W_MAX = 120  # the reference kernel's limit (pallas_gather.py:76)
C_MAX = 1 << 17  # the packed word's 17-bit group field
ITEM_MAX = 1024  # most snips in one staged-kernel work item
PLAIN_CHUNK = 65536  # snips per gather in the plain version
STRIPE_CHUNK = 131072  # snips per stripe gather (run_stripes)

# the staged kernel's shared memory (csrc/quad_accumulate.cu holds the same
# layout and refuses a launch whose size disagrees): the corner, then per
# STAGE_CHUNK snips decoded at once an int32 offset and a uint16 run start
# each, a run-start mask per 32 snips, and the run count
SMEM_MAX = 232_448  # dynamic shared memory a block can take on sm_90
STAGE_CHUNK = 1024
_STAGE_TAIL = (4 * STAGE_CHUNK + 2 * (STAGE_CHUNK + 8)
               + 4 * (STAGE_CHUNK // 32) + 16)
# pixels a staged-kernel thread may hold, and the most threads of a block
# at each
_PIXELS_PER_THREAD = ((1, 1024), (2, 1024), (4, 1024), (8, 1024), (16, 768))

# launches of the staged kernel in this process (the launcher adds one per
# launch; the engine reads it to name its route, the tests to count)
LAUNCHES = 0

def _cdiv(a, b):
    return -(-a // b)


CornerLayout = namedtuple(
    "CornerLayout", "side stride corner_bytes smem_bytes staged bands band_rows"
)


def corner_layout(W):
    """The staged kernel's shared-memory layout for W×W windows.

    Window offsets are below 128, so a window reaches no further than row
    and column ``side = 128 + W - 1`` of its quad. ``stride = W + 128`` is
    congruent to W mod 32, which puts a warp's 32 consecutive pixels in 32
    distinct banks. The window's rows are cut into the fewest ``bands`` of
    ``band_rows`` rows whose staged rows fit a block, one block a band:
    band r holds window rows [r*band_rows, (r+1)*band_rows) and stages the
    ``127 + band_rows`` corner rows from row r*band_rows on
    (``corner_bytes``). One band, the whole ``side``-row corner, up to
    W = 110; two from 111 to 120. ``smem_bytes`` adds the chunk buffers,
    and ``staged`` says whether a block can take them."""
    side = B_TILE + W - 1
    stride = side + 1
    for bands in range(1, W + 1):
        band_rows = _cdiv(W, bands)
        corner_bytes = _cdiv((B_TILE - 1 + band_rows) * stride * 4, 16) * 16
        smem_bytes = corner_bytes + _STAGE_TAIL
        if smem_bytes <= SMEM_MAX:
            break
    return CornerLayout(side, stride, corner_bytes, smem_bytes,
                        smem_bytes <= SMEM_MAX, _cdiv(W, band_rows),
                        band_rows)


def pixels_per_thread(W):
    """``(P, threads)`` of the staged launch: the fewest pixels a thread
    holds such that one block covers a band of ``corner_layout(W)``
    (``band_rows`` × W pixels), and the block's threads (a whole number of
    warps)."""
    pixels = corner_layout(W).band_rows * W
    for P, most in _PIXELS_PER_THREAD:
        threads = _cdiv(_cdiv(pixels, P), 32) * 32
        if threads <= most:
            return P, threads
    raise ValueError(f"pixels_per_thread: no block covers W={W}")


def pack_snips(o1, o2, cid):
    """Pack per-snip (row offset < 128, col offset < 128, group id < 2^17)
    into the kernel's single int32 word: bits [24:31) row offset, [17:24)
    col offset, [0:17) group. Out-of-range fields would overflow into
    adjacent fields and decode as wrong offsets/groups with no error — fail
    loudly instead."""
    o1 = np.asarray(o1, np.int32)
    o2 = np.asarray(o2, np.int32)
    cid = np.asarray(cid, np.int32)
    if len(o1):
        assert o1.max(initial=0) < 128 and o1.min(initial=0) >= 0, (
            "pack_snips: row offset out of the 7-bit field (B must be 128)"
        )
        assert o2.max(initial=0) < 128 and o2.min(initial=0) >= 0, (
            "pack_snips: col offset out of the 7-bit field (B must be 128)"
        )
        assert cid.max(initial=0) < (1 << 17) and cid.min(initial=0) >= 0, (
            "pack_snips: group id out of the 17-bit field"
        )
    return (o1 << 24) | (o2 << 17) | cid


def _quad_spans(quads, counts, tile_map):
    """Each quad's four tile slots (order 00, 01, 10, 11) and span of the
    sorted stream, from the ascending unique quad ids and their counts."""
    ncol = tile_map.shape[1]
    t1, t2 = quads // ncol, quads % ncol
    k = np.stack(
        [tile_map[t1, t2], tile_map[t1, t2 + 1],
         tile_map[t1 + 1, t2], tile_map[t1 + 1, t2 + 1]],
        axis=1,
    ).astype(np.int32)
    starts = np.cumsum(counts) - counts
    return k, starts.astype(np.int32), np.asarray(counts, np.int32)


def _empty_sort(snips):
    return (snips, np.zeros((0, 4), np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.int32))


def sort_quads(r1, r2, cid, tile_map, B):
    """Sort a snip stream by (tile quad, group) and describe every quad.

    Returns ``(snips, k, qstart, qcount)``: the sorted packed words (int32
    [n]), each quad's four tile slots ``k`` (int32 [nq, 4], order 00, 01,
    10, 11), and the span ``[qstart, qstart+qcount)`` of its snips. Within
    a quad the snips of one group are contiguous; within a group they keep
    input order.

    Two stable passes of the native counting sort (``native.quad_sort``):
    by group, then by quad, whose histogram is the per-quad count; the
    order is ``sort_quads_plain``'s bit for bit. Past 2^23 quad ids (the
    reference's limit for the counting sort) the plain version runs."""
    from .. import native

    ncol = tile_map.shape[1]
    nbuckets = (tile_map.shape[0] - 1) * ncol + 1
    if nbuckets > 1 << 23:
        return sort_quads_plain(r1, r2, cid, tile_map, B)
    r1a = np.asarray(r1, np.int64)
    r2a = np.asarray(r2, np.int64)
    packed = pack_snips(r1a % B, r2a % B, cid)
    n = len(packed)
    if n == 0:
        return _empty_sort(packed)
    quad = ((r1a // B) * ncol + (r2a // B)).astype(np.int32)
    group = packed & 0x1FFFF
    by_group, _ = native.quad_sort(group, np.arange(n, dtype=np.int32),
                                   int(group.max()) + 1)
    snips, counts = native.quad_sort(quad[by_group], packed[by_group],
                                     nbuckets)
    quads = np.flatnonzero(counts)
    return (snips, *_quad_spans(quads, counts[quads], tile_map))


def sort_quads_plain(r1, r2, cid, tile_map, B):
    """Plain numpy version of ``sort_quads``: one stable argsort of
    ``(quad << 17) | group``."""
    ncol = tile_map.shape[1]
    r1a = np.asarray(r1, np.int64)
    r2a = np.asarray(r2, np.int64)
    packed = pack_snips(r1a % B, r2a % B, cid)
    quad = (r1a // B) * ncol + (r2a // B)
    order = np.argsort((quad << 17) | (packed & 0x1FFFF), kind="stable")
    snips = packed[order]
    qs = quad[order]
    n = len(snips)
    if n == 0:
        return _empty_sort(snips)
    starts = np.concatenate([[0], np.flatnonzero(np.diff(qs)) + 1])
    counts = np.diff(np.concatenate([starts, [n]]))
    return (snips, *_quad_spans(qs[starts], counts, tile_map))


def split_items(k, qstart, qcount, item_max=ITEM_MAX):
    """Cut each quad's snips into work items of at most ``item_max`` snips,
    whatever their groups: a quad of n snips gives ceil(n / item_max) items
    of equal length (the last may be shorter). Returns ``(k, start, count)``
    per item. Inside an item the snips keep ``sort_quads``' order, sorted by
    group; the staged kernel flushes at each change of group."""
    qcount = np.asarray(qcount, np.int64)
    pieces = _cdiv(qcount, item_max)
    size = _cdiv(qcount, np.maximum(pieces, 1))
    quad_of = np.repeat(np.arange(len(qcount)), pieces)
    first = np.repeat(np.cumsum(pieces) - pieces, pieces)
    off = (np.arange(len(quad_of)) - first) * size[quad_of]
    start = np.asarray(qstart, np.int64)[quad_of] + off
    count = np.minimum(qcount[quad_of] - off, size[quad_of])
    return k[quad_of], start.astype(np.int32), count.astype(np.int32)


def stage_corner_plain(stiles, k4, W, band=0):
    """Plain PyTorch version of the staged kernel's copy: the rows of the
    corner of one quad that band ``band`` of W×W windows can reach
    (``corner_layout``), as float32 [127 + rows, stride] from corner row
    ``band * band_rows`` on, where ``rows`` is the band's window rows; bits
    untouched. The whole corner is all of tile ``k4[0]``, W - 1 columns of
    ``k4[1]``, W - 1 rows of ``k4[2]`` and the (W - 1)² corner of
    ``k4[3]``, [side, stride], which is band 0 where there is one band; the
    columns past ``side`` are zero. The pixel (i, j) of the window at
    offsets (a, b) is element ``(a*stride + b) + ((i - band * band_rows) *
    stride + j)`` of the flattened band (``corner_offsets``)."""
    lay = corner_layout(W)
    t00, t01, t10, t11 = (stiles[int(s)] for s in k4)
    corner = torch.zeros((lay.side, lay.stride), dtype=stiles.dtype,
                         device=stiles.device)
    corner[:B_TILE, :B_TILE] = t00
    corner[:B_TILE, B_TILE:lay.side] = t01[:, :W - 1]
    corner[B_TILE:, :B_TILE] = t10[:W - 1]
    corner[B_TILE:, B_TILE:lay.side] = t11[:W - 1, :W - 1]
    row0 = band * lay.band_rows
    rows = min(lay.band_rows, W - row0)
    return corner[row0:row0 + B_TILE - 1 + rows]


def corner_offsets(snips, W, stride):
    """What the staged kernel decodes and what each thread holds: per snip
    word the corner offset ``a*stride + b`` and the group, and per window
    pixel the offset ``i*stride + j`` ([W*W], row-major), as int64 tensors
    on ``snips.device``."""
    w = snips.to(torch.int64)
    ar = torch.arange(W, device=snips.device)
    pix = (ar[:, None] * stride + ar[None, :]).reshape(-1)
    return (w >> 24) * stride + ((w >> 17) & 0x7F), w & 0x1FFFF, pix


def quad_accumulate_banded_plain(stiles, k, qstart, qcount, snips, W, C,
                                 chunk=256):
    """Plain PyTorch version of the staged kernel's addressing, for tests:
    per work item and band of ``corner_layout(W)``, the band's staged rows
    (``stage_corner_plain``), then each window pixel of the band read at
    its corner offset plus its pixel offset (``corner_offsets``) and added
    as ``quad_accumulate_plain`` adds it, in float64 and in the same order
    (items in turn, their snips in turn), ``chunk`` snips a gather. Returns
    float64 ``(sum, num)`` [C, W, W], ``quad_accumulate_plain``'s bits."""
    lay = corner_layout(W)
    out_sum = torch.zeros((C, W * W), dtype=torch.float64,
                          device=stiles.device)
    out_num = torch.zeros_like(out_sum)
    for kk, s, c in zip(k.tolist(), qstart.tolist(), qcount.tolist()):
        off, g, pix = corner_offsets(snips[s:s + c], W, lay.stride)
        for band in range(lay.bands):
            flat = stage_corner_plain(stiles, kk, W, band).reshape(-1)
            lo = band * lay.band_rows * W
            hi = min(lo + lay.band_rows * W, W * W)
            bpix = pix[lo:hi] - band * lay.band_rows * lay.stride
            for e in range(0, c, chunk):
                v = flat[off[e:e + chunk, None] + bpix[None, :]]
                fin = v == v
                ge = g[e:e + chunk]
                out_sum[:, lo:hi].index_add_(
                    0, ge, torch.where(fin, v, 0.0).to(torch.float64))
                out_num[:, lo:hi].index_add_(
                    0, ge, (fin & (v.abs() != torch.inf)).to(torch.float64))
    return out_sum.reshape(C, W, W), out_num.reshape(C, W, W)


def quad_accumulate_plain(stiles, k, qstart, qcount, snips, W, C):
    """Plain PyTorch version of the quad gather-accumulate, on any device.

    Decodes each snip's packed word, gathers its [W, W] window from the four
    tiles of its quad by index arithmetic into ``stiles`` ([K, 128, 128]
    float32), and adds ``where(v==v, v, 0)`` to ``sum[g]`` and ``(v==v) &
    (|v| != inf)`` to ``num[g]`` with ``index_add_`` in float64, at most
    PLAIN_CHUNK snips at a time. Returns float64 ``(sum, num)`` [C, W, W]."""
    device = stiles.device
    out_sum = torch.zeros((C, W, W), dtype=torch.float64, device=device)
    out_num = torch.zeros((C, W, W), dtype=torch.float64, device=device)
    qcount = qcount.to(torch.int64)
    n = int(qcount.sum())
    if n == 0:
        return out_sum, out_num
    item = torch.repeat_interleave(
        torch.arange(len(qcount), device=device), qcount
    )
    first = torch.cumsum(qcount, 0) - qcount
    pos = qstart.to(torch.int64)[item] + (
        torch.arange(n, device=device) - first[item]
    )
    flat = stiles.reshape(-1)
    ar = torch.arange(W, device=device)
    for lo in range(0, n, PLAIN_CHUNK):
        sl = slice(lo, min(lo + PLAIN_CHUNK, n))
        w = snips[pos[sl]].to(torch.int64)
        a, b, g = w >> 24, (w >> 17) & 0x7F, w & 0x1FFFF
        r = a[:, None] + ar[None, :]  # [m, W]
        c = b[:, None] + ar[None, :]
        slot = (r >= B_TILE)[:, :, None] * 2 + (c >= B_TILE)[:, None, :]
        kk = k[item[sl]].to(torch.int64)
        tile = torch.gather(kk, 1, slot.reshape(len(w), -1))
        tile = tile.reshape(slot.shape)
        idx = (tile * B_TILE + (r % B_TILE)[:, :, None]) * B_TILE + (
            c % B_TILE
        )[:, None, :]
        v = flat[idx]
        fin = v == v
        out_sum.index_add_(0, g, torch.where(fin, v, 0.0).to(torch.float64))
        out_num.index_add_(
            0, g, (fin & (v.abs() != torch.inf)).to(torch.float64)
        )
    return out_sum, out_num


def _check_kernel_args(stiles, k, qstart, qcount, snips, W, C):
    if not 1 <= W <= W_MAX:
        raise ValueError(f"quad_accumulate: W={W} outside [1, {W_MAX}]")
    if not 1 <= C <= C_MAX:
        raise ValueError(f"quad_accumulate: C={C} outside [1, {C_MAX}]")
    if stiles.dtype != torch.float32 or stiles.dim() != 3 or tuple(
        stiles.shape[1:]
    ) != (B_TILE, B_TILE):
        raise ValueError(
            "quad_accumulate: stiles must be float32 [K, 128, 128], got "
            f"{stiles.dtype} {tuple(stiles.shape)}"
        )
    nq = qstart.shape[0]
    if tuple(k.shape) != (nq, 4) or tuple(qcount.shape) != (nq,):
        raise ValueError(
            "quad_accumulate: k must be [nq, 4] and qstart/qcount [nq], got "
            f"{tuple(k.shape)}, {tuple(qstart.shape)}, {tuple(qcount.shape)}"
        )
    for name, t in (("stiles", stiles), ("k", k), ("qstart", qstart),
                    ("qcount", qcount), ("snips", snips)):
        if t.device != stiles.device:
            raise ValueError(f"quad_accumulate: {name} on {t.device}, "
                             f"stiles on {stiles.device}")
        if not t.is_contiguous():
            raise ValueError(f"quad_accumulate: {name} is not contiguous")
        if name != "stiles" and t.dtype != torch.int32:
            raise ValueError(f"quad_accumulate: {name} must be int32, "
                             f"got {t.dtype}")


def quad_accumulate_staged(stiles, k, qstart, qcount, snips, W, C):
    """One launch of the staged kernel (the reachable corner of each item's
    quad, or of each band of its window rows, copied into shared memory;
    ``corner_layout(W).bands`` blocks an item, ``pixels_per_thread(W)``
    pixels a thread) on CUDA tensors. An item may hold many groups, sorted
    by group (``split_items``), and any number of snips. Zeroes float32
    ``sum`` and int32 ``num`` [C, W, W] on the card, launches over them and
    counts the launch; returns them, and raises where the launch fails."""
    global LAUNCHES
    _check_kernel_args(stiles, k, qstart, qcount, snips, W, C)
    if stiles.device.type != "cuda":
        raise ValueError(
            f"quad_accumulate_staged: no kernel for {stiles.device}"
        )
    from ..kernels.build import load_kernels

    lib = load_kernels()
    lay = corner_layout(W)
    out_sum = torch.zeros((C, W, W), dtype=torch.float32, device=stiles.device)
    out_num = torch.zeros((C, W, W), dtype=torch.int32, device=stiles.device)
    nq = int(qstart.shape[0])
    if nq:
        # the launcher sets the kernel's device and restores the caller's;
        # the guard keeps a launch on another card from changing PyTorch's
        # current device as well
        with torch.cuda.device(stiles.device):
            err = lib.quad_accumulate_staged_launch(
                stiles.data_ptr(), k.data_ptr(), qstart.data_ptr(),
                qcount.data_ptr(), snips.data_ptr(), nq, W, C, lay.stride,
                lay.band_rows, pixels_per_thread(W)[0], lay.smem_bytes,
                out_sum.data_ptr(), out_num.data_ptr(),
                torch.cuda.current_stream(stiles.device).cuda_stream,
                stiles.device.index,
            )
        if err != 0:
            msg = lib.quad_accumulate_error_string(err).decode()
            raise RuntimeError(
                "quad_accumulate_staged: kernel launch failed, CUDA "
                f"error {err} ({msg})"
            )
        LAUNCHES += 1
    return out_sum, out_num


def quad_accumulate(stiles, k, qstart, qcount, snips, W, C):
    """Per-group window sums and finite counts over quad-sorted snips.

    ``stiles`` float32 [K, 128, 128] (NaN-encoded), ``k`` int32 [nq, 4] tile
    slots per item, ``qstart``/``qcount`` int32 [nq] spans into ``snips``
    (int32 packed words, ``pack_snips``). Returns float64 ``(sum, num)``
    [C, W, W] on ``stiles.device``.

    A CPU tensor runs ``quad_accumulate_plain``, which takes items of any
    shape. A CUDA tensor launches the staged kernel (built at first use),
    whose items may hold many groups (``split_items``, as
    ``QuadPileupSession.stage`` cuts them), and raises on any failure."""
    if stiles.device.type == "cpu":
        _check_kernel_args(stiles, k, qstart, qcount, snips, W, C)
        return quad_accumulate_plain(stiles, k, qstart, qcount, snips, W, C)
    out_sum, out_num = quad_accumulate_staged(stiles, k, qstart, qcount,
                                              snips, W, C)
    return out_sum.to(torch.float64), out_num.to(torch.float64)


class QuadPileupSession:
    """Device-resident state for repeated accumulations over one region
    (counterpart of ``PallasPileupSession`` for ``SymTileStack``,
    ``TileStack`` and ``CooTileStack`` inputs): the raw tiles (or the COO
    wire's pixels) are uploaded once, expanded or scattered and normalized
    on ``device``; each ``run_many`` quad-sorts one snip stream on the host
    and accumulates it on the device. ``finalize`` reduces the
    collected outputs to float64 numpy totals plus the poison plane.

    ``cfg_kw`` holds ``W`` and ``capacity`` (C, the accumulator rows) and
    the normalization keys ``ooe``, ``cis``, ``ignore_diags`` and
    ``frame_shift``, and the upload wire as the reference's
    ``PallasPileupSession`` takes it: ``tile_f16`` in {False, "exact",
    "lossy", "int8"} (``ops/tiles.upload_tiles``) for an upper-triangle or
    dense stack (a COO wire carries its own cast), and ``fold_weights``
    (the int8 wire's raw counts, ``valid1``/``valid2`` then the balancing
    weights) for an upper-triangle stack only. ``wire`` lists the dtype
    names of the uploaded payload (``tiles.normalized_stack``)."""

    def __init__(self, tile_stack, valid1, valid2, evec, cfg_kw, device):
        from .tiles import normalized_stack

        cfg_kw = dict(cfg_kw)
        self.W = int(cfg_kw.pop("W"))
        self.C = int(cfg_kw.pop("capacity"))
        norm = dict(
            ooe=bool(cfg_kw.pop("ooe", False)),
            cis=bool(cfg_kw.pop("cis", True)),
            ignore_diags=int(cfg_kw.pop("ignore_diags", 2)),
            frame_shift=int(cfg_kw.pop("frame_shift", 0)),
            fold_weights=bool(cfg_kw.pop("fold_weights", False)),
            f16_mode=cfg_kw.pop("tile_f16", False),
        )
        if cfg_kw:
            raise TypeError(
                f"QuadPileupSession: unknown cfg_kw {sorted(cfg_kw)}"
            )
        if tile_stack.B != B_TILE:
            raise ValueError(f"QuadPileupSession: B must be {B_TILE}")
        if not 1 <= self.W <= W_MAX:
            raise ValueError(
                f"QuadPileupSession: W={self.W} outside [1, {W_MAX}]"
            )
        if not 1 <= self.C <= C_MAX:
            raise ValueError(f"QuadPileupSession: capacity={self.C} outside "
                             f"[1, {C_MAX}]")
        self.device = torch.device(device)
        self.tile_stack = tile_stack
        self.tile_map = tile_stack.tile_map
        self.wire = []
        self.stiles = normalized_stack(
            tile_stack, valid1, valid2, evec, self.device, wire=self.wire,
            **norm
        )

    @classmethod
    def from_normalized(cls, stiles, tile_map, W, capacity):
        """A session over a stack already normalized on its device
        (``stiles``, with ``tile_map`` the [nr+1, nc+1] host grid of its
        slots): one device's band or replica of a region on a mesh
        (``parallel/quad_mesh.QuadMeshSession``)."""
        self = cls.__new__(cls)
        self.W, self.C = int(W), int(capacity)
        self.device = stiles.device
        self.tile_stack = None
        self.wire = []
        self.tile_map = np.asarray(tile_map)
        self.stiles = stiles
        return self

    def stage(self, r1, r2, cid):
        """Host quad sort + work-item split (``split_items``), uploaded to
        the device: the ``(k, qstart, qcount, snips)`` arguments of
        ``quad_accumulate``."""
        cid = np.asarray(cid)
        if len(cid) and (cid.min() < 0 or cid.max() >= self.C):
            raise ValueError(
                f"QuadPileupSession: group ids must lie in [0, {self.C})"
            )
        # a negative start would wrap around the tile map unnoticed
        if len(cid) and (np.min(r1) < 0 or np.min(r2) < 0):
            raise ValueError("QuadPileupSession: negative window start")
        snips, k, qstart, qcount = sort_quads(
            r1, r2, cid, self.tile_map, B_TILE
        )
        k, qstart, qcount = split_items(k, qstart, qcount)
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)
            for a in (k, qstart, qcount, snips)
        )

    def run_many(self, r1, r2, cid, fetch=True):
        """All snips in one accumulation. With ``fetch`` false, returns the
        device accumulators ``{"sum", "num"}`` for ``finalize``."""
        k, qstart, qcount, snips = self.stage(r1, r2, cid)
        s, n = quad_accumulate(self.stiles, k, qstart, qcount, snips,
                               self.W, self.C)
        out = {"sum": s, "num": n}
        return self.finalize([out]) if fetch else out

    def run(self, r1, r2, dd0=None, cid=None, fetch=True):
        """One snip batch (dd0 unused: distance banding is encoded in cid)."""
        return self.run_many(r1, r2, cid, fetch=fetch)

    def run_stripes(self, r1, r2, chunk=STRIPE_CHUNK, f16=False):
        """Per-snip stripe planes in stream order (counterpart of
        ``PallasPileupSession.run_stripes(hv=True)``, reference
        coolpup.py:1164–1188): float32 numpy [n, 2W], the centre row
        ``M[a+mid, b:b+W]`` then the centre column ``M[a:a+W, b+mid]``
        (unreversed; callers reverse it), for the window starting at
        (a, b), ``chunk`` snips at a time (``stripes_device``) to bound the
        index tensors. ``f16`` fetches the planes as float16 (the
        reference's stripe wire) and upcasts them on the host."""
        out = np.empty((len(r1), 2 * self.W), np.float32)
        for lo in range(0, len(r1), chunk):
            hi = min(lo + chunk, len(r1))
            out[lo:hi] = self.stripes_device(r1[lo:hi], r2[lo:hi],
                                             f16=f16).cpu().numpy()
        return out

    def stripes_device(self, r1, r2, f16=False):
        """The stripe planes of ``run_stripes`` for one chunk of snips, as a
        float32 [n, 2W] tensor on the session's device: gathered as torch
        ops from the normalized NaN-encoded stack through the tile map, so
        masked pixels are NaN and poison stays +inf. ``f16`` casts them to
        float16 on the device, with no scale (reference
        ``make_stripe_gather_hv(W, B, True)``)."""
        if not hasattr(self, "_tmap_dev"):
            self._tmap_dev = torch.from_numpy(
                np.asarray(self.tile_map, np.int64)
            ).to(self.device)
        a = torch.from_numpy(np.asarray(r1, np.int64)).to(self.device)
        b = torch.from_numpy(np.asarray(r2, np.int64)).to(self.device)
        hv = torch.cat(centre_lines(self.stiles, self._tmap_dev, a, b,
                                    self.W), dim=1)
        return hv.to(torch.float16) if f16 else hv

    @staticmethod
    def finalize(outs, compact=None):
        """Reduce a list of ``run_many(fetch=False)`` outputs to float64 numpy
        totals. ``compact=(G, half)`` keeps rows [0:G] and [half:half+G]
        (the unflipped and flip banks) before the fetch. Poison rides the
        sums as +inf; ``poison`` is the explicit 0/1 plane."""
        total = dict(outs[0])
        for o in outs[1:]:
            total = {k: total[k] + o[k] for k in total}
        if compact is not None:
            G, half = compact
            total = {
                k: torch.cat([v[:G], v[half : half + G]])
                for k, v in total.items()
            }
        res = {k: v.to(torch.float64).cpu().numpy() for k, v in total.items()}
        res["poison"] = np.isinf(res["sum"]).astype(np.float64)
        return res


def centre_lines(stiles, tmap, a, b, W):
    """The centre row and the centre column of the W x W windows starting
    at ``(a, b)`` (int64 tensors on the device of ``stiles``), gathered
    through the device tile map ``tmap``: two [n, W] tensors, the column
    top to bottom, values as the stack holds them."""
    B, mid = B_TILE, W // 2
    ar = torch.arange(W, device=stiles.device)
    row = (a + mid)[:, None]  # horizontal: one row, W columns
    col = b[:, None] + ar[None, :]
    h = stiles[tmap[row // B, col // B], row % B, col % B]
    row = a[:, None] + ar[None, :]  # vertical: W rows, one column
    col = (b + mid)[:, None]
    v = stiles[tmap[row // B, col // B], row % B, col % B]
    return h, v


def stripes_host(stiles, tile_map, r1, r2, W):
    """Host oracle of ``QuadPileupSession.run_stripes``: cut every window
    from a host copy of the normalized stack (``assemble_windows_batch``)
    and take its centre row and centre column. Returns float32 [n, 2W]."""
    from .tiles import assemble_windows_batch

    win = assemble_windows_batch(
        np.asarray(stiles), tile_map, B_TILE, r1, r2, W
    )
    mid = W // 2
    return np.concatenate([win[:, mid, :], win[:, :, mid]], axis=1)


def run_quad_pileup(tile_stack, r1, r2, dd0, cid, valid1, valid2, evec,
                    cfg_kw, device="cuda"):
    """One-shot wrapper around QuadPileupSession (counterpart of
    ``run_pallas_pileup``). Runs on the card and raises without one;
    ``device="cpu"`` runs the plain PyTorch version."""
    session = QuadPileupSession(tile_stack, valid1, valid2, evec, cfg_kw,
                                resolve_device(device))
    return session.run(r1, r2, dd0, cid)
