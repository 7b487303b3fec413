"""Block-sparse tile stacks (counterpart of ``coolpuppy_tpu/ops/tiles.py``).

The host half is copied from the reference: the tile dataclasses, the tile
predicates (the windows' touched tiles, a |row - col| band, rectangles of
bin ranges), the COO and pixel-slab scatters into upper-triangle or full
tile stacks, the sparse COO wire (``CooTileStack``), and the host oracles
``normalize_tile_stack`` and ``assemble_windows_batch``. It is copied, not
imported, because importing any ``coolpuppy_tpu`` module imports jax. The
scatters run the port's native C++ (``coolpuppy_tpu_torch/native``) as the
reference does: ``scatter`` and ``scatter_slab``, looked up in this module
at call time. Their numpy branches stay as the plain versions
``scatter_plain`` and ``scatter_slab_plain`` (balancing weights folded in
float64 where the C++ folds them in float32), which the tests hold the
native entries against.

The upload wire is copied too: ``f16_wire_plan``, ``cast_slab_f16``,
``cast_tiles_f16`` and ``cast_tiles_int8`` pick a power-of-two scale and
cast the raw tiles to float16 (``"exact"``: only where the round trip is
exact; ``"lossy"``: at most 2^-11 relative error a value) or ship raw
integer counts as int8. The float16 scan and cast are native
(``native.abs_max``, ``native.cast_f16``: one pass each, the cast's round
trip checked in the same registers); the reference's numpy cast stays as
``cast_slab_f16_plain``, which the tests hold the native cast against.
``upload_tiles`` runs the cast per slab of ``UPLOAD_SLAB`` tiles straight
into a pinned buffer and starts each slab's copy as soon as it is cast, so
the cast overlaps the transfer.

The device half ports the reference's jnp functions as torch ops:
``expand_sym`` (upper tiles -> full raw stack), ``coo_tiles`` (the COO wire
scatter-added into the raw stack), ``normalize_tiles`` (raw stack -> one
NaN-encoded observed-over-expected stack; ``fold_weights`` folds the
balancing weights of the int8 wire), ``normalized_stack`` (a host tile
stack of any of the three kinds uploaded, expanded and normalized) and
``cut_windows`` (windows of any size cut from that stack through its tile
map: the generic and rescale paths, in place of the reference's bucket
restack and 2×2 superwindows).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..device import resolve_device


@dataclass
class TileStack:
    tiles: np.ndarray  # [K, B, B] float32; tiles[0] is all zeros
    tile_map: np.ndarray  # [nr+1, nc+1] int32 -> stack index (0 = empty)
    B: int
    shape: tuple  # logical (n1, n2) of the region matrix

    @property
    def n_tiles(self):
        return self.tiles.shape[0] - 1


@dataclass
class SymTileStack:
    """Upper-triangle tile storage for SYMMETRIC (cis) regions: only tiles
    with tile_row <= tile_col are scattered; ``expand_sym`` materializes the
    full stack as ``full[k] = upper[src[k]]`` (transposed where ``flip[k]``,
    symmetrized where ``diag[k]`` and the scatter held only the stored
    upper half)."""

    upper: np.ndarray  # [Ku+1, B, B] float32; slot 0 all zeros
    tile_map: np.ndarray  # [nr+1, nc+1] -> FULL stack index (0 = empty)
    src: np.ndarray  # [K+1] full slot -> upper slot
    flip: np.ndarray  # [K+1] bool: transpose upper[src]
    diag: np.ndarray  # [K+1] bool: tile_row == tile_col
    diag_full: bool  # diagonal tiles already hold both halves
    B: int
    shape: tuple

    @property
    def n_tiles(self):
        return len(self.src) - 1

    def expand_host(self):
        """Materialize the full [K+1, B, B] stack on the host."""
        g = self.upper[self.src]
        gt = np.transpose(g, (0, 2, 1))
        full = np.where(self.flip[:, None, None], gt, g)
        if not self.diag_full:
            eye = np.eye(self.B, dtype=g.dtype)
            sym = g + gt - g * eye
            full = np.where(self.diag[:, None, None], sym, full)
        return full.astype(np.float32)

    def to_tile_stack(self):
        return TileStack(
            tiles=self.expand_host(), tile_map=self.tile_map, B=self.B,
            shape=self.shape,
        )


def from_reference(ts):
    """The port's tile stack from a reference ``TileStack`` or
    ``SymTileStack``, read by duck-typing its numpy fields (the reference
    class is never imported). Together with the per-bin ``valid``/``evec``
    vectors, the tile stack is the whole state a pileup runs on."""
    if hasattr(ts, "upper") and hasattr(ts, "src"):
        return SymTileStack(
            upper=np.asarray(ts.upper, np.float32),
            tile_map=np.asarray(ts.tile_map, np.int32),
            src=np.asarray(ts.src, np.int32),
            flip=np.asarray(ts.flip, bool),
            diag=np.asarray(ts.diag, bool),
            diag_full=bool(ts.diag_full),
            B=int(ts.B),
            shape=tuple(ts.shape),
        )
    if hasattr(ts, "tiles"):
        return TileStack(
            tiles=np.asarray(ts.tiles, np.float32),
            tile_map=np.asarray(ts.tile_map, np.int32),
            B=int(ts.B),
            shape=tuple(ts.shape),
        )
    raise TypeError(
        f"from_reference: {type(ts).__name__} is neither a TileStack nor a "
        "SymTileStack"
    )


# -- the upload wire (reference ops/tiles.py:85-169) ------------------------

# tiles a slab of the f16/int8 upload (``upload_tiles``): 8 MB of float16
UPLOAD_SLAB = 256


def f16_wire_plan(tiles, mode):
    """Scan-only half of ``cast_tiles_f16``: pick the pow2 scale (or
    refuse). Returns ``(scale, inv)`` or None. The scan is one native pass
    over the float32 payload (``native.abs_max``: the largest |value|, NaN
    skipped), in place of numpy's ``nanmax`` of a copy of ``|tiles|``. The
    multiply and f16 cast then run per upload slab (``cast_slab_f16``), so
    they overlap the copies instead of running in front of them."""
    if not mode or tiles.size == 0:
        return None
    amax = native.abs_max(tiles)
    if np.isinf(amax):
        return None
    if amax == 0.0:  # all-zero / all-NaN
        return np.float32(1.0), np.float32(1.0)
    scale = np.float32(2.0 ** (13 - int(np.ceil(np.log2(amax) + 1e-12))))
    return scale, np.float32(1.0 / scale)


def cast_slab_f16_plain(arr, scale, mode):
    """Plain numpy version of ``cast_slab_f16`` (the reference's): the
    multiply and the float16 cast, and for ``"exact"`` the cast back, the
    multiply by the inverse and the comparison, each a pass of its own;
    None on any mismatch."""
    wire = (arr * scale).astype(np.float16)
    if mode == "exact":
        rt = wire.astype(np.float32) * np.float32(1.0 / float(scale))
        if not np.array_equal(rt, arr, equal_nan=True):
            return None
    return wire


def cast_slab_f16(arr, scale, mode, out=None):
    """Cast one float32 slab with a pre-planned scale (``f16_wire_plan``)
    in one native pass (``native.cast_f16``, F16C where the host has it):
    ``float16(arr * scale)`` rounded to nearest even, the bits of
    ``cast_slab_f16_plain``, written into ``out`` (a float16 array of
    ``arr``'s shape: the slab's part of the pinned upload buffer) or a new
    array, which is returned. For ``mode == "exact"`` the same pass
    verifies the round trip and returns None on any mismatch (the caller
    then ships the whole payload float32)."""
    if out is None:
        out = np.empty(arr.shape, np.float16)
    inv = np.float32(1.0 / float(scale))
    if not native.cast_f16(arr, scale, inv, mode == "exact", out):
        return None
    return out


def cast_tiles_f16(tiles, mode):
    """The float16 wire of a raw tile payload, with a power-of-2 scale that
    puts the largest |value| near 2^13 (pow2 scaling is exact both ways).

    ``mode``: falsy -> None (ship float32); ``"exact"`` -> float16 only when
    the scaled round trip is bit-exact (always true for integer counts <=
    2048), else None; ``"lossy"`` -> float16 with at most 2^-11 relative
    error a value (balanced or OOE-divided values). Returns ``(wire,
    inv_scale)`` or None; the device multiplies by ``inv_scale`` after
    upconverting."""
    if not mode:
        return None
    if tiles.size == 0:
        return tiles.astype(np.float16), np.float32(1.0)
    plan = f16_wire_plan(tiles, mode)
    if plan is None:
        return None
    scale, inv = plan
    wire = cast_slab_f16(tiles, scale, mode)
    if wire is None:
        return None
    return wire, inv


def cast_tiles_int8(tiles):
    """The int8 wire of RAW integer count tiles (weights not folded): exact
    when every value is an integer in [-127, 127]. A quarter of the float32
    payload; the device folds the balancing weights while normalizing
    (``fold_weights``). Returns the int8 array or None."""
    if tiles.size == 0:
        return tiles.astype(np.int8)
    amax = float(tiles.max())
    amin = float(tiles.min())
    if not (np.isfinite(amax) and np.isfinite(amin)):
        return None
    if amin < -127 or amax > 127:
        return None
    wire = tiles.astype(np.int8)
    if not np.array_equal(wire.astype(np.float32), tiles):
        return None
    return wire


def _upload_slabs(tiles, device, cast, dtype):
    """``tiles`` cast slab by slab (``cast(slab, dst)`` writes the slab's
    wire into ``dst``, its part of one host buffer of numpy ``dtype``, and
    returns False to refuse) and copied to ``device``: on a CUDA device the
    buffer is pinned and each slab's copy starts as soon as it is cast.
    Returns the device tensor, or None where ``cast`` refused a slab."""
    K = tiles.shape[0]
    cuda = torch.device(device).type == "cuda"
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    host = torch.empty(tiles.shape, dtype=tdtype, pin_memory=cuda)
    out = torch.empty(tiles.shape, dtype=tdtype, device=device) if cuda \
        else host
    hn = host.numpy()
    for lo in range(0, K, UPLOAD_SLAB):
        hi = min(lo + UPLOAD_SLAB, K)
        if not cast(tiles[lo:hi], hn[lo:hi]):
            return None
        if cuda:
            out[lo:hi].copy_(host[lo:hi], non_blocking=True)
    return out


def _int8_into(slab, dst):
    """``cast_tiles_int8`` of a slab copied into ``dst``; False where it
    refuses."""
    wire = cast_tiles_int8(slab)
    if wire is None:
        return False
    dst[...] = wire
    return True


def upload_tiles(tiles, f16_mode, device):
    """Raw tiles [K, B, B] (float32 numpy) on ``device`` through the upload
    wire of ``f16_mode`` (the reference's ``tile_f16`` values): False ships
    float32; ``"exact"``/``"lossy"`` ship scaled float16 where
    ``cast_tiles_f16`` allows it, cast natively straight into the pinned
    buffer (``cast_slab_f16``); ``"int8"`` ships int8 where
    ``cast_tiles_int8`` allows it, else ``"exact"`` float16 (raw integer
    counts). A refused cast ships float32. Returns ``(tensor in the wire's
    dtype, inv)``: the device multiplies by ``inv`` after upconverting."""
    one = np.float32(1.0)
    if f16_mode == "int8":
        out = _upload_slabs(tiles, device, _int8_into, np.int8)
        if out is not None:
            return out, one
        f16_mode = "exact"  # misjudged: raw integer counts still f16-exact
    if f16_mode:
        plan = (one, one) if tiles.size == 0 else f16_wire_plan(tiles,
                                                                 f16_mode)
        if plan is not None:
            scale, inv = plan
            out = _upload_slabs(
                tiles, device,
                lambda a, dst: cast_slab_f16(a, scale, f16_mode,
                                             out=dst) is not None,
                np.float16)
            if out is not None:
                return out, inv
    t = torch.from_numpy(np.ascontiguousarray(tiles, np.float32))
    return t.to(device), one


def _upconvert(t, inv):
    """A wire payload as float32 times ``inv`` (skipped at 1, where it is
    the identity)."""
    t = t.to(torch.float32)
    return t if float(inv) == 1.0 else t * float(inv)


def _sym_maps(want, nr, nc):
    """Build the full tile_map plus (src, flip, diag) expansion metadata and
    the upper scatter map for an upper-triangle build."""
    tr, tc = want // nc, want % nc
    K = len(want)
    tile_map = np.zeros((nr + 1, nc + 1), dtype=np.int32)
    tile_map[tr, tc] = np.arange(1, K + 1, dtype=np.int32)

    lo = np.minimum(tr, tc)
    hi = np.maximum(tr, tc)
    ukey = lo.astype(np.int64) * nc + hi
    uniq, inv = np.unique(ukey, return_inverse=True)
    Ku = len(uniq)
    utile_map = np.zeros((nr + 1, nc + 1), dtype=np.int32)
    utile_map[uniq // nc, uniq % nc] = np.arange(1, Ku + 1, dtype=np.int32)

    src = np.zeros(K + 1, np.int32)
    src[1:] = inv + 1
    flip = np.zeros(K + 1, bool)
    flip[1:] = tr > tc
    diag = np.zeros(K + 1, bool)
    diag[1:] = tr == tc
    return tile_map, utile_map, src, flip, diag, Ku


def touched_tiles(r1, r2, window1, window2, B, shape):
    """Set of (tile_row, tile_col) touched by windows starting at (r1, r2)
    with heights window1 and widths window2 (arrays or scalars), as flat
    ids ``tile_row * nc + tile_col``; windows may span any number of
    tiles."""
    n1, n2 = shape
    nr, nc = -(-n1 // B), -(-n2 // B)
    w1 = np.broadcast_to(np.asarray(window1), np.shape(r1))
    w2 = np.broadcast_to(np.asarray(window2), np.shape(r2))
    r1, r2 = np.asarray(r1), np.asarray(r2)

    def lines(ta, tb):
        # each window's first and last tile on one axis (the four corner
        # tiles of the reference, for windows narrower than B) and, for
        # wider windows (rescale extents, W > B), the d-th tile between
        # them, min(ta + d, tb)
        span = int((tb - ta).max(initial=0))
        mids = [np.minimum(ta + d, tb) for d in range(1, span)]
        return [t.astype(np.int64, copy=False)
                for t in ([ta, *mids, tb] if span else [ta])]

    rows = lines(r1 // B, (r1 + w1 - 1) // B)
    cols = lines(r2 // B, (r2 + w2 - 1) // B)
    flags = np.zeros(nr * nc, dtype=bool)
    for rr in rows:
        rr = rr * nc
        for cc in cols:
            flags[rr + cc] = True
    return np.flatnonzero(flags), nr, nc


def _want_tiles(rows, cols, B, shape, r1, r2, window1, window2):
    n1, n2 = shape
    nr, nc = -(-n1 // B), -(-n2 // B)
    if r1 is not None:
        return touched_tiles(r1, r2, window1, window2, B, (n1, n2))
    want = np.unique(
        (rows.astype(np.int64) // B) * nc + cols.astype(np.int64) // B
    )
    return want, nr, nc


def scatter_plain(rows, cols, vals, tmap, B, K):
    """Plain numpy version of ``scatter``: bincount-scatter COO pixels
    into [K+1, B, B] float32 tiles (sums in float64, one cast) through a
    (tile_row, tile_col) -> slot map; pixels on unmapped tiles are
    dropped."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    pix_tile = tmap[rows // B, cols // B].astype(np.int64)
    keep = pix_tile > 0
    flat_idx = (
        pix_tile[keep] * (B * B) + (rows[keep] % B) * B + (cols[keep] % B)
    )
    flat = np.bincount(flat_idx, weights=vals[keep], minlength=(K + 1) * B * B)
    return flat.reshape(K + 1, B, B).astype(np.float32)


def scatter(rows, cols, vals, tmap, B, K):
    """COO pixels -> [K+1, B, B] float32 tiles through ``tmap``: the native
    ``tile_scatter`` (float32 sums)."""
    return native.tile_scatter(rows, cols, vals, tmap, B, K)


def scatter_slab_plain(slab, tmap, B, K, mirror):
    """Plain numpy version of ``scatter_slab``: the slab's pixels balanced
    by its weights (folded in float64), each off-diagonal pixel's transpose
    added when ``mirror``, cut to the rectangle and bincount-scattered."""
    n1, n2 = slab.shape
    rows = slab.rows - slab.lo1
    cols = slab.cols - slab.lo2
    vals = slab.vals.astype(np.float64)
    if slab.weights is not None:
        vals = vals * slab.weights[slab.rows] * slab.weights[slab.cols]
    if mirror:
        off = slab.rows != slab.cols
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, vals[off]]),
        )
    inb = (rows >= 0) & (rows < n1) & (cols >= 0) & (cols < n2)
    return scatter_plain(rows[inb], cols[inb], vals[inb], tmap, B, K)


def scatter_slab(slab, tmap, B, K, mirror):
    """A ``PixelSlab`` -> [K+1, B, B] float32 tiles through ``tmap`` in one
    fused pass: the native ``tile_scatter_wtri`` (weights folded in
    float32, the mirror when ``mirror``); the mirrored or balanced COO
    never exists on the host."""
    n1, n2 = slab.shape
    return native.tile_scatter_wtri(
        slab.rows, slab.cols, slab.vals, slab.lo1, slab.lo2, n1, n2,
        slab.weights, tmap, B, K, mirror,
    )


def _dense_map(want, nr, nc):
    tile_map = np.zeros((nr + 1, nc + 1), dtype=np.int32)
    tile_map[want // nc, want % nc] = np.arange(1, len(want) + 1,
                                                dtype=np.int32)
    return tile_map


def build_tile_stack(coo, B, r1=None, r2=None, window1=None, window2=None):
    """Scatter a scipy COO region matrix into a TileStack.

    If (r1, r2, window sizes) are given, only tiles touched by those windows
    are materialized; otherwise all nonzero tiles are. One O(nnz) pass of
    ``scatter`` in scipy's own dtypes."""
    n1, n2 = coo.shape
    rows = np.asarray(coo.row)
    cols = np.asarray(coo.col)
    vals = np.asarray(coo.data)
    want, nr, nc = _want_tiles(
        rows, cols, B, (n1, n2), r1, r2, window1, window2
    )
    K = len(want)
    # +1 for the shared zero tile at stack index 0
    tile_map = _dense_map(want, nr, nc)
    if K == 0 or len(rows) == 0:
        tiles = np.zeros((K + 1, B, B), dtype=np.float32)
    else:
        tiles = scatter(rows, cols, vals, tile_map, B, K)
    return TileStack(tiles=tiles, tile_map=tile_map, B=B, shape=(n1, n2))


def build_tile_stack_sym(coo, B, r1=None, r2=None, window1=None, window2=None):
    """Upper-triangle build from a FULL symmetric COO (both triangles
    stored, e.g. a mirrored fetch): entries landing on lower tiles fall off
    the upper scatter map, so diagonal tiles keep both halves
    (``diag_full=True``) and off-diagonal lower tiles come from the device
    transpose. Scatters ~half the tiles of build_tile_stack."""
    n1, n2 = coo.shape
    if n1 != n2:
        raise ValueError("sym build requires a square (cis) region")
    rows = np.asarray(coo.row)
    cols = np.asarray(coo.col)
    vals = np.asarray(coo.data)
    want, nr, nc = _want_tiles(
        rows, cols, B, (n1, n2), r1, r2, window1, window2
    )
    tile_map, utile_map, src, flip, diag, Ku = _sym_maps(want, nr, nc)

    if Ku == 0 or len(rows) == 0:
        upper = np.zeros((Ku + 1, B, B), dtype=np.float32)
    else:
        upper = scatter(rows, cols, vals, utile_map, B, Ku)
    return SymTileStack(
        upper=upper, tile_map=tile_map, src=src, flip=flip, diag=diag,
        diag_full=True, B=B, shape=(n1, n2),
    )


def _slab_want(slab, B, r1, r2, window1, window2, band, want, both):
    """The tiles to materialize of a slab's rectangle: an explicit ``want``
    (raveled tile ids), the ``band`` predicate, the tiles windows starting
    at (r1, r2) touch, or else every tile holding a stored pixel (and its
    transpose when ``both``). Returns ``(want, nr, nc)``."""
    n1, n2 = slab.shape
    nr, nc = -(-n1 // B), -(-n2 // B)
    if want is not None:
        return np.asarray(want, np.int64), nr, nc
    if band is not None:
        return band_tiles(band, B, (n1, n2))
    if r1 is not None:
        return touched_tiles(r1, r2, window1, window2, B, (n1, n2))
    lr = slab.rows - slab.lo1
    lc = slab.cols - slab.lo2
    t = np.unique((lr // B) * nc + lc // B)
    if both:
        t = np.union1d(t, (lc // B) * nc + lr // B)
    return t, nr, nc


def build_tile_stack_slab_sym(slab, B, r1=None, r2=None, window1=None,
                              window2=None, band=None, want=None):
    """Upper-triangle build from a stored-triangle cis ``PixelSlab``
    (``io/cool.Cooler.fetch_slab``) for the tiles of the predicate
    (``_slab_want``: ``want``, ``band`` or the windows starting at (r1,
    r2)): the pixels are balanced by the slab's weights and scattered
    unmirrored onto the upper tile map (``scatter_slab``), so diagonal
    tiles hold only the stored upper half (``diag_full=False``;
    ``expand_sym`` symmetrizes them)."""
    n1, n2 = slab.shape
    if n1 != n2 or not slab.mirror:
        raise ValueError(
            "sym slab build requires a square cis region with a stored "
            "triangle"
        )
    want, nr, nc = _slab_want(slab, B, r1, r2, window1, window2, band, want,
                              True)
    tile_map, utile_map, src, flip, diag, Ku = _sym_maps(want, nr, nc)
    if Ku == 0 or slab.nnz == 0:
        upper = np.zeros((Ku + 1, B, B), dtype=np.float32)
    else:
        upper = scatter_slab(slab, utile_map, B, Ku, False)
    return SymTileStack(
        upper=upper, tile_map=tile_map, src=src, flip=flip, diag=diag,
        diag_full=False, B=B, shape=(n1, n2),
    )


def build_tile_stack_slab(slab, B, r1=None, r2=None, window1=None,
                          window2=None, band=None, want=None):
    """Dense TileStack of the tiles of the predicate (``_slab_want``) from a
    ``PixelSlab`` in one fused pass (``scatter_slab``): balancing weights
    folded, the stored triangle mirrored when ``slab.mirror``; the stack of
    rectangles that have no mirror (trans region pairs)."""
    n1, n2 = slab.shape
    want, nr, nc = _slab_want(slab, B, r1, r2, window1, window2, band, want,
                              slab.mirror)
    K = len(want)
    tile_map = _dense_map(want, nr, nc)
    if K == 0 or slab.nnz == 0:
        tiles = np.zeros((K + 1, B, B), dtype=np.float32)
    else:
        tiles = scatter_slab(slab, tile_map, B, K, slab.mirror)
    return TileStack(tiles=tiles, tile_map=tile_map, B=B, shape=(n1, n2))


@dataclass
class CooTileStack:
    """Sparse wire of a tile stack: per-pixel (flat index, value) pairs that
    the device scatter-adds into the dense [K+1, B, B] raw stack
    (``coo_tiles``). Chosen over the dense host scatter when the pixels
    undercut the dense tile payload: trans feature products touch nearly
    every tile of a mostly empty rectangle. Balancing weights are folded on
    the host; values ride float32, or scaled float16 under the dense
    wire's rules (``cast_tiles_f16``), which the device multiplies by
    ``inv_scale`` after upconverting."""

    idx: np.ndarray  # [nnz] int32 flat index into the raveled [K+1, B, B]
    vals: np.ndarray  # [nnz] float32, or scaled float16
    tile_map: np.ndarray  # [nr+1, nc+1] -> stack index (0 = empty)
    B: int
    shape: tuple
    k1: int  # dense stack depth K+1 (slot 0 = the shared zero tile)
    inv_scale: np.float32 = np.float32(1.0)

    @property
    def n_tiles(self):
        return self.k1 - 1

    @property
    def nnz(self):
        return len(self.idx)

    def expand_host(self):
        """The dense [K+1, B, B] float32 stack on the host (sums in
        float64)."""
        flat = np.zeros(self.k1 * self.B * self.B, np.float64)
        np.add.at(flat, self.idx,
                  self.vals.astype(np.float64) * float(self.inv_scale))
        return flat.reshape(self.k1, self.B, self.B).astype(np.float32)

    def to_tile_stack(self):
        return TileStack(
            tiles=self.expand_host(), tile_map=self.tile_map, B=self.B,
            shape=self.shape,
        )


def build_tile_stack_coo(slab, B, want, f16_mode=False):
    """The COO wire of the tiles in ``want`` (raveled tile ids) from a
    ``PixelSlab``: O(nnz) host work (tile lookup, weight fold in float64
    then one float32 cast, flat index), no host scatter and no dense host
    stack. The mirrored twin of off-diagonal pixels is emitted when
    ``slab.mirror``. ``f16_mode`` casts the values as the dense wire does
    (``cast_tiles_f16``; float32 where it refuses)."""
    n1, n2 = slab.shape
    nr, nc = -(-n1 // B), -(-n2 // B)
    want = np.asarray(want, np.int64)
    tile_map = _dense_map(want, nr, nc)
    rows = slab.rows - slab.lo1
    cols = slab.cols - slab.lo2
    vals = slab.vals.astype(np.float64)
    if slab.weights is not None:
        vals = vals * slab.weights[slab.rows] * slab.weights[slab.cols]
    vals = vals.astype(np.float32)
    inb = (rows >= 0) & (rows < n1) & (cols >= 0) & (cols < n2)
    rows, cols, vals = rows[inb], cols[inb], vals[inb]
    if slab.mirror:
        off = rows != cols
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, vals[off]]),
        )
    pix_tile = tile_map[rows // B, cols // B].astype(np.int64)
    keep = pix_tile > 0
    rows, cols, vals, pix_tile = (
        rows[keep], cols[keep], vals[keep], pix_tile[keep],
    )
    idx = (pix_tile * (B * B) + (rows % B) * B + (cols % B)).astype(np.int32)
    inv = np.float32(1.0)
    if f16_mode and len(vals):
        cast = cast_tiles_f16(vals, f16_mode)
        if cast is not None:
            vals, inv = cast
    return CooTileStack(idx=idx, vals=vals, tile_map=tile_map, B=B,
                        shape=(n1, n2), k1=len(want) + 1, inv_scale=inv)


def rect_tiles(lo1, hi1, lo2, hi2, B, shape):
    """All (tile_row, tile_col) ids covered by the bin-range rectangles
    [lo1, hi1) x [lo2, hi2): the tile predicate of streams whose windows
    are known as intervals before any coordinate frame exists (BEDPE rows,
    trans feature products with shift margins). Ranges are clipped to the
    region; returns sorted unique raveled ids, nr, nc."""
    n1, n2 = shape
    nr, nc = -(-n1 // B), -(-n2 // B)
    lo1 = np.clip(np.asarray(lo1, np.int64), 0, n1 - 1)
    hi1 = np.clip(np.asarray(hi1, np.int64), 1, n1)
    lo2 = np.clip(np.asarray(lo2, np.int64), 0, n2 - 1)
    hi2 = np.clip(np.asarray(hi2, np.int64), 1, n2)
    t1a, t1b = lo1 // B, (hi1 - 1) // B
    t2a, t2b = lo2 // B, (hi2 - 1) // B
    sp1 = int((t1b - t1a).max(initial=0)) + 1
    sp2 = int((t2b - t2a).max(initial=0)) + 1
    flags = np.zeros(nr * nc, dtype=bool)
    for di in range(sp1):
        rr = t1a + di
        okr = rr <= t1b
        for dj in range(sp2):
            cc = t2a + dj
            ok = okr & (cc <= t2b)
            flags[rr[ok] * nc + cc[ok]] = True
    return np.flatnonzero(flags), nr, nc


def band_tiles(max_diag_bins, B, shape):
    """All (tile_row, tile_col) ids within ``max_diag_bins`` of the
    diagonal: the tile predicate that needs no window coordinates, so a
    stream's stack can be staged before the windows exist. A tile is
    included when any of its pixels can satisfy |row - col| <=
    max_diag_bins. Returns sorted raveled ids, nr, nc."""
    n1, n2 = shape
    nr, nc = -(-n1 // B), -(-n2 // B)
    k = int(max_diag_bins) // B + 1
    t1 = np.repeat(np.arange(nr, dtype=np.int64), 2 * k + 1)
    t2 = t1 + np.tile(np.arange(-k, k + 1, dtype=np.int64), nr)
    keep = (t2 >= 0) & (t2 < nc)
    return np.sort(t1[keep] * nc + t2[keep]), nr, nc


def assemble_windows_batch(stiles, tile_map, B, r1, r2, W):
    """Host oracle for fixed-size window cuts: group snips by tile quad,
    build each 2B×2B superwindow once, and cut all of its windows with
    slice copies. ``stiles`` is the NaN-encoded normalized stack
    (normalize_tile_stack). Returns float32 ``data`` [N, W, W]."""
    N = len(r1)
    r1 = np.asarray(r1, np.int64)
    r2 = np.asarray(r2, np.int64)
    out = np.empty((N, W, W), np.float32)
    t1, o1 = r1 // B, r1 % B
    t2, o2 = r2 // B, r2 % B
    ncol = tile_map.shape[1]
    quad = t1 * ncol + t2
    order = np.argsort(quad, kind="stable")
    qs = quad[order]
    starts = np.concatenate(
        [[0], np.flatnonzero(np.diff(qs)) + 1, [N]]
    ) if N else np.array([0, 0])
    for b in range(len(starts) - 1):
        lo, hi = starts[b], starts[b + 1]
        if hi <= lo:
            continue
        ids = order[lo:hi]
        tt1, tt2 = int(t1[ids[0]]), int(t2[ids[0]])
        sup = np.block(
            [
                [stiles[tile_map[tt1, tt2]], stiles[tile_map[tt1, tt2 + 1]]],
                [
                    stiles[tile_map[tt1 + 1, tt2]],
                    stiles[tile_map[tt1 + 1, tt2 + 1]],
                ],
            ]
        )
        for i, a, c in zip(ids.tolist(), o1[ids].tolist(), o2[ids].tolist()):
            out[i] = sup[a : a + W, c : c + W]
    return out


def normalize_tile_stack(
    ts: TileStack,
    valid1,
    valid2,
    evec=None,
    ooe=False,
    cis=True,
    ignore_diags=2,
    frame_shift=0,
):
    """Host oracle: pre-normalize a tile stack into ONE NaN-encoded stack.

    For every materialized tile, applies the per-pixel semantics of the
    reference hot loop (coolpup.py:1104–1156) — bad-bin masking, diagonal
    masking, OOE division:

      stiles[k, x, y] = OOE-divided value where the pixel counts (+inf kept
                        at poison pixels, like the reference's sums),
                        NaN where masked out or NaN-valued.

    The diagonal index of pixel (x, y) in tile (tr, tc) is
    tr*B + x - (tc*B + y) + frame_shift. Returns ``stiles`` float32
    [K+1, B, B]; slot 0 (the shared empty tile) is all-NaN.
    """
    B = ts.B
    tiles = ts.tiles
    K1 = tiles.shape[0]
    tr = np.zeros(K1, np.int64)
    tc = np.zeros(K1, np.int64)
    grid_r, grid_c = np.nonzero(ts.tile_map)
    tr[ts.tile_map[grid_r, grid_c]] = grid_r
    tc[ts.tile_map[grid_r, grid_c]] = grid_c

    n1, n2 = ts.shape
    # callers may pass valid vectors padded beyond the tiled extent; bins
    # past the tile grid are unreachable, clip
    v1 = np.zeros(((n1 + 2 * B - 1) // B) * B + B, np.float32)
    m1 = min(len(valid1), len(v1))
    v1[:m1] = np.asarray(valid1, np.float32)[:m1]
    v2 = np.zeros(((n2 + 2 * B - 1) // B) * B + B, np.float32)
    m2 = min(len(valid2), len(v2))
    v2[:m2] = np.asarray(valid2, np.float32)[:m2]

    ar = np.arange(B)
    rows = tr[:, None] * B + ar[None, :]  # [K1, B]
    cols = tc[:, None] * B + ar[None, :]
    mask = v1[rows][:, :, None] * v2[cols][:, None, :]  # [K1, B, B]
    if cis and ignore_diags > 0:
        diag = rows[:, :, None] - cols[:, None, :] + frame_shift
        mask = mask * (np.abs(diag) >= ignore_diags)

    if ooe:
        if np.ndim(evec) == 0 or len(np.atleast_1d(evec)) == 1:
            ew = np.full((K1, B, B), float(np.atleast_1d(evec)[0]), np.float32)
        else:
            diag = np.abs(rows[:, :, None] - cols[:, None, :] + frame_shift)
            epad = np.full(
                max(int(diag.max()) + 1, len(evec)), np.nan, np.float32
            )
            epad[: len(evec)] = evec
            ew = epad[diag]
        with np.errstate(divide="ignore", invalid="ignore"):
            val = tiles / ew
    else:
        val = tiles

    stiles = np.where(mask > 0, val, np.nan).astype(np.float32)
    stiles[0] = np.nan
    return stiles


# --------------------------------------------------------------------------
# device half: torch ops (jnp in the reference, not Pallas)
# --------------------------------------------------------------------------


def expand_sym(sym: SymTileStack, device, f16_mode=False, wire=None):
    """Upload the upper tiles and materialize the FULL raw stack on
    ``device``: ``full[k] = upper[src[k]]``, transposed where ``flip[k]``,
    and ``g + gᵀ − g·I`` on diagonal tiles when the scatter held only the
    upper half (``diag_full`` false). ``f16_mode`` is the upload wire
    (``upload_tiles``): a float16 or int8 payload is upconverted and
    multiplied by its inverse scale before the mirroring (reference
    ``_make_expand_sym_fn``, ``expand_sym_device``). A list ``wire``
    gets the payload's dtype name appended. Returns float32 [K+1, B,
    B]."""
    up, inv = upload_tiles(sym.upper, f16_mode, device)
    if wire is not None:
        wire.append(_dtype_name(up.dtype))
    src = torch.from_numpy(np.asarray(sym.src, np.int64)).to(device)
    flip = torch.from_numpy(np.asarray(sym.flip, bool)).to(device)
    g = _upconvert(up[src], inv)
    gt = g.transpose(1, 2)
    full = torch.where(flip[:, None, None], gt, g)
    if not sym.diag_full:
        diag = torch.from_numpy(np.asarray(sym.diag, bool)).to(device)
        eye = torch.eye(sym.B, dtype=g.dtype, device=g.device)
        full = torch.where(diag[:, None, None], g + gt - g * eye, full)
    return full.contiguous()


def _dtype_name(dtype):
    """``torch.float16`` -> ``"float16"``; numpy dtypes pass through
    ``str``."""
    return str(dtype).replace("torch.", "")


def _padded_vec(v, n):
    out = np.zeros(n, np.float32)
    m = min(len(v), n)
    out[:m] = np.asarray(v, np.float32)[:m]
    return out


def normalize_tiles(
    tiles,
    tile_map,
    B,
    valid1,
    valid2,
    evec=None,
    ooe=False,
    cis=True,
    ignore_diags=2,
    frame_shift=0,
    slab=1024,
    fold_weights=False,
    inv=None,
):
    """Raw stack -> ONE NaN-encoded stack on ``tiles.device``: the per-pixel
    semantics of ``normalize_tile_stack`` (bad-bin mask, |diag| <
    ignore_diags mask, division by the expected toeplitz), NaN where masked
    out. Slots not referenced by ``tile_map`` normalize to values no window
    reads; slot 0 is set to all-NaN.

    ``valid1``/``valid2`` may be padded past the tiled extent (they are
    clipped). The toeplitz is a direct gather ``epad[min(|diag|, L-1)]``;
    ``epad`` is NaN past ``evec``. Slabs of ``slab`` tiles bound the
    intermediates. ``tiles`` may be a wire payload (float16 or int8), which
    is upconverted and multiplied by ``inv`` first. ``fold_weights`` is the
    int8 wire's: ``valid1``/``valid2`` then carry the cleaned balancing
    weights (0 at bad bins), whose product both gates a pixel (> 0) and
    multiplies its raw count (reference ``_make_normalize_slab_fn``)."""
    K = int(tiles.shape[0])
    tr = np.zeros(K, np.int64)
    tc = np.zeros(K, np.int64)
    gr, gc = np.nonzero(tile_map)
    tr[tile_map[gr, gc]] = gr
    tc[tile_map[gr, gc]] = gc
    nrp, ncp = tile_map.shape
    v1 = _padded_vec(valid1, nrp * B + B)
    v2 = _padded_vec(valid2, ncp * B + B)
    # epad covers every reachable |diag|; NaN beyond the expected vector
    L = (max(nrp, ncp) + 2) * B + abs(int(frame_shift)) + 1
    epad = np.full(L, np.nan, np.float32)
    if ooe and evec is not None:
        ev = np.atleast_1d(np.asarray(evec, np.float32))
        if ev.size == 1:
            epad[:] = ev[0]
        else:
            epad[: min(ev.size, L)] = ev[:L]

    out = normalize_slots(tiles, tr, tc, B, v1, v2, epad, ooe=ooe, cis=cis,
                          ignore_diags=ignore_diags, frame_shift=frame_shift,
                          slab=slab, inv=inv, fold_weights=fold_weights)
    out[0] = torch.nan
    return out


def normalize_slots(tiles, tr, tc, B, v1, v2, epad, ooe=False, cis=True,
                    ignore_diags=2, frame_shift=0, slab=1024, inv=None,
                    fold_weights=False):
    """The per-pixel normalization of ``normalize_tiles`` for slots whose
    tile coordinates are given: slot k of ``tiles`` [K, B, B] lies at tile
    row ``tr[k]`` and column ``tc[k]`` (int numpy [K]); ``v1``/``v2`` are
    the 0/1 valid-bin vectors padded to the grid (the balancing weights
    with ``fold_weights``) and ``epad`` the expected vector padded with NaN
    (float32 numpy); ``inv`` the inverse scale of a wire payload. Returns
    the NaN-encoded float32 [K, B, B] stack on ``tiles.device``, slot 0
    untouched by any rule of its own (callers set it)."""
    device = tiles.device
    K = int(tiles.shape[0])
    L = len(epad)
    trd, tcd = (torch.from_numpy(np.asarray(a, np.int64)).to(device)
                for a in (tr, tc))
    v1d, v2d, ed = (torch.from_numpy(np.asarray(a, np.float32)).to(device)
                    for a in (v1, v2, epad))
    ar = torch.arange(B, device=device)
    out = torch.empty((K, B, B), dtype=torch.float32, device=device)
    for lo in range(0, K, slab):
        hi = min(lo + slab, K)
        rows = trd[lo:hi, None] * B + ar[None, :]  # [k, B]
        cols = tcd[lo:hi, None] * B + ar[None, :]
        mask = v1d[rows][:, :, None] * v2d[cols][:, None, :]
        val = _upconvert(tiles[lo:hi], 1.0 if inv is None else inv)
        if fold_weights:
            val = val * mask
        diag = rows[:, :, None] - cols[:, None, :] + int(frame_shift)
        if cis and ignore_diags > 0:
            mask = mask * (diag.abs() >= ignore_diags)
        if ooe:
            val = val / ed[diag.abs().clamp_(max=L - 1)]
        out[lo:hi] = torch.where(mask > 0, val, torch.nan)
    return out


def normalize_tile_stack_device(
    ts: TileStack,
    valid1,
    valid2,
    evec=None,
    ooe=False,
    cis=True,
    ignore_diags=2,
    frame_shift=0,
    slab=1024,
    f16_mode=False,
    fold_weights=False,
    device="cuda",
):
    """``normalize_tile_stack`` on ``device`` for a dense TileStack: upload
    the raw tiles through the wire of ``f16_mode`` (``upload_tiles``), then
    ``normalize_tiles`` (with ``fold_weights``, ``valid1``/``valid2`` are
    the balancing weights of raw counts). Runs on the card and raises
    without one; ``device="cpu"`` runs it there."""
    tiles, inv = upload_tiles(ts.tiles, f16_mode, resolve_device(device))
    return normalize_tiles(
        tiles, ts.tile_map, ts.B, valid1, valid2, evec=evec, ooe=ooe,
        cis=cis, ignore_diags=ignore_diags, frame_shift=frame_shift,
        slab=slab, fold_weights=fold_weights, inv=inv,
    )


def coo_tiles(cts: CooTileStack, device):
    """The COO wire on ``device``: upload ``(idx, vals)`` and scatter-add
    ``vals`` upconverted to float32 times ``inv_scale`` into a zeroed
    float32 [K+1, B, B] raw stack with ``index_add_`` (the torch-op port of
    the reference's jnp ``_make_coo_scatter``,
    ``ops/pallas_gather.py:229-242``; float32 sums, in an order the device
    picks)."""
    B = cts.B
    idx = torch.from_numpy(np.ascontiguousarray(cts.idx, np.int32))
    vals = torch.from_numpy(np.ascontiguousarray(cts.vals))
    vals = _upconvert(vals.to(device), cts.inv_scale)
    flat = torch.zeros(cts.k1 * B * B, dtype=torch.float32, device=device)
    flat.index_add_(0, idx.to(device), vals)
    return flat.view(cts.k1, B, B)


def normalized_stack(tile_stack, valid1, valid2, evec, device,
                     f16_mode=False, fold_weights=False, wire=None, **norm):
    """A host ``TileStack``, ``SymTileStack`` or ``CooTileStack`` uploaded
    to ``device``, expanded (``expand_sym``) or scattered (``coo_tiles``)
    and normalized into ONE NaN-encoded float32 stack [K+1, B, B]
    (``normalize_tiles`` with the keywords ``norm``). ``f16_mode`` is the
    upload wire of a dense or upper-triangle stack (a COO wire carries its
    own); ``fold_weights`` applies to an upper-triangle stack of raw counts
    only, as in the reference's session. A list ``wire`` gets the dtype
    name of what went over the wire appended: ``"float16"``, ``"int8"``,
    or ``"float32"`` where the cast was refused or not asked for."""
    inv = None
    if isinstance(tile_stack, SymTileStack):
        tiles = expand_sym(tile_stack, device, f16_mode, wire=wire)
    elif isinstance(tile_stack, CooTileStack):
        tiles = coo_tiles(tile_stack, device)
        fold_weights = False
        if wire is not None:
            wire.append(_dtype_name(tile_stack.vals.dtype))
    elif isinstance(tile_stack, TileStack):
        tiles, inv = upload_tiles(tile_stack.tiles, f16_mode, device)
        fold_weights = False
        if wire is not None:
            wire.append(_dtype_name(tiles.dtype))
    else:
        raise TypeError(
            f"normalized_stack: unsupported {type(tile_stack).__name__}"
        )
    return normalize_tiles(
        tiles, tile_stack.tile_map, tile_stack.B, valid1, valid2, evec=evec,
        fold_weights=fold_weights, inv=inv, **norm,
    )


def cut_windows(stiles, tile_map, r1, r2, H, h1=None, w2=None):
    """[b, H, H] windows cut from a NaN-encoded stack ``stiles`` [K, B, B]
    through its device tile map (int64 [nr+1, nc+1]): pixel (i, j) of the
    window starting at (r1, r2) is
    ``stiles[tile_map[(r1+i)//B, (r2+j)//B], (r1+i)%B, (r2+j)%B]``, one
    gather per block. With logical sizes ``h1``/``w2`` (rescale), offsets
    past them are clamped to the last row/column of the logical window,
    whose tiles the window touches; the caller masks those pixels."""
    B = stiles.shape[-1]
    ar = torch.arange(H, device=stiles.device)
    i = ar[None, :] if h1 is None else torch.minimum(ar[None, :],
                                                     h1[:, None] - 1)
    j = ar[None, :] if w2 is None else torch.minimum(ar[None, :],
                                                     w2[:, None] - 1)
    rows = r1[:, None] + i  # [b, H]
    cols = r2[:, None] + j
    tid = tile_map[(rows // B)[:, :, None], (cols // B)[:, None, :]]
    idx = (tid * B + (rows % B)[:, :, None]) * B + (cols % B)[:, None, :]
    return stiles.reshape(-1)[idx]


# host bytes of one fetched block of windows (float32)
FETCH_BYTES = 256 << 20


def fetch_windows(stiles, tile_map, r1, r2, H, h1=None, w2=None, flip=None):
    """The windows of a snip stream, cut from the device stack
    (``cut_windows``) and fetched to the host in blocks of at most
    ``FETCH_BYTES``: yields ``(lo, hi, block)`` with ``block`` the float32
    numpy [hi - lo, H, H] windows of snips ``lo:hi``, a fresh array per
    block that nothing else holds. ``r1``, ``r2`` and the optional logical
    sizes ``h1``/``w2`` and ``flip`` marks are host arrays; a flagged
    snip's window is anti-transposed (rows and columns reversed, then
    transposed) on the device before the fetch. With ``h1``/``w2`` the
    pixels past a snip's logical extent hold clamped copies: the caller
    slices ``block[i, :h1[i], :w2[i]]``."""
    device = stiles.device
    n = len(r1)
    step = max(1, FETCH_BYTES // (4 * H * H))

    def upload(a, lo, hi, dtype=torch.int64):
        return torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(device,
                                                                   dtype)

    for lo in range(0, n, step):
        hi = min(lo + step, n)
        blk = cut_windows(
            stiles, tile_map, upload(r1, lo, hi), upload(r2, lo, hi), H,
            None if h1 is None else upload(h1, lo, hi),
            None if w2 is None else upload(w2, lo, hi),
        )
        if flip is not None and flip[lo:hi].any():
            fl = upload(flip, lo, hi, torch.bool)
            blk = torch.where(fl[:, None, None],
                              blk.flip(1, 2).transpose(1, 2), blk)
        yield lo, hi, blk.to(torch.float32).cpu().numpy()
