"""Block-sparse tile stacks (counterpart of ``coolpuppy_tpu/ops/tiles.py``).

The host half is copied from the reference as numpy: the tile dataclasses,
the COO and pixel-slab scatters into upper-triangle or full tile stacks,
and the host oracles ``normalize_tile_stack`` and
``assemble_windows_batch``. It is copied, not imported, because importing
any ``coolpuppy_tpu`` module imports jax. The native C++ scatter of the
reference is not ported; the numpy branch is the only path.

The device half ports the reference's jnp functions as torch ops:
``expand_sym`` (upper tiles -> full raw stack), ``normalize_tiles`` (raw
stack -> one NaN-encoded observed-over-expected stack), ``normalized_stack``
(both, from a host tile stack) and ``cut_windows`` (windows of any size cut
from that stack through its tile map: the generic and rescale paths, in
place of the reference's bucket restack and 2×2 superwindows).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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


def _scatter(rows, cols, vals, tmap, B, K):
    """bincount-scatter COO pixels into [K+1, B, B] float32 tiles through a
    (tile_row, tile_col) -> slot map; pixels on unmapped tiles are dropped."""
    pix_tile = tmap[rows // B, cols // B].astype(np.int64)
    keep = pix_tile > 0
    flat_idx = (
        pix_tile[keep] * (B * B) + (rows[keep] % B) * B + (cols[keep] % B)
    )
    flat = np.bincount(flat_idx, weights=vals[keep], minlength=(K + 1) * B * B)
    return flat.reshape(K + 1, B, B).astype(np.float32)


def build_tile_stack(coo, B, r1=None, r2=None, window1=None, window2=None):
    """Scatter a scipy COO region matrix into a TileStack.

    If (r1, r2, window sizes) are given, only tiles touched by those windows
    are materialized; otherwise all nonzero tiles are.
    One O(nnz) pass: tile-id per pixel, filter to touched, bincount-scatter.
    """
    n1, n2 = coo.shape
    rows = np.asarray(coo.row)
    cols = np.asarray(coo.col)
    vals = np.asarray(coo.data)
    want, nr, nc = _want_tiles(
        rows, cols, B, (n1, n2), r1, r2, window1, window2
    )

    K = len(want)
    # +1 for the shared zero tile at stack index 0
    tile_map = np.zeros((nr + 1, nc + 1), dtype=np.int32)
    tile_map[want // nc, want % nc] = np.arange(1, K + 1, dtype=np.int32)
    if K == 0 or len(rows) == 0:
        tiles = np.zeros((K + 1, B, B), dtype=np.float32)
    else:
        tiles = _scatter(rows, cols, vals, tile_map, B, K)
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
        upper = _scatter(rows, cols, vals, utile_map, B, Ku)
    return SymTileStack(
        upper=upper, tile_map=tile_map, src=src, flip=flip, diag=diag,
        diag_full=True, B=B, shape=(n1, n2),
    )


def build_tile_stack_slab_sym(slab, B, r1, r2, window1, window2):
    """Upper-triangle build from a stored-triangle cis ``PixelSlab``
    (``io/cool.Cooler.fetch_slab``) for the tiles that windows starting at
    (r1, r2) touch: the pixels are balanced by the slab's weights (folded
    in float64) and scattered unmirrored onto the upper tile map, so
    diagonal tiles hold only the stored upper half (``diag_full=False``;
    ``expand_sym`` symmetrizes them)."""
    n1, n2 = slab.shape
    if n1 != n2 or not slab.mirror:
        raise ValueError(
            "sym slab build requires a square cis region with a stored "
            "triangle"
        )
    want, nr, nc = touched_tiles(r1, r2, window1, window2, B, (n1, n2))
    tile_map, utile_map, src, flip, diag, Ku = _sym_maps(want, nr, nc)
    if Ku == 0 or slab.nnz == 0:
        upper = np.zeros((Ku + 1, B, B), dtype=np.float32)
    else:
        rows = slab.rows - slab.lo1
        cols = slab.cols - slab.lo2
        vals = slab.vals.astype(np.float64)
        if slab.weights is not None:
            vals = vals * slab.weights[slab.rows] * slab.weights[slab.cols]
        inb = (rows >= 0) & (rows < n1) & (cols >= 0) & (cols < n2)
        upper = _scatter(rows[inb], cols[inb], vals[inb], utile_map, B, Ku)
    return SymTileStack(
        upper=upper, tile_map=tile_map, src=src, flip=flip, diag=diag,
        diag_full=False, B=B, shape=(n1, n2),
    )


def build_tile_stack_slab(slab, B, r1, r2, window1, window2):
    """Dense TileStack of the tiles that windows starting at (r1, r2) touch,
    from a ``PixelSlab`` — the stack of rectangles that have no mirror
    (trans region pairs). The reference's numpy branch: balancing weights
    folded in float64, the stored triangle mirrored when ``slab.mirror``,
    one bincount scatter, one float32 cast."""
    n1, n2 = slab.shape
    want, nr, nc = touched_tiles(r1, r2, window1, window2, B, (n1, n2))
    K = len(want)
    tile_map = np.zeros((nr + 1, nc + 1), dtype=np.int32)
    tile_map[want // nc, want % nc] = np.arange(1, K + 1, dtype=np.int32)
    if K == 0 or slab.nnz == 0:
        tiles = np.zeros((K + 1, B, B), dtype=np.float32)
        return TileStack(tiles=tiles, tile_map=tile_map, B=B, shape=(n1, n2))
    rows = slab.rows - slab.lo1
    cols = slab.cols - slab.lo2
    vals = slab.vals.astype(np.float64)
    if slab.weights is not None:
        vals = vals * slab.weights[slab.rows] * slab.weights[slab.cols]
    if slab.mirror:
        off = slab.rows != slab.cols
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, vals[off]]),
        )
    inb = (rows >= 0) & (rows < n1) & (cols >= 0) & (cols < n2)
    tiles = _scatter(rows[inb], cols[inb], vals[inb], tile_map, B, K)
    return TileStack(tiles=tiles, tile_map=tile_map, B=B, shape=(n1, n2))


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


def expand_sym(sym: SymTileStack, device):
    """Upload the upper tiles and materialize the FULL raw stack on
    ``device``: ``full[k] = upper[src[k]]``, transposed where ``flip[k]``,
    and ``g + gᵀ − g·I`` on diagonal tiles when the scatter held only the
    upper half (``diag_full`` false). Returns float32 [K+1, B, B]."""
    up = torch.from_numpy(np.ascontiguousarray(sym.upper, np.float32))
    up = up.to(device)
    src = torch.from_numpy(np.asarray(sym.src, np.int64)).to(device)
    flip = torch.from_numpy(np.asarray(sym.flip, bool)).to(device)
    g = up[src]
    gt = g.transpose(1, 2)
    full = torch.where(flip[:, None, None], gt, g)
    if not sym.diag_full:
        diag = torch.from_numpy(np.asarray(sym.diag, bool)).to(device)
        eye = torch.eye(sym.B, dtype=g.dtype, device=g.device)
        full = torch.where(diag[:, None, None], g + gt - g * eye, full)
    return full.contiguous()


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
):
    """Raw stack -> ONE NaN-encoded stack on ``tiles.device``: the per-pixel
    semantics of ``normalize_tile_stack`` (bad-bin mask, |diag| <
    ignore_diags mask, division by the expected toeplitz), NaN where masked
    out. Slots not referenced by ``tile_map`` normalize to values no window
    reads; slot 0 is set to all-NaN.

    ``valid1``/``valid2`` may be padded past the tiled extent (they are
    clipped). The toeplitz is a direct gather ``epad[min(|diag|, L-1)]``;
    ``epad`` is NaN past ``evec``. Slabs of ``slab`` tiles bound the
    intermediates. ``fold_weights`` exists only for the reference's int8
    raw-count wire, which is not ported."""
    if fold_weights:
        raise NotImplementedError(
            "fold_weights (the int8 raw-count wire) is not ported"
        )
    device = tiles.device
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

    trd, tcd = (torch.from_numpy(a).to(device) for a in (tr, tc))
    v1d, v2d, ed = (torch.from_numpy(a).to(device) for a in (v1, v2, epad))
    ar = torch.arange(B, device=device)
    out = torch.empty((K, B, B), dtype=torch.float32, device=device)
    for lo in range(0, K, slab):
        hi = min(lo + slab, K)
        rows = trd[lo:hi, None] * B + ar[None, :]  # [k, B]
        cols = tcd[lo:hi, None] * B + ar[None, :]
        mask = v1d[rows][:, :, None] * v2d[cols][:, None, :]
        diag = rows[:, :, None] - cols[:, None, :] + int(frame_shift)
        if cis and ignore_diags > 0:
            mask = mask * (diag.abs() >= ignore_diags)
        val = tiles[lo:hi].to(torch.float32)
        if ooe:
            val = val / ed[diag.abs().clamp_(max=L - 1)]
        out[lo:hi] = torch.where(mask > 0, val, torch.nan)
    out[0] = torch.nan
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
    device="cuda",
):
    """``normalize_tile_stack`` on ``device`` for a dense TileStack: upload
    the raw tiles, then ``normalize_tiles``. Runs on the card and raises
    without one; ``device="cpu"`` runs it there."""
    tiles = torch.from_numpy(np.ascontiguousarray(ts.tiles, np.float32))
    tiles = tiles.to(resolve_device(device))
    return normalize_tiles(
        tiles, ts.tile_map, ts.B, valid1, valid2, evec=evec, ooe=ooe,
        cis=cis, ignore_diags=ignore_diags, frame_shift=frame_shift,
        slab=slab,
    )


def normalized_stack(tile_stack, valid1, valid2, evec, device, **norm):
    """A host ``TileStack`` or ``SymTileStack`` uploaded to ``device``,
    expanded and normalized into ONE NaN-encoded float32 stack
    [K+1, B, B] (``normalize_tiles`` with the keywords ``norm``)."""
    if isinstance(tile_stack, SymTileStack):
        tiles = expand_sym(tile_stack, device)
    elif isinstance(tile_stack, TileStack):
        tiles = torch.from_numpy(
            np.ascontiguousarray(tile_stack.tiles, np.float32)
        ).to(device)
    else:
        raise TypeError(
            f"normalized_stack: unsupported {type(tile_stack).__name__}"
        )
    return normalize_tiles(
        tiles, tile_stack.tile_map, tile_stack.B, valid1, valid2, evec=evec,
        **norm,
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
