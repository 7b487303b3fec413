"""The generic pile-up step and the accumulator helpers (counterpart of
``coolpuppy_tpu/ops/gather.py``).

Copied as numpy, because the reference module imports jax at its top: the
flip-bank merge and the exact histogram forms of the coverage and
expected-emission side sums. As torch ops: the coverage scatter-add that
replaces the histogram at by-window group counts, and ``generic_accumulate``,
the counterpart of ``make_pileup_step_fn`` for windows wider than the quad
kernel takes (W > 120): on the card one launch of the hand-written wide
kernel (``csrc/wide_accumulate.cu``) over work items of one tile and one
group (``wide_items``), on the CPU its plain version
``generic_accumulate_plain``.
"""

from __future__ import annotations

import numpy as np
import torch

from .quad_gather import B_TILE, C_MAX, centre_lines
from .tiles import cut_windows

COV_CHUNK = 131072  # snips per coverage scatter-add (coverage_scatter_sums)
GENERIC_PIXELS = 1 << 24  # window pixels per block of generic_accumulate
# the wide kernel (csrc/wide_accumulate.cu): most snips in one work item,
# and the window pixels of one block (256 threads of 8 pixels: kBand there)
ITEM_MAX = 1024
WIDE_BAND = 2048
# launches of the wide kernel in this process (the engine reads it to name
# its route, the tests to count)
LAUNCHES = 0


def merge_flip_banks(out, half):
    """Collapse the flip bank: slots [half:2*half] hold snips accumulated
    unflipped that *should* be flipped; anti-transpose those sums once and add
    them to slots [0:half]. Linearity of the flip makes this exactly equal to
    flipping every snip individually (reference coolpup.py:128–131).
    Coverage vectors are NOT flipped, matching the reference (flip_snip_func
    swaps no cov_ keys)."""
    merged = {}
    for k, v in out.items():
        if k in ("horizontal_stripe", "vertical_stripe"):
            merged[k] = v
            continue
        lo, hi = v[:half], v[half : 2 * half]
        if v.ndim == 3:  # [C, W, W] planes get anti-transposed
            hi = np.flip(hi, axis=(-2, -1)).swapaxes(-2, -1)
        merged[k] = lo + hi
    return merged


def coverage_histogram_sums(cid, r1, r2, cov1, cov2, W, G):
    """cov_start / cov_end [G, W] accumulated EXACTLY from per-(group,
    start-bin) histograms: the per-group sum of coverage-vector slices is
    Σ_r h[g, r]·cov[r : r + W] — one [G, n] @ [n, W] matmul, with h built by
    one bincount over the snip stream (the per-snip coverage slices of
    reference coolpup.py:1152–1153). Nonfinite coverage values contribute
    0. Memory is O(G·n)."""
    cid = np.asarray(cid, np.int64)

    def one(cov, starts):
        cov = np.asarray(cov, np.float64)
        cov = np.where(np.isfinite(cov), cov, 0.0)
        n = len(cov)
        h = np.bincount(
            cid * n + np.asarray(starts, np.int64), minlength=G * n
        ).reshape(G, n).astype(np.float64)
        win = np.lib.stride_tricks.sliding_window_view(
            np.concatenate([cov, np.zeros(W - 1)]), W
        )  # [n, W]
        return h @ win

    return one(cov1, r1), one(cov2, r2)


def coverage_scatter_sums(cid, r1, r2, cov1, cov2, W, G, device,
                          chunk=COV_CHUNK):
    """cov_start / cov_end [G, W] by scatter-add on ``device`` (counterpart
    of the reference's ``make_cov_step``, for group counts whose [G, n]
    histogram would be too large): every snip's ``W``-slice of each
    coverage vector, non-finite values set to 0, goes through
    ``index_add_`` into a float32 [G, W] accumulator, ``chunk`` snips at a
    time. Returns float64 numpy arrays."""
    cid_all = np.asarray(cid, np.int64)
    ar = torch.arange(W, device=device)
    sums = []
    for cov, starts in ((cov1, r1), (cov2, r2)):
        c = torch.from_numpy(np.asarray(cov, np.float32)).to(device)
        c = torch.where(torch.isfinite(c), c, 0.0)
        acc = torch.zeros((G, W), dtype=torch.float32, device=device)
        starts = np.asarray(starts, np.int64)
        for lo in range(0, len(cid_all), chunk):
            hi = min(lo + chunk, len(cid_all))
            s = torch.from_numpy(starts[lo:hi]).to(device)
            g = torch.from_numpy(cid_all[lo:hi]).to(device)
            acc.index_add_(0, g, c[s[:, None] + ar[None, :]])
        sums.append(acc.cpu().numpy().astype(np.float64))
    return sums[0], sums[1]


def expected_toeplitz_sums(cid, dd0, evec, W, G):
    """exp_sum / exp_num [G, W, W]: the expected-emission accumulators
    (ooe=False) computed EXACTLY from the (group, dd0) histogram — each
    snip's expected window is the toeplitz E(|dd0 + i − j|), so the per-group
    sum is Σ_d h[g,d]·E(|d + i − j|). Unmasked, like the reference's exp
    channel (coolpup.py:1130–1138); toeplitz planes are invariant under the
    flip anti-transpose, so flipped snips need no special casing."""
    evec = np.atleast_1d(np.asarray(evec, dtype=np.float64))
    uniq, inv = np.unique(np.asarray(dd0), return_inverse=True)
    hist = np.zeros((G, len(uniq)))
    np.add.at(hist, (np.asarray(cid), inv), 1.0)

    offsets = np.arange(-(W - 1), W)  # k = i - j
    idx = np.abs(uniq[None, :] + offsets[:, None])  # [2W-1, D]
    ek = evec[np.minimum(idx, len(evec) - 1)]  # clipped like the device path
    finite = np.isfinite(ek)
    m_sum = hist @ np.where(finite, ek, 0.0).T  # [G, 2W-1]
    m_num = hist @ finite.T.astype(np.float64)

    kmap = (np.arange(W)[:, None] - np.arange(W)[None, :]) + (W - 1)
    return m_sum[:, kmap], m_num[:, kmap]


def generic_accumulate_plain(stiles, tile_map, r1, r2, cid, W, C,
                             stripes=False, block=None):
    """Plain PyTorch version of the generic step (the reference's
    ``make_pileup_step_fn``, ops/gather.py:111-234) for any window size W:
    each snip's [W, W] window is cut from the NaN-encoded normalized stack
    ``stiles`` (masked pixels NaN, OOE-divided values, +inf poison;
    ``ops/tiles.cut_windows``) and added into float32 accumulators
    [C, W, W] by ``index_add_`` over ``cid``: ``sum`` the finite values,
    ``num`` their count, ``poison`` the count of infinite values. Blocks of
    ``block`` snips bound the temporaries (``GENERIC_PIXELS`` window
    pixels, ~300 MB). With ``stripes``, also returns every snip's centre
    row and reversed centre column [n, W], non-finite values as NaN
    (reference :157-165). ``r1``, ``r2`` and ``cid`` are int tensors on
    ``stiles.device``."""
    dev = stiles.device
    block = block or max(1, GENERIC_PIXELS // (W * W))
    acc = _zero_acc(C, W, dev)
    hs, vs = [], []
    mid = W // 2
    for lo in range(0, len(r1), block):
        sl = slice(lo, lo + block)
        win = cut_windows(stiles, tile_map, r1[sl], r2[sl], W)
        fin = torch.isfinite(win)
        g = cid[sl]
        acc["sum"].index_add_(0, g, torch.where(fin, win, 0.0))
        acc["num"].index_add_(0, g, fin.to(torch.float32))
        acc["poison"].index_add_(0, g, torch.isinf(win).to(torch.float32))
        if stripes:
            snip = torch.where(fin, win, torch.nan)
            hs.append(snip[:, mid, :])
            vs.append(snip[:, :, mid].flip(1))
    if stripes:
        empty = torch.zeros((0, W), dtype=torch.float32, device=dev)
        acc["horizontal_stripe"] = torch.cat(hs) if hs else empty
        acc["vertical_stripe"] = torch.cat(vs) if vs else empty
    return acc


def _zero_acc(C, W, device):
    return {k: torch.zeros((C, W, W), dtype=torch.float32, device=device)
            for k in ("sum", "num", "poison")}


def wide_slots(W):
    """R, the side of the R x R tile slots of a wide-kernel item: a window
    at offsets below 128 in its top-left tile reaches ``127 + W - 1`` rows
    and columns past that tile's first."""
    return -(-(B_TILE - 1 + W) // B_TILE)


def wide_bands(W):
    """Blocks of the wide kernel an item: bands of ``WIDE_BAND`` pixels."""
    return -(-(W * W) // WIDE_BAND)


def wide_items(tile_map, r1, r2, cid, W, C, item_max=ITEM_MAX):
    """The wide kernel's work items, as torch ops on the snips' device.

    Every snip is packed into one int32 word (``quad_gather.pack_snips``:
    its offsets ``r1 % 128`` and ``r2 % 128`` in its top-left tile, its
    group) and the words are sorted stably by the key ``tile * C + cid``,
    with ``tile = (r1 // 128) * ncol + r2 // 128`` on the tile map's grid
    (``torch.sort(stable=True)`` on the device: the snips already live
    there, so nothing crosses to the host but the item count). Each
    (tile, group) run is cut into ``ceil(n / item_max)`` items of equal
    length (the last may be shorter). Returns int32 ``(slots, istart,
    icount, snips)``: per item its R x R tile slots (``wide_slots``; row
    ``u``, column ``v`` at ``u * R + v``; a slot past the map's edge is 0,
    the all-NaN tile, which no window inside the map reads) and its span of
    the sorted words. Raises where a window starts below 0 or leaves the
    map, or a group lies outside [0, C)."""
    dev = r1.device
    n = int(r1.shape[0])
    R = wide_slots(W)
    nrm, ncm = (int(x) for x in tile_map.shape)
    if not 1 <= C <= C_MAX:
        raise ValueError(f"wide_items: C={C} outside [1, {C_MAX}]")
    if n == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z.reshape(0, R * R), z, z, z
    r1, r2, cid = (x.to(torch.int64) for x in (r1, r2, cid))
    lo1, lo2, hi1, hi2, glo, ghi = torch.stack(
        [r1.min(), r2.min(), r1.max(), r2.max(), cid.min(), cid.max()]
    ).tolist()
    if min(lo1, lo2) < 0 or (hi1 + W - 1) // B_TILE >= nrm or \
            (hi2 + W - 1) // B_TILE >= ncm:
        raise ValueError(
            f"wide_items: windows of rows [{lo1}, {hi1 + W}) and columns "
            f"[{lo2}, {hi2 + W}) leave the tile map of {nrm} x {ncm} tiles")
    if glo < 0 or ghi >= C:
        raise ValueError(f"wide_items: group ids must lie in [0, {C})")
    if n >= 1 << 31 or ncm * nrm * C >= 1 << 62:
        raise ValueError(f"wide_items: {n} snips or the key overflows")
    words = ((r1 % B_TILE) << 24) | ((r2 % B_TILE) << 17) | cid
    key = ((r1 // B_TILE) * ncm + r2 // B_TILE) * C + cid
    key, order = torch.sort(key, stable=True)
    snips = words[order].to(torch.int32)
    brk = torch.ones(n, dtype=torch.bool, device=dev)
    brk[1:] = key[1:] != key[:-1]
    rs = torch.nonzero(brk).flatten()
    rc = torch.diff(rs, append=torch.tensor([n], device=dev))
    pieces = -(-rc // item_max)
    size = -(-rc // pieces)
    run_of = torch.repeat_interleave(
        torch.arange(len(rs), device=dev), pieces)
    first = (torch.cumsum(pieces, 0) - pieces)[run_of]
    off = (torch.arange(len(run_of), device=dev) - first) * size[run_of]
    istart = rs[run_of] + off
    icount = torch.minimum(rc[run_of] - off, size[run_of])
    tile = key[istart] // C
    u = torch.arange(R, device=dev)
    rows = (tile // ncm)[:, None] + u  # [items, R]
    cols = (tile % ncm)[:, None] + u
    inside = (rows < nrm)[:, :, None] & (cols < ncm)[:, None, :]
    slots = tile_map[rows.clamp(max=nrm - 1)[:, :, None],
                     cols.clamp(max=ncm - 1)[:, None, :]]
    slots = torch.where(inside, slots, 0).reshape(-1, R * R)
    return tuple(x.to(torch.int32).contiguous()
                 for x in (slots, istart, icount, snips))


def wide_accumulate_banded_plain(stiles, slots, istart, icount, snips, W, C):
    """Plain PyTorch version of the wide kernel's addressing and order, for
    tests: per work item (``wide_items``) and band of ``WIDE_BAND`` pixels,
    each pixel ``p`` of the band at window row ``i = p // W`` and column
    ``j = p % W`` read for each snip word through the item's R x R slots:
    row ``r = a + i`` and column ``c = b + j`` of the superwindow are
    element ``(r % 128) * 128 + c % 128`` of tile ``slots[(r // 128) * R +
    c // 128]``. The band's three partial sums over the item's snips
    (float64) are flushed into the group of the item's first word, as the
    kernel flushes them. Returns float64 ``{"sum", "num", "poison"}``
    [C, W, W]."""
    band = WIDE_BAND
    R = wide_slots(W)
    flat = stiles.reshape(-1)
    out = {k: torch.zeros((C, W * W), dtype=torch.float64,
                          device=stiles.device)
           for k in ("sum", "num", "poison")}
    for sl, s, c in zip(slots.tolist(), istart.tolist(), icount.tolist()):
        w = snips[s:s + c].to(torch.int64)
        a, b = (w >> 24) & 0x7F, (w >> 17) & 0x7F
        g = int(w[0] & 0x1FFFF)
        sl = torch.tensor(sl, dtype=torch.int64, device=stiles.device)
        for lo in range(0, W * W, band):
            p = torch.arange(lo, min(lo + band, W * W), device=stiles.device)
            r = a[:, None] + (p // W)[None, :]  # [snips, pixels]
            col = b[:, None] + (p % W)[None, :]
            tile = sl[(r // B_TILE) * R + col // B_TILE]
            v = flat[(tile * B_TILE + r % B_TILE) * B_TILE + col % B_TILE]
            fin = torch.isfinite(v)
            out["sum"][g, p] += torch.where(fin, v, 0.0).double().sum(0)
            out["num"][g, p] += fin.double().sum(0)
            out["poison"][g, p] += torch.isinf(v).double().sum(0)
    return {k: v.reshape(C, W, W) for k, v in out.items()}


def _check_wide_args(stiles, tile_map, r1, r2, cid, W, C):
    if W < 1 or wide_bands(W) * WIDE_BAND >= 1 << 31:
        raise ValueError(f"wide_accumulate: W={W} outside what it takes")
    if not 1 <= C <= C_MAX:
        raise ValueError(f"wide_accumulate: C={C} outside [1, {C_MAX}]")
    if stiles.dtype != torch.float32 or stiles.dim() != 3 or tuple(
        stiles.shape[1:]
    ) != (B_TILE, B_TILE) or not stiles.is_contiguous():
        raise ValueError(
            "wide_accumulate: stiles must be contiguous float32 "
            f"[K, 128, 128], got {stiles.dtype} {tuple(stiles.shape)}")
    if tile_map.dim() != 2:
        raise ValueError("wide_accumulate: tile_map must be 2-D")
    for name, t in (("tile_map", tile_map), ("r1", r1), ("r2", r2),
                    ("cid", cid)):
        if t.device != stiles.device:
            raise ValueError(f"wide_accumulate: {name} on {t.device}, "
                             f"stiles on {stiles.device}")
        if t.dtype.is_floating_point or t.dtype == torch.bool:
            raise ValueError(f"wide_accumulate: {name} must be integer, "
                             f"got {t.dtype}")
    if not r1.shape == r2.shape == cid.shape or r1.dim() != 1:
        raise ValueError("wide_accumulate: r1, r2 and cid must be [n] alike")


def wide_accumulate(stiles, tile_map, r1, r2, cid, W, C):
    """One launch of the wide kernel (``csrc/wide_accumulate.cu``) on CUDA
    tensors: ``sum``, ``num`` and ``poison`` float32 [C, W, W] of the
    generic step, without stripes, for any W. The items come from
    ``wide_items``; the launch takes the current stream of ``stiles``'
    device and is counted in ``LAUNCHES``. Raises where the library does
    not load, the tensors are not on a card, or the launch fails: there is
    no fallback."""
    global LAUNCHES
    _check_wide_args(stiles, tile_map, r1, r2, cid, W, C)
    from ..kernels.build import load_kernels

    lib = load_kernels()
    dev = stiles.device
    if dev.type != "cuda":
        raise ValueError(f"wide_accumulate: no kernel for {dev}")
    lo, hi = (torch.stack([tile_map.min(), tile_map.max()]).tolist()
              if tile_map.numel() else (0, 0))
    if lo < 0 or hi >= stiles.shape[0]:
        raise ValueError(f"wide_accumulate: tile_map names slots [{lo}, "
                         f"{hi}] of a stack of {stiles.shape[0]}")
    acc = _zero_acc(C, W, dev)
    slots, istart, icount, snips = wide_items(tile_map, r1, r2, cid, W, C)
    nitems = int(istart.shape[0])
    if nitems * wide_bands(W) >= 1 << 31:
        raise ValueError(f"wide_accumulate: {nitems} items x "
                         f"{wide_bands(W)} bands overflow the grid")
    if nitems:
        # the launcher sets the kernel's device and restores the caller's
        with torch.cuda.device(dev):
            err = lib.wide_accumulate_launch(
                stiles.data_ptr(), slots.data_ptr(), istart.data_ptr(),
                icount.data_ptr(), snips.data_ptr(), nitems, W,
                wide_slots(W), C, acc["sum"].data_ptr(),
                acc["num"].data_ptr(), acc["poison"].data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream, dev.index,
            )
        if err != 0:
            msg = lib.wide_accumulate_error_string(err).decode()
            raise RuntimeError(f"wide_accumulate: kernel launch failed, "
                               f"CUDA error {err} ({msg})")
        LAUNCHES += 1
    return acc


def wide_stripes(stiles, tile_map, r1, r2, W):
    """The stripe planes of the generic step without its windows: every
    snip's centre row and its centre column reversed, [n, W] each, non-finite
    values as NaN, in stream order (``quad_gather.centre_lines``, 2W pixels
    a snip, ``GENERIC_PIXELS`` pixels a gather). Equal to
    ``generic_accumulate_plain``'s."""
    hs, vs = [], []
    step = max(1, GENERIC_PIXELS // (2 * W))
    for lo in range(0, len(r1), step):
        h, v = centre_lines(stiles, tile_map, r1[lo:lo + step].to(torch.int64),
                            r2[lo:lo + step].to(torch.int64), W)
        hs.append(h)
        vs.append(v.flip(1))
    out = {}
    for k, parts in (("horizontal_stripe", hs), ("vertical_stripe", vs)):
        v = torch.cat(parts) if parts else torch.zeros(
            (0, W), dtype=torch.float32, device=stiles.device)
        out[k] = torch.where(torch.isfinite(v), v, torch.nan)
    return out


def generic_accumulate(stiles, tile_map, r1, r2, cid, W, C, stripes=False,
                       block=None):
    """The generic fused step (the reference's ``make_pileup_step_fn``,
    ops/gather.py:111-234) for any window size W: float32 ``sum`` (finite
    window values), ``num`` (their count) and ``poison`` (the count of
    infinite values) [C, W, W] over the snips' windows on the NaN-encoded
    stack ``stiles`` through ``tile_map`` (an int device grid), by group
    ``cid``; with ``stripes``, also every snip's centre row and reversed
    centre column [n, W], non-finite values as NaN.

    A CPU tensor runs ``generic_accumulate_plain`` (``block`` snips a
    gather). Any other launches the wide kernel (``wide_accumulate``,
    built at first use) and gathers the stripes as torch ops
    (``wide_stripes``), and raises on any failure."""
    if stiles.device.type == "cpu":
        return generic_accumulate_plain(stiles, tile_map, r1, r2, cid, W, C,
                                        stripes=stripes, block=block)
    acc = wide_accumulate(stiles, tile_map, r1, r2, cid, W, C)
    if stripes:
        acc.update(wide_stripes(stiles, tile_map, r1, r2, W))
    return acc
