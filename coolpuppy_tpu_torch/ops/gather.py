"""The generic pile-up step and the accumulator helpers (counterpart of
``coolpuppy_tpu/ops/gather.py``).

Copied as numpy, because the reference module imports jax at its top: the
flip-bank merge and the exact histogram forms of the coverage and
expected-emission side sums. As torch ops: the coverage scatter-add that
replaces the histogram at by-window group counts, and ``generic_accumulate``,
the counterpart of ``make_pileup_step_fn`` for windows wider than the quad
kernel takes (W > 120).
"""

from __future__ import annotations

import numpy as np
import torch

from .tiles import cut_windows

COV_CHUNK = 131072  # snips per coverage scatter-add (coverage_scatter_sums)
GENERIC_PIXELS = 1 << 24  # window pixels per block of generic_accumulate


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


def generic_accumulate(stiles, tile_map, r1, r2, cid, W, C, stripes=False,
                       block=None):
    """The generic fused step (the reference's ``make_pileup_step_fn``,
    ops/gather.py:111-234) for any window size W: each snip's [W, W] window
    is cut from the NaN-encoded normalized stack ``stiles`` (masked pixels
    NaN, OOE-divided values, +inf poison; ``ops/tiles.cut_windows``) and
    added into float32 accumulators [C, W, W] by ``index_add_`` over
    ``cid``: ``sum`` the finite values, ``num`` their count, ``poison`` the
    count of infinite values. Blocks of ``block`` snips bound the
    temporaries (``GENERIC_PIXELS`` window pixels, ~300 MB). With
    ``stripes``, also returns every snip's centre row and reversed centre
    column [n, W], non-finite values as NaN (reference :157-165).
    ``r1``, ``r2`` and ``cid`` are int tensors on ``stiles.device``."""
    dev = stiles.device
    block = block or max(1, GENERIC_PIXELS // (W * W))
    acc = {k: torch.zeros((C, W, W), dtype=torch.float32, device=dev)
           for k in ("sum", "num", "poison")}
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
