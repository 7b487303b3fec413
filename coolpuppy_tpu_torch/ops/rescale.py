"""Rescaled (variable-size) snips: the counterpart of
``coolpuppy_tpu/ops/rescale.py``, as torch ops.

Every snip's window has its own logical size (h1, w2). It is cut at a
padded size Hmax from the region's NaN-encoded normalized stack
(``ops/tiles.cut_windows``) and resized to R×R by two matmuls with
area-overlap operators,

    out = L(h1) @ win @ L(w2)^T,   L ∈ [R, Hmax],
    L[i, k] = |out-cell i ∩ in-cell k| · R / h,

whose rows sum to 1: an area-weighted average resize. The JAX package uses
this operator in place of upstream's spline ``zoom_array`` (its own
documented departure, DESIGN.md); the port follows the JAX package. The
products run in full float32 (``full_fp32``): the reference pins
``Precision.HIGHEST``.

NaN handling follows the reference: the NaN-indicator plane is resized with
the same operators and any output pixel it touches by more than 1e-6 adds 0
to ``sum`` and 0 to ``num``; an empty or all-NaN snip adds 0 to ``sum`` and
1 to ``num``. The grouped sums are float32 ``index_add_`` over the group
ids.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from .tiles import cut_windows

# an output pixel that the resized NaN plane touches by more than this is
# dropped (reference ops/rescale.py:171)
TOUCH_EPS = 1e-6


@dataclass(frozen=True)
class RescaleConfig:
    R: int  # output size (odd)
    Hmax: int  # padded window (>= every snip's extent)
    capacity: int  # accumulator rows (kind x group, flip banks)
    emit_expected: bool
    coverage: bool
    stripes: bool
    local: bool  # symmetrize before the resize (reference :157-164)


def block_size(hmax):
    """Snips per block of the rescale step (the reference's
    ``min(64, max(8, 4096 // hmax))``): one block holds ``block × Hmax²``
    window pixels, a few hundred MB of temporaries at Hmax = 1024."""
    return min(64, max(8, 4096 // max(1, int(hmax))))


@contextlib.contextmanager
def full_fp32():
    """Run the block's matmuls in full float32: TF32 off for the span of
    the block (``torch.backends.cuda.matmul.allow_tf32`` is False, the
    float32 matmul precision "highest"), the caller's setting restored
    after it."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("TF32 is still enabled for float32 matmuls")
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def resize_matrix(h, R, Hmax, device=None):
    """Area-overlap operators [..., R, Hmax] for input lengths ``h`` (a
    tensor of any shape, or an int), float32, with the arithmetic of the
    reference's jitted step: XLA folds its ``h / R`` into ``h * fl32(1/R)``,
    and the port computes that form, so that the same rounding decides
    which input cells an output cell overlaps. (Where a cell edge falls on
    an input cell's edge, that rounding leaves an overlap of up to ~1e-5
    that decides whether a NaN pixel there touches the output pixel.)"""
    h = torch.as_tensor(h, device=device).to(torch.float32)
    dev = h.device
    i = torch.arange(R, device=dev, dtype=torch.float32)[:, None]
    k = torch.arange(Hmax, device=dev, dtype=torch.float32)[None, :]
    inv_r = torch.reciprocal(torch.tensor(float(R), device=dev))
    cell = (h * inv_r)[..., None, None]  # input cells per output cell
    lo = i * cell
    hi = (i + 1.0) * cell
    overlap = torch.clamp(
        torch.minimum(hi, k + 1.0) - torch.maximum(lo, k), min=0.0
    )
    return overlap / torch.clamp(cell, min=1e-30)


def resize2d(win, h, w, R, Hmax):
    """Area-resize padded windows [..., Hmax, Hmax] of logical size (h, w)
    to [..., R, R]: ``L(h) @ win @ L(w)^T``."""
    L = resize_matrix(h, R, Hmax, device=win.device)
    Rm = resize_matrix(w, R, Hmax, device=win.device)
    return torch.matmul(torch.matmul(L, win), Rm.transpose(-1, -2))


def resize1d(vec, h, R, Hmax):
    """Area-resize padded vectors [..., Hmax] of logical length h to
    [..., R]."""
    L = resize_matrix(h, R, Hmax, device=vec.device)
    return torch.matmul(L, vec[..., None])[..., 0]


def area_resize_host(arr, out_shape):
    """Numpy twin of resize2d/resize1d (reference ops/rescale.py:96-118):
    exact area-overlap average resize of a 1D or 2D array to ``out_shape``,
    in float64."""

    def op(n_in, n_out):
        i = np.arange(n_out)[:, None].astype(np.float64)
        k = np.arange(n_in)[None, :].astype(np.float64)
        cell = n_in / n_out
        overlap = np.maximum(
            0.0, np.minimum((i + 1) * cell, k + 1) - np.maximum(i * cell, k)
        )
        return overlap / max(cell, 1e-30)

    arr = np.asarray(arr, dtype=np.float64)
    if arr.ndim == 1:
        return op(arr.shape[0], out_shape[0]) @ arr
    left = op(arr.shape[0], out_shape[0])
    right = op(arr.shape[1], out_shape[1])
    return left @ arr @ right.T


def _resize_masked(plane, nanplane, h, w, R, H):
    """Resize a zero-filled plane and its NaN indicator; returns the resized
    plane with touched pixels zeroed and the 0/1 count plane."""
    rs = resize2d(plane, h, w, R, H)
    touched = resize2d(nanplane, h, w, R, H) > TOUCH_EPS
    return (torch.where(touched, 0.0, rs),
            torch.where(touched, 0.0, 1.0))


def rescale_block(stiles, tile_map, evec, cov1, cov2, r1, r2, h1, w2, dd0,
                  cfg):
    """Per-snip R×R planes of one block of snips (the reference's
    ``per_snip`` and ``block_fn``, :139-243), from the normalized stack
    ``stiles`` [K, B, B] and its device tile map.

    The logical [h1, w2] window is the top-left corner of a padded
    [Hmax, Hmax] window. A stack pixel is NaN where masked (bad bin, |diag|
    < ignore_diags) and holds the OOE-divided value otherwise; non-finite
    values (+inf poison included) count as NaN, as in the reference
    (:151-155). Returns a dict of float32 tensors: ``sum``/``num``
    [b, R, R], with ``exp_sum``/``exp_num`` (the unmasked expected window,
    resized), ``cov_start``/``cov_end`` [b, R] and the stripes
    ``horizontal_stripe``/``vertical_stripe`` [b, R] (the centre row, and
    the centre column reversed) when the config asks for them."""
    R, H = cfg.R, cfg.Hmax
    dev = stiles.device
    ar = torch.arange(H, device=dev)
    win = cut_windows(stiles, tile_map, r1, r2, H, h1, w2)
    in1 = ar[None, :] < h1[:, None]
    in2 = ar[None, :] < w2[:, None]
    inside = in1[:, :, None] & in2[:, None, :]
    fin = torch.isfinite(win) & inside
    dat = torch.where(fin, win, 0.0)
    if cfg.local:
        # nanmean(data, data.T) before resizing (reference :157-164)
        finT = fin.transpose(1, 2)
        cnt = fin.to(torch.float32) + finT.to(torch.float32)
        s = dat + dat.transpose(1, 2)
        fin = (cnt > 0) & inside
        dat = torch.where(fin, s / torch.clamp(cnt, min=1.0), 0.0)
    nanplane = (inside & ~fin).to(torch.float32)
    empty = ~fin.flatten(1).any(1)[:, None, None]

    out = {}
    rs, num = _resize_masked(dat, nanplane, h1, w2, R, H)
    out["sum"] = torch.where(empty, 0.0, rs)
    out["num"] = torch.where(empty, 1.0, num)

    if cfg.emit_expected:
        # the unmasked expected toeplitz of the window (reference :181-189)
        dij = ar[:, None] - ar[None, :]
        absd = (dd0[:, None, None] + dij[None]).abs()
        ew = evec[absd.clamp_(max=evec.shape[0] - 1)]
        efin = torch.isfinite(ew)
        out["exp_sum"], out["exp_num"] = _resize_masked(
            torch.where(efin & inside, ew, 0.0),
            (inside & ~efin).to(torch.float32), h1, w2, R, H,
        )

    if cfg.coverage:
        # per-bin coverage slices of Hmax bins; the operator weighs bins past
        # the logical length (almost) zero (reference :231-241)
        for key, cov, start, n in (("cov_start", cov1, r1, h1),
                                   ("cov_end", cov2, r2, w2)):
            c = cov[start[:, None] + ar[None, :]]
            c = torch.where(torch.isfinite(c), c, 0.0)
            out[key] = resize1d(c, n, R, H)

    if cfg.stripes:
        c = R // 2
        snip = torch.where(out["num"] > 0, out["sum"], torch.nan)
        out["horizontal_stripe"] = snip[:, c, :]
        out["vertical_stripe"] = snip[:, :, c].flip(1)
    return out


def rescale_accumulate(stiles, tile_map, evec, cov1, cov2, r1, r2, h1, w2,
                       dd0, cid, cfg, block=None):
    """The rescale step over a snip stream (the reference's
    ``make_rescale_step_fn``): blocks of ``block_size(Hmax)`` snips through
    ``rescale_block``, per-snip planes added into float32 accumulators
    [capacity, R, R] (``cov_*`` [capacity, R]) by ``index_add_`` over
    ``cid``. Every per-snip input is an int tensor on ``stiles.device``.
    Returns the accumulators, plus the stripes of every snip in stream
    order ([n, R] each) when ``cfg.stripes``."""
    R, C = cfg.R, cfg.capacity
    dev = stiles.device
    block = block or block_size(cfg.Hmax)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                       device=dev)
    acc = {"sum": zeros(C, R, R), "num": zeros(C, R, R)}
    if cfg.emit_expected:
        acc["exp_sum"] = zeros(C, R, R)
        acc["exp_num"] = zeros(C, R, R)
    if cfg.coverage:
        acc["cov_start"] = zeros(C, R)
        acc["cov_end"] = zeros(C, R)
    stripes = {"horizontal_stripe": [], "vertical_stripe": []}
    with full_fp32():
        for lo in range(0, len(r1), block):
            sl = slice(lo, lo + block)
            planes = rescale_block(stiles, tile_map, evec, cov1, cov2,
                                   r1[sl], r2[sl], h1[sl], w2[sl], dd0[sl],
                                   cfg)
            for k, v in planes.items():
                if k in stripes:
                    stripes[k].append(v)
                else:
                    acc[k].index_add_(0, cid[sl], v)
    if cfg.stripes:
        for k, v in stripes.items():
            acc[k] = torch.cat(v) if v else zeros(0, R)
    return acc
