"""Pileup matrix statistics (counterpart of
``coolpuppy_tpu/lib/numutils.py``, copied as numpy).

Pure numpy on small W×W pileups: post-processing and the scores a hook
computes per snip, never the device path.
"""

from __future__ import annotations

import numpy as np


def fill_diag(arr, x, i=0, copy=True):
    """Set the i-th diagonal of a square array to x (cooltools.numutils
    counterpart used by get_insulation_strength)."""
    if copy:
        arr = arr.copy()
    n = arr.shape[0]
    if i >= 0:
        idx = np.arange(n - i)
        arr[idx, idx + i] = x
    else:
        idx = np.arange(n + i)
        arr[idx - i, idx] = x
    return arr


def _copy_array_halves(x):
    """Mirror the right half of an array onto the left, in place (reference
    lib/numutils.py:6–9; used for local stripe symmetrization)."""
    cntr = int(np.floor(x.shape[1] / 2))
    x[:, : (cntr + 1)] = np.fliplr(x[:, cntr:])
    return x


def corner_cv(amap, i=4):
    """Coefficient of variation of the upper-left + lower-right corner pixels
    (noise estimate; reference lib/numutils.py:12–33)."""
    corners = np.concatenate((amap[0:i, 0:i], amap[-i:, -i:]))
    corners = corners[np.isfinite(corners)]
    return np.std(corners) / np.mean(corners)


def norm_cis(amap, i=3):
    """Normalize by the mean of corner pixels (reference
    lib/numutils.py:36–57)."""
    if i > 0:
        return amap / np.nanmean((amap[0:i, 0:i] + amap[-i:, -i:])) * 2
    return amap


def get_enrichment(amap, n):
    """Mean of the central n×n square (reference lib/numutils.py:60–79)."""
    c = amap.shape[0] // 2
    if c < n:
        raise ValueError(
            f"Central pixel value {n} is too large, can be maximum {c}"
        )
    return np.nanmean(
        amap[c - n // 2 : c + n // 2 + 1, c - n // 2 : c + n // 2 + 1]
    )


def get_local_enrichment(amap, flank=1):
    """Mean of the central (1/(2*flank+1)) fraction square (reference
    lib/numutils.py:82–103)."""
    c = amap.shape[0] / (flank * 2 + 1)
    assert int(c) == c
    c = int(c)
    return np.nanmean(amap[c:-c, c:-c])


def get_domain_score(amap, flank=1):
    """Central square sum over top+right rectangles ×2 (reference
    lib/numutils.py:106–132)."""
    c = amap.shape[0] / (flank * 2 + 1)
    assert int(c) == c
    c = int(c)
    central = np.nansum(amap[c:-c, c:-c])
    top = np.nansum(amap[:c, c:-c])
    right = np.nansum(amap[c:-c, -c:])
    return central / (top + right) * 2


def get_insulation_strength(amap, ignore_central=0, ignore_diags=2):
    """Intra-corner over inter-corner means (reference
    lib/numutils.py:135–166)."""
    for d in range(ignore_diags):
        amap = fill_diag(amap, np.nan, d)
        if d != 0:
            amap = fill_diag(amap, np.nan, -d)
    if ignore_central != 0 and ignore_central % 2 != 1:
        raise ValueError(
            f"ignore_central has to be odd (or 0), got {ignore_central}"
        )
    i = (amap.shape[0] - ignore_central) // 2
    intra = np.nanmean(
        np.concatenate([amap[:i, :i].ravel(), amap[-i:, -i:].ravel()])
    )
    inter = np.nanmean(
        np.concatenate([amap[:i, -i:].ravel(), amap[-i:, :i].ravel()])
    )
    return intra / inter
