"""Host-side accumulator helpers (counterpart of
``coolpuppy_tpu/ops/gather.py``).

``merge_flip_banks`` is copied as numpy because the reference module imports
jax at its top.
"""

from __future__ import annotations

import numpy as np


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
