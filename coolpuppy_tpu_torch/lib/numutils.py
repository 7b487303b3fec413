"""Pileup array helpers (counterpart of ``coolpuppy_tpu/lib/numutils.py``,
copied as numpy). Only what the engine calls is copied."""

from __future__ import annotations

import numpy as np


def _copy_array_halves(x):
    """Mirror the right half of an array onto the left, in place (reference
    lib/numutils.py:6–9; used for local stripe symmetrization)."""
    cntr = int(np.floor(x.shape[1] / 2))
    x[:, : (cntr + 1)] = np.fliplr(x[:, cntr:])
    return x
