"""Pup (accumulated pileup) algebra on small host arrays (counterpart of
``coolpuppy_tpu/lib/puputils.py``, copied as numpy/pandas): the empty pup,
the ``sum_pups`` monoid merge and coverage normalization."""

from __future__ import annotations

import numpy as np
import pandas as pd


def empty_pup(shape):
    return {
        "data": np.zeros(shape),
        "horizontal_stripe": [],
        "vertical_stripe": [],
        "n": 0,
        "num": np.zeros(shape),
        "cov_start": np.zeros(shape[0]),
        "cov_end": np.zeros(shape[1]),
        "coordinates": [],
    }


def sum_pups(pup1, pup2):
    """Monoid merge of two pups (reference lib/puputils.py:88–113, without
    the ``extra_funcs`` hook, which the port does not run yet)."""
    pup1 = dict(pup1)
    pup2 = dict(pup2)
    pup1["data"] = np.nan_to_num(pup1["data"])
    pup2["data"] = np.nan_to_num(pup2["data"])
    pup = {
        "data": pup1["data"] + pup2["data"],
        "cov_start": pup1["cov_start"] + pup2["cov_start"],
        "cov_end": pup1["cov_end"] + pup2["cov_end"],
        "n": pup1.get("n", 1) + pup2.get("n", 1),
        "num": pup1.get("num", np.isfinite(pup1["data"]).astype(int))
        + pup2.get("num", np.isfinite(pup2["data"]).astype(int)),
        "horizontal_stripe": list(pup1.get("horizontal_stripe", []))
        + list(pup2.get("horizontal_stripe", [])),
        "vertical_stripe": list(pup1.get("vertical_stripe", []))
        + list(pup2.get("vertical_stripe", [])),
        "coordinates": list(pup1.get("coordinates", []))
        + list(pup2.get("coordinates", [])),
    }
    if "poison" in pup1 or "poison" in pup2:
        pup["poison"] = pup1.get("poison", 0) + pup2.get("poison", 0)
    return pd.Series(pup)


def norm_coverage(snip):
    """Divide pup data by outer(cov_start, cov_end)/mean (reference
    lib/puputils.py:168–190)."""
    coverage = np.outer(snip["cov_start"], snip["cov_end"])
    coverage = coverage / np.nanmean(coverage)
    snip["data"] = snip["data"] / coverage
    snip["data"][np.isnan(snip["data"])] = 0
    return snip
