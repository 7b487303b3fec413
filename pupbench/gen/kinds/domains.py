"""Domains: widths of a log-normal law about ``median_width_bp`` with
log-sd ``width_log_sigma``, taken at its n quantiles (i + 1/2) / n for the
n domains of a chromosome, rounded to whole bins, clipped to
[``min_width_bp``, ``max_width_bp``] and put in a random order. Every
chromosome of every job holds the same set of widths, so the seed moves
the domains and not the work."""

from statistics import NormalDist

import numpy as np


def widths(feat_cfg, n, res):
    """The n widths in bins, ascending."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    med = float(feat_cfg["median_width_bp"]) / res
    w = np.rint(med * np.exp(float(feat_cfg["width_log_sigma"]) * z))
    return np.clip(w, int(feat_cfg["min_width_bp"]) // res,
                   int(feat_cfg["max_width_bp"]) // res).astype(np.int64)


def draw(feat_cfg, start, res, rng):
    w = rng.permutation(widths(feat_cfg, len(start), res))
    return start + w * res, {}
