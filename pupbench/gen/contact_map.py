"""The contact map of a configuration, drawn on the device from the seed
by the module that its ``map.kind`` names (``maps/<kind>.py``), as the
upper-triangle pixels and weights that the program and the reference both
read."""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np


@dataclass
class ContactMap:
    """Upper-triangle pixels in global bin ids, sorted by (bin1, bin2), and
    the per-bin weights, as host arrays. The reference and the program
    read these same arrays."""

    chroms: list
    bins_per: int
    binsize: int
    bin1: np.ndarray  # int64
    bin2: np.ndarray  # int64
    count: np.ndarray  # int32
    weights: np.ndarray  # float64, NaN = bad bin
    chrom_pixel_offset: np.ndarray  # [n_chroms + 1] pixel row offsets

    @property
    def chromsizes(self):
        return {c: self.bins_per * self.binsize for c in self.chroms}

    def chrom_pixels(self, k):
        """Local (bin1, bin2, count) of the k-th chromosome."""
        lo, hi = self.chrom_pixel_offset[k], self.chrom_pixel_offset[k + 1]
        off = k * self.bins_per
        return (self.bin1[lo:hi] - off, self.bin2[lo:hi] - off,
                self.count[lo:hi])

    def chrom_weights(self, k):
        return self.weights[k * self.bins_per:(k + 1) * self.bins_per]


def draw(map_cfg, seed, device):
    """Draw the configuration's map from ``seed`` on ``device``."""
    kind = importlib.import_module(f"pupbench.gen.maps.{map_cfg['kind']}")
    return kind.draw(map_cfg, seed, device)
