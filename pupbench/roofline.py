"""The least time the card could take for a job's accumulation, counted
from the job's windows alone (never from the program's tiles, items or
launch shapes), and the card's published peaks.

Work of a set of windows:

- bytes: each distinct map pixel that the windows cover, counted once (a
  stored pixel of the symmetric map: (r, c) and (c, r) are one), at 4
  bytes; each window's two coordinates and group read once, 12 bytes; each
  group's W x W sum and count written once, 8 bytes a pixel;
- operations: one add to the sum and one to the count, a window pixel.

The bound is the larger of bytes / ``PEAK_BYTES_S`` and operations /
``PEAK_FLOPS``.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet at its 700 W limit: HBM3 bandwidth, float32
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = 67e12
PIXEL_BYTES = 4
SNIP_BYTES = 12
OUT_BYTES = 8


def covered(n, st1, st2, W, device):
    """Boolean [n, n] map of the pixels that W x W windows with top-left
    corners (st1, st2) cover, mirrored, so that its upper triangle holds
    every stored pixel that some window reads."""
    origins = torch.zeros(n, n, dtype=torch.int32, device=device)
    r = torch.as_tensor(st1, device=device, dtype=torch.int64)
    c = torch.as_tensor(st2, device=device, dtype=torch.int64)
    ones = torch.ones(len(r), dtype=torch.int32, device=device)
    flat = origins.view(-1)
    flat.index_add_(0, r * n + c, ones)
    flat.index_add_(0, c * n + r, ones)
    q = torch.zeros(n + W, n + W, dtype=torch.int32, device=device)
    q[W:, W:] = origins.cumsum(0, dtype=torch.int32).cumsum(
        1, dtype=torch.int32)
    del origins
    box = q[W:, W:] - q[:n, W:] - q[W:, :n] + q[:n, :n]
    return box > 0


class Work:
    """Bytes and operations of the windows added with ``add``, per
    block of ``n`` bins; the covered pixels of each block are
    kept as a union, so the order and the split of the windows into calls
    change nothing."""

    def __init__(self, n, device="cpu"):
        self.n, self.device = int(n), device
        self.maps = {}
        self.snips = 0
        self.window_pixels = 0
        self.groups = {}

    def add(self, chrom, st1, st2, W, cid):
        """Windows of size W at (st1, st2) of block ``chrom``, each
        accumulated into group ``cid``."""
        if len(st1) == 0:
            return
        cov = covered(self.n, st1, st2, int(W), self.device)
        self.maps[chrom] = (cov if chrom not in self.maps
                            else self.maps[chrom] | cov)
        self.snips += len(st1)
        self.window_pixels += len(st1) * int(W) ** 2
        for g in set(int(x) for x in cid):
            self.groups[g] = int(W)

    def pixels(self):
        return sum(int(torch.triu(m).sum()) for m in self.maps.values())

    def bytes(self):
        out = sum(w * w for w in self.groups.values())
        return (PIXEL_BYTES * self.pixels() + SNIP_BYTES * self.snips
                + OUT_BYTES * out)

    def ops(self):
        return 2 * self.window_pixels

    def bound_s(self):
        """(seconds, "bytes" or "operations")."""
        tb, to = self.bytes() / PEAK_BYTES_S, self.ops() / PEAK_FLOPS
        return (tb, "bytes") if tb >= to else (to, "operations")


def job_work(job, device="cpu"):
    """The ``Work`` of a ``reference.coords.JobSnips``."""
    work = Work(job.n, device)
    G = len(job.labels)
    for block, s in job.blocks.items():
        if len(s) and (s.h != s.h[0]).any():
            raise ValueError("a roofline needs windows of one size")
        if len(s):
            work.add(block, s.st1, s.st2, int(s.h[0]), s.kind * G + s.group)
    return work
