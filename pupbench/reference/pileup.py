"""The reference pileup of one job: every window cut from the balanced map
in float64, accumulated per group, and the table's numbers worked out
again, by the parts that the cell names (``reference/__init__.py``).

``precision="bfloat16"`` is the comparison's control: every window value
is cast through bfloat16 (``lower``) before it is accumulated.
"""

from __future__ import annotations

import numpy as np
import torch

from .coords import JobSnips

BLOCK_ELEMS = 1 << 25  # window pixels a block
LOWER = {"bfloat16": torch.bfloat16}


def lower(v, precision):
    """``v`` through ``precision`` (float64 leaves it as it is), scaled by
    a power of two a block so that its largest finite value lies in [2^7,
    2^8), as the program's float16 wire scales a slab; NaN and inf pass as
    they are."""
    if precision == "float64":
        return v
    fin = torch.isfinite(v)
    top = torch.where(fin, v.abs(), 0.0).max()
    if top <= 0:
        return v
    scale = 2.0 ** (7 - torch.floor(torch.log2(top)))
    q = (v * scale).to(LOWER[precision]).double() / scale
    return torch.where(fin, q, v)


def reference_pileup(cmap, features, kw, device, parts, expected=None,
                     precision="float64"):
    """The job's table as {row key: {"n", "control_n", "num",
    "control_num", "data"}}, numpy, keyed as the cell's ``table`` module
    keys the program's rows. ``parts``: the cell's modules
    (``reference.parts``)."""
    job = JobSnips(features, kw, cmap.chroms, cmap.bins_per, cmap.binsize,
                   parts)
    size = parts.windows.size(job)
    G = len(job.labels)
    acc = {k: torch.zeros(2 * G, size, size, dtype=torch.float64,
                          device=device)
           for k in ("sum", "num", "poison")}
    n = np.zeros(2 * G, np.int64)
    for block, snips in job.blocks.items():
        if not len(snips):
            continue
        cid = snips.kind * G + snips.group
        n += np.bincount(cid, minlength=2 * G)
        values = parts.values.make(cmap, block, kw, expected, precision,
                                   device)
        parts.windows.accumulate(values, snips, cid, size, kw, acc)
        del values
    acc = {k: v.cpu().numpy() for k, v in acc.items()}
    return parts.table.finalize(acc, n, job.labels, kw)
