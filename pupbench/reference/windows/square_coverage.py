"""The ``square`` accumulation, plus each window's coverage: the rows'
slice of the chromosome's coverage (``values.cov``) summed per group into
``acc["cov_start"]`` [2G, W], the columns' slice into ``acc["cov_end"]``
(coolpuppy's per-snip ``cov_start`` and ``cov_end``, summed as the pileup
sums its snips)."""

import torch

from . import square

size = square.size


def accumulate(values, snips, cid, W, kw, acc):
    square.accumulate(values, snips, cid, W, kw, acc)
    dev = values.device
    ar = torch.arange(W, device=dev)
    c = torch.from_numpy(cid).to(dev)
    rows = acc["sum"].shape[0]
    for key, starts in (("cov_start", snips.st1), ("cov_end", snips.st2)):
        if key not in acc:
            acc[key] = torch.zeros(rows, W, dtype=torch.float64, device=dev)
        st = torch.from_numpy(starts).to(dev)
        acc[key].index_add_(0, c, values.cov[st[:, None] + ar])
