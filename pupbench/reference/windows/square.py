"""W x W windows at their top-left bins, summed per group: ``sum`` of the
finite values, ``num`` their count, ``poison`` the count of +inf (an
expected of 0)."""

import torch

from ..pileup import BLOCK_ELEMS


def size(job):
    return job.W


def accumulate(values, snips, cid, W, kw, acc):
    dev = values.device
    ar = torch.arange(W, device=dev)
    block = max(1, BLOCK_ELEMS // (W * W))
    st1 = torch.from_numpy(snips.st1).to(dev)
    st2 = torch.from_numpy(snips.st2).to(dev)
    cid = torch.from_numpy(cid).to(dev)
    for a in range(0, len(st1), block):
        v = values(st1[a:a + block, None] + ar, st2[a:a + block, None] + ar)
        c = cid[a:a + block]
        fin = torch.isfinite(v)
        acc["sum"].index_add_(0, c, torch.where(fin, v, 0.0))
        acc["num"].index_add_(0, c, fin.double())
        acc["poison"].index_add_(0, c, torch.isposinf(v).double())
