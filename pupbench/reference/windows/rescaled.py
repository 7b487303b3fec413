"""Windows of h x h bins resized to R x R (``rescale_size``) by the
area-overlap operator whose arithmetic the program states (float32 steps),
NaN-aware: an output pixel that the resized NaN plane touches by more than
``TOUCH_EPS`` adds nothing, an all-NaN window adds 0 with count 1. Local
windows are first symmetrized: a pixel's mean over itself and its mirror,
where finite."""

import numpy as np
import torch

from ..pileup import BLOCK_ELEMS

TOUCH_EPS = 1e-6


def size(job):
    return int(job.kw.get("rescale_size", 99))


def op32(h, R):
    """The area-overlap operator [R, h], float32 steps, as float64."""
    f32 = np.float32
    i = np.arange(R, dtype=f32)[:, None]
    k = np.arange(h, dtype=f32)[None, :]
    cell = f32(h) * (f32(1) / f32(R))
    overlap = np.maximum(f32(0), np.minimum((i + f32(1)) * cell, k + f32(1))
                         - np.maximum(i * cell, k))
    return (overlap / max(cell, f32(1e-30))).astype(np.float64)


def accumulate(values, snips, cid, R, kw, acc):
    dev = values.device
    local = bool(kw.get("local"))
    for h in np.unique(snips.h):
        idx = np.flatnonzero(snips.h == h)
        h = int(h)
        L = torch.from_numpy(op32(h, R)).to(dev)
        ar = torch.arange(h, device=dev)
        st1 = torch.from_numpy(snips.st1[idx]).to(dev)
        st2 = torch.from_numpy(snips.st2[idx]).to(dev)
        c_all = torch.from_numpy(cid[idx]).to(dev)
        block = max(1, BLOCK_ELEMS // (h * h))
        for a in range(0, len(idx), block):
            v = values(st1[a:a + block, None] + ar,
                       st2[a:a + block, None] + ar)
            fin = torch.isfinite(v)
            dat = torch.where(fin, v, 0.0)
            if local:
                cnt = fin.double() + fin.transpose(1, 2).double()
                s = dat + dat.transpose(1, 2)
                fin = cnt > 0
                dat = torch.where(fin, s / cnt.clamp(min=1.0), 0.0)
            empty = ~fin.flatten(1).any(1)[:, None, None]
            rs = L @ dat @ L.T
            touched = (L @ (~fin).double() @ L.T) > TOUCH_EPS
            c = c_all[a:a + block]
            acc["sum"].index_add_(0, c, torch.where(
                empty, 0.0, torch.where(touched, 0.0, rs)))
            acc["num"].index_add_(0, c, torch.where(
                empty, 1.0, (~touched).double()))
