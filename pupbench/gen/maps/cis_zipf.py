"""A synthetic cis contact map, drawn on the device.

Per chromosome of ``bins_per_chromosome`` bins: ``contacts_per_chromosome``
contacts at a uniform first bin ``i`` and a distance ``d`` drawn from the
zipf(``distance_zipf_a``) law truncated to ``d < bins_per_chromosome`` (by
the inverse of its CDF), second bin ``min(i + d, n - 1)``, counts
Poisson(``count_poisson_lam``) + 1; weights uniform in [``weight_low``,
``weight_high``] with a ``bad_bin_fraction`` of bins NaN. The pixels of
each chromosome are sorted by (bin1, bin2) on the device; duplicate pixels
are kept, as a contact list has them. These are the distributions of the
maps the port's earlier card runs measured, drawn in a few large calls on
the card in place of hundreds of millions of host draws.
"""

from __future__ import annotations

import numpy as np
import torch

from ..contact_map import ContactMap

COUNT_BITS = 8  # a count packs into the low bits of the sort key


def zipf_cdf(a, n_max, device):
    """CDF of zipf(a) truncated to 1 <= d < n_max, float64."""
    k = torch.arange(1, n_max, device=device, dtype=torch.float64)
    pmf = k.pow(-float(a))
    cdf = torch.cumsum(pmf, 0)
    return cdf / cdf[-1]


def draw(map_cfg, seed, device):
    """Draw the configuration's map from ``seed`` on ``device``."""
    n_chroms = int(map_cfg["chromosomes"])
    n = int(map_cfg["bins_per_chromosome"])
    per = int(map_cfg["contacts_per_chromosome"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    cdf = zipf_cdf(map_cfg["distance_zipf_a"], n, device)
    total = n_chroms * per
    bin1 = torch.empty(total, dtype=torch.int64, device=device)
    bin2 = torch.empty(total, dtype=torch.int64, device=device)
    count = torch.empty(total, dtype=torch.int32, device=device)
    lam = torch.full((per,), float(map_cfg["count_poisson_lam"]),
                     device=device, dtype=torch.float32)
    for c in range(n_chroms):
        u = torch.rand(per, generator=gen, device=device, dtype=torch.float64)
        d = torch.searchsorted(cdf, u, right=True) + 1
        d.clamp_(max=n - 1)  # u within rounding of 1
        i = torch.randint(0, n, (per,), generator=gen, device=device)
        j = torch.clamp(i + d, max=n - 1)
        v = torch.poisson(lam, generator=gen).to(torch.int64) + 1
        if int(v.max()) >= 1 << COUNT_BITS:
            raise ValueError("a count does not fit the sort key")
        key, _ = torch.sort((i * n + j) << COUNT_BITS | v)
        ij = key >> COUNT_BITS
        sl = slice(c * per, (c + 1) * per)
        bin1[sl] = ij // n + c * n
        bin2[sl] = ij % n + c * n
        count[sl] = (key & ((1 << COUNT_BITS) - 1)).to(torch.int32)
    w = torch.rand(n_chroms * n, generator=gen, device=device,
                   dtype=torch.float64)
    w = float(map_cfg["weight_low"]) + w * (
        float(map_cfg["weight_high"]) - float(map_cfg["weight_low"]))
    bad = torch.rand(n_chroms * n, generator=gen, device=device,
                     dtype=torch.float64) < float(map_cfg["bad_bin_fraction"])
    w = torch.where(bad, torch.nan, w)
    return ContactMap(
        chroms=[f"chr{k + 1}" for k in range(n_chroms)], bins_per=n,
        binsize=int(map_cfg["binsize"]), bin1=bin1.cpu().numpy(),
        bin2=bin2.cpu().numpy(), count=count.cpu().numpy(),
        weights=w.cpu().numpy(),
        chrom_pixel_offset=np.arange(n_chroms + 1, dtype=np.int64) * per,
    )
