"""A dry run of the multi-device pile-up (the counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``).

    python -m coolpuppy_tpu_torch.parallel.dryrun 4 [cuda|cpu]

builds a toy map in memory and runs ``PileUpper`` over ``LociMesh`` es of
``n_devices`` against one device, in five modes, each held to the
single-device table: counts exact, ``data`` within rtol 1e-4 with NaN
positions equal.
"""

from __future__ import annotations

import sys

import numpy as np
import pandas as pd
import torch

from .mesh import LociMesh

BINSIZE = 1_000_000
RTOL = 1e-4

# per mode: CoordCreator and PileUpper keywords, the grouping, and whether
# the first chromosome must band over the mesh
MODES = {
    "quad": dict(cc=dict(flank=3_000_000, mindist=0, maxdist=120_000_000,
                         nshifts=1),
                 group="strand", banded=True),
    "wide": dict(cc=dict(flank=61_000_000, mindist=0, maxdist=200_000_000,
                         nshifts=1),
                 group="strand", banded=True),
    "by_window": dict(cc=dict(flank=3_000_000, mindist=0, maxdist=60_000_000,
                              nshifts=1),
                      group="window"),
    "trans": dict(cc=dict(flank=3_000_000, nshifts=1, trans=True),
                  group="all"),
    "stripes": dict(cc=dict(flank=3_000_000, mindist=0, maxdist=60_000_000),
                    pu=dict(store_stripes=True), group="all"),
}


def toy_map(n_bins=1408, n_bins2=704, seed=0):
    """The JAX package's dry-run map (``__graft_entry__._toy_cooler``) in
    memory, with a second chromosome of ``n_bins2`` bins for trans:
    distance-decaying Poisson contacts, 5% NaN-weight bins, sparse trans
    contacts. Returns a ``Cooler``."""
    from ..io import Cooler

    rng = np.random.default_rng(seed)
    parts = []
    for off, n in ((0, n_bins), (n_bins, n_bins2)):
        i, j = np.triu_indices(n)
        vals = rng.poisson(100.0 / (1.0 + np.abs(i - j)) + 0.5)
        keep = vals > 0
        parts.append((i[keep] + off, j[keep] + off, vals[keep]))
    i, j = np.meshgrid(np.arange(n_bins), np.arange(n_bins2) + n_bins,
                       indexing="ij")
    vals = rng.poisson(0.5, i.shape)
    keep = vals > 0
    parts.append((i[keep], j[keep], vals[keep]))
    n_all = n_bins + n_bins2
    weights = rng.uniform(0.5, 1.5, n_all)
    weights[rng.random(n_all) < 0.05] = np.nan
    return Cooler.from_arrays(
        {"chr1": n_bins * BINSIZE, "chr2": n_bins2 * BINSIZE}, BINSIZE,
        tuple(np.concatenate(p) for p in zip(*parts)), weights=weights)


def toy_sites(seed=1):
    """48 stranded sites on chr1 (as the JAX package's dry run) and 24 on
    chr2."""
    rng = np.random.default_rng(seed)
    frames = []
    for chrom, hi, n in (("chr1", 1380, 48), ("chr2", 680, 24)):
        centers = np.sort(rng.choice(np.arange(20, hi), size=n,
                                     replace=False)) * BINSIZE
        frames.append(pd.DataFrame({
            "chrom": chrom, "start": centers, "end": centers + 500_000,
            "name": ".", "score": 0,
            "strand": rng.choice(["+", "-"], n),
        }))
    return pd.concat(frames, ignore_index=True)


def run_mode(clr, feats, mode, device, mesh=None):
    """One mode through ``PileUpper``; returns it and its table."""
    from .. import CoordCreator, PileUpper

    spec = MODES[mode]
    cc = CoordCreator(feats, BINSIZE, features_format="bed", seed=0,
                      **spec["cc"])
    pu = PileUpper(clr, cc, control=spec["cc"].get("nshifts", 0) > 0,
                   device=device, mesh=mesh, **spec.get("pu", {}))
    group = spec["group"]
    if group == "strand":
        return pu, pu.pileupsByStrandWithControl()
    if group == "window":
        return pu, pu.pileupsByWindowWithControl()
    return pu, pu.pileupsWithControl()


def _rows(table):
    """The table's rows in a fixed order and their keys: groups as they
    come, by-window rows sorted on chrom/start/end."""
    if "group" in table.columns:
        return table.reset_index(drop=True), ["group"]
    keys = ["chrom", "start", "end"]
    return table.sort_values(keys).reset_index(drop=True), keys


def check_equal(got, want, what):
    """Counts exact, ``data`` (and stripe planes) within RTOL with NaN
    positions equal; rows in the same order of their keys. Returns the snip
    count."""
    got, keys = _rows(got)
    want, _ = _rows(want)
    if got[keys].values.tolist() != want[keys].values.tolist():
        raise AssertionError(f"{what}: row keys differ")
    for col in ("n", "control_n"):
        if col in want and not np.array_equal(got[col].to_numpy(float),
                                              want[col].to_numpy(float)):
            raise AssertionError(f"{what}: {col} differs")
    for i in range(len(want)):
        for col in ("num", "control_num"):
            if col in want and not np.array_equal(got[col].iloc[i],
                                                  want[col].iloc[i]):
                raise AssertionError(f"{what}: {col} of row {i} differs")
        for col in ("data", "horizontal_stripe", "vertical_stripe"):
            if col in want:
                np.testing.assert_allclose(
                    np.asarray(got[col].iloc[i], float),
                    np.asarray(want[col].iloc[i], float), rtol=RTOL,
                    atol=1e-7, equal_nan=True,
                    err_msg=f"{what}: {col} of row {i}")
    return int(want["n"].sum())


def dryrun_multichip(n_devices, device="cuda"):
    """Run every mode of ``MODES`` on ``LociMesh`` es of 2, 4, ...,
    ``n_devices`` devices (CUDA cards in turn, the same card repeated where
    there are fewer; or the CPU) and on one device, and hold each mesh run
    to the single-device table. The 1,408-bin chr1 spans 11 tile rows of
    128 bins, so up to 8 devices band it on the quad route and at W = 123
    (the ``banded`` modes, checked through ``_rowshard_regions``)."""
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n_devices)]
    else:
        devices = [device] * n_devices
    clr, feats = toy_map(), toy_sites()
    sizes = sorted({2 ** k for k in range(1, n_devices.bit_length())}
                   | {n_devices})
    total = 0
    for mode, spec in MODES.items():
        _, single = run_mode(clr, feats, mode, devices[0])
        for n in sizes:
            mesh = LociMesh(devices[:n])
            pu, meshed = run_mode(clr, feats, mode, devices[0], mesh=mesh)
            snips = check_equal(meshed, single, f"{mode} mesh of {n}")
            if spec.get("banded") and pu._rowshard_regions == 0:
                raise AssertionError(f"{mode} mesh of {n}: no region banded")
            print(f"{mode}: mesh of {n} == one device: {snips} snips, "
                  f"{len(single)} rows, route {meshed['accumulate'].iloc[0]},"
                  f" banded {pu._rowshard_regions}, replicated "
                  f"{pu.mesh_stats['replicated']}, launches per device "
                  f"{pu.mesh_stats['launches']}")
            total += snips
    print(f"dryrun_multichip ok: {len(MODES)} modes on meshes of {sizes} "
          f"{devices[0].type} devices, {total} snips held to one device")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
