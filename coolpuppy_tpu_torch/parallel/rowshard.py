"""Row-partitioned tile storage across devices with a halo copy (counterpart
of ``coolpuppy_tpu/parallel/rowshard.py``).

The reference holds one whole-chromosome scipy CSR per worker process
(reference coolpup.py:1053–1077), so memory per worker scales with the full
region. Here each device holds ONLY the tiles whose tile row falls in its
contiguous row band, snips go to the device owning their start row, and the
one boundary tile row a window can straddle (windows span at most 2 tile
rows because B >= W) is copied from each device to its neighbour below:
device d sends its first tile row to d - 1, the JAX package's ``ppermute``
over ICI, here a device-to-device copy (a peer copy over NVLink between
cards). Accumulators are summed over the devices as on the replicated path
(``parallel/mesh.py``); per-device matrix memory drops from O(region) to
O(region / n_devices + one tile row).

Host side, copied from the JAX package bit for bit: ``build_row_partition``
splits a ``TileStack`` by snip load and ``route_snips`` orders the snip
stream device-major. Device side: ``row_sharded_step`` runs the generic
step (``ops/gather.generic_accumulate``) per device on [own band ‖ halo
received from d + 1], as normalized by ``quad_mesh.sharded_normalize_halo``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.gather import generic_accumulate
from .mesh import _STRIPE_KEYS, on_device, sum_on_first

logger = logging.getLogger("coolpuppy_tpu_torch")


def _next_pow2(x):
    return 1 << max(0, int(np.ceil(np.log2(max(1, x)))))


@dataclass
class RowPartition:
    """Host-side description of a row-banded tile stack split.

    Arrays are padded so every device's slice has the same shape:

    - ``tiles``    [n, 1 + Kcap, B, B] — slot 0 is the shared zero tile,
      slots 1..K_d hold device d's own band tiles
    - ``tile_map`` [n, Mpad] raveled (nr+1, nc+1) grids; own tiles map to
      1..K_d, halo tiles (first row of the NEXT band) map to 1+Kcap+j
    - ``send_idx`` [n, Hcap] local stack indices of the tiles device d must
      ship to device d-1 (its own first tile-row), zero-padded
    - ``row_bounds`` tile-row band edges, length n+1
    """

    tiles: np.ndarray
    tile_map: np.ndarray
    send_idx: np.ndarray
    ncolp: np.int32
    row_bounds: np.ndarray
    n_dev: int
    B: int

    @property
    def per_device_tile_bytes(self):
        return self.tiles[0].nbytes + self.tile_map[0].nbytes

    def grids(self):
        """Each device's tile map as its [rows, ncolp] grid (the raveled
        map's whole rows, the zero padding rows included)."""
        ncp = int(self.ncolp)
        rows = self.tile_map.shape[1] // ncp
        return [m[: rows * ncp].reshape(rows, ncp) for m in self.tile_map]


def _tile_rows_cols(tile_map):
    """Recover (tile_row, tile_col) per stack slot from the grid lookup."""
    K1 = int(tile_map.max()) + 1
    tr = np.zeros(K1, np.int64)
    tc = np.zeros(K1, np.int64)
    gr, gc = np.nonzero(tile_map)
    tr[tile_map[gr, gc]] = gr
    tc[tile_map[gr, gc]] = gc
    return tr, tc


def build_row_partition(tile_stack, r1, n_dev):
    """Split ``tile_stack`` into ``n_dev`` contiguous tile-row bands balanced
    by snip start-row load. Returns None when the region has fewer tile rows
    than devices (callers fall back to the replicated-tiles path)."""
    B = tile_stack.B
    nrp, ncp = tile_stack.tile_map.shape
    nr = nrp - 1  # last grid row/col are the all-zero boundary entries
    if nr < n_dev or tile_stack.tiles.shape[0] <= 1:
        return None

    # band edges at tile-row granularity, balancing the snip count per band
    # (cis snips are roughly uniform along the diagonal, but controls and
    # clustered features are not — use the actual distribution)
    t1 = np.asarray(r1, np.int64) // B
    hist = np.bincount(np.clip(t1, 0, nr - 1), minlength=nr).astype(np.float64)
    cum = np.cumsum(hist)
    targets = cum[-1] * np.arange(1, n_dev) / n_dev
    inner = np.searchsorted(cum, targets, side="left") + 1
    # STRICTLY increasing edges so every band owns >= 1 tile row — the halo
    # provider must be the direct +1 neighbor for the one-step copy.
    # Forward pass pushes each edge past its predecessor, backward pass pulls
    # edges below nr; nr >= n_dev guarantees a feasible assignment.
    for i in range(len(inner)):
        lo = inner[i - 1] + 1 if i else 1
        inner[i] = max(int(inner[i]), lo)
    for i in range(len(inner) - 1, -1, -1):
        hi = inner[i + 1] - 1 if i + 1 < len(inner) else nr - 1
        inner[i] = min(int(inner[i]), hi)
    row_bounds = np.concatenate([[0], inner, [nr]]).astype(np.int64)
    if not (np.diff(row_bounds) >= 1).all():
        # infeasible edge assignment (should be unreachable given nr >= n_dev,
        # but an assert would vanish under python -O and silently mis-route
        # halos) — let callers fall back to the replicated-tiles path
        return None

    tr, _tc = _tile_rows_cols(tile_stack.tile_map)
    K1 = tile_stack.tiles.shape[0]
    slots = np.arange(1, K1, dtype=np.int64)
    band_of_tile = np.searchsorted(row_bounds, tr[1:], side="right") - 1

    own = [np.sort(slots[band_of_tile == d]) for d in range(n_dev)]
    # halo for device d = the FULL first tile-row of band d+1 (windows end at
    # most one tile-row past the band; taking the whole row keeps the send
    # list independent of which columns d's snips touch)
    halo = [
        np.sort(slots[tr[1:] == row_bounds[d + 1]]) if d + 1 < n_dev else
        np.empty(0, np.int64)
        for d in range(n_dev)
    ]

    Kcap = _next_pow2(max(1, max(len(o) for o in own)))
    Hcap = _next_pow2(max(1, max(len(h) for h in halo)))
    # every device's buffer is padded to the LARGEST band's pow2 tile count,
    # so a skewed tile distribution erodes the per-device memory win — make
    # the achieved fraction visible
    frac = (1 + Kcap + Hcap) / max(1, K1)
    logger.debug(
        "rowshard: %d tiles -> %d bands, Kcap=%d Hcap=%d, "
        "per-device tile fraction %.2fx",
        K1 - 1, n_dev, Kcap, Hcap, frac,
    )

    tiles = np.zeros((n_dev, 1 + Kcap, B, B), np.float32)
    Mpad = _next_pow2(nrp * ncp)
    tile_map = np.zeros((n_dev, Mpad), np.int32)
    send_idx = np.zeros((n_dev, Hcap), np.int32)

    local_of = np.zeros((n_dev, K1), np.int32)  # global slot -> local index
    for d in range(n_dev):
        k = len(own[d])
        tiles[d, 1 : 1 + k] = tile_stack.tiles[own[d]]
        local_of[d, own[d]] = np.arange(1, 1 + k, dtype=np.int32)

    tr_grid, tc_grid = np.nonzero(tile_stack.tile_map)
    slot_grid = tile_stack.tile_map[tr_grid, tc_grid]
    for d in range(n_dev):
        grid = np.zeros((nrp, ncp), np.int32)
        mine = band_of_tile[slot_grid - 1] == d
        grid[tr_grid[mine], tc_grid[mine]] = local_of[d, slot_grid[mine]]
        # halo tiles live at 1+Kcap+j, j in the provider's send order
        # (both sides sort by global slot index, so orders agree)
        for j, g in enumerate(halo[d]):
            grid[tr_grid[slot_grid == g], tc_grid[slot_grid == g]] = (
                1 + Kcap + j
            )
        tile_map[d, : nrp * ncp] = grid.ravel()
        if d > 0:
            # what THIS device ships to d-1: its own first tile-row,
            # which is exactly halo[d-1] by construction
            send_idx[d, : len(halo[d - 1])] = local_of[d, halo[d - 1]]

    return RowPartition(
        tiles=tiles,
        tile_map=tile_map,
        send_idx=send_idx,
        ncolp=np.int32(ncp),
        row_bounds=row_bounds,
        n_dev=n_dev,
        B=B,
    )


def route_snips(part: RowPartition, r1):
    """Owner device per snip + a stable device-major order.

    Returns (order, counts): ``order`` permutes the snip stream so device 0's
    snips come first, etc.; ``counts[d]`` is device d's snip count. Original
    positions are recovered as ``order[routed_position]``."""
    t1 = np.asarray(r1, np.int64) // part.B
    owner = np.searchsorted(part.row_bounds, t1, side="right") - 1
    owner = np.clip(owner, 0, part.n_dev - 1)
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=part.n_dev)
    return order, counts


def row_sharded_step(mesh, stacks, tile_maps, r1_rows, r2_rows, cid_rows, W,
                     C, stripes=False):
    """The generic step with ROW-SHARDED tiles (the JAX package's
    ``make_row_sharded_step``, rowshard.py:193-252): device d runs
    ``generic_accumulate`` on ``stacks[d]``, its normalized [own band ‖
    halo received from d + 1] (``quad_mesh.sharded_normalize_halo``),
    through ``tile_maps[d]`` (its int64 grid) over its routed snips
    (``r1_rows[d]``, ``r2_rows[d]``, ``cid_rows[d]``: host int arrays), and
    the [C, W, W] accumulators are summed on the first device. With
    ``stripes``, each stripe key holds one [len(r1_rows[d]), W] tensor per
    device, rows in routed order."""
    outs = []
    for d, dev in enumerate(mesh.devices):
        if len(r1_rows[d]) == 0:
            outs.append(None)
            continue

        def put(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

        with on_device(dev):
            outs.append(generic_accumulate(
                stacks[d], tile_maps[d], put(r1_rows[d]), put(r2_rows[d]),
                put(cid_rows[d]), W, C, stripes=stripes))
    total = sum_on_first(mesh, outs)
    if total is None:
        first = mesh.devices[0]
        total = {k: torch.zeros((C, W, W), dtype=torch.float32, device=first)
                 for k in ("sum", "num", "poison")}
    if stripes:
        for k in _STRIPE_KEYS:
            total[k] = [
                o[k] if o is not None else torch.zeros((0, W))
                for o in outs
            ]
    return total
