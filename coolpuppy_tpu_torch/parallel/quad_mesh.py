"""The quad kernel on a device mesh (counterpart of
``coolpuppy_tpu/parallel/pallas_mesh.py``).

Nothing in the quad gather-accumulate needs the mesh axis: here it runs once
per device, on that device's stack, with ONE sum of the [C, W, W]
accumulators at the end, composed with the row-partitioned halo copy of
``parallel/rowshard.py``:

1. ``sharded_normalize_halo``: each device normalizes ITS OWN tile-row band
   (bad-bin masks, diagonal mask, OOE division, ``ops/tiles.normalize_slots``
   — the per-pixel semantics of the reference hot loop, reference
   coolpup.py:1104–1156), then copies its first tile row, already
   normalized, to its neighbour d - 1 (the JAX package's ``ppermute``; a
   peer copy between cards). The stacks stay on their devices for the whole
   region.
2. ``QuadMeshSession.run_chunk``: each device quad-sorts its routed snips
   against its OWN tile map and launches ``quad_gather.quad_accumulate``
   once on [own band ‖ received halo]; the accumulators are summed on the
   first device (``mesh.sum_on_first``), the counterpart of the reference's
   driver-side ``reduce(sum_pups, …)`` (reference coolpup.py:1502–1531).

Small regions (fewer tile rows than devices) use the replicated variant: the
region's normalized stack copied to every device, snips split evenly — still
the quad kernel per device, still one sum.

The JAX package's packed fixed-shape calls (``pack_stream``, ``Q_CAP`` and
the all-empty calls of devices with fewer snips) exist for the TPU's scalar
prefetch and are not ported: a device with no snips launches nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import quad_gather
from ..ops.tiles import normalize_slots, normalized_stack
from .mesh import on_device, replicate, sum_on_first


def _ceil_pow2(x):
    return 1 << int(np.ceil(np.log2(max(1, int(x)))))


def _normalize_vectors(B, nrp, ncp, valid1, valid2, evec, ooe):
    """Pad per-bin vectors to the tile grid (same clipping rules as
    ops/tiles.normalize_tiles)."""
    v1 = np.zeros(nrp * B + B, np.float32)
    m1 = min(len(valid1), len(v1))
    v1[:m1] = np.asarray(valid1, np.float32)[:m1]
    v2 = np.zeros(ncp * B + B, np.float32)
    m2 = min(len(valid2), len(v2))
    v2[:m2] = np.asarray(valid2, np.float32)[:m2]
    L = (max(nrp, ncp) + 2) * B + 1
    epad = np.full(L, np.nan, np.float32)
    if ooe and evec is not None:
        ev = np.atleast_1d(np.asarray(evec, np.float32))
        if ev.size == 1:
            epad[:] = ev[0]
        else:
            epad[: min(ev.size, L)] = ev[:L]
    return v1, v2, epad


def local_tile_coords(part):
    """Per-device (tr, tc) [n, 1+Kcap] global tile coordinates of each local
    OWN slot, recovered from the per-device raveled tile_map grids (halo
    slots arrive already normalized from their provider, so they need no
    coordinates here; padding slots keep (0, 0) and are never referenced)."""
    n, Mpad = part.tile_map.shape
    ncp = int(part.ncolp)
    D0 = part.tiles.shape[1]
    tr = np.zeros((n, D0), np.int32)
    tc = np.zeros((n, D0), np.int32)
    for d in range(n):
        grid = part.tile_map[d][: (Mpad // ncp) * ncp].reshape(-1, ncp)
        gr, gc = np.nonzero((grid > 0) & (grid < D0))
        slots = grid[gr, gc]
        tr[d, slots] = gr
        tc[d, slots] = gc
    return tr, tc


def halo_depth(part):
    """``(D0, Hcap, D2)`` of a partition's per-device stacks: own slots,
    halo slots and the whole depth, padded with all-NaN slots to a power of
    two of at least 64 as in the JAX package."""
    D0 = part.tiles.shape[1]
    Hcap = part.send_idx.shape[1]
    return D0, Hcap, max(64, _ceil_pow2(D0 + Hcap))


def halo_copy_bytes(part):
    """The bytes the halo copies of a partition move: every device but the
    first sends its padded send list (``Hcap`` tiles of float32)."""
    return (part.n_dev - 1) * part.send_idx.shape[1] * part.B * part.B * 4


def sharded_normalize_halo(mesh, part, valid1, valid2, evec, ooe=False,
                           cis=True, ignore_diags=2):
    """Per-device band normalization and the normalized halo copy (the JAX
    package's ``make_sharded_normalize_halo``, pallas_mesh.py:45-114).
    Device d uploads its band ``part.tiles[d]``, normalizes it into the
    NaN-encoded stack (slot 0 all NaN), gathers its first tile row
    (``part.send_idx[d]``) and copies it to device d - 1. Returns one
    float32 [D2, B, B] stack per device (``halo_depth``): the D0 own slots,
    the Hcap halo slots received from d + 1 (zeros on the last device of a
    mesh of more than one, which no tile map references; its own send rows
    on a mesh of one) and all-NaN padding."""
    B = part.B
    n = len(mesh)
    ncp = int(part.ncolp)
    nrp = part.tile_map.shape[1] // ncp
    v1, v2, epad = _normalize_vectors(B, nrp, ncp, valid1, valid2, evec, ooe)
    D0, Hcap, D2 = halo_depth(part)
    tr, tc = local_tile_coords(part)
    own, sends = [], []
    for d, dev in enumerate(mesh.devices):
        with on_device(dev):
            tiles = torch.from_numpy(part.tiles[d]).to(dev)
            st = normalize_slots(tiles, tr[d], tc[d], B, v1, v2, epad,
                                 ooe=ooe, cis=cis, ignore_diags=ignore_diags)
            st[0] = torch.nan
            idx = torch.from_numpy(part.send_idx[d].astype(np.int64)).to(dev)
            own.append(st)
            sends.append(st[idx])
    stacks = []
    for d, dev in enumerate(mesh.devices):
        with on_device(dev):
            if n == 1:
                halo = sends[0]
            elif d + 1 < n:
                halo = sends[d + 1].to(dev, non_blocking=True)
            else:
                halo = torch.zeros((Hcap, B, B), dtype=torch.float32,
                                   device=dev)
            pad = torch.full((D2 - D0 - Hcap, B, B), torch.nan,
                             dtype=torch.float32, device=dev)
            stacks.append(torch.cat([own[d], halo, pad]))
    return stacks


class QuadMeshSession:
    """The normalized stacks of one region on a mesh, one per device — the
    multi-device twin of ``ops/quad_gather.QuadPileupSession``.

    ``part`` (a ``rowshard.RowPartition`` over B=128 tiles) selects the
    banded variant with the halo copy; ``part=None`` copies the region's
    full normalized stack to every device (small regions). ``cfg_kw`` holds
    ``W``, ``capacity`` and the normalization keys ``ooe``, ``cis`` and
    ``ignore_diags``. Per device: ``stack_bytes`` (its stack's bytes),
    ``snips`` (the snips it accumulated) and ``launches`` (kernel launches
    made for it, from ``quad_gather.LAUNCHES``); ``halo_bytes`` the bytes
    the halo copies moved."""

    def __init__(self, mesh, tile_stack, part, valid1, valid2, evec, cfg_kw):
        cfg_kw = dict(cfg_kw)
        W = int(cfg_kw.pop("W"))
        C = int(cfg_kw.pop("capacity"))
        norm = dict(ooe=bool(cfg_kw.pop("ooe", False)),
                    cis=bool(cfg_kw.pop("cis", True)),
                    ignore_diags=int(cfg_kw.pop("ignore_diags", 2)))
        if cfg_kw:
            raise TypeError(
                f"QuadMeshSession: unknown cfg_kw {sorted(cfg_kw)}")
        if tile_stack.B != quad_gather.B_TILE:
            raise ValueError(
                f"QuadMeshSession: B must be {quad_gather.B_TILE}")
        self.mesh = mesh
        self.part = part
        self.W = W
        n = len(mesh)
        if part is None:
            with on_device(mesh.devices[0]):
                st = normalized_stack(tile_stack, valid1, valid2, evec,
                                      mesh.devices[0], **norm)
            stacks = replicate(mesh, st)
            maps = [tile_stack.tile_map] * n
            self.halo_bytes = 0
        else:
            stacks = sharded_normalize_halo(mesh, part, valid1, valid2, evec,
                                            **norm)
            maps = part.grids()
            self.halo_bytes = halo_copy_bytes(part)
        self.sessions = [
            quad_gather.QuadPileupSession.from_normalized(st, m, W, C)
            for st, m in zip(stacks, maps)
        ]
        self.stack_bytes = [st.numel() * st.element_size() for st in stacks]
        self.snips = [0] * n
        self.launches = [0] * n

    def run_chunk(self, r1_rows, r2_rows, cid_rows):
        """One accumulation of per-device snip lists (host arrays, one per
        device): device d's snips are quad-sorted against ITS OWN tile map
        and accumulated on its stack (``QuadPileupSession.run_many``, which
        looks ``quad_gather.quad_accumulate`` up at call time); a device
        with no snips launches nothing. Returns ``{"sum", "num"}`` summed on
        the first device (``QuadPileupSession.finalize`` takes it)."""
        outs = []
        for d, sess in enumerate(self.sessions):
            if len(r1_rows[d]) == 0:
                outs.append(None)
                continue
            before = quad_gather.LAUNCHES
            with on_device(sess.device):
                outs.append(sess.run_many(r1_rows[d], r2_rows[d],
                                          np.asarray(cid_rows[d], np.int32),
                                          fetch=False))
            self.launches[d] += quad_gather.LAUNCHES - before
            self.snips[d] += len(r1_rows[d])
        total = sum_on_first(self.mesh, outs)
        if total is None:
            shape = (self.sessions[0].C, self.W, self.W)
            total = {k: torch.zeros(shape, dtype=torch.float64,
                                    device=self.mesh.devices[0])
                     for k in ("sum", "num")}
        return total

    def run_stripes(self, r1_rows, r2_rows, f16=False):
        """Per-snip stripe planes on the mesh: each device gathers the rows
        of its routed snips from its own (banded + halo, or replicated)
        stack through its own tile map. Returns one float32 numpy [len(
        r1_rows[d]), 2W] array per device, rows in the order of
        ``r1_rows[d]``: the centre row then the unreversed centre column.
        ``f16`` fetches them as float16 and upcasts on the host."""
        out = []
        for d, sess in enumerate(self.sessions):
            with on_device(sess.device):
                out.append(sess.run_stripes(np.asarray(r1_rows[d]),
                                            np.asarray(r2_rows[d]), f16=f16))
        return out
