"""Multi-device pile-up over a mesh of torch devices (counterpart of
``coolpuppy_tpu/parallel/mesh.py``).

The reference scales with one process per region pair and a driver-side
reduce (reference coolpup.py:1502–1531). The JAX package turns the two
decomposition axes into the axes of a ``jax.sharding.Mesh``: ``regions`` (a
batch of region pairs, each with its own stack and vectors) and ``loci``
(the snip stream of a region, split across devices), with the fixed-shape
accumulators ``psum``-ed over both. Here:

- a mesh is an ordered list of ``torch.device`` s with named axes
  (``LociMesh``); the same device may appear more than once, as the JAX
  tests' virtual CPU devices do (``LociMesh([cpu] * 8)`` on the CPU,
  ``LociMesh([cuda:0] * 4)`` on one card);
- ``shard_map`` becomes a loop over the mesh's devices on the calling
  thread: each device's work is launched under ``torch.cuda.device(dev)``
  on that device's current stream, and launches are asynchronous, so
  different cards overlap without threads;
- ``psum`` becomes a sum of the per-device accumulators on
  ``mesh.devices[0]`` in device order (``sum_on_first``), and a replicated
  input one copy per device (``replicate``).

Snips split into contiguous, even shards (device d takes shard d), the
counterpart of ``P("loci")`` over the snip axis, so per-snip stripe planes
come back in snip order when the shards are concatenated.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gather import generic_accumulate
from ..ops.rescale import rescale_accumulate
from ..ops.tiles import cut_windows

_STRIPE_KEYS = ("horizontal_stripe", "vertical_stripe")


class LociMesh:
    """An ordered list of torch devices with named axes, the counterpart of
    ``jax.sharding.Mesh``: ``shape`` is ``{"loci": n}``, or ``{"regions":
    r, "loci": n // r}`` for the two-axis form of ``make_mesh``, so engine
    code reads ``mesh.shape["loci"]`` as the JAX package's does. Every
    device must be of one type; a CUDA device without an index takes the
    current one, and a CUDA device raises where torch sees no card."""

    def __init__(self, devices, regions=None):
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("LociMesh: no devices")
        types = sorted({d.type for d in devices})
        if len(types) != 1:
            raise ValueError(f"LociMesh: devices of mixed types {types}")
        self.devices = devices = [resolve_device(d) for d in devices]
        if regions is None:
            self.shape = {"loci": len(devices)}
        else:
            if regions < 1 or len(devices) % regions:
                raise ValueError(f"LociMesh: {len(devices)} devices do not "
                                 f"split into {regions} region rows")
            self.shape = {"regions": int(regions),
                          "loci": len(devices) // int(regions)}

    @property
    def type(self):
        """The device type of every device of the mesh."""
        return self.devices[0].type

    def grid(self):
        """The devices as rows of the ``regions`` axis, each a list over
        ``loci``."""
        n = self.shape["loci"]
        return [self.devices[i: i + n] for i in range(0, len(self.devices), n)]

    def __len__(self):
        return len(self.devices)

    def __repr__(self):
        names = [str(d) for d in self.devices]
        return f"LociMesh({names}, shape={self.shape})"


def make_loci_mesh(devices=None):
    """One ``loci`` axis over this process's devices (the production
    engine's mesh, ``PileUpper(mesh=...)``). Default: every CUDA device
    torch sees, or, in a multi-process run (``parallel/distributed.py``),
    this process's own card ``cuda:{LOCAL_RANK % device_count}``: each
    process piles up its own region pairs on its own device and the
    per-region outputs merge afterwards, the opposite decomposition to one
    mesh over all processes. Raises without a card; never falls back to the
    CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_loci_mesh: torch sees no CUDA device; pass devices "
                "(e.g. LociMesh(['cpu'] * n)) to run the plain version"
            )
        from .distributed import local_device_index, world_size

        count = torch.cuda.device_count()
        if world_size() > 1:
            devices = [torch.device("cuda", local_device_index() % count)]
        else:
            devices = [torch.device("cuda", i) for i in range(count)]
    return LociMesh(devices)


def make_mesh(devices=None, regions_axis=None):
    """Mesh with ("regions", "loci") axes over ``devices`` (default: every
    CUDA device), as the JAX package's ``make_mesh``: ``regions_axis``
    defaults to 2 when the device count is even and above one."""
    devices = list(make_loci_mesh(devices).devices)
    n = len(devices)
    if regions_axis is None:
        regions_axis = 2 if n % 2 == 0 and n > 1 else 1
    loci_axis = n // regions_axis
    return LociMesh(devices[: regions_axis * loci_axis], regions=regions_axis)


def on_device(device):
    """The context a device's launches sit in: ``torch.cuda.device`` for a
    CUDA device, nothing for the CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def replicate(mesh, tensor):
    """One copy of ``tensor`` per mesh device (the counterpart of a
    replicated ``NamedSharding``): the tensor itself for the first device
    where it already lies there, a copy for every other, the same card
    included."""
    return [
        tensor if i == 0 and tensor.device == dev
        else tensor.to(dev, copy=True)
        for i, dev in enumerate(mesh.devices)
    ]


def sum_on_first(mesh, outs):
    """The ``psum``: per-device accumulator dicts (None for a device with
    nothing to add) summed on ``mesh.devices[0]`` in device order. Stripe
    keys are left out. Returns the summed dict, or None when every entry is
    None."""
    first = mesh.devices[0]
    total = None
    for out in outs:
        if out is None:
            continue
        acc = {k: v for k, v in out.items() if k not in _STRIPE_KEYS}
        if total is None:
            total = {k: v.to(first, copy=True) for k, v in acc.items()}
        else:
            for k, v in acc.items():
                total[k] += v.to(first)
    return total


def _sharded(mesh, fn, per_device, snips):
    """Run ``fn(*per_device[d], *shards_d)`` on every device ``d``, where
    ``shards_d`` is the d-th of ``len(mesh)`` contiguous, even shards of
    each tensor in ``snips``; returns the accumulators summed on the first
    device plus the stripe planes of every shard concatenated there in snip
    order."""
    n = len(mesh)
    split = [torch.tensor_split(x, n) for x in snips]
    outs = []
    for d, dev in enumerate(mesh.devices):
        with on_device(dev):
            outs.append(fn(*per_device[d], *(s[d].to(dev) for s in split)))
    total = sum_on_first(mesh, outs)
    for k in _STRIPE_KEYS:
        if k in outs[0]:
            total[k] = torch.cat([o[k].to(mesh.devices[0]) for o in outs])
    return total


def sharded_generic_step(mesh, stacks, tile_maps, r1, r2, cid, W, C,
                         stripes=False):
    """The loci-sharded generic step (the JAX package's
    ``make_engine_sharded_step``, mesh.py:87-138): each device runs
    ``ops/gather.generic_accumulate`` on its replica of the region's
    normalized stack (``stacks[d]``, ``tile_maps[d]`` its int64 grid) over
    its shard of the snips (``r1``, ``r2``, ``cid``: int tensors), and the
    [C, W, W] accumulators are summed on the first device. Stripe planes
    come back per shard, concatenated in snip order."""

    def step(st, tm, a, b, g):
        return generic_accumulate(st, tm, a, b, g, W, C, stripes=stripes)

    return _sharded(mesh, step, list(zip(stacks, tile_maps)), (r1, r2, cid))


def sharded_rescale_step(mesh, per_device, r1, r2, h1, w2, dd0, cid, cfg):
    """The loci-sharded twin of the rescale step
    (``make_engine_sharded_rescale_step``, mesh.py:102-107): each device
    runs ``ops/rescale.rescale_accumulate`` with its replicas
    ``per_device[d] = (stiles, tile_map, evec, cov1, cov2)`` over its shard
    of the snips, accumulators summed on the first device, stripes in snip
    order."""

    def step(st, tm, ev, c1, c2, *snips):
        return rescale_accumulate(st, tm, ev, c1, c2, *snips, cfg)

    return _sharded(mesh, step, per_device, (r1, r2, h1, w2, dd0, cid))


@dataclass(frozen=True)
class StepConfig:
    """The static shape of ``window_step`` (the fields of the JAX package's
    ``GatherConfig`` that it reads): window ``W``, tile size ``B``, snips
    per device ``S``, accumulator rows ``capacity``, and the normalization
    and side outputs."""

    W: int
    B: int
    S: int
    capacity: int
    cis: bool = True
    ignore_diags: int = 2
    ooe: bool = True
    emit_expected: bool = False
    coverage: bool = False


def window_step(cfg, tiles, tmap, evec, valid1, valid2, cov1, cov2, r1, r2,
                dd0, cid, block=4096):
    """The fused step over RAW tiles (the JAX package's
    ``make_pileup_step_fn``, ops/gather.py:111-234), normalizing each
    window pixel from its own bins: the window of each snip is cut from
    ``tiles`` [K, B, B] through the int64 grid ``tmap``, masked by
    ``valid1[r1 + i] * valid2[r2 + j]`` and, in cis, by ``|dd0 + i - j| <
    ignore_diags``, divided by ``evec[|dd0 + i - j|]`` under ``ooe``, and
    added by ``index_add_`` into float32 [C, W, W] ``sum`` (finite
    values), ``num`` (their count) and ``poison`` (infinite values), with
    ``exp_sum``/``exp_num`` (the unmasked expected windows) and
    ``cov_start``/``cov_end`` (coverage slices, non-finite as 0) where
    ``cfg`` asks. Every per-snip input is a tensor on ``tiles.device``."""
    W, C = cfg.W, cfg.capacity
    dev = tiles.device
    ar = torch.arange(W, device=dev)
    dij = ar[:, None] - ar[None, :]
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    acc = {"sum": zeros(C, W, W), "num": zeros(C, W, W),
           "poison": zeros(C, W, W)}
    if cfg.emit_expected:
        acc["exp_sum"] = zeros(C, W, W)
        acc["exp_num"] = zeros(C, W, W)
    if cfg.coverage:
        acc["cov_start"] = zeros(C, W)
        acc["cov_end"] = zeros(C, W)
    for lo in range(0, len(r1), block):
        a, b = r1[lo: lo + block], r2[lo: lo + block]
        g = cid[lo: lo + block]
        win = cut_windows(tiles, tmap, a, b, W)
        rows, cols = a[:, None] + ar, b[:, None] + ar
        mask = valid1[rows][:, :, None] * valid2[cols][:, None, :]
        absd = (dd0[lo: lo + block, None, None] + dij).abs()
        if cfg.cis and cfg.ignore_diags > 0:
            mask = mask * (absd >= cfg.ignore_diags)
        if cfg.ooe or cfg.emit_expected:
            ew = evec[absd.clamp(0, len(evec) - 1)]
        val = win / ew if cfg.ooe else win
        fin = torch.isfinite(val)
        acc["sum"].index_add_(0, g, torch.where(fin, val, 0.0) * mask)
        acc["num"].index_add_(0, g, fin.to(torch.float32) * mask)
        acc["poison"].index_add_(0, g, torch.isinf(val).to(torch.float32)
                                 * mask)
        if cfg.emit_expected:
            efin = torch.isfinite(ew)
            acc["exp_sum"].index_add_(0, g, torch.where(efin, ew, 0.0))
            acc["exp_num"].index_add_(0, g, efin.to(torch.float32))
        if cfg.coverage:
            for key, cov, idx in (("cov_start", cov1, rows),
                                  ("cov_end", cov2, cols)):
                c = cov[idx]
                acc[key].index_add_(0, g, torch.where(torch.isfinite(c), c,
                                                      0.0))
    return acc


def sharded_pileup_step(cfg, mesh):
    """The step over (regions, loci) (the JAX package's
    ``make_sharded_pileup_step``, mesh.py:141-204) for the global inputs of
    ``sharded_pileup_demo_inputs``: region r of the batch goes to row
    ``r // (NR / regions)`` of the mesh, its snips in contiguous shards over
    that row's ``loci`` devices (``cfg.S`` each), masked snips
    (``snipmask`` False) dropped; ``window_step`` runs per (region, shard)
    (the reference's ``vmap`` over the local region batch, a loop here) and
    every accumulator is summed on the first device. Returns the step
    ``f(ncolp, tiles, tmap, evec, valid1, valid2, cov1, cov2, r1, r2, dd0,
    cid, snipmask) -> {key: tensor}``."""
    rows = mesh.grid()

    def step(ncolp, tiles, tmap, evec, valid1, valid2, cov1, cov2, r1, r2,
             dd0, cid, snipmask):
        nr = tiles.shape[0]
        per_row = nr // len(rows)
        if per_row * len(rows) != nr:
            raise ValueError(f"sharded_pileup_step: {nr} regions do not "
                             f"split over {len(rows)} region rows")
        outs = []
        for r in range(nr):
            shard_devs = rows[r // per_row]
            n = len(shard_devs)
            S = r1.shape[1] // n
            for s, dev in enumerate(shard_devs):
                def put(x, dtype=None):
                    return torch.from_numpy(np.ascontiguousarray(x)).to(
                        dev, dtype)

                sl = slice(s * S, (s + 1) * S)
                keep = np.asarray(snipmask[r, sl], bool)
                grid = np.asarray(tmap[r]).reshape(-1, int(ncolp))
                with on_device(dev):
                    outs.append(window_step(
                        cfg, put(tiles[r], torch.float32),
                        put(grid, torch.int64),
                        *(put(v[r], torch.float32)
                          for v in (evec, valid1, valid2, cov1, cov2)),
                        *(put(x[r, sl][keep], torch.int64)
                          for x in (r1, r2, dd0, cid)),
                    ))
        return sum_on_first(mesh, outs)

    return step


def sharded_pileup_demo_inputs(cfg, mesh, nr=None, seed=0):
    """Tiny synthetic global inputs for a sharded step (dry runs and
    tests), the JAX package's ``sharded_pileup_demo_inputs`` bit for bit."""
    rng = np.random.default_rng(seed)
    nr = nr or mesh.shape["regions"]
    S_global = cfg.S * mesh.shape["loci"]
    K, B, W = 8, cfg.B, cfg.W
    n_bins = 4 * B
    nrow = -(-n_bins // B)
    tmap = np.zeros((nr, (nrow + 1) * (nrow + 1)), np.int32)
    for r in range(nr):
        grid = np.zeros((nrow + 1, nrow + 1), np.int32)
        grid[:nrow, :nrow] = rng.integers(0, K, (nrow, nrow))
        tmap[r] = grid.ravel()
    tiles = rng.gamma(1.0, 1.0, (nr, K + 1, B, B)).astype(np.float32)
    tiles[:, 0] = 0.0
    evec = np.linspace(1.0, 0.1, 2 * n_bins).astype(np.float32)[None].repeat(
        nr, 0
    )
    valid = (rng.random((nr, n_bins + B)) > 0.05).astype(np.float32)
    cov = rng.random((nr, n_bins + B)).astype(np.float32)
    r1 = rng.integers(0, n_bins - W, (nr, S_global)).astype(np.int32)
    r2 = rng.integers(0, n_bins - W, (nr, S_global)).astype(np.int32)
    dd0 = (r1 - r2).astype(np.int32)
    cid = rng.integers(0, cfg.capacity, (nr, S_global)).astype(np.int32)
    snipmask = np.ones((nr, S_global), bool)
    return (
        np.int32(nrow + 1),
        tiles,
        tmap,
        evec,
        valid,
        valid.copy(),
        cov,
        cov.copy(),
        r1,
        r2,
        dd0,
        cid,
        snipmask,
    )
