"""The pile-up engine: PileUpper + pileup() (counterpart of
``coolpuppy_tpu/engine/pileup.py``, reference coolpup.py:752–2279).

Per region, the host collects every snip's window start, size and group
into flat index arrays and scatters the B=128 tiles those windows touch; the
tile stack is expanded and normalized on ``device`` into one NaN-encoded
stack. Three routes accumulate the windows:

- ``cuda_kernel`` / ``plain`` (W <= 120, not rescaled):
  ``ops/quad_gather.QuadPileupSession`` quad-sorts the snips and
  ``quad_gather.quad_accumulate`` adds every window into per-group sums and
  finite counts (the hand-written CUDA kernel on a CUDA device, the plain
  PyTorch version on the CPU);
- ``generic_cuda`` / ``generic_torch`` (W > 120, the reference's cutoff):
  ``ops/gather.generic_accumulate`` adds every window into per-group sums,
  finite counts and poison counts (the hand-written wide kernel on a CUDA
  device, the plain PyTorch version on the CPU: windows cut by one index
  gather per block, summed by ``index_add_``);
- ``rescale_torch`` (``rescale=True``): variable-size windows in pow2 extent
  buckets (at least 128), each resized to R×R by float32 area-overlap
  matmuls (``ops/rescale.rescale_accumulate``).

Regions run as in the reference (:3542-3593, :782-980): prefetch threads
stage the next regions while the main thread accumulates one, and on the
quad route a region whose windows fit a tile predicate known before any
coordinate (the |row - col| band of ``maxdist`` for cis BED, the rectangles
of BEDPE rows and trans products) streams (``_QuadStream``): its stack is
scattered and normalized on a staging thread while the coordinates are
made, and every ``_STREAM_CHUNK`` snips are quad-sorted and launched as soon
as they exist. A window off the predicate or more groups than the stream's
bank send the region to the collected path above, with the same results.

On the card the quad route takes the reference's transfer wires, as the JAX
package takes them on an accelerator: the raw tiles go up as pow2-scaled
float16 (``"lossy"`` on balanced maps, ``"exact"`` on raw counts; int8 raw
counts with the weights folded on the device where ``tile_int8`` is set),
stripe planes come back as float16, and the accumulators of more groups
than the reference's pinned bank (by-window) are flip-merged on the device,
cast to pow2-scaled float16 per key and fetched one flush ahead
(``_stack_merge_fetch``). ``tile_f16=False`` / ``stripe_f16=False`` turn
them off; on the CPU every transfer stays float32.

The host finishes with the reference's normalization algebra: division by
shifted controls or expected, coverage normalization, local symmetrization.

Under a mesh (``mesh=``, a ``parallel.LociMesh``; the reference :1496-1600)
regions take the collected path and no stream: on the quad route each mesh
device holds one row band of the region's stack plus the first tile row of
the next band (``parallel/quad_mesh.py``), or a copy of the whole stack
where the region does not band, and launches the kernel once on its snips;
wider windows run the generic step per band (``parallel/rowshard.py``) or
per replica, rescale per replica (``parallel/mesh.py``); the accumulators
are summed on the mesh's first device. In a multi-process run
(``parallel/distributed.py``) each process takes its round-robin share of
region pairs and the per-region outputs are all-gathered before the reduce.

The extension hooks choose among four routes per region (``pileup_region``):
``postprocess_frame_func`` alone and ``accumulate_values`` extras over frame
columns stay on the accumulate routes above; ``postprocess_batch_func``
(``batch_hook``) and ``postprocess_snip_func`` or opaque extras
(``host_stream``) read windows that ``ops/tiles.fetch_windows`` cuts from
the normalized stack on ``device`` and fetches in capped blocks, and fold
them on the host in numpy, as the reference does.

The port covers cis and trans pileups of BED features and of BEDPE rows:
observed-over-expected, expected emission, shifted controls, by strand / by
distance / by window / custom groupby, ignore_group_order,
flip_negative_strand, local, coverage_norm, stripes and rescale, at any
window size, with the reference's four extension hooks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import math
import os
import pickle
import re
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from functools import partial, reduce

import numpy as np
import pandas as pd
import torch

from .. import coverage as coverage_mod
from ..coords import (
    KINDS,
    CoordBlock,
    CoordCreator,
    bin_distance_intervals,
    flip_mark_intervals,
    swap_paired_columns_for_flipped,
)
from ..device import resolve_device
from ..genomics.intervals import (
    is_compatible_viewframe,
    is_valid_expected,
    make_cooler_view,
    make_viewframe,
    natsorted,
    sort_bedframe,
)
from ..lib.numutils import _copy_array_halves
from ..lib.puputils import (
    _add_snip,
    _add_snip_batch,
    accumulate_values,
    collapse_snips,
    empty_pup,
    group_by_region_frame,
    norm_coverage,
    sum_pups,
)
from ..observability import PhaseTimers, device_trace
from ..ops import quad_gather
from ..ops.gather import (
    coverage_histogram_sums,
    coverage_scatter_sums,
    expected_toeplitz_sums,
    generic_accumulate,
    merge_flip_banks,
)
from ..ops.rescale import RescaleConfig, area_resize_host, rescale_accumulate
from ..ops.tiles import (
    SymTileStack,
    build_tile_stack_coo,
    build_tile_stack_slab,
    build_tile_stack_slab_sym,
    fetch_windows,
    normalized_stack,
    rect_tiles,
)

logger = logging.getLogger("coolpuppy_tpu_torch")

# paired column bases that index the gather and must NOT be swapped when
# ignore_group_order flips a snip: the gather uses the original orientation
# plus the flip-bank anti-transpose
_GATHER_BASES = (
    "stBin",
    "endBin",
    "exp_start",
    "exp_end",
    "chrom",
    "start",
    "end",
    "center",
)

# the coverage histogram holds G x n_bins float64 on the host; past this the
# engine switches to the device scatter-add (by-window with coverage_norm)
_COV_HIST_MAX = 1 << 22

# device bytes of one group block's accumulators (float32 sum + int32 num,
# unflipped and flip banks): more groups than fit run in cid-sorted blocks
_BLOCK_BYTES = 256 << 20

# the feature coordinates each stripe row carries
_COORD_COLS = ("chrom1", "start1", "end1", "chrom2", "start2", "end2")

# the smallest pow2 extent bucket of the rescale route (the reference's B0)
_RESCALE_MIN_BUCKET = 128

_STRIPE_KEYS = ("horizontal_stripe", "vertical_stripe")

# hooked snips the host stream buffers per flush of its batched fold
_FOLD_FLUSH = 8192

# the stream (``_QuadStream``): groups of its accumulator bank (the
# reference's 512, capped by ``_block_half(W)``), snips a launch, the most
# tiles its predicate may stage in the region loop and from the region
# prefetch (several prefetched stacks can sit on the device at once), and
# the window count past which a cis collected build takes a band predicate
_STREAM_HALF = 512
_STREAM_CHUNK = 131_072
_STREAM_TILES = 12_288
_PREFETCH_TILES = 3_072
_BAND_WINDOWS = 2_000_000

# regions staged ahead of the one being accumulated, at most
_PREFETCH_MAX = 4

_STAGE_POOL = None
_STAGE_POOL_LOCK = threading.Lock()


def _stage_pool():
    """The process-wide single worker that builds streams' sessions (tile
    scatter, upload, normalize): the native scatter releases the GIL, and
    one card serializes the builds anyway (reference :80-93)."""
    global _STAGE_POOL
    with _STAGE_POOL_LOCK:
        if _STAGE_POOL is None:
            _STAGE_POOL = ThreadPoolExecutor(max_workers=1,
                                             thread_name_prefix="quad-stage")
    return _STAGE_POOL


def _stack_merge_fetch(outs, half, f16=False, lazy=False, f16_keys=None):
    """Stack per-block accumulator dicts (torch tensors [C, W, W], the flip
    bank at rows [half, 2 * half)), collapse the flip bank ON THE DEVICE
    (the anti-transpose of rows [half, 2 * half) added to [0, half), the
    device twin of ``ops/gather.merge_flip_banks``) and fetch once
    (reference ``engine/pileup.py:96-141``).

    ``f16`` casts each key (of ``f16_keys``, all when None) to float16 with
    a pow2 scale computed on the device that puts the largest finite |value|
    near 2^13, as the reference computes it (``floor(log(max) / log(2))``
    in float32); +inf poison survives the cast. ``lazy`` starts the copies
    into pinned host buffers and returns the handles for
    ``_stack_merge_materialize``, so the transfer overlaps later launches.
    Returns ``{key: (wire, inv_scale or None, copy event or None)}``, or the
    materialized float64 arrays [nblk, half, W, W] without ``lazy``."""
    merged = {}
    for k in outs[0]:
        v = torch.stack([o[k] for o in outs])
        lo = v[:, :half]
        hi = v[:, half : 2 * half].flip((-2, -1)).transpose(-2, -1)
        m = lo + hi
        inv = None
        if f16 and (f16_keys is None or k in f16_keys):
            fin = torch.where(torch.isfinite(m), m.abs(), 0.0)
            mx = fin.max()
            ex = torch.floor(torch.log(torch.clamp(mx, min=1e-30))
                             / math.log(2.0))
            # 2^(13 - ex) from its exponent bits: exact on every device
            e = (13 - ex).clamp(-126, 127).to(torch.int32)
            bits = (e + 127) << 23
            scale = torch.where(mx > 0, bits.view(torch.float32).to(m.dtype),
                                1.0)
            inv = 1.0 / scale
            m = (m * scale).to(torch.float16)
        merged[k] = (m, inv, None)
    if not lazy:
        return _stack_merge_materialize(merged)
    if not any(m.is_cuda for m, _, _ in merged.values()):
        return merged
    out = {}
    for k, (m, inv, _) in merged.items():
        host = torch.empty(m.shape, dtype=m.dtype, pin_memory=True)
        host.copy_(m, non_blocking=True)
        hinv = None
        if inv is not None:
            hinv = torch.empty((), dtype=inv.dtype, pin_memory=True)
            hinv.copy_(inv, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(m.device))
        out[k] = (host, hinv, done)
    return out


def _stack_merge_materialize(merged):
    """The float64 host arrays of ``_stack_merge_fetch`` handles: each wire
    upcast and multiplied by its inverse scale (reference :144-155)."""
    out = {}
    for k, (v, inv, done) in merged.items():
        if done is not None:
            done.synchronize()
        a = v.cpu().numpy().astype(np.float64)
        if inv is not None:
            a *= float(inv.cpu())
        out[k] = a
    return out


def _bank_groups(W):
    """The accumulator bank the reference pins per window tier on an
    accelerator (reference :1798-1806): past this many groups its
    ``_pallas_accumulate`` runs in blocks and fetches them flip-merged on the
    device (``_stack_merge_fetch``), and so does ``_quad_accumulate``."""
    return 512 if W <= 33 else 128 if W <= 64 else 32


class _QuadStream:
    """Single-pass accumulation of one region (the counterpart of the
    reference's ``_PallasStream``, :200-343): the session's tile stack is
    built from a predicate that needs no window coordinates (the |row - col|
    band of cis BED, explicit tiles of BEDPE rows and trans products), so
    snip chunks are quad-sorted and launched WHILE the host still makes
    coordinate frames.

    The session arrives as a future of ``(session, ready)``:
    the tile scatter and the upload, expansion and normalization run on
    ``_stage_pool``'s worker while the first frames are made, and ``feed``
    buffers until it resolves. ``ready`` is a CUDA event recorded after the
    build on the worker's stream, which the main thread's stream waits on
    before its first launch (None on the CPU). An error of the build
    re-raises from the future. Each ``chunk`` snips are one
    ``run_many`` (one launch of the quad kernel) into groups ``cid + half *
    flip``; the chunks' accumulators are summed on the device and fetched
    once by ``finish``. ROI snips' stripe planes are gathered per chunk
    (as float16 with ``stripe_f16``, the reference's stripe wire) and
    copied to pinned host buffers without blocking, an event each, which
    ``stripe_planes`` waits on."""

    def __init__(self, future, half, chunk, device, stripes=False,
                 timers=None, stripe_f16=False, region=None):
        self._fut = future
        self.region = region
        self.session = None
        self.half = half
        self.chunk = chunk
        self.device = device
        self.stripes = stripes
        self.stripe_f16 = stripe_f16
        self.timers = timers
        self.chunks = 0
        self._bufs = {"r1": [], "r2": [], "cid": []}
        self._sbufs = {"r1": [], "r2": []}
        self._total = None
        self._stripe_parts = []  # (host tensor, copy event or None)

    def resolve(self, block=True):
        """Adopt the built session; True when ready. ``block=False`` keeps
        buffering rather than stalling the coordinate producer."""
        if self.session is not None:
            return True
        if not self._fut.done():
            if not block:
                return False
            ctx = (self.timers.phase("wait", self.region) if self.timers
                   else contextlib.nullcontext())
            with ctx:
                self._fut.result()
        self.session, ready = self._fut.result()
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        return True

    def feed(self, r1, r2, cid, sr1=None, sr2=None):
        """Buffer one frame's windows (and the ROI snips' stripe windows)
        and launch every full chunk once the session is ready."""
        for key, a in (("r1", r1), ("r2", r2), ("cid", cid)):
            self._bufs[key].append(a)
        if self.stripes:
            self._sbufs["r1"].append(sr1)
            self._sbufs["r2"].append(sr2)
        if not self.resolve(block=False):
            return
        while _buffered(self._bufs) >= self.chunk:
            self._dispatch(self.chunk)
        while self.stripes and _buffered(self._sbufs) >= self.chunk:
            self._dispatch_stripes(self.chunk)

    def _dispatch(self, n):
        take = _take(self._bufs, n)
        out = self.session.run_many(take["r1"], take["r2"], take["cid"],
                                    fetch=False)
        self.chunks += 1
        if self._total is None:
            self._total = out
        else:
            for k, v in out.items():
                self._total[k] += v

    def _dispatch_stripes(self, n):
        take = _take(self._sbufs, n)
        hv = self.session.stripes_device(take["r1"], take["r2"],
                                         f16=self.stripe_f16)
        if self.device.type != "cuda":
            self._stripe_parts.append((hv, None))
            return
        host = torch.empty(hv.shape, dtype=hv.dtype, pin_memory=True)
        host.copy_(hv, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self._stripe_parts.append((host, done))

    def finish(self, groups):
        """Launch the tail and fetch once: the float64 totals of the used
        groups in the compact layout (unflipped rows [0, groups), flip bank
        [groups, 2 * groups)) plus ``poison``; None when nothing was
        fed."""
        self.resolve(block=True)
        while _buffered(self._bufs):
            self._dispatch(min(self.chunk, _buffered(self._bufs)))
        while self.stripes and _buffered(self._sbufs):
            self._dispatch_stripes(min(self.chunk, _buffered(self._sbufs)))
        if self._total is None:
            return None
        return self.session.finalize([self._total],
                                     compact=(groups, self.half))

    def stripe_planes(self):
        """The streamed ROI stripe planes in stream order, float32 numpy
        ``(horizontal [n, W], vertical [n, W] unreversed)``; float16 planes
        are upcast here."""
        W = self.session.W
        parts = []
        for host, done in self._stripe_parts:
            if done is not None:
                done.synchronize()
            parts.append(host.numpy())
        hv = np.concatenate(parts) if parts else np.zeros((0, 2 * W),
                                                          np.float32)
        hv = hv.astype(np.float32, copy=False)
        return hv[:, :W], hv[:, W:]

    def discard(self):
        """Give the stream up: wait for its build (whose error re-raises)
        and drop the session and everything fed."""
        self._fut.result()
        self.session = self._total = None
        self._stripe_parts = []


def _buffered(bufs):
    return sum(len(a) for a in bufs["r1"])


def _take(bufs, n):
    """The first ``n`` buffered entries of every key of ``bufs``, removed
    from the buffers."""
    out = {}
    for key, parts_list in bufs.items():
        parts, got = [], 0
        while got < n:
            head = parts_list[0]
            if len(head) <= n - got:
                parts.append(parts_list.pop(0))
                got += len(head)
            else:
                parts.append(head[: n - got])
                parts_list[0] = head[n - got :]
                got = n
        out[key] = np.concatenate(parts) if len(parts) > 1 else parts[0]
    return out


def _next_pow2(x):
    return 1 << max(0, int(np.ceil(np.log2(max(1, int(x))))))


def _generic_route(stiles):
    """The generic step's route on the device of ``stiles``: the wide
    kernel on a card, its plain version on the CPU."""
    return "generic_cuda" if stiles.device.type == "cuda" else "generic_torch"


def _block_half(W):
    """Groups per accumulator block: the largest power of two whose two
    banks of [W, W] float32 sums and int32 counts fit ``_BLOCK_BYTES``,
    within the packed word's group field (32,768 at W = 21, 1,024 at
    W = 120)."""
    h = max(1, _BLOCK_BYTES // (2 * W * W * 8))
    return min(1 << (int(h).bit_length() - 1), quad_gather.C_MAX // 2)


def _group_blocks(cidl, G, half):
    """The accumulator blocks of a snip stream: ``(sel, base, span)`` with
    ``sel`` the snips of groups [base, base + span), or None for all of
    them when the G groups fit one block of ``half``. Past that, blocks of
    ``half`` groups in cid order; a block's local group ids are ``cid -
    base``, and its flip bank rides rows [half, half + span)."""
    if G <= half:
        yield None, 0, G
        return
    order = np.argsort(cidl, kind="stable")
    bounds = np.searchsorted(cidl[order], np.arange(0, G + half, half))
    for bi in range(len(bounds) - 1):
        lo, hi = int(bounds[bi]), int(bounds[bi + 1])
        if hi > lo:
            yield order[lo:hi], bi * half, min(half, G - bi * half)


def _put_block(out, part, base, G):
    """Write one block's flip-merged totals into ``out``'s [G, ...]
    arrays (allocated at the first block) at rows [base, base + span); the
    one block of all G groups is taken as it is."""
    for k, v in part.items():
        if len(v) == G:
            out[k] = v
            continue
        if k not in out:
            out[k] = np.zeros((G,) + v.shape[1:])
        out[k][base : base + len(v)] = v


def _fast_all(pups):
    """The 'all' pup of many groups at once: reduce(sum_pups) builds a
    pd.Series per merge, which at by-window's tens of thousands of groups
    costs seconds; summing the stacked planes gives the same pup (the same
    nan_to_num and list concatenation as sum_pups)."""
    pups = list(pups)
    return {
        "data": np.nan_to_num(np.sum([p["data"] for p in pups], axis=0)),
        "num": np.sum([p["num"] for p in pups], axis=0),
        "poison": np.sum([p["poison"] for p in pups], axis=0),
        "n": int(sum(p["n"] for p in pups)),
        "cov_start": np.sum([p["cov_start"] for p in pups], axis=0),
        "cov_end": np.sum([p["cov_end"] for p in pups], axis=0),
        "horizontal_stripe": [
            s for p in pups for s in p["horizontal_stripe"]
        ],
        "vertical_stripe": [s for p in pups for s in p["vertical_stripe"]],
        "coordinates": [c for p in pups for c in p["coordinates"]],
    }


def _accumulate_values_frame_keys(extra_sum_funcs):
    """``{output_key: snip_key}`` when every ``extra_sum_funcs`` entry is
    ``functools.partial(accumulate_values, key=...)``: the engine then stays
    on the accumulate route and collects the values from FRAME columns, with
    no per-snip work. None when any entry is opaque (those need the host
    stream). The test is identity with this package's
    ``lib.puputils.accumulate_values``: a partial of another package's
    function of the same name is opaque here, and takes the host stream,
    which is right and slow."""
    keys = {}
    for outkey, func in (extra_sum_funcs or {}).items():
        if not isinstance(func, partial):
            return None
        if func.func is not accumulate_values or func.args:
            return None
        kw = dict(func.keywords or {})
        snip_key = kw.pop("key", None)
        if kw or snip_key is None:
            return None
        keys[outkey] = snip_key
    return keys


def _group_key(group):
    """A pup map's key of one frame group: scalars as they are, anything
    else as a tuple."""
    if isinstance(group, (str, int, np.integer)):
        return group
    return tuple(group)


def _block_cids(kind, group, groups, ensure_cid, lut=None):
    """Cids of a chunk's (kind, group code) pairs, ``ensure_cid`` called
    once per new pair in first-appearance order (the order of ``cid_of``
    is the group order downstream). A code space no larger than the chunk
    goes through a dense table, ``lut``, kept across the chunks of one
    ``groups`` (None: a new one); a larger one through ``np.unique``.
    Returns ``(cids as int32, lut)``."""
    ng = max(len(groups), 1)
    pair = kind.astype(np.int64) * ng + group
    n = len(pair)
    if 2 * ng > n:
        upair, first, inv = np.unique(pair, return_index=True,
                                      return_inverse=True)
        ucid = np.empty(len(upair), np.int32)
        for i in np.argsort(first):
            ucid[i] = ensure_cid(KINDS[upair[i] // ng], groups[upair[i] % ng])
        return ucid[inv], None
    if lut is None:
        lut = np.full(2 * ng, -1, np.int32)
    cids = lut[pair]
    new = np.flatnonzero(cids < 0)
    if len(new):
        first = np.full(2 * ng, n, np.int64)
        np.minimum.at(first, pair[new], new)
        seen = np.flatnonzero(first < n)
        for p in seen[np.argsort(first[seen])]:
            lut[p] = ensure_cid(KINDS[p // ng], groups[p % ng])
        cids = lut[pair]
    return cids, lut


def _orientation_labels(pups):
    """'strand1strand2' labels with the all-group collapsed to 'all'."""
    labels = pups["strand1"].astype(str) + pups["strand2"].astype(str)
    return labels.where(labels != "allall", "all")


def _separation_label(band):
    """Human-readable separation text for one distance-band tuple."""
    if band == "all":
        return "all"
    lo = band[0] / 1_000_000
    if len(band) < 2:
        return f"{lo}Mb+"
    return f"{lo}Mb-\n{band[1] / 1_000_000}Mb"


class PileUpper:
    """See reference coolpup.py:752–836 for parameter semantics; the
    constructor surface is the JAX package's minus ``backend``, plus
    ``device`` (a torch device: ``"cuda"`` runs the CUDA kernel, ``"cpu"``
    the plain PyTorch version). ``mesh`` is None, ``"auto"`` (every CUDA
    device, ``parallel.make_loci_mesh``) or a ``parallel.LociMesh``, whose
    devices must be of ``device``'s type; results then land on its first
    device.

    ``tile_f16`` and ``stripe_f16`` are the reference's transfer wires,
    taken where the JAX package takes them on an accelerator. On ``cuda``,
    ``tile_f16=True`` uploads the quad route's raw tiles as pow2-scaled
    float16: ``"lossy"`` on balanced maps (at most 2^-11 relative error a
    value), ``"exact"`` on raw counts (float32 where the round trip is not
    exact); with the attribute ``tile_int8 = True`` set on the instance, a
    cis region of a map whose stored counts are integers
    (``Cooler.counts_are_int``) in [0, 127] ships them as int8 and folds
    the balancing weights on the device. ``stripe_f16=True`` fetches the
    stripe planes as float16 and the flip-merged accumulators of more
    groups than the reference's pinned bank (by-window) as pow2-scaled
    float16 (``num`` only where no group holds more than 2048 snips), on
    balanced or OOE-divided values only. ``False`` turns a wire off. On
    ``cpu`` every transfer is float32 whatever the flags.
    ``chunk_size`` and ``tile_size`` are accepted and unused, as in the
    JAX package, and recorded in the output's ``ignored`` column.
    ``timers``: a ``PhaseTimers`` that every ``pileupsWithControl`` run
    records into, kept by the caller; without one each run makes its own
    (``self.timers``), its span log on where ``trace_dir`` is set."""

    def __init__(
        self,
        clr,
        CC,
        *,
        view_df=None,
        clr_weight_name="weight",
        expected=False,
        expected_value_col="balanced.avg",
        ooe=True,
        control=False,
        coverage_norm=False,
        rescale=False,
        rescale_size=99,
        flip_negative_strand=False,
        ignore_diags=2,
        store_stripes=False,
        stripe_f16=True,
        tile_f16=True,
        nproc=1,
        chunk_size=32768,
        tile_size=None,
        checkpoint_dir=None,
        trace_dir=None,
        device="cuda",
        mesh=None,
        timers=None,
    ):
        self.device = resolve_device(device)
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh={mesh!r}: use None, 'auto' or a "
                                 "LociMesh")
            from ..parallel.mesh import make_loci_mesh

            mesh = make_loci_mesh()
        if mesh is not None:
            if mesh.type != self.device.type:
                raise ValueError(
                    f"a mesh of {mesh.type} devices with device="
                    f"{str(self.device)!r}: pass the device type of the mesh"
                )
            self.device = mesh.devices[0]
        self.mesh = mesh
        # regions the mesh banded / left replicated for lack of tile rows or
        # for a snip-load skew (the reference's counters), and what the mesh
        # runs of the last pileupsWithControl did (``_new_mesh_stats``)
        self._rowshard_regions = 0
        self._rowshard_fallbacks = 0
        self.mesh_stats = self._new_mesh_stats()
        self.clr = clr
        self.resolution = clr.binsize
        self.CC = CC
        if self.resolution != self.CC.resolution:
            raise ValueError(
                f"cooler resolution {self.resolution} differs from the "
                f"coordinates' {self.CC.resolution}"
            )
        # mirrored CC attributes (reference coolpup.py:841 merges __dict__)
        for attr in (
            "flank",
            "rescale_flank",
            "minshift",
            "maxshift",
            "nshifts",
            "mindist",
            "maxdist",
            "local",
            "subset",
            "seed",
            "trans",
            "kind",
            "final_chroms",
        ):
            setattr(self, attr, getattr(CC, attr))
        self.clr_weight_name = clr_weight_name
        self.expected = expected
        self.expected_value_col = expected_value_col
        self.ooe = ooe
        self.control = control
        self.pad_bins = self.CC.flank // self.resolution
        self.coverage_norm = coverage_norm
        self.rescale = rescale
        self.rescale_size = rescale_size
        self.flip_negative_strand = flip_negative_strand
        self.ignore_diags = ignore_diags
        self.store_stripes = store_stripes
        self.stripe_f16 = stripe_f16
        self.tile_f16 = tile_f16
        self.chunk_size = int(chunk_size)
        self.tile_size = tile_size
        self.nproc = nproc
        self.checkpoint_dir = checkpoint_dir
        self.trace_dir = trace_dir
        # the last pileupsWithControl run's PhaseTimers (its breakdown):
        # ``timers`` where one was given, which every run then adds to
        self._given_timers = self.timers = timers
        self._routes = set()

        if view_df is None:
            self.view_df = make_cooler_view(clr)
        else:
            self.view_df = make_viewframe(view_df, check_bounds=clr.chromsizes)

        self.expected_vectors = {}
        self.expected_df = None
        if self.expected is not None and self.expected is not False:
            expected_df = self.expected
            expected_df = expected_df[
                expected_df["region1"].isin(self.view_df["name"])
                & expected_df["region2"].isin(self.view_df["name"])
            ].reset_index(drop=True)
            if self.control:
                warnings.warn(
                    "Can't do both expected and control shifts; "
                    "defaulting to expected",
                    stacklevel=2,
                )
                self.control = False
            if self.trans:
                is_valid_expected(
                    expected_df,
                    "trans",
                    self.view_df,
                    verify_cooler=clr,
                    expected_value_cols=[self.expected_value_col],
                    raise_errors=True,
                )
                self.expected_df = expected_df
            else:
                expected_df = expected_df[
                    expected_df["region1"] == expected_df["region2"]
                ].reset_index(drop=True)
                is_valid_expected(
                    expected_df,
                    "cis",
                    self.view_df,
                    verify_cooler=clr,
                    expected_value_cols=[self.expected_value_col],
                    raise_errors=True,
                )
                self.expected_df = expected_df
                for name, sub in expected_df.groupby("region1", observed=True):
                    sub = sub.sort_values("dist")
                    vec = np.full(int(sub["dist"].max()) + 1, np.nan)
                    vec[sub["dist"].astype(int).values] = sub[
                        self.expected_value_col
                    ].values
                    self.expected_vectors[name] = vec
            self.expected = True

        self.view_df = self.view_df.set_index("name")
        self.view_df_extents = {}
        for region_name, region in self.view_df.iterrows():
            lo, hi = self.clr.extent(region)
            chroffset = self.clr.offset(region.iloc[0])
            self.view_df_extents[region_name] = lo - chroffset, hi - chroffset

        self.chroms = natsorted(
            set(self.CC.final_chroms) & set(self.clr.chromnames)
        )
        self.view_df = self.view_df[self.view_df["chrom"].isin(self.chroms)]
        if self.view_df["chrom"].unique().shape[0] == 0:
            raise ValueError(
                "No chromosomes are in common between the coordinate "
                "file and the cooler file"
            )
        if self.trans and self.view_df["chrom"].unique().shape[0] < 2:
            raise ValueError("Trying to do trans with fewer than two chromosomes")

        if self.coverage_norm is True or self.coverage_norm == "total":
            self.coverage_norm = "cov_tot_raw"
        elif self.coverage_norm == "cis":
            self.coverage_norm = "cov_cis_raw"
        if self.coverage_norm and self.clr_weight_name:
            raise ValueError(
                "Can't do coverage normalization when clr_weight_name is provided"
            )
        if (
            self.coverage_norm
            and self.coverage_norm not in self.clr.bins().columns
        ):
            if self.coverage_norm in ("cov_cis_raw", "cov_tot_raw"):
                with self._detail("prepare/coverage"):
                    coverage_mod.coverage(
                        self.clr, store=True, ignore_diags=self.ignore_diags
                    )
            else:
                raise ValueError(
                    f"coverage_norm {self.coverage_norm} not found in cooler bins"
                )

        if self.rescale:
            if self.rescale_flank is None:
                raise ValueError("Cannot use rescale without setting rescale_flank")
            if self.rescale_size % 2 == 0:
                raise ValueError("Please provide an odd rescale_size")
            iv = self.CC.intervals
            if self.CC.kind == "bed":
                self.max_extent_bins = int((iv["endBin"] - iv["stBin"]).max())
            else:
                self.max_extent_bins = int(max(
                    (iv["endBin1"] - iv["stBin1"]).max(),
                    (iv["endBin2"] - iv["stBin2"]).max(),
                ))

    # ------------------------------------------------------------------

    def make_outmap(self):
        if self.rescale:
            return np.zeros((self.rescale_size, self.rescale_size))
        return np.zeros((2 * self.pad_bins + 1, 2 * self.pad_bins + 1))

    def _window_bins(self):
        """Window size in bins (reference make_outmap,
        coolpup.py:1007–1022)."""
        return 2 * self.pad_bins + 1

    def get_expected_trans(self, region1, region2):
        """The scalar expected of one trans region pair."""
        exp_value = self.expected_df.loc[
            (self.expected_df["region1"] == region1)
            & (self.expected_df["region2"] == region2),
            self.expected_value_col,
        ]
        return float(exp_value.iloc[0])

    # -- region staging ----------------------------------------------------

    def _region_device_inputs(self, region1, region2, minpad=512):
        """Fetch everything per region that snips index into: the pixel
        slab, the 0/1 valid-bin vectors, the coverage vectors and the
        expected vector, padded to ``next_pow2(len + minpad)`` (``evec``
        NaN-filled; the region pair's scalar under trans; ``[nan]`` without
        an expected table). ``cis`` marks a region with itself outside
        trans mode: only there are diagonals masked. The timers count the
        path the fetch's column filter took: ``fetch_views`` +1 where it
        dropped no pixel of its row spans (the slab holds views of the
        store's columns), and ``fetch_dropped_pixels``. Under
        ``coverage_norm`` the coverage vectors' fetch is the phase
        ``coverage``, counted in ``coverage_regions``."""
        r1c = self.view_df.loc[region1]
        r2c = self.view_df.loc[region2] if region2 != region1 else r1c
        min1, max1 = self.view_df_extents[region1]
        min2, max2 = self.view_df_extents[region2]

        with self._detail("ingest/fetch"):
            slab = self.clr.fetch_slab(r1c, r2c,
                                       balance=self.clr_weight_name)
        self._count("fetch_views", int(slab.dropped == 0))
        self._count("fetch_dropped_pixels", slab.dropped)

        def padded(vec, fill=0.0):
            out = np.full(
                _next_pow2(len(vec) + minpad), fill, dtype=np.float32
            )
            out[: len(vec)] = vec
            return out

        valid1 = padded(
            (~self.clr.bad_bin_mask(r1c, self.clr_weight_name)).astype(np.float32)
        )
        valid2 = padded(
            (~self.clr.bad_bin_mask(r2c, self.clr_weight_name)).astype(np.float32)
        )
        # the cleaned balancing weights (0 at bad bins) replace the 0/1
        # valid vectors on the int8 wire (``_tile_wire_plan``), whose
        # device normalization folds them; only that wire reads them
        w1 = w2 = None
        if self.clr_weight_name and getattr(self, "tile_int8", False):
            wall = self.clr._clean_weights(self.clr_weight_name)
            lo1g, hi1g = self.clr.extent(r1c)
            lo2g, hi2g = self.clr.extent(r2c)
            w1 = padded(wall[lo1g:hi1g])
            w2 = padded(wall[lo2g:hi2g])
        if self.coverage_norm:
            with self._phase("coverage"):
                cov1 = padded(
                    self.clr.bins()[self.coverage_norm].fetch(r1c).values
                )
                cov2 = padded(
                    self.clr.bins()[self.coverage_norm].fetch(r2c).values
                )
            self._count("coverage_regions")
        else:
            cov1 = np.zeros(8, np.float32)
            cov2 = np.zeros(8, np.float32)
        if self.expected and self.trans:
            evec = np.array(
                [self.get_expected_trans(region1, region2)], np.float32
            )
        elif self.expected:
            evec = padded(self.expected_vectors[region1], fill=np.nan)
        else:
            evec = np.array([np.nan], np.float32)
        return dict(
            slab=slab,
            min1=min1,
            min2=min2,
            n1=max1 - min1,
            n2=max2 - min2,
            valid1=valid1,
            valid2=valid2,
            w1=w1,
            w2=w2,
            cov1=cov1,
            cov2=cov2,
            evec=evec,
            cis=(not self.trans) and region1 == region2,
        )

    # -- the transfer wires (reference :658-720, :777-780) ------------------

    def _on_accelerator(self):
        """The reference's accelerator test: the card takes the transfer
        wires, the CPU keeps every transfer float32 (and every golden
        exact)."""
        return self.device.type == "cuda"

    def _stripe_f16_effective(self):
        """f16 stripe and accumulator fetches only when the values are
        bounded: balancing weights or expected normalization keep them
        O(1-100); raw counts on deep maps can pass float16's 65504."""
        if not bool(getattr(self, "stripe_f16", True)):
            return False
        # expected WITHOUT ooe leaves raw counts in the stacks (the
        # expected plane is emitted separately)
        return bool(self.clr_weight_name) or bool(self.expected and self.ooe)

    def _fetch_f16(self):
        """Whether stripe planes and the blocked accumulators come back as
        float16: ``_stripe_f16_effective`` on the card."""
        return self._stripe_f16_effective() and self._on_accelerator()

    def _tile_f16_mode(self):
        """The upload wire of raw tiles (``ops/tiles.cast_tiles_f16``):
        balanced maps carry O(1) values, where scaled float16's <= 2^-11
        relative error is below the noise of any pile-up average
        (``"lossy"``); unbalanced maps carry integer counts, shipped
        float16 only where the cast round-trips exactly (``"exact"``). The
        CPU keeps float32."""
        if not bool(getattr(self, "tile_f16", True)):
            return False
        if not self._on_accelerator():
            return False
        return "lossy" if self.clr_weight_name else "exact"

    def _tile_wire_plan(self, dev):
        """The wire mode and the per-bin vectors of a staged region. With
        the attribute ``tile_int8 = True`` (opt-in), a balanced cis region
        whose STORED counts are integers (``clr.counts_are_int``) in [0,
        127] ships raw int8 counts (a quarter of float32) and folds the
        balancing weights on the device: the weight vectors replace the 0/1
        valid vectors. Everything else takes ``_tile_f16_mode``. Returns
        ``(mode, valid1, valid2)``."""
        mode = self._tile_f16_mode()
        slab = dev.get("slab")
        if (
            getattr(self, "tile_int8", False)
            and mode == "lossy"
            and dev.get("w1") is not None
            and dev.get("cis")
            and getattr(slab, "mirror", False)
            and getattr(self.clr, "counts_are_int", False)
            and slab.nnz > 0
        ):
            vmax = float(slab.vals.max())
            vmin = float(slab.vals.min())
            if 0.0 <= vmin and vmax <= 127.0:
                return "int8", dev["w1"], dev["w2"]
        return mode, dev["valid1"], dev["valid2"]

    def _phase(self, name, region=None):
        timers = self.timers
        return (timers.phase(name, region) if timers
                else contextlib.nullcontext())

    def _detail(self, name):
        timers = self.timers
        return timers.detail(name) if timers else contextlib.nullcontext()

    def _count(self, name, n=1):
        if self.timers:
            self.timers.count(name, n)

    def _count_wire(self, mode, wire):
        """Count a region's raw tiles on the ``"exact"`` float16 wire
        (``_tile_f16_mode`` of integer counts): ``tile_wire_f32_regions``
        where a payload fell back to float32 (a count the float16 cast
        does not hand back bit for bit), else
        ``tile_wire_exact_f16_regions``. On any float16 wire, a region
        whose payload went over as float16 counts
        ``tile_cast_native_regions``: the native cast
        (``ops/tiles.cast_slab_f16``) makes every such payload. ``wire``:
        the dtype names of the region's uploads
        (``QuadPileupSession.wire``)."""
        if mode == "exact" and wire:
            self._count("tile_wire_f32_regions" if "float32" in wire
                        else "tile_wire_exact_f16_regions")
        if "float16" in wire:
            self._count("tile_cast_native_regions")

    def _stage_region(self, region1, region2, region=None):
        """Fetch + stage one region pair's inputs (``region``: its index
        in the region loop, for the span log). Under rescale the per-bin
        vectors are padded past the largest extent bucket, whose coverage
        slices read ``Hmax`` bins from every window start (reference
        :1002-1016)."""
        with self._phase("ingest", region):
            if self.rescale:
                hmax = max(_RESCALE_MIN_BUCKET,
                           _next_pow2(self.max_extent_bins))
                return self._region_device_inputs(region1, region2,
                                                  minpad=hmax + 8)
            return self._region_device_inputs(region1, region2)

    # -- one region ----------------------------------------------------------

    def pileup_region(
        self,
        region1,
        region2=None,
        groupby=None,
        modify_2Dintervals_func=None,
        postprocess_frame_func=None,
        postprocess_snip_func=None,
        postprocess_batch_func=None,
        extra_sum_funcs=None,
        dev=None,
        column_hint=None,
        dual_anchor=False,
    ):
        """Accumulate all snips of one region (pair) on the device; returns
        {"ROI": {group: pup}, "control": {...}} (reference
        coolpup.py:1285-1358).

        The hooks choose the route: ``postprocess_batch_func`` takes
        ``_pileup_region_batchhook``; ``postprocess_snip_func``, an opaque
        ``extra_sum_funcs`` entry, or extras under expected emission take the
        host stream (``_pileup_region_hostpath``); ``postprocess_frame_func``
        (applied to every coordinate frame before groups are assigned) and
        ``accumulate_values`` extras over frame columns stay here.

        Two phases (the reference's collected path): (1) the host streams
        vectorized snip frames into flat index arrays (bounds-checked, group
        ids factorized in first-appearance order); (2) one tile stack of the
        touched tiles is built and staged once, and every snip runs through
        one route: ``_rescale_accumulate`` under rescale,
        ``_generic_accumulate`` for W > 120, ``_quad_accumulate`` otherwise.
        ``dual_anchor`` (the by-window mode) adds every snip to the groups
        of both its anchors, keyed by the integer anchor id."""
        groupby = groupby or []
        if region2 is None:
            region2 = region1
        # without a hook that reads or rewrites a frame, the coordinates
        # come as integer blocks (CoordCreator.blocks)
        block_route = (
            modify_2Dintervals_func is None
            and postprocess_frame_func is None
            and postprocess_snip_func is None
            and postprocess_batch_func is None
            and not extra_sum_funcs
            and not dual_anchor
            and not self.store_stripes
            and self.CC.block_groups(groupby) is not None
        )
        self._count("coord_block_regions" if block_route
                    else "coord_frame_regions")

        if postprocess_batch_func is not None:
            if postprocess_snip_func is not None:
                raise ValueError(
                    "postprocess_batch_func and postprocess_snip_func "
                    "are mutually exclusive"
                )
            if (
                self.rescale
                or self.store_stripes
                or (self.expected and not self.ooe)
                or self.mesh is not None
                or dual_anchor
            ):
                raise ValueError(
                    "postprocess_batch_func does not support rescale / "
                    "stripes / expected-emission / mesh / by-window "
                    "runs; use postprocess_snip_func there"
                )
            return self._pileup_region_batchhook(
                region1,
                region2,
                groupby,
                modify_2Dintervals_func,
                postprocess_frame_func,
                postprocess_batch_func,
                extra_sum_funcs,
                dev=dev,
            )

        if dev is None:
            dev = self._stage_region(region1, region2)

        # extras in the accumulate_values form are frame columns, regrouped
        # per cid on the host with no per-snip work. Opaque extras, per-snip
        # data hooks and expected-emission runs (whose synthetic expected
        # snips pass through the hooks too) use the host stream.
        hostpath_args = (
            region1,
            region2,
            groupby,
            modify_2Dintervals_func,
            postprocess_frame_func,
            postprocess_snip_func,
            extra_sum_funcs,
        )
        extra_frame_keys = None
        if (
            extra_sum_funcs
            and postprocess_snip_func is None
            and not (self.expected and not self.ooe)
        ):
            extra_frame_keys = _accumulate_values_frame_keys(extra_sum_funcs)
        if postprocess_snip_func is not None or (
            extra_sum_funcs and extra_frame_keys is None
        ):
            if not getattr(self, "_warned_hostpath", False):
                self._warned_hostpath = True
                logger.warning(
                    "per-snip extension hooks (postprocess_snip_func / "
                    "opaque extra_sum_funcs) run on the HOST snip stream: "
                    "windows are cut on the device, then every snip is one "
                    "python dict folded in numpy; accumulate_values-style "
                    "extra_sum_funcs over frame columns, "
                    "postprocess_frame_func and postprocess_batch_func "
                    "avoid the per-snip python"
                )
            return self._pileup_region_hostpath(*hostpath_args, dev=dev)

        W = self._window_bins()
        shape = self.make_outmap().shape
        emit_expected = bool(self.expected and not self.ooe)
        timers = self.timers

        cid_of = {}

        def ensure_cid(kind, group):
            key = (kind, group)
            if key not in cid_of:
                cid_of[key] = len(cid_of)
            return cid_of[key]

        region1_coords = tuple(self.view_df.loc[region1])
        region2_coords = tuple(self.view_df.loc[region2])

        if column_hint is not None:
            column_hint = set(column_hint)
            if extra_frame_keys:
                column_hint |= set(extra_frame_keys.values())
            if self.store_stripes:
                column_hint |= set(_COORD_COLS)
            if dual_anchor:
                column_hint |= {"anchor_idx1", "anchor_idx2"}

        # the single-pass stream (quad route, not by-window: its groups
        # outnumber any stream's bank): pre-opened by the region prefetch,
        # or opened here
        stream = dev.get("_stream")
        quad_route = not self.rescale and W <= quad_gather.W_MAX
        if stream is None and quad_route and not dual_anchor:
            with self._phase("tiles"):
                stream = self._maybe_open_stream(region1, region2, dev)
        elif stream is not None and (not quad_route or dual_anchor):
            stream.discard()
            stream = None
        launches = quad_gather.LAUNCHES

        # -- phase 1: host coordinate collection -----------------------
        cols = {k: [] for k in ("r1", "r2", "h1", "w2", "dd0", "cidl", "flip",
                                "roi")}
        coord_blocks = []
        dual_lut = None
        cid_lut = (None, None)  # (the group table it codes, the table)
        extra_cols = (
            {k: [] for k in extra_frame_keys} if extra_frame_keys else None
        )
        fell_back = False
        region2_arg = region2_coords if region2 != region1 else None
        if block_route:
            chunks = self.CC.blocks(region1_coords, region2_arg,
                                    control=self.control, groupby=groupby)
        else:
            chunks = self.CC.batches(
                region1_coords,
                region2_arg,
                control=self.control,
                groupby=groupby,
                modify_2Dintervals_func=modify_2Dintervals_func,
                columns=(
                    tuple(sorted(column_hint))
                    if column_hint is not None
                    else None
                ),
            )
        with self._phase("coords"):
            for chunk in chunks:
                if block_route:
                    blk = chunk
                else:
                    if postprocess_frame_func is not None:
                        chunk = postprocess_frame_func(chunk)
                    if len(chunk) == 0:
                        continue
                    if extra_frame_keys is not None:
                        missing = [c for c in extra_frame_keys.values()
                                   if c not in chunk.columns]
                        if missing:
                            # the value exists per snip only. This fires on
                            # the FIRST non-empty chunk, before anything was
                            # collected
                            assert not any(len(a) for a in cols["r1"]), missing
                            logger.warning(
                                "extra_sum_funcs keys %s are not "
                                "feature-frame columns; falling back to the "
                                "host snip stream",
                                missing,
                            )
                            fell_back = True
                            break
                    blk = CoordBlock.from_frame(chunk)
                low = self._lower_block(blk, dev, W)
                if low is None:
                    continue
                inb, r1c, r2c, h1, w2, dd0c, kindc, groupc, flipc = low
                if not block_route and inb is not None:
                    chunk = chunk.loc[inb]
                if dual_anchor:
                    cid_parts = self._dual_anchor_cids(
                        chunk, ensure_cid, dual_lut
                    )
                    dual_lut = cid_parts.pop()
                else:
                    if cid_lut[0] is not blk.groups:
                        cid_lut = (blk.groups, None)
                    cidc, lut = _block_cids(kindc, groupc, blk.groups,
                                            ensure_cid, cid_lut[1])
                    cid_lut = (blk.groups, lut)
                    cid_parts = [cidc]
                    # (the dual-anchor path collects no extras, as in the
                    # reference)
                    if extra_cols is not None:
                        for outkey, col in extra_frame_keys.items():
                            extra_cols[outkey].append(chunk[col].values)
                if self.store_stripes:
                    # planes and coordinates exist for ROI snips only;
                    # the coordinate strings are cast once per region
                    roic = kindc == 0
                    roi_coords = tuple(chunk[c].to_numpy()[roic]
                                       for c in _COORD_COLS)
                if stream is not None and (
                    not stream.covers(r1c, r2c) or len(cid_of) > stream.half
                ):
                    # a window off the staged tiles (a modify func moved
                    # it) or more groups than the stream's bank: the
                    # collected path takes the region
                    stream.discard()
                    stream = None
                    self._count("stream_aborts")
                if stream is not None:
                    with self._phase("device"):
                        stream.feed(
                            r1c, r2c,
                            cid_parts[0] if flipc is None else
                            (cid_parts[0] + stream.half * flipc).astype(
                                np.int32),
                            *((r1c[roic], r2c[roic]) if self.store_stripes
                              else ()),
                        )
                if flipc is None:
                    flipc = np.zeros(len(r1c), bool)
                for cidc in cid_parts:
                    cols["r1"].append(r1c)
                    cols["r2"].append(r2c)
                    cols["h1"].append(h1)
                    cols["w2"].append(w2)
                    cols["dd0"].append(dd0c)
                    cols["flip"].append(flipc)
                    cols["cidl"].append(cidc)
                    if self.store_stripes:
                        cols["roi"].append(roic)
                        coord_blocks.append(roi_coords)

        if stream is not None and (fell_back or not cols["r1"]):
            stream.discard()
            stream = None
        if fell_back:
            return self._pileup_region_hostpath(*hostpath_args, dev=dev)

        ntot = sum(len(a) for a in cols["r1"])
        acc = {}
        n_counts = {}
        stripes = {}
        extras = {}
        if ntot > 0:
            arr = {k: np.concatenate(v) for k, v in cols.items() if v}
            if timers:
                timers.count("snips", ntot)
            G = len(cid_of)
            counts = np.bincount(arr["cidl"], minlength=G)
            for i, c in enumerate(counts):
                n_counts[i] = int(c)
            # -- phase 2: one tile stack, one accumulation ------------------
            if self.rescale:
                with self._phase("tiles"):
                    tile_stack = self._build_tile_stack(dev, arr, arr["h1"],
                                                        arr["w2"])
                with self._phase("device"):
                    acc = self._rescale_accumulate(tile_stack, dev, arr, G)
            elif stream is not None:
                self._count("stream_regions")
                with self._phase("device"):
                    acc = self._stream_accumulate(stream, dev, arr, W, G,
                                                  launches)
            elif self.mesh is not None:
                acc = self._mesh_accumulate(dev, arr, W, G)
            else:
                raw = (W <= quad_gather.W_MAX
                       and self._tile_wire_plan(dev)[0] == "int8")
                with self._phase("tiles"):
                    tile_stack = self._build_tile_stack(dev, arr, W,
                                                        raw_counts=raw)
                with self._phase("device"):
                    if W > quad_gather.W_MAX:
                        acc = self._generic_accumulate(tile_stack, dev, arr,
                                                       W, G)
                    else:
                        acc = self._quad_accumulate(tile_stack, dev, arr, W,
                                                    G)
            if self.store_stripes:
                with self._phase("stripes"):
                    stripes = self._package_stripes(acc, arr, coord_blocks, G)
            if extra_cols is not None:
                # accumulate_values semantics: per group, the flat list of
                # the frame column's values in stream order (a STABLE sort
                # by cid), stored under the SNIP key like the host stream's
                # _add_snip
                order = np.argsort(arr["cidl"], kind="stable")
                bounds = np.searchsorted(arr["cidl"][order], np.arange(G + 1))
                for outkey, col in extra_frame_keys.items():
                    vals = np.concatenate(extra_cols[outkey])
                    extras[col] = {
                        c: vals[order[bounds[c] : bounds[c + 1]]].tolist()
                        for c in range(G)
                        if bounds[c + 1] > bounds[c]
                    }

        # -- package into pup dicts ------------------------------------
        outdict = {"ROI": {}, "control": {}}
        for (kind, group), i in cid_of.items():
            if n_counts.get(i, 0) == 0:
                continue
            pup = {
                "data": acc["sum"][i],
                "num": acc["num"][i],
                "poison": acc["poison"][i],
                "n": n_counts[i],
                "cov_start": acc["cov_start"][i]
                if self.coverage_norm
                else np.zeros(shape[0]),
                "cov_end": acc["cov_end"][i]
                if self.coverage_norm
                else np.zeros(shape[1]),
                "horizontal_stripe": stripes.get(i, {}).get("h", []),
                "vertical_stripe": stripes.get(i, {}).get("v", []),
                "coordinates": stripes.get(i, {}).get("coords", []),
            }
            for outkey in extras:
                pup[outkey] = extras[outkey].get(i, [])
            key = _group_key(group)
            outdict[kind][key] = pup
            if emit_expected and kind == "ROI":
                epup = {
                    "data": acc["exp_sum"][i],
                    "num": acc["exp_num"][i],
                    "poison": np.zeros(shape),
                    "n": n_counts[i],
                    "cov_start": np.zeros(shape[0]),
                    "cov_end": np.zeros(shape[1]),
                    "horizontal_stripe": [],
                    "vertical_stripe": [],
                    "coordinates": [],
                }
                if key in outdict["control"]:
                    outdict["control"][key] = dict(
                        sum_pups(outdict["control"][key], epup)
                    )
                else:
                    outdict["control"][key] = epup

        sum_func = (
            partial(sum_pups, extra_funcs=extra_sum_funcs)
            if extra_frame_keys
            else sum_pups
        )
        kinds = ["ROI"]
        if self.control or emit_expected:
            kinds.append("control")
        for kind in kinds:
            if "all" in outdict[kind]:
                continue
            if len(outdict[kind]) > 64 and not extra_frame_keys:
                outdict[kind]["all"] = _fast_all(outdict[kind].values())
            else:
                outdict[kind]["all"] = dict(
                    reduce(sum_func, outdict[kind].values(), empty_pup(shape))
                )
        if outdict["ROI"]["all"]["n"] > 0:
            logger.info(f"{region1, region2}: {outdict['ROI']['all']['n']}")
        return outdict

    def _lower_block(self, blk, dev, W):
        """A block's snips inside the region's bins, lowered to the index
        arrays of the accumulate routes: ``(inb, r1, r2, h1, w2, dd0, kind,
        group, flip)``, int32 but for the codes; ``inb`` the mask of the
        snips kept, None where every snip is; None where none is. Raises
        on a window of another size than ``W`` outside rescale."""
        min1, min2 = dev["min1"], dev["min2"]
        s1, e1, s2, e2 = blk.stBin1, blk.endBin1, blk.stBin2, blk.endBin2
        kind, group, flip = blk.kind, blk.group, blk.flip
        inb = s1 >= min1
        inb &= e1 <= min1 + dev["n1"]
        inb &= s2 >= min2
        inb &= e2 <= min2 + dev["n2"]
        if inb.all():
            inb = None
        elif not inb.any():
            return None
        else:
            s1, e1, s2, e2 = s1[inb], e1[inb], s2[inb], e2[inb]
            kind, group = kind[inb], group[inb]
            if flip is not None:
                flip = flip[inb]

        def diff32(a, b):  # a - b, cast as it is stored
            return np.subtract(a, b, out=np.empty(len(a), np.int32))

        h1, w2 = diff32(e1, s1), diff32(e2, s2)
        if not self.rescale and ((h1 != W).any() or (w2 != W).any()):
            raise ValueError(
                "inconsistent window size; flank must be a multiple "
                "of the resolution"
            )
        return (inb, diff32(s1, min1), diff32(s2, min2), h1, w2,
                diff32(s1, s2), kind, group, flip)

    def _dual_anchor_cids(self, chunk, ensure_cid, lut):
        """By-window cids of one frame: each snip belongs to the groups of
        both its anchors, (kind, anchor id) through a dense lookup table
        filled in first-appearance order. Returns ``[cid1, cid2, lut]``."""
        a1 = chunk["anchor_idx1"].to_numpy().astype(np.int64)
        a2 = chunk["anchor_idx2"].to_numpy().astype(np.int64)
        isctl = (chunk["kind"].to_numpy() == "control").astype(np.int8)
        if lut is None:
            lut = np.full((2, len(self.CC.intervals)), -1, np.int32)
        for ids in (a1, a2):
            for k, kname in ((0, "ROI"), (1, "control")):
                sel = ids[isctl == k]
                for u in np.unique(sel[lut[k, sel] < 0]):
                    lut[k, u] = ensure_cid(kname, int(u))
        return [lut[isctl, a1], lut[isctl, a2], lut]

    def _build_tile_stack(self, dev, arr, window1, window2=None,
                          raw_counts=False):
        """The B=128 tiles the windows of ``arr`` touch (heights
        ``window1``, widths ``window2``, scalars or per-snip arrays), built
        by ``_build_quad_stack``."""
        return self._build_quad_stack(
            dev, raw_counts=raw_counts, r1=arr["r1"], r2=arr["r2"],
            window1=window1, window2=window1 if window2 is None else window2,
        )

    def _build_quad_stack(self, dev, raw_counts=False, **kw):
        """The region's B=128 tile stack for the predicate in ``kw``
        (``r1``/``r2``/``window1``/``window2``, ``band`` or ``want``; the
        reference's ``_build_pallas_stack``, :725-775): the upper-triangle
        stack of a mirrored cis slab, where more than ``_BAND_WINDOWS``
        windows (outside rescale) take the |row - col| band of their
        largest distance plus W instead of their touched tiles (one pass in
        place of ``touched_tiles`` over millions of windows; the band holds
        every tile a W×W window can reach); the COO wire for an explicit
        tile set of a rectangle with no mirror whose pixels (an int32 index
        and a float32 value each, or a float16 value on the float16 wire)
        undercut 0.7 of the dense stack's bytes (4 a pixel, 2 on the
        float16 wire); the dense stack otherwise. ``raw_counts`` scatters a
        mirrored cis slab WITHOUT the weight fold (the int8 wire, whose
        device normalization folds the weights)."""
        B = quad_gather.B_TILE
        slab = dev["slab"]
        if raw_counts and dev["cis"] and slab.mirror \
                and slab.weights is not None:
            slab = dataclasses.replace(slab, weights=None)
        if dev["cis"] and slab.mirror:
            r1 = kw.get("r1")
            if r1 is not None and len(r1) > _BAND_WINDOWS and not self.rescale:
                dd = np.abs(np.asarray(r1, np.int64)
                            - np.asarray(kw["r2"], np.int64))
                kw = {"band": min(int(dd.max(initial=0))
                                  + self._window_bins() + 8, int(dev["n1"]))}
            return build_tile_stack_slab_sym(slab, B, **kw)
        want = kw.get("want")
        if want is not None and not slab.mirror:
            f16 = self._tile_f16_mode()
            pixel_bytes, tile_bytes = (6, 2) if f16 else (8, 4)
            if slab.nnz * pixel_bytes < 0.7 * (len(want) + 1) * B * B \
                    * tile_bytes:
                return build_tile_stack_coo(slab, B, want, f16_mode=f16)
        return build_tile_stack_slab(slab, B, **kw)

    # -- the stream (reference :782-980) ------------------------------------

    def _stream_tile_want(self, region1, region2, dev):
        """The tile predicate of the streams that are not cis BED (BEDPE
        rows, trans feature products): the windows follow from the binned
        intervals, widened by the control shifts' margin, before any
        coordinate frame exists. Returns raveled tile ids, or None where no
        predicate applies."""
        B = quad_gather.B_TILE
        margin = (int(self.maxshift) // self.resolution + 2
                  if (self.control or self.nshifts > 0) else 0)
        n1, n2 = int(dev["n1"]), int(dev["n2"])
        r1c = tuple(self.view_df.loc[region1])
        r2c = tuple(self.view_df.loc[region2]) if region2 != region1 else r1c
        if self.CC.kind == "bedpe":
            if self.trans and region2 != region1:
                rows = self.CC.filter_bedpe_trans_pairs(r1c, r2c)
            elif region2 == region1:
                rows = self.CC.filter_bedpe_region(r1c)
            else:
                return None
            want, _, _ = rect_tiles(
                rows["stBin1"].values - dev["min1"] - margin,
                rows["endBin1"].values - dev["min1"] + margin,
                rows["stBin2"].values - dev["min2"] - margin,
                rows["endBin2"].values - dev["min2"] + margin,
                B, (n1, n2),
            )
            return want
        if self.trans and region2 != region1:
            f1 = self.CC.filter_bed_region(r1c)
            f2 = self.CC.filter_bed_region(r2c)
            if len(f1) == 0 or len(f2) == 0:
                return np.array([], np.int64)

            def axis_tiles(f, mn, n):
                lo = np.clip(f["stBin"].values - mn - margin, 0, n - 1)
                hi = np.clip(f["endBin"].values - mn + margin, 1, n)
                return np.unique(np.concatenate(
                    [np.arange(a // B, (b - 1) // B + 1)
                     for a, b in zip(lo, hi)]))

            rt = axis_tiles(f1, dev["min1"], n1)
            ct = axis_tiles(f2, dev["min2"], n2)
            return (rt[:, None] * -(-n2 // B) + ct[None, :]).ravel()
        return None

    def _maybe_open_stream(self, region1, region2, dev, prefetch=False,
                           region=None):
        """The stream of a region pair where one applies (no rescale, no
        mesh, W within the quad kernel's reach): called in the region loop,
        or from the region prefetch, whose stricter tile cap keeps several
        prefetched stacks from filling the device (``region``: the loop's
        index, for the span log). None otherwise."""
        W = self._window_bins()
        if self.rescale or W > quad_gather.W_MAX or self.mesh is not None:
            return None
        max_tiles = _PREFETCH_TILES if prefetch else _STREAM_TILES
        if region2 == region1 and self.CC.kind == "bed" and not self.trans:
            return self._open_quad_stream(dev, W, max_tiles=max_tiles,
                                          region=region)
        want = self._stream_tile_want(region1, region2, dev)
        if want is None:
            return None
        return self._open_quad_stream(dev, W, want=want, max_tiles=max_tiles,
                                      region=region)

    def _open_quad_stream(self, dev, W, want=None, max_tiles=_STREAM_TILES,
                          region=None):
        """A ``_QuadStream`` whose stack holds every tile a window can
        touch, staged before any coordinate exists: the |row - col| band of
        ``maxdist`` plus W for cis BED (``want`` None), or the explicit tile
        set ``want``. None when the predicate passes ``max_tiles`` (an
        unbounded ``maxdist`` on a large region): the collected path takes
        those. The stream's ``covers(r1, r2)`` says whether every window
        starting there lies on staged tiles (a ``modify_2Dintervals_func``
        may move windows anywhere)."""
        B = quad_gather.B_TILE
        n1 = int(dev["n1"])
        if want is not None:
            est_tiles = len(want)
        else:
            band_bins = n1
            if np.isfinite(self.maxdist):
                band_bins = min(int(self.maxdist // self.resolution) + W + 8,
                                n1)
            est_tiles = -(-n1 // B) * (2 * (band_bins // B + 1) + 1)
        if est_tiles > max_tiles:
            return None
        half = min(_STREAM_HALF, _block_half(W))

        if want is not None:
            nc = -(-int(dev["n2"]) // B)
            flags = np.zeros(-(-n1 // B) * nc, bool)
            flags[np.asarray(want, np.int64)] = True

            def covers(r1, r2):
                t1, t2 = r1 // B, r2 // B
                e1, e2 = (r1 + W - 1) // B, (r2 + W - 1) // B
                return bool((flags[t1 * nc + t2] & flags[t1 * nc + e2]
                             & flags[e1 * nc + t2] & flags[e1 * nc + e2]).all())
        else:
            # band_tiles holds the tiles with |tile_row - tile_col| <= kband:
            # a window's corner tiles are (t1|e1, t2|e2), so the two extreme
            # diagonals decide
            kband = band_bins // B + 1

            def covers(r1, r2):
                t1, t2 = r1 // B, r2 // B
                e1, e2 = (r1 + W - 1) // B, (r2 + W - 1) // B
                worst = np.maximum(np.abs(e1 - t2), np.abs(t1 - e2))
                return bool((worst <= kband).all())

        wire_mode, wv1, wv2 = self._tile_wire_plan(dev)

        def build():
            kw = dict(want=want) if want is not None else dict(band=band_bins)
            with self._phase("tiles", region):
                tile_stack = self._build_quad_stack(
                    dev, raw_counts=wire_mode == "int8", **kw)
            with self._phase("stage", region):
                session = quad_gather.QuadPileupSession(
                    tile_stack, wv1, wv2, dev["evec"],
                    dict(W=W, capacity=2 * half, cis=dev["cis"],
                         ignore_diags=int(self.ignore_diags),
                         ooe=bool(self.expected and self.ooe),
                         tile_f16=wire_mode,
                         fold_weights=wire_mode == "int8"),
                    self.device,
                )
                self._count_wire(wire_mode, session.wire)
                ready = None
                if self.device.type == "cuda":
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(self.device))
            return session, ready

        stream = _QuadStream(_stage_pool().submit(build), half, _STREAM_CHUNK,
                             self.device, stripes=bool(self.store_stripes),
                             timers=self.timers,
                             stripe_f16=self._fetch_f16(), region=region)
        stream.covers = covers
        return stream

    def _quad_accumulate(self, tile_stack, dev, arr, W, G):
        """The counterpart of the reference's ``_pallas_accumulate``: one
        ``QuadPileupSession`` per region on ``self.device``, groups
        ``cid + half * flip`` so the flip bank rides rows [half, 2 * half).
        The accumulators live in device memory, so the reference's pinned
        capacities (sized for VMEM) do not apply: ``half = min(next_pow2(G),
        _block_half(W))``. Up to ``half`` groups, every snip goes into one
        ``quad_gather.quad_accumulate`` call; more groups (by-window) run in
        cid-sorted blocks of ``half`` groups with local ids ``cid - base +
        half * flip``, one call a block, into a [G, ...] host total. Where
        the reference runs in blocks (more than ``_bank_groups(W)``
        groups), each block is flip-merged on the device and fetched by
        ``_stack_merge_fetch`` (float16 where ``_fetch_f16``), one block in
        flight (``_merged_blocks``); otherwise it is fetched in float64 and
        merged on the host. The session takes the upload wire of
        ``_tile_wire_plan`` (int8 only on an upper-triangle stack).
        ``QuadPileupSession.run_many`` looks ``quad_accumulate`` up in its
        module at call time, so a caller can count its launches
        (``quad_gather.LAUNCHES``) or swap it. Returns flip-merged float64
        accumulators [G, ...] plus the side outputs (``_side_outputs``) and
        the ROI snips' stripe planes, gathered from the session's stack (the
        vertical one reversed, reference coolpup.py:1164–1188)."""
        half = min(_next_pow2(G), _block_half(W))
        wire_mode, wv1, wv2 = self._tile_wire_plan(dev)
        raw_wire = wire_mode == "int8" and isinstance(tile_stack,
                                                      SymTileStack)
        session = quad_gather.QuadPileupSession(
            tile_stack,
            wv1 if raw_wire else dev["valid1"],
            wv2 if raw_wire else dev["valid2"],
            dev["evec"],
            dict(
                W=W,
                capacity=2 * half,
                cis=dev["cis"],
                ignore_diags=int(self.ignore_diags),
                ooe=bool(self.expected and self.ooe),
                tile_f16=wire_mode if raw_wire or wire_mode != "int8"
                else False,
                fold_weights=raw_wire,
            ),
            self.device,
        )
        self._count_wire(wire_mode, session.wire)
        launches = quad_gather.LAUNCHES
        out = {}
        if G > _bank_groups(W):
            self._merged_blocks(session, arr, G, half, out)
        else:
            for sel, base, span in _group_blocks(arr["cidl"], G, half):
                ix = slice(None) if sel is None else sel
                cid = arr["cidl"][ix] - base + half * arr["flip"][ix]
                total = session.finalize(
                    [session.run_many(arr["r1"][ix], arr["r2"][ix],
                                      cid.astype(np.int32), fetch=False)],
                    compact=(span, half),
                )
                _put_block(out, merge_flip_banks(total, span), base, G)
        self._routes.add(
            "cuda_kernel" if quad_gather.LAUNCHES > launches else "plain"
        )
        self._side_outputs(dev, arr, W, G, out)
        if self.store_stripes:
            roi = arr["roi"]
            hv = session.run_stripes(arr["r1"][roi], arr["r2"][roi],
                                     f16=self._fetch_f16())
            out["horizontal_stripe"] = hv[:, :W]
            out["vertical_stripe"] = hv[:, W:][:, ::-1]
        return out

    def _merged_blocks(self, session, arr, G, half, out):
        """The blocked accumulation of ``_quad_accumulate`` with the
        reference's by-window fetch (K9, reference :1870-1915): each block's
        used rows (unflipped and flip bank) are flip-merged on the device by
        ``_stack_merge_fetch`` and their copies started at once; a block is
        materialized into ``out`` after the next block has launched, so one
        fetch is in flight. On the card the merge runs on the kernel's
        float32 sums and counts (exact: the block's float64 accumulators
        hold one launch's float32 values), cast to pow2-scaled float16 where
        ``_fetch_f16``; ``num`` takes the cast only where no group holds more
        than 2048 snips, so every count stays exact. ``poison`` is the +inf
        plane of the merged sums."""
        f16 = self._fetch_f16()
        keys = frozenset(("sum",))
        if int(np.bincount(arr["cidl"], minlength=G).max(initial=0)) <= 2048:
            keys = frozenset(("sum", "num"))
        pending = []

        def drain():
            base, span, handles = pending.pop(0)
            part = {k: v[0] for k, v in
                    _stack_merge_materialize(handles).items()}
            part["poison"] = np.isinf(part["sum"]).astype(np.float64)
            _put_block(out, part, base, G)

        for sel, base, span in _group_blocks(arr["cidl"], G, half):
            ix = slice(None) if sel is None else sel
            cid = arr["cidl"][ix] - base + half * arr["flip"][ix]
            acc = session.run_many(arr["r1"][ix], arr["r2"][ix],
                                   cid.astype(np.int32), fetch=False)
            acc = {k: torch.cat([v[:span], v[half : half + span]])
                   for k, v in acc.items()}
            if self._on_accelerator():
                acc = {k: v.to(torch.float32) for k, v in acc.items()}
            pending.append((base, span, _stack_merge_fetch(
                (acc,), span, f16=f16, lazy=True, f16_keys=keys)))
            while len(pending) > 1:
                drain()
        while pending:
            drain()

    def _stream_accumulate(self, stream, dev, arr, W, G, launches):
        """Phase 2 of a streamed region: the tail launched, the chunks'
        totals fetched once (``_QuadStream.finish``) and flip-merged, the
        side outputs from the collected arrays (``_side_outputs``), the
        streamed stripe planes (the vertical one reversed). The route is
        ``cuda_kernel`` where the quad kernel launched since ``launches``
        (``quad_gather.LAUNCHES``), ``plain`` otherwise."""
        out = merge_flip_banks(stream.finish(G), G)
        self._count("stream_chunks", stream.chunks)
        self._routes.add(
            "cuda_kernel" if quad_gather.LAUNCHES > launches else "plain"
        )
        self._side_outputs(dev, arr, W, G, out)
        if self.store_stripes:
            h, v = stream.stripe_planes()
            out["horizontal_stripe"] = h
            out["vertical_stripe"] = v[:, ::-1]
        return out

    def _device_stack(self, tile_stack, dev, f16_mode=False):
        """The region's normalized stack on ``self.device``
        (``ops/tiles.normalized_stack``, uploaded through the wire of
        ``f16_mode``: masked pixels NaN, OOE-divided values) and its tile
        map as an int64 device tensor."""
        wire = []
        stiles = normalized_stack(
            tile_stack, dev["valid1"], dev["valid2"], dev["evec"],
            self.device, f16_mode=f16_mode, wire=wire,
            ooe=bool(self.expected and self.ooe),
            cis=dev["cis"], ignore_diags=int(self.ignore_diags),
        )
        self._count_wire(f16_mode, wire)
        tmap = torch.from_numpy(
            np.asarray(tile_stack.tile_map, np.int64)
        ).to(self.device)
        return stiles, tmap

    def _torch_blocks(self, arr, G, half, step):
        """Run a torch step over the snip stream, one call per accumulator
        block (``_group_blocks``): ``step(ix, cid, C)`` gets the block's
        snip selection (a device index tensor, or ``slice(None)``), its
        local group ids ``cid - base + half * flip`` on the device and the
        capacity ``2 * half``, and returns device accumulators. Returns the
        flip-merged float64 totals [G, ...] and, where the step returns
        stripes, every snip's stripe rows in stream order."""
        out = {}
        ntot = len(arr["cidl"])
        for sel, base, span in _group_blocks(arr["cidl"], G, half):
            ix = slice(None) if sel is None else sel
            cid = arr["cidl"][ix] - base + half * arr["flip"][ix]
            acc = step(
                ix if sel is None else torch.from_numpy(sel).to(self.device),
                torch.from_numpy(cid.astype(np.int64)).to(self.device),
                2 * half,
            )
            for k in _STRIPE_KEYS:
                if k in acc:
                    v = acc.pop(k).cpu().numpy()
                    if k not in out:
                        out[k] = np.empty((ntot, v.shape[1]), np.float32)
                    out[k][ix] = v
            banks = {
                k: torch.cat([v[:span], v[half : half + span]])
                .to(torch.float64).cpu().numpy()
                for k, v in acc.items()
            }
            _put_block(out, merge_flip_banks(banks, span), base, G)
        return out

    def _generic_accumulate(self, tile_stack, dev, arr, W, G):
        """The generic route for windows wider than the quad kernel takes
        (the reference's ``_device_accumulate`` with
        ``make_pileup_step_fn``, :1536-1594): ``generic_accumulate`` over
        the region's normalized stack in blocks of ``_block_half(W)``
        groups; coverage and expected emission from the exact host sums
        (``_side_outputs``); stripes of the ROI snips, non-finite values as
        NaN. Under a mesh, each device runs it on its copy of the stack
        over its even shard of every block's snips
        (``parallel.mesh.sharded_generic_step``)."""
        stiles, tmap = self._device_stack(tile_stack, dev)
        r1, r2 = (torch.from_numpy(arr[k].astype(np.int64)).to(self.device)
                  for k in ("r1", "r2"))
        stripes = bool(self.store_stripes)

        if self.mesh is None:
            def step(ix, cid, C):
                return generic_accumulate(stiles, tmap, r1[ix], r2[ix], cid,
                                          W, C, stripes=stripes)
        else:
            from ..parallel.mesh import replicate, sharded_generic_step

            stacks = replicate(self.mesh, stiles)
            tmaps = replicate(self.mesh, tmap)
            self._mesh_region(stacks, 0)

            def step(ix, cid, C):
                return sharded_generic_step(self.mesh, stacks, tmaps, r1[ix],
                                            r2[ix], cid, W, C,
                                            stripes=stripes)

        half = min(_next_pow2(G), _block_half(W))
        out = self._torch_blocks(arr, G, half, step)
        self._routes.add(_generic_route(stiles))
        self._side_outputs(dev, arr, W, G, out)
        for k in _STRIPE_KEYS:
            if k in out:
                out[k] = out[k][arr["roi"]]
        return out

    def _rescale_accumulate(self, tile_stack, dev, arr, G):
        """The rescale route (the reference's ``_rescale_accumulate``,
        :2228-2372): one normalized B=128 stack per region; snips in pow2
        extent buckets of at least ``_RESCALE_MIN_BUCKET`` bins, each bucket
        through ``rescale_accumulate`` at Hmax = its extent, in blocks of
        ``_block_half(R)`` groups. Windows are cut from the stack directly
        (no bucket restack); off a mesh, an upper-triangle stack uploads
        through ``_tile_f16_mode``'s wire, as the reference's restack base
        does (:2274-2284). Returns flip-merged float64 totals [G, R, R]
        (``poison`` all zero) and the ROI snips' stripes. Under a mesh each
        device runs a bucket's step on its copies of the stack and vectors
        over its even shard of the snips
        (``parallel.mesh.sharded_rescale_step``)."""
        R = self.rescale_size
        wire = self.mesh is None and isinstance(tile_stack, SymTileStack)
        stiles, tmap = self._device_stack(
            tile_stack, dev, f16_mode=self._tile_f16_mode() if wire else False)

        def upload(a, dtype=torch.int64):
            return torch.from_numpy(np.asarray(a)).to(self.device, dtype)

        evec = upload(dev["evec"], torch.float32)
        cov1 = upload(dev["cov1"], torch.float32)
        cov2 = upload(dev["cov2"], torch.float32)
        if self.mesh is not None:
            from ..parallel.mesh import replicate, sharded_rescale_step

            per_device = list(zip(*(replicate(self.mesh, t)
                                    for t in (stiles, tmap, evec, cov1,
                                              cov2))))
            self._mesh_region([p[0] for p in per_device], 0)
        extent = np.maximum(arr["h1"], arr["w2"]).astype(np.int64)
        buckets = np.maximum(
            _RESCALE_MIN_BUCKET,
            1 << np.ceil(np.log2(np.maximum(extent, 1))).astype(np.int64),
        )
        half = min(_next_pow2(G), _block_half(R))
        out = {}
        ntot = len(extent)
        for hb in np.unique(buckets):
            idx = np.flatnonzero(buckets == hb)
            sub = {k: arr[k][idx] for k in ("cidl", "flip")}
            d = {k: upload(arr[k][idx]) for k in ("r1", "r2", "h1", "w2", "dd0")}
            cfg = RescaleConfig(
                R=R, Hmax=int(hb), capacity=2 * half,
                emit_expected=bool(self.expected and not self.ooe),
                coverage=bool(self.coverage_norm),
                stripes=bool(self.store_stripes), local=bool(self.local),
            )

            def step(ix, cid, C, d=d, cfg=cfg):
                snips = (d["r1"][ix], d["r2"][ix], d["h1"][ix], d["w2"][ix],
                         d["dd0"][ix], cid)
                if self.mesh is not None:
                    return sharded_rescale_step(self.mesh, per_device,
                                                *snips, cfg)
                return rescale_accumulate(stiles, tmap, evec, cov1, cov2,
                                          *snips, cfg)

            part = self._torch_blocks(sub, G, half, step)
            for k, v in part.items():
                if k in _STRIPE_KEYS:
                    if k not in out:
                        out[k] = np.empty((ntot, R), np.float32)
                    out[k][idx] = v
                else:
                    out[k] = v if k not in out else out[k] + v
        out["poison"] = np.zeros_like(out["sum"])
        for k in _STRIPE_KEYS:
            if k in out:
                out[k] = out[k][arr["roi"]]
        self._routes.add("rescale_torch")
        return out

    # -- the mesh (reference :1496-1600, :1961-2135, :2374-2515) -------------

    def _new_mesh_stats(self):
        """What the mesh did over a run: snips and kernel launches per mesh
        device on the quad route, regions banded and replicated, the
        largest stack a device held (bytes, per device) and the bytes the
        halo copies moved."""
        n = len(self.mesh) if self.mesh is not None else 0
        return {"snips": [0] * n, "launches": [0] * n, "banded": 0,
                "replicated": 0, "stack_bytes": [0] * n, "halo_bytes": 0}

    def _mesh_region(self, stacks, halo_bytes, banded=False):
        """Record one mesh region in ``mesh_stats``."""
        st = self.mesh_stats
        st["banded" if banded else "replicated"] += 1
        st["stack_bytes"] = [
            max(b, t.numel() * t.element_size())
            for b, t in zip(st["stack_bytes"], stacks)
        ]
        st["halo_bytes"] += int(halo_bytes)

    def _mesh_accumulate(self, dev, arr, W, G):
        """Phase 2 of a region under a mesh, routed as the reference routes
        it: the quad route (``_quad_mesh_accumulate``) for W <= 120 unless
        the coverage histogram would pass ``_COV_HIST_MAX`` entries;
        otherwise the generic step on a dense stack of the reference's tile
        size ``max(64, next_pow2(W))``, row-banded over a mesh of more than
        one device (``_rowshard_accumulate``), else replicated
        (``_generic_accumulate``)."""
        if W <= quad_gather.W_MAX and self._quad_mesh_supported(G, dev):
            with self._phase("tiles"):
                tile_stack = build_tile_stack_slab(
                    dev["slab"], quad_gather.B_TILE, r1=arr["r1"],
                    r2=arr["r2"], window1=W, window2=W)
            with self._phase("device"):
                return self._quad_mesh_accumulate(tile_stack, dev, arr, W, G)
        with self._phase("tiles"):
            tile_stack = build_tile_stack_slab(
                dev["slab"], max(64, _next_pow2(W)), r1=arr["r1"],
                r2=arr["r2"], window1=W, window2=W)
        with self._phase("device"):
            out = None
            if self.mesh.shape["loci"] > 1:
                out = self._rowshard_accumulate(tile_stack, dev, arr, W, G)
            if out is None:
                out = self._generic_accumulate(tile_stack, dev, arr, W, G)
        return out

    def _quad_mesh_supported(self, G, dev):
        """The reference's ``_pallas_mesh_supported``: group counts past one
        accumulator bank run in blocks per device; only the coverage host
        histogram bounds the route."""
        if self.coverage_norm:
            n_cov = max(len(dev["cov1"]), len(dev["cov2"]))
            if G * n_cov > _COV_HIST_MAX:
                return False
        return True

    def _mesh_split(self, tile_stack, r1, count_small):
        """The band partition of a region over the mesh's ``loci`` devices
        and the device-major snip order (``rowshard.build_row_partition``,
        ``route_snips``), or ``(None, None, None)`` where the region has
        fewer tile rows than devices or the busiest band holds more than 4x
        the mean snip load. A band counts in ``_rowshard_regions``, a skew
        in ``_rowshard_fallbacks``, and so does a region too small to band
        where ``count_small`` (the generic route's count; the quad route's
        leaves it out, as the reference's does, :1994-2010)."""
        from ..parallel.rowshard import build_row_partition, route_snips

        n = self.mesh.shape["loci"]
        part = build_row_partition(tile_stack, r1, n)
        if part is None:
            if not count_small:
                return None, None, None
            self._rowshard_fallbacks += 1
            logger.info("rowshard: region too small to band over %d devices, "
                        "replicating tiles (fallback %d so far)", n,
                        self._rowshard_fallbacks)
            return None, None, None
        order, counts = route_snips(part, r1)
        if counts.max() > 4 * max(1.0, float(counts.mean())):
            self._rowshard_fallbacks += 1
            logger.info("rowshard: snip load skew %.1fx across bands, falling "
                        "back to replicated tiles",
                        counts.max() / max(1.0, float(counts.mean())))
            return None, None, None
        self._rowshard_regions += 1
        return part, order, counts

    def _mesh_blocks(self, arr, dev_items, G, half):
        """The accumulator blocks of a mesh region: ``(base, span, items)``
        with ``items`` each device's snips of groups [base, base + span) in
        routed order; one block of all G groups where they fit ``half``
        (the reference's cid-blocked loop, :2073-2097)."""
        if G <= half:
            yield 0, G, dev_items
            return
        cidl = arr["cidl"]
        for base in range(0, G, half):
            span = min(half, G - base)
            selm = (cidl >= base) & (cidl < base + span)
            items = [it[selm[it]] for it in dev_items]
            if any(len(it) for it in items):
                yield base, span, items

    def _quad_mesh_accumulate(self, tile_stack, dev, arr, W, G):
        """The quad kernel per mesh device (the reference's
        ``_pallas_mesh_accumulate``, :1972-2135): the region's B=128 stack
        banded over the devices with the halo copy where it partitions
        (``_mesh_split``), else copied to every device with the snips split
        evenly; per accumulator block one ``QuadMeshSession.run_chunk``
        (one launch per device that holds snips, the accumulators summed on
        the first device) with local groups ``cid - base + half * flip``;
        coverage and expected emission from the exact host sums
        (``_side_outputs``); the ROI snips' stripe planes gathered per
        device and put back in stream order through their ROI positions."""
        from ..parallel.quad_mesh import QuadMeshSession

        n = self.mesh.shape["loci"]
        ntot = len(arr["r1"])
        part, order, counts = self._mesh_split(tile_stack, arr["r1"],
                                               count_small=False)
        if part is None:
            order = np.arange(ntot)
            counts = np.full(n, ntot // n, np.int64)
            counts[: ntot % n] += 1
        dev_items = np.split(order, np.cumsum(counts)[:-1])
        half = min(_next_pow2(G), _block_half(W))
        session = QuadMeshSession(
            self.mesh, tile_stack, part, dev["valid1"], dev["valid2"],
            dev["evec"],
            dict(W=W, capacity=2 * half, cis=dev["cis"],
                 ignore_diags=int(self.ignore_diags),
                 ooe=bool(self.expected and self.ooe)),
        )
        launches = quad_gather.LAUNCHES
        out = {}
        for base, span, items in self._mesh_blocks(arr, dev_items, G, half):
            total = session.run_chunk(
                [arr["r1"][it] for it in items],
                [arr["r2"][it] for it in items],
                [arr["cidl"][it] - base + half * arr["flip"][it]
                 for it in items],
            )
            total = quad_gather.QuadPileupSession.finalize(
                [total], compact=(span, half))
            _put_block(out, merge_flip_banks(total, span), base, G)
        self._routes.add(
            "cuda_kernel" if quad_gather.LAUNCHES > launches else "plain"
        )
        self._side_outputs(dev, arr, W, G, out)
        if self.store_stripes:
            roi = arr["roi"]
            pos = np.cumsum(roi) - 1
            items_roi = [it[roi[it]] for it in dev_items]
            hv = session.run_stripes([arr["r1"][it] for it in items_roi],
                                     [arr["r2"][it] for it in items_roi],
                                     f16=self._fetch_f16())
            n_roi = int(roi.sum())
            h = np.full((n_roi, W), np.nan, np.float32)
            v = np.full((n_roi, W), np.nan, np.float32)
            for rows, it in zip(hv, items_roi):
                h[pos[it]] = rows[:, :W]
                v[pos[it]] = rows[:, W:][:, ::-1]
            out["horizontal_stripe"] = h
            out["vertical_stripe"] = v
        st = self.mesh_stats
        for key in ("snips", "launches"):
            st[key] = [a + b for a, b in zip(st[key], getattr(session, key))]
        self._mesh_region([s.stiles for s in session.sessions],
                          session.halo_bytes, banded=part is not None)
        return out

    def _rowshard_accumulate(self, tile_stack, dev, arr, W, G):
        """The generic step on row-banded stacks (the reference's
        ``_rowshard_accumulate``, :2374-2515): each device normalizes its
        band and receives the next band's first tile row
        (``quad_mesh.sharded_normalize_halo``), then runs
        ``generic_accumulate`` on its routed snips per accumulator block
        (``rowshard.row_sharded_step``). Returns None where the region does
        not band (``_mesh_split``): the caller replicates."""
        from ..parallel.quad_mesh import (
            halo_copy_bytes,
            sharded_normalize_halo,
        )
        from ..parallel.rowshard import row_sharded_step

        part, order, counts = self._mesh_split(tile_stack, arr["r1"],
                                               count_small=True)
        if part is None:
            return None
        stacks = sharded_normalize_halo(
            self.mesh, part, dev["valid1"], dev["valid2"], dev["evec"],
            ooe=bool(self.expected and self.ooe), cis=dev["cis"],
            ignore_diags=int(self.ignore_diags))
        tmaps = [torch.from_numpy(g.astype(np.int64)).to(d)
                 for g, d in zip(part.grids(), self.mesh.devices)]
        dev_items = np.split(order, np.cumsum(counts)[:-1])
        half = min(_next_pow2(G), _block_half(W))
        stripes = bool(self.store_stripes)
        ntot = len(arr["r1"])
        planes = {k: np.full((ntot, W), np.nan, np.float32)
                  for k in _STRIPE_KEYS} if stripes else {}
        out = {}
        for base, span, items in self._mesh_blocks(arr, dev_items, G, half):
            acc = row_sharded_step(
                self.mesh, stacks, tmaps,
                [arr["r1"][it] for it in items],
                [arr["r2"][it] for it in items],
                [arr["cidl"][it] - base + half * arr["flip"][it]
                 for it in items],
                W, 2 * half, stripes=stripes,
            )
            for k in planes:
                for rows, it in zip(acc.pop(k), items):
                    planes[k][it] = rows.cpu().numpy()
            banks = {
                k: torch.cat([v[:span], v[half: half + span]])
                .to(torch.float64).cpu().numpy()
                for k, v in acc.items()
            }
            _put_block(out, merge_flip_banks(banks, span), base, G)
        self._routes.add(_generic_route(stacks[0]))
        self._side_outputs(dev, arr, W, G, out)
        for k, v in planes.items():
            out[k] = v[arr["roi"]]
        self._mesh_region(stacks, halo_copy_bytes(part), banded=True)
        return out

    def _side_outputs(self, dev, arr, W, G, out):
        """The side sums beside the window accumulation (the reference's
        ``_pallas_side_outputs``): coverage from the exact (group,
        start-bin) histogram, or by device scatter-add where its [G, n]
        table would pass ``_COV_HIST_MAX`` entries; expected emission from
        the (group, dd0) histogram. The coverage sums are the phase
        ``coverage``, counted in ``coverage_hist_regions`` or
        ``coverage_scatter_regions`` by the path they took."""
        cidl = arr["cidl"]
        if self.coverage_norm:
            n_cov = max(len(dev["cov1"]), len(dev["cov2"]))
            hist = G * n_cov <= _COV_HIST_MAX
            cov_sums = (
                coverage_histogram_sums
                if hist
                else partial(coverage_scatter_sums, device=self.device)
            )
            with self._phase("coverage"):
                out["cov_start"], out["cov_end"] = cov_sums(
                    cidl, arr["r1"], arr["r2"], dev["cov1"], dev["cov2"],
                    W, G
                )
            self._count("coverage_hist_regions" if hist
                        else "coverage_scatter_regions")
        if self.expected and not self.ooe:
            out["exp_sum"], out["exp_num"] = expected_toeplitz_sums(
                cidl, arr["dd0"], dev["evec"], W, G
            )

    @staticmethod
    def _package_stripes(acc, arr, coord_blocks, G):
        """Per group, ONE block per region of its ROI snips' stripe planes
        and [n, 6] coordinate strings, in stream order (reference
        engine/pileup.py:1600-1638). Every coordinate column is cast to
        strings once per region."""
        hs = acc.pop("horizontal_stripe")
        vs = acc.pop("vertical_stripe")
        cid_roi = arr["cidl"][arr["roi"]]
        order = np.argsort(cid_roi, kind="stable")
        bounds = np.searchsorted(cid_roi[order], np.arange(G + 1))
        cols6 = []
        for ci in range(len(_COORD_COLS)):
            col = np.concatenate([blk[ci] for blk in coord_blocks])
            if col.dtype.kind in "iu":
                col = col.astype("U20").astype(object)
            elif col.dtype.kind != "O":
                col = col.astype(str).astype(object)
            cols6.append(col)
        coords = np.stack(cols6, axis=1)
        stripes = {}
        for c in range(G):
            sel = order[bounds[c] : bounds[c + 1]]
            if len(sel):
                stripes[c] = {
                    "h": [hs[sel]], "v": [vs[sel]], "coords": [coords[sel]],
                }
        return stripes

    # -- the per-snip extension surface (reference coolpup.py:1059-1283) ------

    def _hook_chunks(self, region1, region2, dev, groupby, control,
                     modify_2Dintervals_func, postprocess_frame_func):
        """The coordinate chunks of one region for the routes that read
        windows: each frame through ``postprocess_frame_func``, cut to the
        snips inside the region and re-indexed, with its flat window arrays
        and the chunk's normalized stack on ``self.device``. Yields
        ``(chunk, arr, stiles, tmap)``; ``arr`` holds int64 ``r1``, ``r2``,
        ``h1``, ``w2``."""
        region1_coords = tuple(self.view_df.loc[region1])
        region2_coords = tuple(self.view_df.loc[region2])
        W = self._window_bins()
        batches = iter(self.CC.batches(
            region1_coords,
            region2_coords if region2 != region1 else None,
            control=control,
            groupby=groupby,
            modify_2Dintervals_func=modify_2Dintervals_func,
        ))
        while True:
            with self._phase("coords"):
                chunk = next(batches, None)
                if chunk is None:
                    return
                if postprocess_frame_func is not None:
                    chunk = postprocess_frame_func(chunk)
                if len(chunk) == 0:
                    continue
                r1 = (chunk["stBin1"].values - dev["min1"]).astype(np.int64)
                r2 = (chunk["stBin2"].values - dev["min2"]).astype(np.int64)
                e1 = (chunk["endBin1"].values - dev["min1"]).astype(np.int64)
                e2 = (chunk["endBin2"].values - dev["min2"]).astype(np.int64)
                inb = ((r1 >= 0) & (e1 <= dev["n1"]) & (r2 >= 0)
                       & (e2 <= dev["n2"]))
                if not inb.any():
                    continue
                chunk = chunk.loc[inb].reset_index(drop=True)
                arr = dict(r1=r1[inb], r2=r2[inb], h1=(e1 - r1)[inb],
                           w2=(e2 - r2)[inb])
                if not self.rescale and not ((arr["h1"] == W).all()
                                             and (arr["w2"] == W).all()):
                    raise ValueError(
                        "inconsistent window size; flank must be a multiple "
                        "of the resolution"
                    )
            with self._phase("tiles"):
                if self.rescale:
                    tile_stack = self._build_tile_stack(dev, arr, arr["h1"],
                                                        arr["w2"])
                else:
                    tile_stack = self._build_tile_stack(dev, arr, W)
            with self._phase("device"):
                stiles, tmap = self._device_stack(tile_stack, dev)
            if self.timers:
                self.timers.count("snips", len(chunk))
            yield chunk, arr, stiles, tmap

    def _rescale_snip_host(self, snip):
        """Host per-snip rescale for the host stream (reference
        _rescale_snip, coolpup.py:1193-1234): local symmetrization,
        NaN-aware area resize (an output pixel any NaN touches is NaN),
        coverage vector resize."""
        R = self.rescale_size
        data = np.asarray(snip["data"], dtype=float)
        if data.size == 0 or np.all(np.isnan(data)):
            snip["data"] = np.zeros((R, R))
        else:
            if self.local:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", category=RuntimeWarning)
                    data = np.nanmean(np.dstack((data, data.T)), 2)
            nanplane = np.isnan(data).astype(float)
            resized = area_resize_host(np.nan_to_num(data), (R, R))
            nan_touch = area_resize_host(nanplane, (R, R))
            resized[np.ceil(nan_touch).astype(bool)] = np.nan
            snip["data"] = resized
        if self.coverage_norm:
            snip["cov_start"] = area_resize_host(snip["cov_start"], (R,))
            snip["cov_end"] = area_resize_host(snip["cov_end"], (R,))
        else:
            snip["cov_start"] = np.zeros(R)
            snip["cov_end"] = np.zeros(R)
        return snip

    def stream_snips(
        self,
        region1,
        region2=None,
        *,
        groupby=None,
        control=None,
        modify_2Dintervals_func=None,
        postprocess_frame_func=None,
        dev=None,
    ):
        """Yield per-snip dicts with gathered ``data``: the extension surface
        (reference _stream_snips, coolpup.py:1059-1191). Each dict carries
        every feature column plus data / cov vectors / stripes /
        coordinates. The windows are cut from the region's normalized stack
        on ``self.device`` (``ops/tiles.fetch_windows``: masked pixels NaN,
        OOE-divided values, +inf where the expected is 0) and fetched in
        capped blocks; a snip's ``data`` is float32 [W, W], or under rescale
        its own h x w window resized on the host. Snips are yielded UNFLIPPED
        with their 'flip' mark, like the reference stream; expected snips
        (kind='control') follow their ROI snip when expected is used without
        ooe. On ``device="cuda"`` without a card the ``PileUpper`` could not
        be built: nothing here runs on the CPU unless it was asked to."""
        groupby = groupby or []
        if control is None:
            control = self.control
        if region2 is None:
            region2 = region1
        if dev is None:
            dev = self._stage_region(region1, region2)

        emit_expected = bool(self.expected and not self.ooe)
        evec = np.asarray(dev["evec"], dtype=float)
        W = self._window_bins()

        for chunk, arr, stiles, tmap in self._hook_chunks(
            region1, region2, dev, groupby, control,
            modify_2Dintervals_func, postprocess_frame_func,
        ):
            r1, r2, h1, w2 = (arr[k] for k in ("r1", "r2", "h1", "w2"))
            if self.rescale:
                cut = dict(H=int(max(h1.max(), w2.max())), h1=h1, w2=w2)
            else:
                cut = dict(H=W)

            # record dicts from per-column numpy arrays: to_dict("records")
            # would box every cell through pandas
            colnames = list(chunk.columns)
            colarrs = [
                chunk[c].to_numpy()
                if isinstance(chunk[c].dtype, np.dtype)
                else np.asarray(chunk[c].array)
                for c in colnames
            ]
            blocks = fetch_windows(stiles, tmap, r1, r2, **cut)
            while True:
                with self._phase("device"):
                    got = next(blocks, None)
                if got is None:
                    break
                lo, hi, block = got
                for i in range(lo, hi):
                    snip = {c: a[i] for c, a in zip(colnames, colarrs)}
                    a, b, h, w = int(r1[i]), int(r2[i]), int(h1[i]), int(w2[i])
                    if self.rescale:
                        snip["data"] = block[i - lo, :h, :w].astype(float)
                    else:
                        snip["data"] = block[i - lo]

                    if self.coverage_norm:
                        snip["cov_start"] = dev["cov1"][a : a + h].astype(float)
                        snip["cov_end"] = dev["cov2"][b : b + w].astype(float)
                    else:
                        snip["cov_start"] = np.zeros(h)
                        snip["cov_end"] = np.zeros(w)

                    exp_snip = None
                    if emit_expected:
                        exp_snip = dict(snip)
                        exp_snip["kind"] = "control"
                        if len(evec) == 1:
                            exp_data = np.full((h, w), evec[0])
                        else:
                            dd = ((a - b) + np.arange(h)[:, None]
                                  - np.arange(w)[None, :])
                            exp_data = evec[
                                np.minimum(np.abs(dd), len(evec) - 1)
                            ]
                        exp_snip["data"] = exp_data
                        exp_snip["coordinates"] = []

                    if self.rescale:
                        snip = self._rescale_snip_host(snip)
                        if exp_snip is not None:
                            exp_snip = self._rescale_snip_host(exp_snip)

                    if self.store_stripes:
                        mid = snip["data"].shape[0] // 2
                        snip["horizontal_stripe"] = np.asarray(
                            snip["data"][mid, :], dtype=float
                        )
                        snip["vertical_stripe"] = np.asarray(
                            snip["data"][:, mid][::-1], dtype=float
                        )
                        snip["coordinates"] = ".".join(
                            str(snip[col]) for col in _COORD_COLS
                        )
                    else:
                        snip["horizontal_stripe"] = []
                        snip["vertical_stripe"] = []
                        snip["coordinates"] = []
                    if exp_snip is not None:
                        exp_snip["horizontal_stripe"] = []
                        exp_snip["vertical_stripe"] = []

                    yield snip
                    if exp_snip is not None:
                        yield exp_snip

    def _all_rows(self, outdict, extra_sum_funcs, control):
        """Add the 'all' pup of a hook route's group maps where no snip
        carried that group: ``reduce(sum_pups)`` with the extras."""
        shape = self.make_outmap().shape
        sum_func = partial(sum_pups, extra_funcs=extra_sum_funcs)
        for kind in ("ROI", "control") if control else ("ROI",):
            if "all" not in outdict[kind]:
                outdict[kind]["all"] = dict(
                    reduce(sum_func, outdict[kind].values(), empty_pup(shape))
                )

    def _pileup_region_batchhook(
        self,
        region1,
        region2,
        groupby,
        modify_2Dintervals_func,
        postprocess_frame_func,
        postprocess_batch_func,
        extra_sum_funcs,
        dev=None,
    ):
        """The vectorized extension route: per-snip DATA semantics without
        per-snip python. Each coordinate chunk's windows are cut on the
        device and fetched in capped blocks into one [N, W, W] float32
        array, flip applied; the user hook runs ONCE per chunk as
        ``postprocess_batch_func(frame, data) -> frame`` (add columns
        computed from ``data``), and whole group slices are folded in numpy
        on the host. ``data`` is a fresh array per chunk that the engine
        does not reuse: a hook may keep it across chunks, and its in-place
        edits of ``data`` are honoured by the fold.

        extra_sum_funcs must be accumulate_values-style over frame columns
        (typically columns the batch hook just added); stripes /
        expected-emission / rescale are not supported here: use the per-snip
        stream (postprocess_snip_func) for those."""
        if dev is None:
            dev = self._stage_region(region1, region2)
        W = self._window_bins()
        extra_frame_keys = (
            _accumulate_values_frame_keys(extra_sum_funcs)
            if extra_sum_funcs
            else None
        )
        if extra_sum_funcs and extra_frame_keys is None:
            raise ValueError(
                "postprocess_batch_func supports accumulate_values-style "
                "extra_sum_funcs over frame columns; use "
                "postprocess_snip_func for opaque per-snip accumulators"
            )
        outdict = {"ROI": {}, "control": {}}

        def _fold(key, kind, dsel, cssum, cesum, extras_rows):
            m = dsel.shape[0]
            if m == 1:
                dsum = dsel[0].astype(np.float64)  # keep NaNs (n=1 group)
                dnum = np.isfinite(dsel[0]).astype(np.int64)
            else:
                dsum = np.add.reduce(dsel, axis=0, dtype=np.float64,
                                     where=~np.isnan(dsel))
                dnum = np.isfinite(dsel).sum(axis=0)
            pup = outdict[kind].get(key)
            if pup is None:
                outdict[kind][key] = pup = {
                    "data": dsum,
                    "num": dnum,
                    "cov_start": cssum,
                    "cov_end": cesum,
                    "n": m,
                    "horizontal_stripe": [],
                    "vertical_stripe": [],
                    "coordinates": [],
                }
            else:
                pup["data"] = np.nansum([pup["data"], dsum], axis=0)
                pup["num"] = pup["num"] + dnum
                pup["cov_start"] = pup["cov_start"] + cssum
                pup["cov_end"] = pup["cov_end"] + cesum
                pup["n"] += m
            if extras_rows:
                for col, vals in extras_rows.items():
                    cur = pup.get(col)
                    if isinstance(cur, list):
                        cur.extend(vals)
                    else:
                        pup[col] = list(vals)

        def _cat_codes(col):
            if isinstance(col.dtype, pd.CategoricalDtype):
                return col.cat.codes.to_numpy().astype(np.int64)
            return pd.factorize(col, use_na_sentinel=False)[0].astype(
                np.int64
            )

        if self.coverage_norm:
            covw1 = np.lib.stride_tricks.sliding_window_view(dev["cov1"], W)
            covw2 = np.lib.stride_tricks.sliding_window_view(dev["cov2"], W)

        for chunk, arr, stiles, tmap in self._hook_chunks(
            region1, region2, dev, groupby, self.control,
            modify_2Dintervals_func, postprocess_frame_func,
        ):
            r1, r2 = arr["r1"], arr["r2"]
            flip = (chunk["flip"].values.astype(bool)
                    if "flip" in chunk.columns else None)
            with self._phase("device"):
                data = None
                for lo, hi, block in fetch_windows(stiles, tmap, r1, r2, W,
                                                   flip=flip):
                    if hi - lo == len(r1):
                        data = block
                        break
                    if data is None:
                        data = np.empty((len(r1), W, W), np.float32)
                    data[lo:hi] = block
            with self._phase("hook"):
                out = postprocess_batch_func(chunk, data)
            if out is not None:
                chunk = out
                if len(chunk) != data.shape[0]:
                    raise ValueError(
                        "postprocess_batch_func must keep the frame "
                        "aligned with the data stack (row-for-row)"
                    )
            with self._phase("fold"):
                kc = _cat_codes(chunk["kind"])
                gc_ = _cat_codes(chunk["group"])
                pair = kc * (int(gc_.max(initial=0)) + 1) + gc_
                order = np.argsort(pair, kind="stable")
                bounds = np.concatenate(
                    [[0], np.flatnonzero(np.diff(pair[order])) + 1,
                     [len(pair)]]
                )
                kinds = chunk["kind"]
                groups = chunk["group"]
                for bi in range(len(bounds) - 1):
                    sel = order[bounds[bi] : bounds[bi + 1]]
                    first = int(sel[0])
                    if self.coverage_norm:
                        cssum = np.nansum(covw1[r1[sel]], axis=0)
                        cesum = np.nansum(covw2[r2[sel]], axis=0)
                    else:
                        cssum = np.zeros(W)
                        cesum = np.zeros(W)
                    extras_rows = None
                    if extra_frame_keys:
                        extras_rows = {
                            col: chunk[col].values[sel].tolist()
                            for col in extra_frame_keys.values()
                        }
                    # one group: fold the stack as it is (the order of a
                    # sum does not matter), without the fancy gather
                    dsel = data if len(bounds) == 2 else data[sel]
                    _fold(_group_key(groups.iloc[first]),
                          str(kinds.iloc[first]), dsel, cssum, cesum,
                          extras_rows)

        self._routes.add("batch_hook")
        self._all_rows(outdict, extra_sum_funcs, self.control)
        if outdict["ROI"]["all"]["n"] > 0:
            logger.info(f"{region1, region2}: {outdict['ROI']['all']['n']}")
        return outdict

    def _pileup_region_hostpath(
        self,
        region1,
        region2,
        groupby,
        modify_2Dintervals_func,
        postprocess_frame_func,
        postprocess_snip_func,
        extra_sum_funcs,
        dev=None,
    ):
        """Per-snip host accumulation over ``stream_snips``: taken when user
        hooks must see snip data or run per-snip extra accumulators
        (reference accumulate_stream, coolpup.py:1236-1283).

        Hooked snips are buffered per (kind, group) and folded in batches
        (``_add_snip_batch``), in stream order within each group; extra
        funcs run per snip, in order, at the flush. What is buffered is a
        shallow copy of each yielded dict, so a hook that yields one dict
        several times, rebinding ``group``, ``data`` or an extras key in
        between, folds each state it yielded (the reference's buffer keeps
        the dict itself and folds its last state only). Opaque extra funcs
        may read the accumulator's per-snip intermediate state, so they keep
        the strictly interleaved per-snip fold."""
        outdict = {"ROI": {}, "control": {}}
        stream = self.stream_snips(
            region1,
            region2,
            groupby=groupby,
            modify_2Dintervals_func=modify_2Dintervals_func,
            postprocess_frame_func=postprocess_frame_func,
            dev=dev,
        )
        batchable = extra_sum_funcs is None or (
            _accumulate_values_frame_keys(extra_sum_funcs) is not None
        )
        buf = {}
        buffered = 0

        def _flush():
            nonlocal buffered
            for (kind, key), snips in buf.items():
                _add_snip_batch(
                    outdict[kind], key, snips, extra_funcs=extra_sum_funcs
                )
            buf.clear()
            buffered = 0

        # the stream's own phases (coords, tiles, device) pause this one:
        # the rest of this loop is the per-snip host work
        with self._phase("snips_host"):
            for snip in stream:
                if snip.get("flip"):
                    # rot90(flipud(x)) == anti-transpose (reference
                    # coolpup.py:131)
                    snip["data"] = np.flip(snip["data"], axis=(0, 1)).T
                out = (
                    postprocess_snip_func(snip)
                    if postprocess_snip_func is not None
                    else snip
                )
                for s in collapse_snips(out):
                    key = (
                        s["group"]
                        if isinstance(s["group"], str)
                        else tuple(s["group"])
                    )
                    if not batchable:
                        _add_snip(
                            outdict[s["kind"]], key, s,
                            extra_funcs=extra_sum_funcs,
                        )
                        continue
                    buf.setdefault((s["kind"], key), []).append(dict(s))
                    buffered += 1
                if buffered >= _FOLD_FLUSH:
                    _flush()
            _flush()

        self._routes.add("host_stream")
        self._all_rows(outdict, extra_sum_funcs,
                       self.control or (self.expected and not self.ooe))
        if outdict["ROI"]["all"]["n"] > 0:
            logger.info(f"{region1, region2}: {outdict['ROI']['all']['n']}")
        return outdict

    # -- the region loop and the output table --------------------------------

    def _region_pairs(self):
        """The work decomposition: cis pairs each view region with itself,
        trans pairs the view regions of distinct chromosomes (reference
        coolpup.py:1416–1429)."""
        if not self.trans:
            return [(r, r) for r in self.view_df.index]
        chrom_of = self.view_df["chrom"]
        return [
            (r1, r2)
            for r1, r2 in itertools.combinations(self.view_df.index, 2)
            if chrom_of[r1] != chrom_of[r2]
        ]

    def _resolve_flipby(self, groupby):
        """Which paired column base decides snip flipping. Returns a base
        name ('strand', or a groupby base for ignore_group_order) or None
        when no flip machinery applies (reference coolpup.py:1431–1476)."""
        igo = self.ignore_group_order

        def _reject_unflippable():
            if self.local:
                raise ValueError(
                    "ignore_group_order doesn't make sense for local pileups"
                )
            if self.CC.kind == "bedpe":
                raise ValueError(
                    "ignore_group_order doesn't make sense for bedpe files"
                )

        if self.flip_negative_strand:
            if igo:
                _reject_unflippable()
                if groupby:
                    warnings.warn(
                        "flip_negative_strand and ignore_group_order leads to "
                        "combining strands, not other groups"
                    )
            return "strand"
        if not igo:
            return None
        if not groupby:
            warnings.warn("Need to specify groupby for ignore_group_order")
            return None
        _reject_unflippable()
        paired = {
            c[:-1] for c in groupby if c.endswith("1") and c[:-1] + "2" in groupby
        }
        if igo is True:
            candidates = sorted(paired)
        elif isinstance(igo, str):
            candidates = [igo]
        elif len(igo) == 1:
            candidates = list(igo)
        else:
            candidates = sorted({c[:-1] for c in igo})
        if len(candidates) == 1 and candidates[0] in paired:
            return candidates[0]
        raise ValueError(
            "Ambiguous ignore_group_order, please provide str or list "
            "of two strings which are in groupby"
        )

    def _compose_modify_func(self, flipby, user_func):
        """Chain flip marking (+ paired-column swap under ignore_group_order)
        in front of the user's modify_2Dintervals_func."""
        if flipby is None:
            return user_func

        def modify(frame):
            frame = flip_mark_intervals(frame, flipby, self.flip_negative_strand)
            if self.ignore_group_order:
                frame = swap_paired_columns_for_flipped(
                    frame, exclude_bases=_GATHER_BASES
                )
            return frame if user_func is None else user_func(frame)

        return modify

    @staticmethod
    def _combine_region_maps(maps, sum_func=sum_pups):
        """Fold per-region {group: pup} maps into one with the sum_pups
        monoid (``sum_func``: with the run's extra funcs), in
        first-appearance group order."""
        combined = {}
        for m in maps:
            for group, pup in m.items():
                if group in combined:
                    combined[group] = dict(sum_func(combined[group], pup))
                else:
                    combined[group] = dict(pup)
        return combined

    @staticmethod
    def _poison_to_inf(pup):
        """Re-materialize +inf at pixels whose OOE division hit expected == 0
        (the reference accumulates the inf directly, coolpup.py:1154–1156;
        sum_pups' nan_to_num makes it finite on the way)."""
        pois = pup.get("poison")
        if pois is not None:
            hot = np.asarray(pois) > 0
            if hot.any():
                data = np.array(pup["data"], dtype=float, copy=True)
                data[hot] = np.inf
                pup["data"] = data
        return pup

    def _finalize_table(self, roi, ctrl, groupby, extra_keys=()):
        """Normalize combined accumulators into the output DataFrame:
        per-pixel mean, control/expected division, inf cleanup, local
        symmetrization, stripes, the ``extra_keys`` columns of the extra sum
        funcs (and ``control_<key>`` with controls), groupby columns
        (reference coolpup.py:1533–1625)."""
        have_control = ctrl is not None
        if self.coverage_norm:
            for pup in roi.values():
                norm_coverage(pup)
            if self.control:
                for pup in ctrl.values():
                    norm_coverage(pup)
            elif self.expected:
                warnings.warn(
                    "Expected can not be normalized to coverage", stacklevel=2
                )
        # stripes divide by the centre row / column of the control 'all'
        ctrl_h = ctrl_v = None
        if self.store_stripes and have_control:
            c_all = ctrl["all"]
            with np.errstate(divide="ignore", invalid="ignore"):
                c_norm = c_all["data"] / c_all["num"]
            mid = c_norm.shape[0] // 2
            ctrl_h = np.asarray(c_norm[mid, :], dtype=float)
            ctrl_v = np.asarray(c_norm[:, mid][::-1], dtype=float)
        rows = []
        for group, pup in roi.items():
            row = {}
            with np.errstate(divide="ignore", invalid="ignore"):
                data = pup["data"] / pup["num"]
                if have_control:
                    cpup = ctrl.get(group)
                    if cpup is not None:
                        data = data / (cpup["data"] / cpup["num"])
                        row["control_n"] = cpup["n"]
                        row["control_num"] = cpup["num"]
                    else:
                        data = np.full_like(np.asarray(data, float), np.nan)
                        row["control_n"] = np.nan
                        row["control_num"] = np.nan
            data = np.where(np.isposinf(data), np.nan, data)
            if self.local:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", category=RuntimeWarning)
                    data = np.nanmean(np.dstack((data, data.T)), 2)
            row["data"] = data
            row["n"] = pup["n"]
            row["num"] = pup["num"]
            if self.store_stripes:
                # [n, 6] component blocks from the accumulate routes,
                # joined "chrom1.start1..." strings from the host stream
                parts = []
                for c in pup["coordinates"]:
                    a = np.asarray(c, dtype=object)
                    if a.ndim == 2:
                        parts.append(a)
                    else:
                        parts.append(
                            np.array(str(c).split("."), dtype=object)[None]
                        )
                row["coordinates"] = np.vstack(parts)
                with np.errstate(divide="ignore", invalid="ignore"):
                    for name, cstripe in (
                        ("horizontal_stripe", ctrl_h),
                        ("vertical_stripe", ctrl_v),
                    ):
                        stripes = np.vstack(pup[name])
                        if cstripe is not None:
                            stripes = stripes / cstripe
                        if self.local:
                            stripes = _copy_array_halves(stripes)
                        row[name] = stripes
            for key in extra_keys:
                row[key] = pup.get(key)
                if self.control:
                    row[f"control_{key}"] = (ctrl.get(group) or {}).get(key)
            row["group"] = group
            rows.append(row)

        table = pd.DataFrame(rows)
        table.insert(0, "group", table.pop("group"))
        if groupby:
            labels = [
                ("all",) * len(groupby) if g == "all" else tuple(g)
                for g in table["group"]
            ]
            for pos, col in enumerate(groupby):
                table.insert(0, col, [lab[pos] for lab in labels])
        return table

    def _annotation(self):
        """Run-parameter provenance columns (reference coolpup.py:1628–1654),
        plus the port's own: the backend, the device, the accumulate routes
        the regions took (``cuda_kernel`` or ``plain`` for the quad kernel,
        ``generic_cuda`` or ``generic_torch`` for the wide one,
        ``rescale_torch``, and ``batch_hook`` or
        ``host_stream`` for the hook routes that fold on the host) and the
        reference keywords the port accepts and ignores."""
        fname = self.clr.filename
        device_name = str(self.device)
        if self.device.type == "cuda":
            device_name += f" ({torch.cuda.get_device_name(self.device)})"
        if self.mesh is not None:
            device_name += f", loci mesh of {self.mesh.shape['loci']}"
        annot = {
            "clr": os.path.abspath(fname) if fname else None,
            "resolution": self.resolution,
            "clr_weight_name": self.clr_weight_name,
            "expected": bool(self.expected),
            "expected_value_col": self.expected_value_col,
            "ooe": self.ooe,
            "control": self.control,
            "pad_bins": self.pad_bins,
            "coverage_norm": self.coverage_norm,
            "rescale": self.rescale,
            "rescale_size": self.rescale_size,
            "flip_negative_strand": self.flip_negative_strand,
            "ignore_diags": self.ignore_diags,
            "store_stripes": self.store_stripes,
            "nproc": self.nproc,
            "flank": self.flank,
            "rescale_flank": self.rescale_flank,
            "chroms": str(self.chroms),
            "minshift": self.minshift,
            "maxshift": self.maxshift,
            "nshifts": self.nshifts,
            "trans": self.trans,
            "mindist": self.mindist,
            "maxdist": self.maxdist,
            "local": self.local,
            "subset": self.subset,
            "seed": self.seed,
            "ignore_group_order": self.ignore_group_order,
            "backend": "torch",
            "device": device_name,
            "accumulate": ",".join(sorted(self._routes)) or "none",
            "ignored": f"chunk_size={self.chunk_size}, "
                       f"tile_size={self.tile_size}",
        }
        return {
            k: (str(v) if isinstance(v, list) else v) for k, v in annot.items()
        }

    def pileupsWithControl(
        self,
        nproc=None,
        groupby=None,
        ignore_group_order=False,
        modify_2Dintervals_func=None,
        postprocess_frame_func=None,
        postprocess_snip_func=None,
        postprocess_batch_func=None,
        extra_sum_funcs=None,
        dual_anchor=False,
    ):
        """Run the full pileup over every region (pair) and normalize
        (reference coolpup.py:1360–1654 counterpart). Regions are
        accumulated one after another on the main thread, each
        checkpointed to ``checkpoint_dir`` when set, while up to
        ``min(4, nproc)`` threads (4 for ``nproc`` <= 0; ``nproc`` None
        takes the PileUpper's) stage the next regions: the slab and per-bin
        vectors, and where the region will stream, its stream, whose
        session the staging worker builds meanwhile (reference
        :3542-3593). A region with a checkpoint is not staged.
        ``dual_anchor`` groups every snip under both of its anchors
        (``pileupsByWindowWithControl``).

        Extension hooks (reference coolpup.py:1261–1283,
        lib/puputils.py:39–41), all of which receive pandas frames, numpy
        arrays and dicts, never tensors: ``modify_2Dintervals_func`` and
        ``postprocess_frame_func`` transform vectorized snip frames before
        their groups are assigned and stay on the accumulate routes;
        ``postprocess_snip_func`` sees each snip dict WITH its gathered data
        (may return one snip, a list, or a generator) and
        ``extra_sum_funcs`` accumulates extra per-snip values into output
        columns: either routes the regions through the per-snip host stream
        (``stream_snips``), unless every extra is
        ``partial(accumulate_values, key=<frame column>)``, which stays on
        the accumulate route.

        ``postprocess_batch_func(frame, data) -> frame`` is the VECTORIZED
        per-snip-data hook: it runs once per coordinate chunk with the full
        [N, W, W] float32 window stack (flip applied) aligned row-for-row
        with the frame (see ``_pileup_region_batchhook``). Not combinable
        with postprocess_snip_func; for stripes / rescale /
        expected-emission use postprocess_snip_func instead.

        NOTE: combining ``groupby`` with ``extra_sum_funcs`` inherits the
        reference's sum_pups quirk (reference lib/puputils.py:110–112:
        extra funcs REPLACE the merged pup), so the 'all' row carries only
        the extras; read the per-group rows. Replicated for parity."""
        groupby = groupby or []
        self.ignore_group_order = ignore_group_order
        if nproc is None:
            nproc = self.nproc
        flipby = self._resolve_flipby(groupby)
        modify_final = self._compose_modify_func(flipby, modify_2Dintervals_func)

        # coordinate frames materialize only the columns the device path
        # reads when every frame transform is known to the engine
        column_hint = None
        user_modify_known = modify_2Dintervals_func is None or (
            isinstance(modify_2Dintervals_func, partial)
            and modify_2Dintervals_func.func is bin_distance_intervals
        )
        if (
            user_modify_known
            and postprocess_frame_func is None
            and postprocess_snip_func is None
            and postprocess_batch_func is None
        ):
            column_hint = set(groupby)
            if flipby:
                column_hint |= {flipby + "1", flipby + "2"}

        timers = self._given_timers
        if timers is None:
            timers = PhaseTimers(spans=bool(self.trace_dir))
        self.timers = timers
        self._routes = set()
        self.mesh_stats = self._new_mesh_stats()

        def _ckpt_path(r1, r2):
            safe = re.sub(r"[^A-Za-z0-9_.-]", "_", f"{r1}__{r2}")
            return os.path.join(self.checkpoint_dir, safe + ".pkl")

        def _run_one(r1, r2, dev):
            # per-region accumulator checkpoints: the resume unit; each keeps
            # the accumulate routes its region took for the annotation
            if self.checkpoint_dir:
                path = _ckpt_path(r1, r2)
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        out, routes = pickle.load(f)
                    self._routes |= routes
                    return out
            outer, self._routes = self._routes, set()
            out = self.pileup_region(
                r1,
                r2,
                groupby=groupby,
                modify_2Dintervals_func=modify_final,
                postprocess_frame_func=postprocess_frame_func,
                postprocess_snip_func=postprocess_snip_func,
                postprocess_batch_func=postprocess_batch_func,
                extra_sum_funcs=extra_sum_funcs,
                dev=dev,
                column_hint=column_hint,
                dual_anchor=dual_anchor,
            )
            routes, self._routes = self._routes, outer | self._routes
            if self.checkpoint_dir:
                os.makedirs(self.checkpoint_dir, exist_ok=True)
                tmp = _ckpt_path(r1, r2) + ".tmp"
                with open(tmp, "wb") as f:
                    pickle.dump((out, routes), f)
                os.replace(tmp, _ckpt_path(r1, r2))
            return out

        # a stream is pre-opened exactly where pileup_region would open one
        # (the per-snip hooks take the host routes instead)
        can_prestream = (
            postprocess_snip_func is None
            and postprocess_batch_func is None
            and extra_sum_funcs is None
            and not dual_anchor
            and not self.rescale
        )

        def _stage_with_stream(i, r1, r2):
            if self.checkpoint_dir and os.path.exists(_ckpt_path(r1, r2)):
                return None  # resumed from its checkpoint: nothing to stage
            dev = self._stage_region(r1, r2, region=i)
            if can_prestream:
                stream = self._maybe_open_stream(r1, r2, dev, prefetch=True,
                                                 region=i)
                if stream is not None:
                    dev = dict(dev, _stream=stream)
            return dev

        pairs = self._region_pairs()
        # the processes of a multi-process run under a mesh each take their
        # round-robin share of region pairs, and exchange the per-region
        # outputs after the loop (reference :3566-3602)
        multiprocess = False
        if self.mesh is not None:
            from ..parallel import distributed

            multiprocess = distributed.world_size() > 1
            if multiprocess:
                pairs = distributed.local_region_pairs(pairs)
        n_prefetch = max(1, min(_PREFETCH_MAX, nproc if nproc > 0 else
                                _PREFETCH_MAX))
        pileups = []
        with device_trace(self.trace_dir, timers), ThreadPoolExecutor(
            max_workers=n_prefetch, thread_name_prefix="region-stage"
        ) as pool:
            futures = {i: pool.submit(_stage_with_stream, i, *pair)
                       for i, pair in enumerate(pairs[:n_prefetch])}
            for i, (r1, r2) in enumerate(pairs):
                fut = futures.pop(i)
                if not fut.done():
                    with timers.phase("wait", region=i):
                        fut.result()
                dev = fut.result()
                if i + n_prefetch < len(pairs):
                    j = i + n_prefetch
                    futures[j] = pool.submit(_stage_with_stream, j,
                                             *pairs[j])
                with timers.phase("region", region=i):
                    pileups.append(_run_one(r1, r2, dev))
        if multiprocess:
            with timers.phase("exchange"):
                timers.count("exchange_bytes", len(pickle.dumps(pileups)))
                pileups = distributed.allreduce_region_maps(pileups)

        with timers.phase("finalize"):
            sum_func = partial(sum_pups, extra_funcs=extra_sum_funcs)
            roi = self._combine_region_maps(
                (p["ROI"] for p in pileups), sum_func
            )
            ctrl = None
            if self.control or (self.expected and not self.ooe):
                ctrl = self._combine_region_maps(
                    (p["control"] for p in pileups), sum_func
                )
            for pup in roi.values():
                self._poison_to_inf(pup)
            if ctrl is not None:
                for pup in ctrl.values():
                    self._poison_to_inf(pup)
            table = self._finalize_table(
                roi, ctrl, groupby, extra_keys=tuple(extra_sum_funcs or ())
            )
            for name, value in self._annotation().items():
                table[name] = [value] * len(table)
        timers.log_summary()
        logger.info(
            f"Total number of piled up windows: {int(roi['all']['n'])}"
        )
        return table

    # -- grouped wrappers (reference coolpup.py:1656–1919) ------------------

    def pileupsByStrandWithControl(
        self, nproc=None, groupby=None, ignore_group_order=False
    ):
        """Group by strand pair; adds the 'orientation' label column
        (reference coolpup.py:1656–1694)."""
        pups = self.pileupsWithControl(
            nproc=nproc,
            groupby=["strand1", "strand2"] + list(groupby or []),
            ignore_group_order=ignore_group_order,
        )
        pups.insert(0, "orientation", _orientation_labels(pups))
        return pups

    def pileupsByWindowWithControl(self, nproc=None):
        """One pup per anchor window: every snip contributes to the groups
        of both its anchors (reference coolpup.py:1696–1756). For BED
        features outside rescale, groups ride the integer anchor id of
        ``CoordCreator`` and map back to window labels once per group.
        BEDPE rows have no shared anchor id, and rescaled windows do not fit
        the dual-anchor path: both group through the frame-doubling
        ``group_by_region_frame`` hook, with (chrom, start, end) tuples as
        groups."""
        if self.local:
            raise ValueError("Cannot do by-window pileups for local")
        if self.CC.kind == "bed" and not self.rescale:
            pups = self.pileupsWithControl(nproc=nproc, dual_anchor=True)
            iv = self.CC.intervals
            codes = iv["anchor_idx"].to_numpy()
            _, first = np.unique(codes, return_index=True)
            ch = iv["chrom"].to_numpy()
            st = iv["start"].to_numpy()
            en = iv["end"].to_numpy()
            lab = {int(codes[i]): (ch[i], int(st[i]), int(en[i]))
                   for i in first}
            anchors = [
                ("all", -1, -1) if g == "all" else lab[int(g)]
                for g in pups["group"]
            ]
        else:
            pups = self.pileupsWithControl(
                nproc=nproc, postprocess_frame_func=group_by_region_frame
            )
            anchors = [
                ("all", -1, -1) if g == "all" else tuple(g)
                for g in pups["group"]
            ]
        pups = pups.drop(columns="group")
        pups.insert(0, "end", np.array([a[2] for a in anchors], dtype=int))
        pups.insert(0, "start", np.array([a[1] for a in anchors], dtype=int))
        pups.insert(0, "chrom", [a[0] for a in anchors])
        return sort_bedframe(pups, view_df=self.view_df.reset_index())

    def _resolve_distance_edges(self, distance_edges):
        """Validate user edges; separations below the engine's minimum
        snappable distance collapse onto mindist (reference
        coolpup.py:1770–1785)."""
        if isinstance(distance_edges, str) and distance_edges == "default":
            return "default"
        if not all(isinstance(n, (int, np.integer)) for n in distance_edges):
            raise ValueError("Distance edges must be integers")
        edges = np.sort(np.asarray(distance_edges))
        return list(np.maximum(edges, self.mindist))

    def _pileups_binned_by_distance(
        self, nproc, distance_edges, groupby, ignore_group_order, sort_cols
    ):
        """Annotate bands at the frame level, group on them, drop
        out-of-band rows, label separations, order rows with 'all' last."""
        edges = self._resolve_distance_edges(distance_edges)
        pups = self.pileupsWithControl(
            nproc=nproc,
            modify_2Dintervals_func=partial(
                bin_distance_intervals, band_edges=edges
            ),
            groupby=groupby,
            ignore_group_order=ignore_group_order,
        )
        if "orientation" in sort_cols:
            pups.insert(0, "orientation", _orientation_labels(pups))
        pups = pups[pups["distance_band"] != ()].reset_index(drop=True)
        pups.insert(
            0,
            "separation",
            [_separation_label(band) for band in pups["distance_band"]],
        )
        is_all = (pups["separation"] == "all").values
        body = pups.loc[~is_all].sort_values(sort_cols)
        return pd.concat([body, pups.loc[is_all]], ignore_index=True)

    def pileupsByDistanceWithControl(
        self,
        nproc=None,
        distance_edges="default",
        groupby=None,
        ignore_group_order=False,
    ):
        """Group by distance band (reference coolpup.py:1757–1833)."""
        if self.local:
            raise ValueError("Cannot do by-distance pileups for local")
        return self._pileups_binned_by_distance(
            nproc,
            distance_edges,
            ["distance_band"] + list(groupby or []),
            ignore_group_order,
            sort_cols=["distance_band"],
        )

    def pileupsByStrandByDistanceWithControl(
        self,
        nproc=None,
        distance_edges="default",
        groupby=None,
        ignore_group_order=False,
    ):
        """Group by strand pair × distance band (reference
        coolpup.py:1835–1919)."""
        return self._pileups_binned_by_distance(
            nproc,
            distance_edges,
            ["strand1", "strand2", "distance_band"] + list(groupby or []),
            ignore_group_order,
            sort_cols=["orientation", "distance_band"],
        )


def pileup(
    clr,
    features,
    features_format="bed",
    view_df=None,
    expected_df=None,
    expected_value_col="balanced.avg",
    clr_weight_name="weight",
    flank=100000,
    minshift=10**5,
    maxshift=10**6,
    nshifts=0,
    ooe=True,
    mindist="auto",
    maxdist=None,
    min_diag=2,
    subset=0,
    by_window=False,
    by_strand=False,
    by_distance=False,
    groupby=None,
    ignore_group_order=False,
    flip_negative_strand=False,
    local=False,
    coverage_norm=False,
    trans=False,
    rescale=False,
    rescale_flank=1,
    rescale_size=99,
    store_stripes=False,
    stripe_f16=True,
    tile_f16=True,
    nproc=1,
    seed=None,
    device="cuda",
    mesh=None,
    timers=None,
):
    """One-shot pileup API (reference coolpup.py:1922–2279): the JAX
    package's parameters minus ``backend``, plus ``device`` (``"cuda"``:
    the hand-written kernel on the card, raising without one; ``"cpu"``:
    the plain PyTorch version). ``mesh``: None, ``"auto"`` or a
    ``parallel.LociMesh`` of ``device``'s type (``PileUpper``). ``clr`` is
    a ``coolpuppy_tpu_torch.Cooler``. ``tile_f16`` and ``stripe_f16`` are
    the reference's transfer wires, taken on ``cuda`` as the JAX package
    takes them on an accelerator: ``tile_f16`` uploads the raw tiles as
    pow2-scaled float16 (``"lossy"`` on balanced maps, ``"exact"`` on raw
    counts), ``stripe_f16`` fetches stripe planes and by-window
    accumulators as float16 on balanced or OOE-divided values
    (``PileUpper``); ``False`` turns a wire off. On ``cpu`` every transfer
    is float32 whatever the flags. ``timers``: a ``PhaseTimers`` that
    records the call, kept by the caller: its root phase ``job``,
    ``prepare`` (the ``CoordCreator`` and ``PileUpper`` built) and the
    engine's phases, and with ``PhaseTimers(spans=True)`` their spans and
    the detail spans (``observability``)."""
    job = timers.job() if timers is not None else contextlib.nullcontext()
    with job:
        with (timers.phase("prepare") if timers is not None
              else contextlib.nullcontext()):
            groupby = groupby or []
            distance_edges = "default"
            if by_distance is not False:
                if local:
                    raise ValueError(
                        "Can't do local pileups by distance, please specify "
                        "only one of those arguments"
                    )
                if isinstance(by_distance, (list, np.ndarray)):
                    try:
                        distance_edges = [int(i) for i in by_distance]
                    except (TypeError, ValueError) as e:
                        raise ValueError(
                            "Distance bin edges have to be an iterable of "
                            "integers"
                        ) from e
                    by_distance = True
                elif by_distance is True or by_distance == "default":
                    by_distance = True
                else:
                    raise ValueError(
                        "Invalid by_distance value: True, 'default' or a "
                        "list of integers"
                    )

            if not rescale:
                rescale_flank = None

            if view_df is None:
                view_df = make_cooler_view(clr)
            else:
                is_compatible_viewframe(
                    view_df, clr, check_sorting=True, raise_errors=True
                )

            control = nshifts > 0
            if expected_df is None:
                expected = None
                expected_value_col = None
            else:
                expected = True
                is_valid_expected(
                    expected_df,
                    "trans" if trans else "cis",
                    view_df,
                    verify_cooler=clr,
                    expected_value_cols=[expected_value_col],
                    raise_errors=True,
                )
            if mindist is None:
                mindist = "auto"
            if maxdist is None:
                maxdist = np.inf
            if rescale and rescale_size % 2 == 0:
                raise ValueError("Please provide an odd rescale_size")
            if by_window:
                if features_format != "bed":
                    raise ValueError(
                        "Can't make by-window pileups without making "
                        "combinations"
                    )
                if local:
                    raise ValueError("Can't make local by-window pileups")

            CC = CoordCreator(
                features=features,
                resolution=clr.binsize,
                features_format=features_format,
                flank=flank,
                rescale_flank=rescale_flank,
                chroms=list(view_df["chrom"].unique()),
                minshift=minshift,
                maxshift=maxshift,
                nshifts=nshifts,
                mindist=mindist,
                maxdist=maxdist,
                local=local,
                subset=subset,
                seed=seed,
                trans=trans,
                timers=timers,
            )
            PU = PileUpper(
                clr=clr,
                CC=CC,
                view_df=view_df,
                clr_weight_name=clr_weight_name,
                expected=expected_df if expected else False,
                expected_value_col=expected_value_col,
                ooe=ooe,
                control=control,
                coverage_norm=coverage_norm,
                rescale=rescale,
                rescale_size=rescale_size,
                flip_negative_strand=flip_negative_strand,
                ignore_diags=min_diag,
                store_stripes=store_stripes,
                stripe_f16=stripe_f16,
                tile_f16=tile_f16,
                nproc=nproc,
                device=device,
                mesh=mesh,
                timers=timers,
            )

        if by_window:
            if groupby:
                warnings.warn(
                    "by-window not compatible with additional groupby")
            pups = PU.pileupsByWindowWithControl(nproc=nproc)
        elif by_strand and by_distance:
            pups = PU.pileupsByStrandByDistanceWithControl(
                nproc=nproc,
                distance_edges=distance_edges,
                groupby=groupby,
                ignore_group_order=ignore_group_order,
            )
        elif by_strand:
            pups = PU.pileupsByStrandWithControl(
                nproc=nproc, groupby=groupby,
                ignore_group_order=ignore_group_order,
            )
        elif by_distance:
            pups = PU.pileupsByDistanceWithControl(
                nproc=nproc,
                distance_edges=distance_edges,
                groupby=groupby,
                ignore_group_order=ignore_group_order,
            )
        else:
            pups = PU.pileupsWithControl(
                nproc=nproc, groupby=groupby,
                ignore_group_order=ignore_group_order,
            )
        pups["by_window"] = bool(by_window)
        pups["by_strand"] = bool(by_strand) and not by_window
        pups["by_distance"] = bool(by_distance) and not by_window
        pups["groupby"] = [groupby] * len(pups)
        pups["expected"] = pups["expected"].fillna(False)
        pups["cooler"] = (
            os.path.splitext(os.path.basename(clr.filename))[0]
            if clr.filename else None
        )
    return pups
