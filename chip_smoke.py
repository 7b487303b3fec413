"""Drive the PyTorch/CUDA port's loop-APA path, its ``pileup()`` engine in
all its modes, its ``coolpup-torch`` command line tool, its genome-wide
many-region path, its ``.cool`` reader's fetch path and its transfer wires
once on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 4,8,10]

Run from the root of a checkout on a machine with a CUDA device, ``nvcc``
and PyTorch built for CUDA. It needs no network and no JAX. With no
argument every phase runs; ``--phases`` runs the probe, the build and the
phases named (the record of the kernel then holds what those phases
measured). Phases, each printing its lines and, as it ends, its seconds:

1. probe: torch/CUDA and pandas versions, the card's name and power limit
   (``nvidia-smi``), the ``nvcc`` release, and which of triton, pandas,
   h5py, matplotlib, scipy, yaml and jax are importable (jax is only looked
   up, never imported);
2. build: compiles ``coolpuppy_tpu_torch/csrc/*.cu`` for sm_90a and loads
   it, with ptxas' register and spill report, and the staged kernel's
   bands, shared memory, threads and resident blocks per SM at W = 21, 33,
   65, 110, 111 and 120;
3. kernel vs plain: both CUDA quad kernels (the staged one, routed at every
   W, in one band of window rows up to W = 110 and two from 111 to 120, and
   the direct one, kept as a comparator) against the plain PyTorch version
   on small inputs: W = 11, 21, 65, 115 and 120 on synthetic stacks (a
   900-snip quad, group ids above 512, zero ``evec`` entries that poison
   sums with +inf, an empty stream), the largest one-band W and the first
   banded W, a quad of more than 50 groups in runs of 1-3 snips, quads of
   exactly ``ITEM_MAX`` and ``ITEM_MAX + 1`` snips, an item longer than the
   kernel's chunk, and quads with missing tiles (slot 0) at W = 21, 33,
   111 and 120: ``num`` exact, poison planes equal, finite ``sum`` within
   rtol 1e-5 / atol 1e-5; the routed ``quad_accumulate`` must launch the
   staged kernel;
4. the slice at the headline size (``bench.make_workload``: a 20,000-bin
   chromosome, 12M contacts, 1M loci, W = 21, observed-over-expected, 4
   groups, 25% flips): COO -> ``build_tile_stack_sym`` ->
   ``QuadPileupSession(device="cuda")`` -> ``run_many`` -> ``finalize`` ->
   ``merge_flip_banks``. It checks that the staged kernel ran on that path,
   holds the path's own accumulators and one more launch of each kernel
   against the plain version on the card (``num`` exact, poison
   equal, ``sum`` rtol 1e-4: float32 atomics add ~250k snips per (group,
   pixel) in an order that changes from run to run) and a 20,000-snip subset
   against the host oracle (numpy normalize + window cuts + nansum: ``num``
   exact, ``sum`` rtol 1e-5), then times the two kernels in turns (direct,
   staged, staged, direct; the kernel's device time between CUDA events
   around its launch, the launcher call between CUDA events), the staged kernel's alternatives
   (pixels a thread, ``ITEM_MAX``; one round each), the plain version and
   the whole path (with its phases), prints the kernel's bound (bytes over
   3.35 TB/s against float adds over 67 TFLOP/s) and its share of it, the
   device's busy share of one end-to-end run from ``torch.profiler``, and a
   sweep over W = 11, 33, 65, 110 (one band), 111, 115 and 120 (two bands)
   at 100,000 loci of the same map, both kernels held against the plain
   version and timed in turns beside the bound;
5. the engine: ``coolpuppy_tpu_torch.pileup`` on an in-memory ``Cooler``.
   (a) Every mode of the port (``ENGINE_MODES``) on a toy two-chromosome
   map with ``device="cuda"`` and with ``device="cpu"`` (the plain
   version): group keys, ``n``, ``control_n``, ``num`` and ``control_num``
   exact, ``data`` within rtol 1e-5 / atol 1e-7 with NaN positions equal.
   (b) ``bench.py``'s ``--engine`` cell (``engine_workload``: a 200 Mb
   chromosome at 10 kb, 12M zipf contacts, 3% NaN-weight bins, 20,000
   stranded sites; ``pileup(flank=100_000, maxdist=2_000_000, nshifts=1,
   seed=0, by_strand=True)``, W = 21): a 1,000-site warm-up, then a checked
   run that must launch the staged kernel and record ``cuda_kernel``, the
   same run with ``quad_accumulate`` swapped for the plain version (0
   launches; ``n``, ``control_n`` and ``num`` exact, ``data`` rtol 1e-4),
   three timed runs (engine snips/s = ROI ``n`` + ``control_n`` of the
   ``all`` row over the wall, median, with the engine's phase breakdown),
   the busy share of one run and the kernel's time there beside its bound.
6. the 2D modes. (a) The trans, BEDPE, by-window and stripes modes
   (``MODES_2D``) on the toy map, card against CPU as in 5a, with
   by-window rows keyed on chrom/start/end, stripe planes within rtol 1e-5
   with NaN positions equal and stripe coordinates exact; one by-window run
   with the accumulator block cap lowered so that 4 groups make a block,
   and one with the coverage sums forced onto the device scatter-add.
   (b) ``bench.py --modes``' cells ``stripes``, ``by_window``, ``bedpe``
   (2M sorted pairs) and ``trans`` (1,500 x 1,500 sites on a second,
   two-chromosome map), generated with bench's RNG calls: per cell a
   warm-up on bench's small subset, a checked run (the kernel launched,
   route ``cuda_kernel``), the same run with ``quad_accumulate`` swapped for
   the plain version (0 launches; counts exact, ``data`` rtol 1e-4), two
   timed runs (snips/s = the ``all`` row's ``n`` over the wall, median,
   with the phase breakdown), the busy share and kernel share of one
   run and the kernel's time beside its bound. The stripes cell also holds
   20,000 of the card's stripe rows against ``quad_gather.stripes_host`` on
   the fetched stack.
7. rescale (torch ops) and wide windows (the wide kernel,
   ``csrc/wide_accumulate.cu``).
   (a) The rescale modes (``RESCALE_MODES``: local, with controls, with
   stripes, OOE, expected emission, coverage_norm, BEDPE, trans) and the
   W = 123 modes (``WIDE_MODES``: OOE, controls by strand, stripes,
   by-window, trans, expected emission, coverage_norm) on the toy map, card
   against CPU as in 6a, with routes ``rescale_torch`` and ``generic_cuda``
   on the card (the wide kernel launched) against ``generic_torch`` on the
   CPU. (b) ``bench.py --rescale`` (``rescale_workload``: the engine map,
   2,000 TADs 20-200 bins wide; ``pileup(local=True, rescale=True,
   rescale_flank=1, rescale_size=99)``), without and with the map's
   ``expected_cis`` table: a warm-up, a checked run (TF32 off), the first
   200 TADs against ``rescale_host_oracle`` (count and mean rtol 1e-4), two
   timed runs with the phase breakdown, the rescale step's device time
   (CUDA events) and the busy share of one run. (c) 201-bin windows
   (+-1 Mb at 10 kb) over 2,000 stranded sites of the engine map with one
   shifted control: a checked run that must launch the wide kernel (route
   ``generic_cuda``), each of its step calls held against the plain
   version on the same inputs (counts exact, ``sum`` rtol 1e-4), the
   plain-swapped run (counts exact, ``data`` rtol 1e-4), 300 sites card
   against CPU (the same), two timed runs with the phases, the step's
   device span, the busy share of a profiled run, and the kernel's device
   time over the checked run's launches beside its bound and the plain
   version's. (d) 119-bin windows (+-590 kb at 10 kb: loop or CTCF-site
   pileups with +-0.6 Mb flanks, or the default 100 kb flank on 2 kb
   Micro-C maps) over the engine cell's 20,000 stranded sites with
   ``maxdist=3_000_000``, the automatic ``mindist`` (1.2 Mb) and one
   shifted control, where the staged kernel runs two bands an item: a
   warm-up, a checked run that must launch the staged kernel only (route
   ``cuda_kernel``), the same run with the direct kernel in its place
   (``direct_swapped``: counts exact, ``data`` rtol 1e-4), the
   plain-swapped run (the same), 300 sites card against CPU, two timed
   runs with the phases, a profiled run (busy share), and each kernel's
   device time over its run's launches (CUDA events around each launch)
   beside the bound and the plain version's. (e) The wide kernel against
   ``generic_accumulate_plain`` at W = 121, 129, 130, 201, 257, 258 and 401
   (``wide_kernel_cases``: missing tiles, +inf poison, NaN-masked pixels,
   several groups in one tile, a run cut at ``ITEM_MAX``, stripes): one
   launch each, ``num`` and ``poison`` exact, ``sum`` rtol 1e-5, stripe
   planes equal; each timed beside its bound and the plain version.
8. the extension hooks. (a) Every route of the hooks and every by-window
   case that groups through the frame hook (``HOOK_MODES``: the frame func,
   frame-column extras by strand and with controls, the batch hook, snip
   hooks for the domain score and one snip per anchor, an opaque extra
   func, extras under expected emission, the host stream with stripes and
   with rescale, by-window of BEDPE rows, by-window under rescale for BED
   and BEDPE) on the toy map, card against CPU as in 5a, the extras columns
   equal (frame columns) or within rtol 1e-5 (computed), in the same order,
   with the route each side took. (b) ``bench.py``'s ``bench_extension`` at
   its own size on the engine map: frame-column extras at 20,000 sites (a
   checked run that must launch the staged kernel, the plain-swapped run,
   two timed runs, busy share, the kernel's time beside its bound), the
   batch hook and the snip hook at 6,000 sites (checked runs, the batch
   route on 1,000 sites card against CPU, two and one timed runs), and the
   three routes on the same sites: ``n`` equal, ``data`` within rtol 1e-4,
   the snip route's ``center`` list equal to the batch route's within rtol
   1e-5. (c) By-window of BEDPE rows: every pair within 2 Mb of 5,000 sites
   of that map as rows, through ``pileupsByWindowWithControl`` (the staged
   kernel must launch), held window by window against the BED dual-anchor
   run over the same pairs (counts exact, ``data`` rtol 1e-4), two timed
   runs, busy share and the kernel's time beside its bound.
9. the ``coolpup-torch`` CLI, all of it but the two h5py calls (reading the
   ``.cool`` file, writing the ``.clpy`` file): the parsed arguments go
   through ``cli.coolpup_cli.pileup_from_args`` with the map in memory.
   (a) Every flag set of ``CLI_FLAG_SETS`` on the toy map, its features,
   BEDPE rows, TADs, view and expected table written as files (BED with
   and without a header line, BED from standard input, BEDPE, an expected
   column by name, strand, distance with and without edges, groupby over
   BED columns, flipped strands, by-window, trans, stripes, local rescale,
   coverage, emitted expected, unbalanced) with ``--device cuda`` and
   ``--device cpu``: compared as in 5a, the same output name, the route the
   card took (``cuda_kernel``, ``rescale_torch`` for the rescaled set);
   ``CLI_REFUSED``'s set (an expected column by index) must be refused on
   both alike. Then a ``.txt`` round trip of one ``all`` row: the array
   bit for bit, the header equal. (b) ``bench.py --engine``'s cell through
   the CLI's flags (``CLI_ENGINE_ARGS``): the engine map's 20,000 sites and
   its view written as BED files, a 1,000-site warm-up, then without and
   with an expected file (the map's ``expected_cis``, written as TSV) a
   checked run that must launch the staged kernel (profiled: the busy
   share), the plain-swapped run and ``pileup()`` called with the keywords
   the CLI resolved (counts exact, ``data`` rtol 1e-4), two timed runs (CLI
   snips/s over the wall from entering ``pileup_from_args`` to its return,
   the engine's phase breakdown, the seconds of each file read) and the
   kernel's time beside its bound.

10. the genome cell (``bench.py:866`` ``bench_genome``): 20 chromosomes of
   13,500 bins at 10 kb, 7.5M zipf contacts each, 3% NaN-weight bins,
   37,000 stranded sites, ``pileup(flank=100_000, maxdist=2_000_000,
   nshifts=10, seed=0, by_strand=True)``, built in memory with bench's RNG
   calls (``genome_workload``): the many-region path, whose regions are
   staged by the prefetch threads and accumulated by streams. First the
   native host ingest against its numpy branches at full size, with the
   seconds of both (``check_native``: ``tile_scatter_wtri`` on a genome
   chromosome's band tiles and on the engine map's slab, the two-pass
   quad sort on the engine cell's words from a collected run,
   ``enumerate_pairs`` on a chromosome's sites), and the torch and native
   thread counts with the OpenMP runtimes loaded. Then a warm-up on one
   chromosome's sites, a checked and profiled run that must stream every
   region (``stream_regions`` 20, ``stream_aborts`` 0) and launch the staged
   kernel once a chunk (``stream_chunks``), the plain-swapped run and the
   collected-path run (counts exact, ``data`` rtol 1e-4), two timed runs
   with their phases, the phases' sum and the counts, the busy share, and
   the kernel's bound for the whole run and for the stream's largest
   chunk.

11. the mesh (``coolpuppy_tpu_torch.parallel``), on ``LociMesh``es that
   repeat the one card. (a) Every mode of ``MESH_MODES`` (cis by strand
   with controls banded and replicated, OOE expected, coverage, trans,
   rescale, W = 123 banded and on whole chromosomes, stripes banded and
   replicated, by-window with a block of 8 groups, BEDPE) on meshes of 2
   and 4, held against the card's single-device run and the
   ``LociMesh(["cpu"] * n)`` run as in 5a, the ``_rowshard_*`` counters
   equal to the CPU's, a quad launch on every device that holds snips, the
   wide kernel launched in the W = 123 modes (the row-sharded step, and
   the loci-sharded one where a region replicates), and the current CUDA
   device unchanged. (b) The genome
   cell (phase 10's map and table) on meshes of 1, 2 and 4: each held
   against phase 10's table (counts exact, ``data`` rtol 1e-4), with its
   wall, phases, launches per device, regions banded and replicated, the
   largest stack per device and the halo bytes; one more run profiled (the
   busy share, the kernel's bound). (c) ``QuadMeshSession.run_chunk`` at
   ``bench.py:673`` bench_scaling's size (262,144 loci, W = 21) on meshes
   of 1, 2 and 4 against ``QuadPileupSession`` (``num`` exact, ``sum``
   rtol 1e-5), with snips/s and the retention against the mesh of one.
   (d) This script started twice as ranks of a gloo group on the card
   (``--rank``), each on a 4-chromosome genome map of its own from seed 0
   (hashes equal across ranks), each taking 2 region pairs; rank 0's table
   against this process's one-process run (keys and counts exact, ``data``
   rtol 1e-5).

12. the reader's fetch path and the public surface, on the engine map.
   (a) The engine cell of 5b through a ``Cooler`` whose store counts its
   reads (``CountingStore`` over the map's arrays: the fetch code a
   ``.cool`` file takes, ``Cooler(uri)``): a checked run that must launch
   the staged kernel, every fetch held to exactly the ``bin1_offset`` rows
   of its spans, the pixels read per fetch and in all, the threads that
   fetched, and the table against 5b's checked run (keys and counts exact,
   ``data`` rtol 1e-4). (b) The seeded fuzz cases of
   ``tests/test_torch_fuzz.py`` (``fuzz_case``, seeds 1000-1007) scaled to
   the engine map (``FUZZ_ENGINE``: 2,000-6,000 sites, flanks of 50-200 kb,
   BED, by-window, BEDPE and local rescaled kinds, groupby, ``min_diag``):
   per case a checked run through the counting reader (the staged kernel
   launched where the route is the quad kernel, every fetch its spans), the
   plain-swapped run (counts exact, NaN positions equal, ``data`` and
   stripes rtol 1e-4) and the first 300 features card against CPU (rtol
   1e-5), one line a case with its flags, snips, wall and route. (c)
   By-strand by-distance APA of the engine cell's 20,000 sites through the
   notebook alias ``coolpuppy_tpu_torch.coolpup.pileup``: a warm-up, a
   checked run that must launch the staged kernel, the plain-swapped run,
   two timed runs with the phases, the busy share of a profiled run and the
   kernel's time over its launches beside its bound.

13. the transfer wires (the float16/int8 tile upload, the float16 stripe
   fetch and the flip-merged accumulator fetch, on by default on the card).
   (a) ``WIRE_TOY``'s cases, the card against the CPU forced onto the same
   wire (``_tile_f16_mode`` replaced on the instance): ``"lossy"`` on the
   balanced toy map, ``"exact"`` unbalanced, int8 (``tile_int8`` on the
   reference's small-count map) and the COO wire (trans); a spy on
   ``_tile_wire_plan`` must see the case's mode on both sides; counts
   exact, ``data`` rtol 1e-5. (b) ``WIRE_CELLS`` on the engine map, wire on
   against ``F32_WIRE``: the engine cell (``"lossy"``), unbalanced
   (``"exact"``), int8 (the map's counts clipped to 127), by_window (the
   float16 accumulator fetch) and stripes (float16 planes); counts exact,
   ``data`` within rtol 2e-3 / atol 1e-5 on the lossy wires and 1e-4 on the
   others, stripe planes within 2^-11 or 6e-8. (c) The runs in turns (on,
   off, off, on; the stripes cell on, off), the first two under the
   profiler: walls, phases, the copies by direction and the largest one,
   and the device ms of the wire's passes (expand + normalize from the
   payload, the flip-merged fetch with and without the cast).

Since phase 13 the card takes the wires by default, so a card run held
against the CPU or a host oracle passes ``F32_WIRE`` (``wires_off`` for the
CLI), and both sides of a card-vs-card comparison of a blocked by-window
run pass ``F32_FETCH``.

Phases 5-13 share the engine map (``bench_cooler`` builds it once a run).
Any failure raises and exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the per-kernel JSON
record, and the one before that the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

KERNEL = {
    "name": "quad_accumulate",
    "route": "cuda",
    "source": "coolpuppy_tpu_torch/csrc/quad_accumulate.cu",
    "replaces": "coolpuppy_tpu/ops/pallas_gather.py:80",
}
WIDE_KERNEL = {
    "name": "wide_accumulate",
    "route": "cuda",
    "source": "coolpuppy_tpu_torch/csrc/wide_accumulate.cu",
    "replaces": "coolpuppy_tpu/ops/gather.py:111",
}
# the wide kernel's launch entry (quad_kernel_events times it)
WIDE_ENTRIES = ("wide_accumulate_launch",)
B = 128
SMALL_TOL = dict(rtol=1e-5, atol=1e-5)
HEADLINE_RTOL = 1e-4
REPEATS = 5
PLAIN_REPEATS = 3
KERNEL_ROUNDS = 3  # rounds of (direct, staged, staged, direct)
# rounds of the pixels-a-thread and ITEM_MAX sweeps, whose constants are
# settled: one reading each shows they still hold
SWEEP_ROUNDS = 1
# published peaks of one H100 SXM: device memory bytes/s, float32 FLOP/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
SWEEP_LOCI = 100_000
# the largest one-band W (110), then two bands an item (111 to 120)
SWEEP_W = (11, 33, 65, 110, 111, 115, 120)
SWEEP_FULL_W = 11  # also swept over every locus of the headline
ITEM_MAX_SWEEP = (512, 1024, 2048, 4096, 8192)

# phase 5: the modes of the port's pileup() on the toy map (TOY_KW plus
# these); "expected_df": True stands for the toy expected table
TOY_KW = dict(features_format="bed", mindist=0, flank=2_000_000)
ENGINE_MODES = {
    "balanced": {},
    "ooe": {"expected_df": True},
    "expected_emission": {"expected_df": True, "ooe": False},
    "controls": {"nshifts": 2, "seed": 7},
    "by_strand": {"by_strand": True, "nshifts": 1, "seed": 0},
    "by_distance": {"by_distance": True, "nshifts": 1, "seed": 0},
    "by_strand_by_distance_edges": {
        "by_strand": True, "nshifts": 1, "seed": 0,
        "by_distance": [0] + [50_000 * 2**k for k in range(30)],
    },
    "groupby": {"groupby": ["name1", "strand2"]},
    "ignore_group_order": {"by_strand": True, "ignore_group_order": True},
    "flip_negative_strand": {"by_strand": True, "flip_negative_strand": True},
    "local": {"local": True},
    "coverage_norm": {"clr_weight_name": None, "coverage_norm": True},
}
ENGINE_MODES_TOL = dict(rtol=1e-5, atol=1e-7)
# the transfer wires off: a card run held against the CPU (which takes no
# wire) or against a host oracle passes these, since the card takes the
# float16 tile upload and fetches by default; phase 13 holds the wires
F32_WIRE = dict(tile_f16=False, stripe_f16=False)
# the float16 fetches off: both sides of a card-vs-card comparison of a
# blocked by-window run, whose float32 sums differ by the atomics' order
# before the flip-merged accumulator fetch rounds them to float16
F32_FETCH = dict(stripe_f16=False)
# bench.py --engine (bench_engine): pileup() arguments and warm-up size
ENGINE_KW = dict(features_format="bed", flank=100_000, maxdist=2_000_000,
                 nshifts=1, seed=0, by_strand=True)
ENGINE_WARMUP_SITES = 1_000
ENGINE_RTOL = 1e-4
ENGINE_REPEATS = 3

# phase 6a: the 2D modes on the toy map (TOY_KW plus these); "features":
# "bedpe" stands for toy_bedpe(), "expected_df": "trans" for the toy trans
# expected table. MODE_PATCHES sets engine module constants for one mode:
# a block cap of 4 groups at the toy's W = 5, and the coverage histogram
# bound at 0 so coverage goes through the device scatter-add
MODES_2D = {
    "stripes_controls": {"store_stripes": True, "nshifts": 2, "seed": 1},
    "stripes_local": {"store_stripes": True, "local": True},
    "trans": {"trans": True},
    "trans_controls": {"trans": True, "nshifts": 2, "seed": 5},
    "trans_ooe": {"trans": True, "expected_df": "trans"},
    "bedpe": {"features": "bedpe"},
    "bedpe_controls_stripes": {"features": "bedpe", "nshifts": 2, "seed": 6,
                               "store_stripes": True},
    "bedpe_by_distance": {"features": "bedpe", "by_distance": True},
    "by_window": {"by_window": True},
    "by_window_controls": {"by_window": True, "nshifts": 1, "seed": 4},
    "by_window_coverage": {"by_window": True, "clr_weight_name": None,
                           "coverage_norm": True},
    "by_window_coverage_scatter": {"by_window": True, "clr_weight_name": None,
                                   "coverage_norm": True},
    "by_window_stripes": {"by_window": True, "store_stripes": True},
    "by_window_blocked": {"by_window": True, "nshifts": 1, "seed": 4},
}
MODE_PATCHES = {
    "by_window_blocked": {"_BLOCK_BYTES": 2 * 4 * 5 * 5 * 8},
    "by_window_coverage_scatter": {"_COV_HIST_MAX": 0},
}
STRIPE_RTOL = 1e-5
# bench.py --modes (bench_modes, bench.py:419-534): pileup() keywords of
# each cell; the trans cell runs on the two-chromosome map
MODES_KW = dict(features_format="bed", flank=100_000, maxdist=2_000_000,
                seed=0)
MODES_CELLS = {
    "stripes": dict(MODES_KW, store_stripes=True),
    "by_window": dict(MODES_KW, by_window=True),
    "bedpe": dict(features_format="bedpe", flank=100_000, mindist=0, seed=0),
    "trans": dict(features_format="bed", flank=100_000, trans=True, seed=0),
}
MODES_REPEATS = 2
STRIPE_SAMPLE = 20_000

# phase 7a: rescaled pileups of toy TADs (toy_features() 3 Mb wide) in the
# toy view (RESCALE_KW plus these), and 123-bin windows (flank 61 Mb, the
# generic path) over whole chromosomes (WIDE_KW plus these); "expected_df":
# True stands for the toy expected table of that view, "features": "bedpe"
# for toy_bedpe() with 2 Mb anchors
RESCALE_KW = dict(features_format="bed", mindist=0, rescale=True,
                  rescale_flank=1, rescale_size=33)
RESCALE_MODES = {
    "local": {"local": True},
    "local_controls": {"local": True, "nshifts": 1, "seed": 7},
    "local_stripes": {"local": True, "store_stripes": True},
    "ooe": {"local": True, "expected_df": True},
    "expected_emission": {"expected_df": True, "ooe": False},
    "coverage_norm": {"clr_weight_name": None, "coverage_norm": True},
    "bedpe": {"features": "bedpe"},
    "trans": {"trans": True},
}
WIDE_KW = dict(features_format="bed", mindist=0, flank=61_000_000)
WIDE_MODES = {
    "ooe": {"expected_df": True},
    "controls_by_strand": {"by_strand": True, "nshifts": 1, "seed": 0},
    "stripes": {"store_stripes": True},
    "by_window": {"by_window": True},
    "trans": {"trans": True},
    "expected_emission": {"expected_df": True, "ooe": False},
    "coverage_norm": {"clr_weight_name": None, "coverage_norm": True},
}
# phase 7b: bench.py --rescale (bench_rescale, bench.py:342-416)
RESCALE_CELL_KW = dict(features_format="bed", local=True, rescale=True,
                       rescale_flank=1, rescale_size=99, mindist=0, seed=0)
RESCALE_ORACLE_TADS = 200
ORACLE_RTOL = 1e-4
# phase 7c: 201-bin windows (+-1 Mb at 10 kb) on the engine map
WIDE_CELL_KW = dict(features_format="bed", flank=1_000_000,
                    maxdist=5_000_000, nshifts=1, seed=0, by_strand=True)
WIDE_CELL_SITES = 2_000
WIDE_SUBSET_SITES = 300
# phase 7e: the wide kernel against its plain version at these W, on
# WIDE_CASE_SNIPS snips each; sums within WIDE_RTOL, counts exact
WIDE_KERNEL_W = (121, 129, 130, 201, 257, 258, 401)
WIDE_CASE_SNIPS = 600
WIDE_RTOL = 1e-5
CELL_REPEATS = 2
# phase 7d: 119-bin windows (+-590 kb at 10 kb) over the engine cell's sites,
# the staged kernel in two bands; mindist automatic (2 * flank + 2 bins)
W119_CELL_KW = dict(ENGINE_KW, flank=590_000, maxdist=3_000_000)
W119_SUBSET_SITES = 300

# phase 8a: the extension routes and the by-window cases that group through
# a frame hook, on the toy map. Per mode: "features" (toy_features() with
# distinct scores unless "bedpe", "tads" or "bedpe_tads"), CoordCreator and
# PileUpper keywords ("expected": True stands for the toy expected table),
# "run" (pileupsWithControl keywords; hooks and extras by name, resolved in
# hook_mode_table), "by_window", the accumulate routes on the card and on
# the CPU, and the extras columns with the tolerance they are held to (None:
# equal, copied from frame columns)
HOOK_MODES = {
    "frame_func": dict(run={"postprocess_frame_func": "group_by_region"},
                       routes=("cuda_kernel", "plain")),
    "frame_column_by_strand": dict(
        run={"extras": "score1", "groupby": ["strand1", "strand2"]},
        routes=("cuda_kernel", "plain"), extras=(["score1"], None)),
    "frame_column_controls": dict(
        cc={"nshifts": 2, "seed": 3}, run={"extras": "score1"},
        routes=("cuda_kernel", "plain"),
        extras=(["score1", "control_score1"], None)),
    "batch_hook": dict(
        run={"postprocess_batch_func": "center_batch", "extras": "center"},
        routes=("batch_hook",) * 2, extras=(["center"], 1e-5)),
    "batch_hook_flip_controls": dict(
        cc={"nshifts": 1, "seed": 5}, pu={"flip_negative_strand": True},
        run={"postprocess_batch_func": "center_batch", "extras": "center",
             "groupby": ["strand1", "strand2"]},
        routes=("batch_hook",) * 2,
        extras=(["center", "control_center"], 1e-5)),
    "snip_domain_score": dict(
        features="tads", cc={"local": True, "rescale_flank": 1},
        pu={"rescale": True, "rescale_size": 33},
        run={"postprocess_snip_func": "domain_score",
             "extras": "domain_score"},
        routes=("host_stream",) * 2, extras=(["domain_score"], 1e-5)),
    "snip_per_anchor": dict(
        run={"postprocess_snip_func": "per_anchor"},
        routes=("host_stream",) * 2),
    "opaque_extra": dict(
        run={"extras": "count_snips"}, routes=("host_stream",) * 2,
        extras=(["snipcount"], None)),
    "extras_expected_emission": dict(
        pu={"expected": True, "ooe": False}, run={"extras": "score1"},
        routes=("host_stream",) * 2, extras=(["score1"], None)),
    "host_stripes": dict(
        cc={"nshifts": 1, "seed": 4}, pu={"store_stripes": True},
        run={"postprocess_snip_func": "center_snip", "extras": "center"},
        routes=("host_stream",) * 2,
        extras=(["center", "control_center"], 1e-5)),
    "host_rescale": dict(
        features="tads", cc={"rescale_flank": 1},
        pu={"rescale": True, "rescale_size": 33, "expected": True},
        run={"postprocess_snip_func": "noop"},
        routes=("host_stream",) * 2),
    "by_window_bedpe": dict(features="bedpe", by_window=True,
                            routes=("cuda_kernel", "plain")),
    "by_window_bedpe_controls": dict(
        features="bedpe", cc={"nshifts": 2, "seed": 6}, by_window=True,
        routes=("cuda_kernel", "plain")),
    "by_window_rescale": dict(
        features="tads", cc={"rescale_flank": 1},
        pu={"rescale": True, "rescale_size": 33}, by_window=True,
        routes=("rescale_torch",) * 2),
    "by_window_rescale_bedpe": dict(
        features="bedpe_tads", cc={"rescale_flank": 1},
        pu={"rescale": True, "rescale_size": 33}, by_window=True,
        routes=("rescale_torch",) * 2),
}
EXTRAS_RTOL = 1e-5
# phase 8b: bench.py:575 bench_extension (its sizes, keywords and hooks)
EXTENSION_KW = dict(features_format="bed", flank=100_000, maxdist=1_000_000,
                    nshifts=0)
EXTENSION_SITES = (20_000, 6_000)  # frame column; batch and snip hooks
EXTENSION_WARMUP = {"frame": 1_000, "batch": 200, "snip": 200}
EXTENSION_REPEATS = {"frame": 2, "batch": 2, "snip": 1}
EXTENSION_CPU_SITES = 1_000
# phase 8c: by-window of BEDPE rows: every pair of these sites of the engine
# map within this distance, written out as rows
BEDPE_WINDOW_SITES = 5_000
BEDPE_WINDOW_KW = dict(flank=100_000, maxdist=2_000_000)

# phase 10: bench.py:866 bench_genome (its pileup() arguments); the native
# entries' runs each and their tolerance against the numpy branches
GENOME_KW = dict(features_format="bed", flank=100_000, maxdist=2_000_000,
                 nshifts=10, seed=0, by_strand=True)
NATIVE_RUNS = 2
# the native scatter adds float32 in input order where the numpy branch
# sums in float64: near the diagonal of bench's zipf maps a cell holds
# hundreds of duplicate contacts, whose float32 sum drifts by a few 1e-6
# (4.3e-6 on the genome map, NVIDIA H100 host)
NATIVE_RTOL = 1e-5


def smi_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def nvcc_line():
    from coolpuppy_tpu_torch.kernels.build import find_nvcc

    res = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    lines = [ln for ln in res.stdout.splitlines() if "release" in ln]
    return lines[0].strip() if lines else res.stdout.strip()


def importable(name):
    """Whether ``name`` imports here. jax is only looked up: this script
    never imports it."""
    if name == "jax":
        return importlib.util.find_spec(name) is not None
    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def compare(got, want, rtol, atol, what):
    """Hold ``(sum, num)`` from the kernel against the plain version:
    ``num`` exact, the +inf poison planes equal, finite sums within
    tolerance. Returns the largest absolute difference of the finite sums."""
    gs, gn = (t.cpu().numpy() for t in got)
    ws, wn = (t.cpu().numpy() for t in want)
    if not np.array_equal(gn, wn):
        bad = int((gn != wn).sum())
        raise AssertionError(f"{what}: num differs at {bad} entries")
    pois = np.isinf(ws)
    if not np.array_equal(np.isinf(gs), pois):
        raise AssertionError(f"{what}: poison planes differ")
    if np.isnan(gs).any() or np.isnan(ws).any():
        raise AssertionError(f"{what}: NaN in a sum")
    np.testing.assert_allclose(gs[~pois], ws[~pois], rtol=rtol, atol=atol,
                               err_msg=what)
    return float(np.abs(gs[~pois] - ws[~pois]).max(initial=0.0))


def small_problem(W, seed):
    """A small cis region and snip stream for one window size: 700 bins,
    one quad holding 900 snips, 600 groups (ids above 512), and zero
    ``evec`` entries that poison some sums with +inf."""
    from scipy import sparse as sp

    rng = np.random.default_rng(seed)
    n, C, S = 700, 600, 2500
    dense = rng.gamma(1.0, 1.0, (n, n)) * (rng.random((n, n)) < 0.2)
    dense = np.triu(dense) + np.triu(dense, 1).T
    coo = sp.coo_matrix(dense)
    valid = (rng.random(n) > 0.05).astype(np.float32)
    evec = (5.0 / (1.0 + np.arange(n))).astype(np.float32)
    evec[rng.integers(2, n, 4)] = 0.0
    r1 = np.concatenate([
        3 + rng.integers(0, 5, 900),
        rng.integers(0, n - W, S - 900),
    ]).astype(np.int32)
    r2 = np.concatenate([
        9 + rng.integers(0, 5, 900),
        rng.integers(0, n - W, S - 900),
    ]).astype(np.int32)
    cid = rng.integers(0, C, S).astype(np.int32)
    cid[:10] = C - 1
    cfg_kw = dict(W=W, capacity=C, cis=True, ignore_diags=2, ooe=True)
    return coo, r1, r2, cid, valid, evec, cfg_kw


def band_limit():
    """``(largest one-band W, first banded W)`` from ``corner_layout``."""
    from coolpuppy_tpu_torch.ops.quad_gather import W_MAX, corner_layout

    first = next(W for W in range(1, W_MAX + 1)
                 if corner_layout(W).bands > 1)
    return first - 1, first


def synthetic_case(W, seed, counts, k, runs=None, C=64):
    """A stack of random tiles (10% NaN, 1% +inf, slot 0 all NaN) and
    quads ``k`` ([nq, 4] slots, 0 = a missing tile) of ``counts`` snips
    each at random offsets (some at 127), groups sorted inside a quad: drawn
    from [0, C), or with ``runs`` in runs of 1..runs snips of rising groups.
    Returns ``(stiles, (snips, k, qstart, qcount), W, C)`` as numpy."""
    rng = np.random.default_rng(seed)
    k = np.asarray(k, np.int32)
    counts = np.asarray(counts, np.int32)
    st = rng.gamma(1.0, 1.0, (int(k.max()) + 1, B, B)).astype(np.float32)
    st[rng.random(st.shape) < 0.1] = np.nan
    st[rng.random(st.shape) < 0.01] = np.inf
    st[0] = np.nan
    n = int(counts.sum())
    o1, o2 = rng.integers(0, 128, (2, n))
    o1[::97], o2[::89] = 127, 127
    if runs:
        g = [np.repeat(np.arange(c), rng.integers(1, runs + 1, c))[:c]
             for c in counts]
        C = max(C, int(max(x.max() for x in g if len(x)) + 1))
    else:
        g = [np.sort(rng.integers(0, C, c)) for c in counts]
    from coolpuppy_tpu_torch.ops.quad_gather import pack_snips

    snips = pack_snips(o1, o2, np.concatenate(g))
    qstart = (np.cumsum(counts) - counts).astype(np.int32)
    return st, (snips, k, qstart, counts), W, C


def kernel_cases():
    """Phase 3's inputs: ``(name, stiles, quads, W, C)`` with ``stiles`` a
    float32 numpy stack and ``quads = (snips, k, qstart, qcount)`` the
    unsplit output of ``sort_quads`` (numpy)."""
    from coolpuppy_tpu_torch.ops.quad_gather import (
        ITEM_MAX,
        STAGE_CHUNK,
        QuadPileupSession,
        sort_quads,
    )
    from coolpuppy_tpu_torch.ops.tiles import build_tile_stack_sym

    last_single, first_banded = band_limit()
    for W, seed in ((11, 7), (21, 8), (65, 9), (120, 10), (last_single, 11),
                    (first_banded, 12), (115, 17)):
        coo, r1, r2, cid, valid, evec, cfg_kw = small_problem(W, seed)
        ts = build_tile_stack_sym(coo, B, r1=r1, r2=r2, window1=W, window2=W)
        sess = QuadPileupSession(ts, valid, valid, evec, cfg_kw, "cpu")
        st = sess.stiles.numpy()
        yield (f"W={W}", st, sort_quads(r1, r2, cid, ts.tile_map, B), W,
               sess.C)
        if W == 21:
            empty = np.zeros(0, np.int32)
            yield ("W=21 empty", st,
                   sort_quads(empty, empty, empty, ts.tile_map, B), W, sess.C)
    full = [1, 2, 3, 4]
    yield ("W=21 by-window runs", *synthetic_case(
        21, 13, [150, 90, 3], [full, [5, 6, 7, 8], full], runs=3))
    yield ("W=21 ITEM_MAX cuts", *synthetic_case(
        21, 14, [ITEM_MAX, ITEM_MAX + 1, 1], [full, [5, 6, 7, 8], full]))
    yield ("W=21 item longer than the chunk", *synthetic_case(
        21, 15, [2 * STAGE_CHUNK + 77, 40], [full, [5, 6, 7, 8]], C=9))
    missing = [[1, 0, 2, 0], [0, 0, 3, 4], [0, 0, 0, 0], [0, 5, 0, 0]]
    for W in (21, 33, first_banded, 120):
        yield (f"W={W} missing tiles", *synthetic_case(
            W, 16 + W, [60, 50, 7, 40], missing))


def variant_args(quads, variant, device):
    """``quad_accumulate`` arguments on ``device`` for one kernel: the
    quads cut by ``split_items`` ("staged"), by ``split_runs`` ("direct"),
    or left whole ("whole": one item per quad, many groups, any length)."""
    import torch

    from coolpuppy_tpu_torch.ops.quad_gather import split_items, split_runs

    snips, k, qstart, qcount = quads
    if variant == "staged":
        k, qstart, qcount = split_items(k, qstart, qcount)
    elif variant == "direct":
        k, qstart, qcount = split_runs(snips, k, qstart, qcount)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
        for a in (k, qstart, qcount, snips)
    )


def check_case(name, stiles, quads, W, C, device, sync):
    """One phase-3 case: both kernels against the plain version (``num``
    exact, poison equal, ``sum`` within SMALL_TOL), the staged one on split
    and on whole quads, and the routed ``quad_accumulate`` on the staged
    kernel's items, which must launch the staged kernel. Returns the
    variants held and the largest absolute error."""
    import torch

    import coolpuppy_tpu_torch.ops.quad_gather as qg

    st = torch.from_numpy(stiles).to(device)
    want = qg.quad_accumulate_plain(
        st, *variant_args(quads, "whole", device), W, C)
    runs = [("direct", qg.quad_accumulate_direct, "direct"),
            ("staged", qg.quad_accumulate_staged, "staged"),
            ("staged, whole quads", qg.quad_accumulate_staged, "whole"),
            ("routed", qg.quad_accumulate, "staged")]
    err = 0.0
    for label, fn, split in runs:
        args = variant_args(quads, split, device)
        before = dict(qg.VARIANT_LAUNCHES)
        got = fn(st, *args, W, C)
        sync()
        took = {v: qg.VARIANT_LAUNCHES[v] - before[v] for v in before}
        n_items = int(args[0].shape[0])
        if label == "routed" and took != {"staged": int(n_items > 0),
                                          "direct": 0}:
            raise AssertionError(f"{name}: routed launch counted {took}")
        err = max(err, compare(got, want, what=f"{label} vs plain {name}",
                               **SMALL_TOL))
    return [label for label, _, _ in runs], err, want


def check_kernels(dev, sync):
    """Phase 3: both kernels against the plain version at small shapes."""
    import torch

    from coolpuppy_tpu_torch.ops.quad_gather import corner_layout

    for name, stiles, quads, W, C in kernel_cases():
        held, err, want = check_case(name, stiles, quads, W, C, dev, sync)
        print(f"kernel vs plain {name}: bands {corner_layout(W).bands} "
              f"quads {len(quads[2])} snips "
              f"{len(quads[0])} C {C} [{'; '.join(held)}] "
              f"max_abs_err {err:.3g} num {int(want[1].sum())} "
              f"poison {int(torch.isinf(want[0]).sum())} ok")


def kernel_bound(calls):
    """The least time the card could take for ``calls`` (one ``call_shape``
    record per launch): the bytes the function must move on these inputs
    (the stack pixels its windows cover, the snip words and the item arrays
    read once, float32 ``sum`` and int32 ``num`` of the groups it adds to
    written once) over the card's memory rate, against one float add per
    window pixel over its float32 rate. Returns ``(ms, "bytes" or
    "operations", bytes, operations)``."""
    nbytes = sum(4 * c["pixels"] + 4 * c["snips"] + 24 * c["items"]
                 + 8 * c["groups"] * c["W"] ** 2 for c in calls)
    ops = sum(c["snips"] * c["W"] ** 2 for c in calls)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, nbytes, ops


def covered_pixels(slots, start, count, snips, W, block=None):
    """The stack pixels the windows of a kernel call cover, each counted
    once: per work item its window starts marked in a B x B grid and spread
    by a W x W max-pool over the (B + W - 1)^2 corner they reach, then added
    into a bitmap of the stack through the item's R x R tile slots
    (``slots`` [items, R * R], row u and column v at u * R + v: a quad
    call's ``k`` [nq, 4] in its order 00, 01, 10, 11, or a wide call's
    slots), ``block`` items at a time (default: as many as keep the padded
    grids near 2^26 pixels)."""
    import torch
    import torch.nn.functional as F

    dev = slots.device
    if slots.shape[0] == 0:
        return 0
    R = int(round(slots.shape[1] ** 0.5))
    flag = torch.zeros((int(slots.max()) + 1, B, B), device=dev)
    start, count = start.long(), count.long()
    S = B + W - 1
    block = block or max(1, (1 << 26) // (B + 2 * (W - 1)) ** 2)
    for lo in range(0, slots.shape[0], block):
        hi = min(lo + block, slots.shape[0])
        cnt = count[lo:hi]
        item = torch.repeat_interleave(torch.arange(hi - lo, device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        pos = start[lo:hi][item] + torch.arange(len(item), device=dev) \
            - first[item]
        w = snips[pos].long()
        marks = torch.zeros((hi - lo, B, B), device=dev)
        marks[item, w >> 24, (w >> 17) & 0x7F] = 1.0
        # the W x W max-pool as a column pass and a row pass (a max over a
        # box is the max of its rows' maxima): 2W compares a pixel, not W^2
        cov = F.max_pool2d(F.pad(marks[:, None], (W - 1,) * 4), (W, 1),
                           stride=1)
        cov = F.max_pool2d(cov, (1, W), stride=1)
        canvas = torch.zeros((hi - lo, R * B, R * B), device=dev)
        canvas[:, :S, :S] = cov[:, 0]
        for u in range(R):
            for v in range(R):
                flag.index_add_(0, slots[lo:hi, u * R + v].long(),
                                canvas[:, u * B:(u + 1) * B,
                                       v * B:(v + 1) * B].contiguous())
    return int((flag > 0).sum())


def call_shape(stiles, k, qstart, qcount, snips, W, C):
    """The ``kernel_bound`` record of one ``quad_accumulate`` call: the
    stack pixels its windows cover and the groups it adds to, with its
    stack tiles, items, snips, W and C."""
    import torch

    return dict(pixels=covered_pixels(k, qstart, qcount, snips, int(W)),
                groups=int(torch.unique(snips & 0x1FFFF).numel()),
                tiles=int(stiles.shape[0]), items=int(k.shape[0]),
                snips=int(snips.shape[0]), W=int(W), C=int(C))


class launch_shapes:
    """Record the arguments of every ``quad_accumulate`` call made during a
    block (``calls``), for the kernel's bound on that run's own inputs
    (``shape_record`` reads them after the block, so the block runs only
    what it runs without the record)."""

    def __enter__(self):
        import coolpuppy_tpu_torch.ops.quad_gather as qg

        self.inner = inner = qg.quad_accumulate
        self.calls = calls = []

        def recording(*args):
            calls.append(args)
            return inner(*args)

        qg.quad_accumulate = recording
        return self

    def __exit__(self, *exc):
        import coolpuppy_tpu_torch.ops.quad_gather as qg

        qg.quad_accumulate = self.inner


def shape_record(what, calls, kernel_ms, launches, card):
    """Print and return one shape's row of the kernel table: launches,
    the kernel's time, its bound on these inputs and the share of it, and
    the plain version's time in the plain-swapped run of the same name.
    ``calls`` holds ``call_shape`` records or ``quad_accumulate``
    arguments."""
    calls = [c if isinstance(c, dict) else call_shape(*c) for c in calls]
    ms, by, nbytes, ops = kernel_bound(calls)
    plain = PLAIN_MS.get(what)
    rec = dict(launches=launches, bound_ms=ms, bound_by=by, ms=kernel_ms,
               plain_ms=plain,
               **{key: sum(c[key] for c in calls)
                  for key in ("pixels", "groups", "items", "snips")},
               C=max((c["C"] for c in calls), default=0))
    share = ("not measured" if not kernel_ms
             else f"{kernel_ms:.3f} ms, bound/kernel {ms / kernel_ms:.4f}")
    print(f"{what} kernel bound: {ms:.5f} ms by {by} ({nbytes} bytes, {ops} "
          f"adds; pixels {rec['pixels']}, groups {rec['groups']}, items "
          f"{rec['items']}, snips {rec['snips']}, C {rec['C']}, launches "
          f"{launches}); kernel {share}; plain version "
          f"{'not measured' if plain is None else f'{plain:.3f} ms'} on "
          f"{card}")
    return rec


def host_oracle(ts, r1, r2, cid, valid, evec, W, C):
    """Host numpy oracle: normalize the full stack, cut every window, and
    nansum / count finite values per group in float64."""
    from coolpuppy_tpu_torch.ops.tiles import (
        assemble_windows_batch,
        normalize_tile_stack,
    )

    full = ts.to_tile_stack() if hasattr(ts, "upper") else ts
    stiles = normalize_tile_stack(full, valid, valid, evec=evec, ooe=True,
                                  cis=True, ignore_diags=2)
    win = assemble_windows_batch(stiles, full.tile_map, B, r1, r2, W)
    fin = win == win
    s = np.zeros((C, W, W))
    m = np.zeros((C, W, W))
    np.add.at(s, cid, np.where(fin, win, 0.0).astype(np.float64))
    np.add.at(m, cid, (fin & ~np.isinf(win)).astype(np.float64))
    return stiles, s, m


def profile_run(fn, sync, kernel="quad_accumulate"):
    """One ``torch.profiler`` run of ``fn``: ``text``, the device time of
    the CUDA kernels and copies that ``fn`` launched over its wall time and
    the port's kernels' own share of the wall (those whose name holds
    ``kernel``: the quad kernels, or ``wide_accumulate``), and
    ``kernel_ms``, their device time (None where the profiler saw no device
    time).
    Only device-side events count (a host op's device time would count its
    kernels twice), less the profiler's own buffer requests."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not e.key.startswith("Activity Buffer")]
    dev_us = sum(e.self_device_time_total for e in dev)
    if dev_us <= 0:
        return dict(text="not measured (the profiler saw no device time)",
                    kernel_ms=None)
    dev.sort(key=lambda e: -e.self_device_time_total)
    names = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                      for e in dev[:4])
    kern_us = sum(e.self_device_time_total for e in dev
                  if kernel in e.key)
    label = "quad" if kernel == "quad_accumulate" else kernel
    text = (f"{dev_us / 1e6 / wall:.4f} (device {dev_us / 1e3:.3f} ms of "
            f"{wall * 1e3:.1f} ms wall, profiled; {label} kernel "
            f"{kern_us / 1e3:.3f} ms = {kern_us / 1e6 / wall:.5f} of the "
            f"wall; top: {names})")
    return dict(text=text, kernel_ms=kern_us / 1e3)


def busy_share(fn, sync, kernel="quad_accumulate"):
    """``profile_run``'s text."""
    return profile_run(fn, sync, kernel)["text"]


def event_ms(fn, sync):
    """Device time of what ``fn`` enqueues, between two CUDA events."""
    import torch

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    sync()
    t0.record()
    fn()
    t1.record()
    sync()
    return t0.elapsed_time(t1)


# cycles of the sleep kernel queued ahead of each timed launch (~50 us at
# the H100's clock): it keeps the stream busy while the host enqueues the
# launch, so the events around the launch time the kernel alone
SLEEP_CYCLES = 100_000


class quad_kernel_events:
    """The device time of every quad kernel launched during a block, in
    launch order (``ms``): for the block the library's two launch entries
    (or ``entries``: ``WIDE_ENTRIES`` for the wide kernel) are wrapped so
    that each launch sits between two CUDA events on its stream, behind a
    short sleep kernel (``cycles``, SLEEP_CYCLES unless given: a launch
    whose host side takes longer than the sleep, as on a thread that shares
    the GIL with the coordinate loop, adds that wait)."""

    ENTRIES = ("quad_accumulate_launch", "quad_accumulate_staged_launch")

    def __init__(self, cycles=SLEEP_CYCLES, entries=None):
        self.cycles = cycles
        self.entries = entries or self.ENTRIES

    def __enter__(self):
        import torch
        from coolpuppy_tpu_torch.kernels.build import load_kernels

        self.lib = load_kernels()
        self.saved = {name: getattr(self.lib, name) for name in self.entries}
        self.events = []

        def bracket(entry):
            def launch(*args):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(self.cycles)
                t0.record()
                err = entry(*args)
                t1.record()
                self.events.append((t0, t1))
                return err
            return launch

        for name, entry in self.saved.items():
            setattr(self.lib, name, bracket(entry))
        return self

    def __exit__(self, *exc):
        import torch

        for name, entry in self.saved.items():
            setattr(self.lib, name, entry)
        torch.cuda.synchronize()
        self.ms = [t0.elapsed_time(t1) for t0, t1 in self.events]


def kernel_and_call_ms(fn, sync):
    """Two calls of one launcher: the whole call between two CUDA events
    (two memsets, the kernel and the launch gaps between them), then the
    quad kernel's own device time between the events around its launch in
    the second call (``quad_kernel_events``)."""
    call = event_ms(fn, sync)
    with quad_kernel_events() as trace:
        fn()
        sync()
    if len(trace.ms) != 1:
        raise AssertionError(f"one launcher call made {len(trace.ms)} quad "
                             "kernel launches")
    return trace.ms[0], call


def in_turns(fns, sync, rounds=None):
    """Time the named launcher calls in turns (a, b, ..., b, a per round).
    Returns ``{name: {"kernel": [ms, ...], "call": [ms, ...]}}`` in the
    order run (``kernel_and_call_ms``)."""
    names = list(fns)
    ms = {name: {"kernel": [], "call": []} for name in names}
    for _ in range(rounds or KERNEL_ROUNDS):
        for name in names + names[::-1]:
            kern, call = kernel_and_call_ms(fns[name], sync)
            ms[name]["kernel"].append(kern)
            ms[name]["call"].append(call)
    return ms


def ms_line(ms):
    return "; ".join(
        f"{name}: kernel {json.dumps([round(x, 4) for x in t['kernel']])} "
        f"median {statistics.median(t['kernel']):.4f}, call median "
        f"{statistics.median(t['call']):.4f}" for name, t in ms.items())


def timed(fn, sync):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return time.perf_counter() - t0, out


def check_slice(dev, sync, workload, card):
    """Phase 4: the slice on ``workload`` (``bench.make_workload``'s
    tuple): drive it once with the launch counts reset, check it and both
    kernels against the plain version and the host oracle, and time them.
    Returns the kernel's JSON record."""
    import torch

    import coolpuppy_tpu_torch.ops.quad_gather as qg
    from coolpuppy_tpu_torch.ops.gather import merge_flip_banks
    from coolpuppy_tpu_torch.ops.tiles import build_tile_stack_sym

    _, coo, r1, r2, gid, flip, valid, evec = workload
    W, half = 21, 4
    C = 2 * half + 8
    cid = (gid + half * flip).astype(np.int32)
    cfg_kw = dict(W=W, capacity=C, cis=True, ignore_diags=2, ooe=True)
    n_snips = len(r1)
    phases = {}

    def run_slice():
        t0 = time.perf_counter()
        ts = build_tile_stack_sym(coo, B, r1=r1, r2=r2, window1=W, window2=W)
        t1 = time.perf_counter()
        sess = qg.QuadPileupSession(ts, valid, valid, evec, cfg_kw, dev)
        sync()
        t2 = time.perf_counter()
        out = sess.run_many(r1, r2, cid, fetch=False)
        sync()
        t3 = time.perf_counter()
        total = sess.finalize([out])
        merged = merge_flip_banks(total, half)
        t4 = time.perf_counter()
        phases.update(scatter=t1 - t0, stack_to_device=t2 - t1,
                      sort_and_accumulate=t3 - t2, finalize_merge=t4 - t3)
        return ts, sess, total, merged

    qg.LAUNCHES = 0
    qg.VARIANT_LAUNCHES.update(staged=0, direct=0)
    ts, sess, total, merged = run_slice()
    launches = qg.LAUNCHES
    if launches < 1 or qg.VARIANT_LAUNCHES != {"staged": launches,
                                               "direct": 0}:
        raise AssertionError(
            f"the headline path launched {launches} kernels, by variant "
            f"{qg.VARIANT_LAUNCHES}: it must take the staged kernel at W=21")
    for k in ("sum", "num", "poison"):
        if merged[k].shape != (half, W, W):
            raise AssertionError(f"merged {k} has shape {merged[k].shape}")
    if not np.isfinite(merged["sum"]).all() or merged["poison"].any():
        raise AssertionError("headline sums are not finite")
    if int(merged["num"].sum()) <= 0:
        raise AssertionError("headline counts are empty")
    quads = qg.sort_quads(r1, r2, cid, ts.tile_map, B)
    args = {v: (sess.stiles, *variant_args(quads, v, dev), W, C)
            for v in ("staged", "direct")}
    lay = qg.corner_layout(W)
    pixels, threads = qg.pixels_per_thread(W)
    print(f"slice: launches {launches} variant staged, items "
          f"{int(args['staged'][1].shape[0])} (direct: "
          f"{int(args['direct'][1].shape[0])}) quads {len(quads[2])} "
          f"tiles {ts.n_tiles} corner_bytes {lay.corner_bytes} smem_bytes "
          f"{lay.smem_bytes} stride {lay.stride} threads {threads} "
          f"pixels/thread {pixels} blocks/SM {qg.staged_occupancy(W, dev)} "
          f"num {int(merged['num'].sum())} ok")
    sync()
    want = qg.quad_accumulate_plain(*args["staged"])
    # the main path's own accumulators, and one more launch of each kernel
    # and of each alternative that is timed below, against the plain version
    session = tuple(torch.from_numpy(total[k]) for k in ("sum", "num"))
    if not np.array_equal(total["poison"], np.isinf(total["sum"])):
        raise AssertionError("session poison plane differs from its sums")
    kernels = {
        "direct": lambda: qg.quad_accumulate_direct(*args["direct"]),
        "staged": lambda: qg.quad_accumulate_staged(*args["staged"]),
    }
    alternatives = {
        "1 pixel": kernels["staged"],
        "2 pixels": lambda: qg.quad_accumulate_staged(
            *args["staged"], pixels=2),
        "4 pixels": lambda: qg.quad_accumulate_staged(
            *args["staged"], pixels=4),
    }
    errs = {"main path": compare(session, want, rtol=HEADLINE_RTOL,
                                 atol=1e-6,
                                 what="session vs plain headline")}
    for name, fn in {**kernels, **alternatives}.items():
        got = fn()
        sync()
        errs[name] = compare(got, want, rtol=HEADLINE_RTOL, atol=1e-6,
                             what=f"{name} vs plain headline")
    max_err = max(errs["main path"], errs["staged"])
    print("kernels vs plain headline: max_abs_err " + json.dumps(
        {k: float(f"{v:.3g}") for k, v in errs.items()})
        + f" max_sum {float(want[0].max()):.6g} ok")

    n_sub = min(20_000, n_snips)
    s_r1, s_r2, s_cid = r1[:n_sub], r2[:n_sub], cid[:n_sub]
    stiles_h, want_s, want_m = host_oracle(ts, s_r1, s_r2, s_cid, valid,
                                           evec, W, C)
    st = sess.stiles.cpu().numpy()
    if not np.array_equal(np.isnan(st), np.isnan(stiles_h)):
        raise AssertionError("device normalize NaN mask differs from host")
    fin = ~np.isnan(stiles_h)
    np.testing.assert_allclose(st[fin], stiles_h[fin], rtol=1e-6, atol=1e-6)
    sub = sess.run_many(s_r1, s_r2, s_cid)
    if not np.array_equal(sub["num"], want_m):
        raise AssertionError("subset num differs from the host oracle")
    np.testing.assert_allclose(sub["sum"], want_s, rtol=1e-5, atol=0,
                               err_msg="subset sum vs host oracle")
    print(f"host oracle subset ({n_sub} snips): num exact, sum rtol 1e-5 ok")

    # timing: the two kernels in turns on the same pre-staged inputs, the
    # staged kernel's alternatives, then the wrapper, the plain version and
    # the path on the host clock
    kern_ms = in_turns(kernels, sync)
    print("kernel timing in turns (direct, staged, staged, direct; kernel "
          "device time between CUDA events around its launch, launcher "
          "call between CUDA events; ms): " + ms_line(kern_ms))
    print("staged alternatives in turns (ms): "
          + ms_line(in_turns(alternatives, sync, rounds=SWEEP_ROUNDS)))
    by_item_max = {}
    for item_max in ITEM_MAX_SWEEP:
        items = qg.split_items(*quads[1:], item_max=item_max)
        a = (sess.stiles, *(torch.from_numpy(x).to(dev) for x in items),
             args["staged"][4], W, C)
        by_item_max[f"item_max {item_max} ({len(items[1])} items)"] = (
            lambda a=a: qg.quad_accumulate_staged(*a))
    print("staged by ITEM_MAX in turns (ms): "
          + ms_line(in_turns(by_item_max, sync, rounds=SWEEP_ROUNDS)))
    staged_ms = statistics.median(kern_ms["staged"]["kernel"])
    direct_ms = statistics.median(kern_ms["direct"]["kernel"])
    shape = shape_record("slice", [call_shape(*args["staged"])], staged_ms,
                         launches, card)
    wrap_t = [timed(lambda: qg.quad_accumulate(*args["staged"]), sync)[0]
              for _ in range(REPEATS)]
    plain_t = [timed(lambda: qg.quad_accumulate_plain(*args["staged"]),
                     sync)[0] for _ in range(PLAIN_REPEATS)]
    stage_t = [timed(lambda: sess.stage(r1, r2, cid), sync)[0]
               for _ in range(REPEATS)]
    e2e_t, e2e_phases = [], []
    for _ in range(REPEATS):
        e2e_t.append(timed(run_slice, sync)[0])
        e2e_phases.append(dict(phases))
    wrap_med = statistics.median(wrap_t)
    plain_med = statistics.median(plain_t)
    e2e_med = statistics.median(e2e_t)
    mid = e2e_phases[int(np.argsort(e2e_t)[len(e2e_t) // 2])]
    mid["of_which_sort_split_upload"] = statistics.median(stage_t)
    print("timing: wrapper_ms (host clock, with the float64 widening) "
          + json.dumps([round(x * 1e3, 3) for x in wrap_t])
          + " plain_ms " + json.dumps([round(x * 1e3, 3) for x in plain_t])
          + " e2e_s " + json.dumps([round(x, 4) for x in e2e_t]))
    print("e2e phases (median run, s): " + json.dumps(
        {k: round(v, 4) for k, v in mid.items()}))
    print("device busy share of one end-to-end run: "
          + busy_share(run_slice, sync))
    print(f"snips/s: device-only {n_snips / staged_ms * 1e3:.0f} "
          f"(staged kernel median {staged_ms:.4f} ms, direct "
          f"{direct_ms:.4f} ms, wrapper {wrap_med * 1e3:.3f} ms, "
          f"plain {plain_med * 1e3:.3f} ms), "
          f"end-to-end {n_snips / e2e_med:.0f} (median {e2e_med:.3f} s)"
          f" on {card}")
    return dict(KERNEL, launches=launches, max_abs_err=max_err,
                ms=staged_ms, plain_ms=plain_med * 1e3,
                bound_ms=shape["bound_ms"], bound_by=shape["bound_by"],
                library_ms=None, direct_ms=direct_ms, variant="staged",
                call_ms=statistics.median(kern_ms["staged"]["call"]),
                shapes={"slice": shape})


def check_sweep(dev, sync, workload, card):
    """Phase 4's sweep over window sizes: the first SWEEP_LOCI loci of the
    headline map at every W of SWEEP_W (one band up to 110, two from 111),
    and every locus at W = 11; both kernels are held against the plain
    version (``num`` exact, poison equal, ``sum`` rtol 1e-4) and timed in
    turns (direct, staged, staged, direct) beside the routed (staged)
    kernel's bound."""
    import coolpuppy_tpu_torch.ops.quad_gather as qg
    from coolpuppy_tpu_torch.ops.tiles import build_tile_stack_sym

    _, coo, r1, r2, gid, flip, valid, evec = workload
    half = 4
    C = 2 * half + 8
    cid_all = (gid + half * flip).astype(np.int32)
    chunk = qg.PLAIN_CHUNK
    qg.PLAIN_CHUNK = 8192  # bounds the plain version's index tensors
    try:
        for W, loci in ((SWEEP_FULL_W, len(r1)),
                        *((W, SWEEP_LOCI) for W in SWEEP_W)):
            a = np.minimum(r1[:loci], coo.shape[0] - W - 1)
            b = np.minimum(r2[:loci], coo.shape[0] - W - 1)
            cid = cid_all[:loci]
            ts = build_tile_stack_sym(coo, B, r1=a, r2=b, window1=W,
                                      window2=W)
            sess = qg.QuadPileupSession(
                ts, valid, valid, evec,
                dict(W=W, capacity=C, cis=True, ignore_diags=2, ooe=True),
                dev)
            quads = qg.sort_quads(a, b, cid, ts.tile_map, B)
            variants = ["direct", "staged"]
            args = {v: (sess.stiles, *variant_args(quads, v, dev), W, C)
                    for v in variants}
            launchers = {"direct": qg.quad_accumulate_direct,
                         "staged": qg.quad_accumulate_staged}
            fns = {v: (lambda v=v: launchers[v](*args[v])) for v in variants}
            t_plain, want = timed(
                lambda: qg.quad_accumulate_plain(*args["direct"]), sync)
            err = 0.0
            for v, fn in fns.items():
                got = fn()
                sync()
                err = max(err, compare(got, want, rtol=HEADLINE_RTOL,
                                       atol=1e-6,
                                       what=f"sweep W={W} {v} vs plain"))
            ms = in_turns(fns, sync)
            routed = "staged"
            bound, by, _, _ = kernel_bound([call_shape(*args[routed])])
            med = statistics.median(ms[routed]["kernel"])
            lay = qg.corner_layout(W)
            print(f"sweep W={W}: {len(a)} snips, quads {len(quads[2])}, "
                  f"items {int(args[routed][1].shape[0])} (direct "
                  f"{int(args['direct'][1].shape[0])}), tiles {ts.n_tiles}, "
                  f"routed {routed}, bands {lay.bands} of {lay.band_rows} "
                  f"rows, smem_bytes {lay.smem_bytes}, (pixels/thread, "
                  f"threads) {qg.pixels_per_thread(W)}, "
                  f"max_abs_err {err:.3g}; ms in turns: {ms_line(ms)}; "
                  f"plain {t_plain * 1e3:.1f} ms (one run); bound "
                  f"{bound:.5f} ms by {by}, bound/kernel {bound / med:.4f} "
                  f"on {card}")
            del sess, args, want
    finally:
        qg.PLAIN_CHUNK = chunk


def toy_cooler(seed=1, binsize=1_000_000, bad_bin_frac=0.05):
    """The toy map of ``tests/fixtures.make_toy_cooler`` (two mm9-sized
    chromosomes at 1 Mb, distance-decaying Poisson cis counts, 30%-dense
    trans counts, 5% NaN-weight bins), built in memory with the same RNG
    calls. Returns ``(Cooler, dense, weights)``: ``dense`` maps (chrom1,
    chrom2) to the full raw block."""
    from coolpuppy_tpu_torch import Cooler

    chromsizes = {"chr1": 197_195_432, "chr2": 181_748_087}
    rng = np.random.default_rng(seed)
    chroms = list(chromsizes)
    n_per = {c: int(np.ceil(n / binsize)) for c, n in chromsizes.items()}
    offsets = dict(zip(chroms, np.cumsum([0] + [n_per[c] for c in chroms])))
    n_bins = sum(n_per.values())
    weights = rng.uniform(0.5, 1.5, n_bins)
    weights[rng.random(n_bins) < bad_bin_frac] = np.nan
    pix1, pix2, cnt, dense = [], [], [], {}
    for ci, c1 in enumerate(chroms):
        for c2 in chroms[ci:]:
            n1, n2 = n_per[c1], n_per[c2]
            if c1 == c2:
                i, j = np.triu_indices(n1)
                vals = rng.poisson(100.0 / (1.0 + np.abs(i - j)) + 0.5)
                keep = vals > 0
                i, j, vals = i[keep], j[keep], vals[keep]
                block = np.zeros((n1, n1))
                block[i, j] = vals
                block[j, i] = vals
            else:
                i, j = np.nonzero(rng.random((n1, n2)) < 0.3)
                vals = rng.poisson(2.0, len(i)) + 1
                block = np.zeros((n1, n2))
                block[i, j] = vals
            dense[(c1, c2)] = block
            pix1.append(i + offsets[c1])
            pix2.append(j + offsets[c2])
            cnt.append(vals)
    clr = Cooler.from_arrays(
        chromsizes, binsize,
        (np.concatenate(pix1), np.concatenate(pix2), np.concatenate(cnt)),
        weights=weights,
    )
    return clr, dense, weights


def toy_features():
    """Six stranded BED features on the toy map (the reference's
    tests/data/toy_features.bed)."""
    import pandas as pd

    return pd.DataFrame({
        "chrom": ["chr1", "chr1", "chr1", "chr2", "chr2", "chr2"],
        "start": [102_000_000, 105_000_000, 108_000_000] * 2,
        "end": [102_500_000, 105_500_000, 108_500_000] * 2,
        "name": ["toy"] * 6,
        "score": [0] * 6,
        "strand": ["+", "-", "+", "+", "-", "-"],
    })


def toy_regions():
    """The toy view (the reference's tests/data/CN.mm9.toy_regions.bed)."""
    import pandas as pd

    return pd.DataFrame({"chrom": ["chr1", "chr2"],
                         "start": [100_000_000] * 2,
                         "end": [150_000_000] * 2, "name": ["foo", "bar"]})


def toy_expected(clr, dense, weights, view_df):
    """By-distance balanced expected of each view region (the arithmetic of
    ``tests/fixtures.toy_expected``): per diagonal, the nansum of balanced
    counts over the number of pairs of valid bins."""
    import pandas as pd

    rows = []
    for _, reg in view_df.iterrows():
        lo = int(reg["start"] // clr.binsize)
        hi = int(np.ceil(reg["end"] / clr.binsize))
        o = clr.offset(reg["chrom"])
        w = weights[o + lo : o + hi]
        block = dense[(reg["chrom"], reg["chrom"])][lo:hi, lo:hi]
        block = block * np.outer(w, w)
        valid = ~np.isnan(w)
        for d in range(hi - lo):
            i = np.arange(hi - lo - d)
            nv = int((valid[i] & valid[i + d]).sum())
            s = np.nansum(block[i, i + d])
            rows.append({"region1": reg["name"], "region2": reg["name"],
                         "dist": d, "n_valid": nv, "count.sum": np.nan,
                         "balanced.sum": s,
                         "balanced.avg": s / nv if nv > 0 else np.nan})
    return pd.DataFrame(rows)


def mode_kwargs(name, expected_df):
    """``pileup()`` keywords of one ENGINE_MODES entry on the toy map."""
    kw = dict(TOY_KW, **ENGINE_MODES[name])
    if kw.get("expected_df") is True:
        kw["expected_df"] = expected_df
    return kw


def toy_bedpe():
    """BEDPE rows on the toy map: tests/test_combo_matrix.py's three cis
    loops, and one whose second anchor comes first (its windows lie below
    the diagonal)."""
    import pandas as pd

    return pd.DataFrame({
        "chrom1": ["chr1", "chr1", "chr2", "chr1"],
        "start1": [102_000_000, 104_000_000, 103_000_000, 111_000_000],
        "end1": [102_500_000, 104_500_000, 103_500_000, 111_500_000],
        "chrom2": ["chr1", "chr1", "chr2", "chr1"],
        "start2": [107_000_000, 110_000_000, 109_000_000, 105_000_000],
        "end2": [107_500_000, 110_500_000, 109_500_000, 105_500_000],
    })


def toy_trans_expected(clr, dense, weights, view_df):
    """The scalar trans expected of each pair of view regions on distinct
    chromosomes (the arithmetic of ``coolpuppy_tpu.expected.
    expected_trans``): the balanced sum of the block over the number of
    pairs of valid bins."""
    import pandas as pd

    rows = []
    regions = [reg for _, reg in view_df.iterrows()]
    for a, r1 in enumerate(regions):
        for r2 in regions[a + 1:]:
            if r1["chrom"] == r2["chrom"]:
                continue
            ext = []
            for reg in (r1, r2):
                lo = int(reg["start"] // clr.binsize)
                hi = int(np.ceil(reg["end"] / clr.binsize))
                o = clr.offset(reg["chrom"])
                ext.append((lo, hi, weights[o + lo : o + hi]))
            (lo1, hi1, w1), (lo2, hi2, w2) = ext
            block = dense[(r1["chrom"], r2["chrom"])][lo1:hi1, lo2:hi2]
            bal = np.nansum(block * np.outer(np.nan_to_num(w1),
                                             np.nan_to_num(w2)))
            nv = int((~np.isnan(w1)).sum()) * int((~np.isnan(w2)).sum())
            rows.append({"region1": r1["name"], "region2": r2["name"],
                         "n_valid": nv, "count.sum": float(block.sum()),
                         "balanced.sum": float(bal),
                         "balanced.avg": float(bal) / nv if nv else np.nan})
    return pd.DataFrame(rows)


def mode_2d_inputs(name, trans_expected):
    """``(features, pileup() keywords)`` of one MODES_2D entry on the toy
    map."""
    kw = dict(TOY_KW, **MODES_2D[name])
    features = toy_features()
    if kw.pop("features", None) == "bedpe":
        features = toy_bedpe()
        kw["features_format"] = "bedpe"
    if kw.get("expected_df") == "trans":
        kw["expected_df"] = trans_expected
    return features, kw


class engine_patch:
    """Set engine module constants (``MODE_PATCHES``) for one block and put
    them back after it."""

    def __init__(self, **values):
        self.values = values

    # the package's ``pileup`` function shadows the module's name
    MODULE = "coolpuppy_tpu_torch.engine.pileup"

    def __enter__(self):
        engine = importlib.import_module(self.MODULE)
        self.saved = {k: getattr(engine, k) for k in self.values}
        for k, v in self.values.items():
            setattr(engine, k, v)

    def __exit__(self, *exc):
        engine = importlib.import_module(self.MODULE)
        for k, v in self.saved.items():
            setattr(engine, k, v)


class wires_off:
    """The card's runs in a block take no transfer wire, as the CPU's: for
    callers that cannot pass ``F32_WIRE`` (the CLI has no flag for it)."""

    MODULE = engine_patch.MODULE

    def __enter__(self):
        self.cls = importlib.import_module(self.MODULE).PileUpper
        self.saved = self.cls._on_accelerator
        self.cls._on_accelerator = lambda pu: False

    def __exit__(self, *exc):
        self.cls._on_accelerator = self.saved


def table_keys(table):
    """A pileup table's row keys: chrom/start/end of a by-window table,
    the group otherwise."""
    if "group" in table.columns:
        return list(table["group"])
    return list(zip(table["chrom"], table["start"], table["end"]))


def compare_tables(got, want, rtol, atol, what, stripe_tol=None):
    """Hold two pileup tables row by row: the group keys (in order), or a
    by-window table's chrom/start/end keys (rows matched on them), ``n``,
    ``control_n``, ``num`` and ``control_num`` exact; ``data`` within
    tolerance with NaN positions equal; stripe planes within ``stripe_tol``
    (rtol ``STRIPE_RTOL``, atol 0 unless given) with NaN positions equal and
    stripe coordinates exact. Returns the largest absolute ``data``
    difference."""
    stripe_tol = stripe_tol or dict(rtol=STRIPE_RTOL, atol=0)
    gk, wk = table_keys(got), table_keys(want)
    if "group" in want.columns:
        if gk != wk:
            raise AssertionError(f"{what}: groups {gk} != {wk}")
    else:
        if len(gk) != len(wk) or set(gk) != set(wk) or len(set(wk)) != len(wk):
            raise AssertionError(f"{what}: window keys differ")
        pos = {k: i for i, k in enumerate(gk)}
        got = got.iloc[[pos[k] for k in wk]]
    got = got.reset_index(drop=True)
    want = want.reset_index(drop=True)
    for col in ("n", "control_n"):
        if (col in got) != (col in want):
            raise AssertionError(f"{what}: column {col} on one side only")
        if col in want:
            np.testing.assert_array_equal(got[col].to_numpy(float),
                                          want[col].to_numpy(float),
                                          err_msg=f"{what}: {col}")
    stripes = "horizontal_stripe" in want
    if stripes != ("horizontal_stripe" in got):
        raise AssertionError(f"{what}: stripes on one side only")
    err = 0.0
    for i in range(len(want)):
        for col in ("num", "control_num"):
            if col in want:
                np.testing.assert_array_equal(
                    got[col].iloc[i], want[col].iloc[i],
                    err_msg=f"{what}: {col} of row {i}",
                )
        g = np.asarray(got["data"].iloc[i], float)
        w = np.asarray(want["data"].iloc[i], float)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   equal_nan=True,
                                   err_msg=f"{what}: data of row {i}")
        fin = np.isfinite(w)
        err = max(err, float(np.abs(g[fin] - w[fin]).max(initial=0.0)))
        if stripes:
            for col in ("horizontal_stripe", "vertical_stripe"):
                np.testing.assert_allclose(
                    np.asarray(got[col].iloc[i], float),
                    np.asarray(want[col].iloc[i], float),
                    **stripe_tol, equal_nan=True,
                    err_msg=f"{what}: {col} of row {i}",
                )
            gc = np.asarray(got["coordinates"].iloc[i], object)
            wc = np.asarray(want["coordinates"].iloc[i], object)
            if gc.shape != wc.shape or not (gc == wc).all():
                raise AssertionError(f"{what}: coordinates of row {i}")
    return err


def compare_extras(got, want, keys, what, rtol=None):
    """Hold the extras columns ``keys`` of two pileup tables whose rows
    ``compare_tables`` matched: per row a list of the same length in the
    same order, equal element by element (values copied from frame columns),
    or within ``rtol`` (values a hook computed from window pixels; NaN
    positions equal)."""
    for key in keys:
        if key not in got or key not in want:
            raise AssertionError(f"{what}: no column {key}")
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            if (g is None) != (w is None):
                raise AssertionError(f"{what}: {key} of row {i} on one "
                                     "side only")
            if w is None:
                continue
            g, w = np.atleast_1d(g), np.atleast_1d(w)
            if g.shape != w.shape:
                raise AssertionError(f"{what}: {key} of row {i} holds "
                                     f"{g.shape} values, not {w.shape}")
            if rtol is None:
                if not (g == w).all():
                    raise AssertionError(f"{what}: {key} of row {i} differs")
            else:
                np.testing.assert_allclose(
                    g.astype(float), w.astype(float), rtol=rtol, atol=1e-7,
                    equal_nan=True, err_msg=f"{what}: {key} of row {i}")


def check_engine_modes(dev):
    """Phase 5a: every mode of the port's pileup() on the toy map, on
    ``dev`` against the plain version on the CPU."""
    from coolpuppy_tpu_torch import pileup

    clr, dense, weights = toy_cooler()
    expected = toy_expected(clr, dense, weights, toy_regions())
    for name in ENGINE_MODES:
        kw = mode_kwargs(name, expected)
        got = pileup(clr, toy_features(), view_df=toy_regions(), device=dev,
                     **kw, **F32_WIRE)
        want = pileup(clr, toy_features(), view_df=toy_regions(),
                      device="cpu", **kw)
        err = compare_tables(got, want, what=f"engine mode {name}",
                             **ENGINE_MODES_TOL)
        routes = (got["accumulate"].iloc[0], want["accumulate"].iloc[0])
        if routes != ("cuda_kernel", "plain"):
            raise AssertionError(f"engine mode {name}: routes {routes}")
        print(f"engine mode {name}: {len(got)} rows, n {list(got['n'])}, "
              f"route {got['accumulate'].iloc[0]}, max_abs_err {err:.3g} ok")


# bench_cooler's maps of this run: (generator state before, sizes) ->
# (Cooler, generator state after)
BENCH_MAPS = {}
# phase 5b's checked run, kept for phase 12a: "checked" -> (Cooler,
# features, table)
ENGINE = {}


def bench_cooler(rng, n_bins=20_000, n_contacts=12_000_000, binsize=10_000):
    """The synthetic chromosome of ``bench.py``'s engine-level benches
    (``bench_engine``, ``_bench_cooler``), drawn from ``rng`` with their
    RNG calls, as an in-memory Cooler: zipf(1.35) distances, Poisson(3)+1
    counts, 3% NaN-weight bins. The phases share one map: a later call from
    the same generator state returns the Cooler built first and leaves
    ``rng`` where drawing it would have."""
    from coolpuppy_tpu_torch import Cooler

    key = (repr(rng.bit_generator.state), n_bins, n_contacts, binsize)
    if key in BENCH_MAPS:
        clr, rng.bit_generator.state = BENCH_MAPS[key]
        return clr

    d = rng.zipf(1.35, 2 * n_contacts)
    d = d[d < n_bins][:n_contacts]
    i = rng.integers(0, n_bins, len(d))
    j = np.minimum(i + d, n_bins - 1)
    vals = rng.poisson(3.0, len(d)) + 1
    keep = i <= j
    weights = rng.uniform(0.5, 1.5, n_bins)
    weights[rng.random(n_bins) < 0.03] = np.nan
    clr = Cooler.from_arrays({"chr1": n_bins * binsize}, binsize,
                             (i[keep], j[keep], vals[keep]), weights=weights)
    BENCH_MAPS[key] = (clr, rng.bit_generator.state)
    return clr


def engine_workload(n_sites=20_000, n_bins=20_000, n_contacts=12_000_000,
                    binsize=10_000, seed=0):
    """``bench.py``'s ``bench_engine`` workload, with its RNG calls, as an
    in-memory Cooler: a 200 Mb chromosome at 10 kb, 12M zipf(1.35)
    contacts with Poisson(3)+1 counts, 3% NaN-weight bins, and ``n_sites``
    stranded 1 kb sites. Returns ``(Cooler, features)``."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    length = n_bins * binsize
    clr = bench_cooler(rng, n_bins, n_contacts, binsize)
    starts = np.sort(rng.choice(length - 10_000, n_sites, replace=False))
    feats = pd.DataFrame({
        "chrom": "chr1", "start": starts, "end": starts + 1_000,
        "name": ".", "score": 0,
        "strand": rng.choice(["+", "-"], n_sites),
    })
    return clr, feats


def check_modes_2d(dev):
    """Phase 6a: the trans, BEDPE, by-window and stripes modes of the port's
    pileup() on the toy map, on ``dev`` against the plain version on the
    CPU."""
    from coolpuppy_tpu_torch import pileup

    clr, dense, weights = toy_cooler()
    trans_expected = toy_trans_expected(clr, dense, weights, toy_regions())
    for name in MODES_2D:
        features, kw = mode_2d_inputs(name, trans_expected)
        with engine_patch(**MODE_PATCHES.get(name, {})):
            got = pileup(clr, features, view_df=toy_regions(), device=dev,
                         **kw, **F32_WIRE)
            want = pileup(clr, features, view_df=toy_regions(),
                          device="cpu", **kw)
        err = compare_tables(got, want, what=f"2D mode {name}",
                             **ENGINE_MODES_TOL)
        routes = (got["accumulate"].iloc[0], want["accumulate"].iloc[0])
        if routes != ("cuda_kernel", "plain"):
            raise AssertionError(f"2D mode {name}: routes {routes}")
        stripes = ""
        if "horizontal_stripe" in got:
            rows = [len(h) for h in got["horizontal_stripe"]]
            stripes = f", stripe rows {rows}"
        print(f"2D mode {name}: {len(got)} rows, n {list(got['n'])}, "
              f"route {routes[0]}, max_abs_err {err:.3g}{stripes} ok")


def modes_workload(n_sites=20_000, n_bins=20_000, n_contacts=12_000_000,
                   n_trans=1_500, trans_size=(10_000, 8_000, 3_000_000,
                                              2_000_000), seed=0):
    """``bench.py --modes``' inputs (``bench_modes``, bench.py:419-534)
    with its RNG calls: the engine map (``_bench_cooler``), ``n_sites``
    stranded 1 kb sites, 2M coordinate-sorted BEDPE pairs 12-199 bins apart,
    and 1,500 sites on each chromosome of the trans map
    (``trans_cooler``); the keywords cut it for tests. Returns ``(clr,
    feats, bedpe, clr2, tfeats)``."""
    import pandas as pd

    clr = bench_cooler(np.random.default_rng(0), n_bins, n_contacts)
    binsize = clr.binsize
    length = clr.n_bins * binsize
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(length - 10_000, n_sites, replace=False))
    feats = pd.DataFrame({
        "chrom": "chr1", "start": starts, "end": starts + 1_000,
        "name": ".", "score": 0,
        "strand": rng.choice(["+", "-"], n_sites),
    })
    n_pairs = min(2_000_000, n_sites * 100)
    a1 = rng.integers(0, clr.n_bins - 300, n_pairs)
    sep = rng.integers(12, 200, n_pairs)
    a2 = np.minimum(a1 + sep, clr.n_bins - 12)
    order = np.lexsort((a2, a1))
    a1, a2 = a1[order], a2[order]
    bedpe = pd.DataFrame({
        "chrom1": "chr1", "start1": a1 * binsize,
        "end1": a1 * binsize + 1_000,
        "chrom2": "chr1", "start2": a2 * binsize,
        "end2": a2 * binsize + 1_000,
    })
    clr2 = trans_cooler(*trans_size)
    n_t = n_trans
    t1 = np.sort(rng.choice(clr2.chromsizes["chr1"] - 10_000, n_t,
                            replace=False))
    t2 = np.sort(rng.choice(clr2.chromsizes["chr2"] - 10_000, n_t,
                            replace=False))
    tfeats = pd.DataFrame({
        "chrom": ["chr1"] * n_t + ["chr2"] * n_t,
        "start": np.concatenate([t1, t2]),
        "end": np.concatenate([t1, t2]) + 1_000,
    })
    return clr, feats, bedpe, clr2, tfeats


def trans_cooler(n1=10_000, n2=8_000, n_cis=3_000_000, n_trans=2_000_000,
                 binsize=10_000, seed=1):
    """``bench.py``'s ``_bench_cooler2`` with its RNG calls, in memory: two
    chromosomes of 10,000 and 8,000 bins, 3M zipf cis contacts each, 2M
    uniform trans contacts, 3% NaN-weight bins."""
    from coolpuppy_tpu_torch import Cooler

    rng = np.random.default_rng(seed)
    pix1, pix2, cnt = [], [], []
    for n, off in ((n1, 0), (n2, n1)):
        d = rng.zipf(1.35, 8 * n_cis // 3)
        d = d[d < n][:n_cis]
        i = rng.integers(0, n, len(d)) + off
        j = np.minimum(i + d, off + n - 1)
        pix1.append(i)
        pix2.append(j)
        cnt.append(rng.poisson(3.0, len(d)) + 1)
    pix1.append(rng.integers(0, n1, n_trans))
    pix2.append(rng.integers(n1, n1 + n2, n_trans))
    cnt.append(rng.poisson(1.0, n_trans) + 1)
    weights = rng.uniform(0.5, 1.5, n1 + n2)
    weights[rng.random(n1 + n2) < 0.03] = np.nan
    return Cooler.from_arrays(
        {"chr1": n1 * binsize, "chr2": n2 * binsize}, binsize,
        (np.concatenate(pix1), np.concatenate(pix2), np.concatenate(cnt)),
        weights=weights,
    )


def all_row(pups):
    """The 'all' row of a pileup table (by-window tables mark it in
    ``chrom``)."""
    key = "group" if "group" in pups.columns else "chrom"
    return pups.loc[pups[key] == "all"].iloc[0]


def check_modes(dev, sync, card, shapes=None):
    """Phase 6b: ``bench.py --modes``' four cells at full size. Returns the
    checked runs' kernel launch counts per cell; ``shapes``, a dict, gets
    each cell's ``shape_record``."""
    import coolpuppy_tpu_torch.ops.quad_gather as qg
    from coolpuppy_tpu_torch import CoordCreator, PileUpper, pileup

    t, (clr, feats, bedpe, clr2, tfeats) = timed(modes_workload, lambda: None)
    print(f"modes workload: {clr.n_bins} bins, {clr.n_pixels} pixels, "
          f"{len(feats)} sites, {len(bedpe)} bedpe pairs; trans map "
          f"{clr2.n_bins} bins, {clr2.n_pixels} pixels, {len(tfeats)} sites; "
          f"{t:.1f} s")
    n_t = len(tfeats) // 2
    k = min(200, n_t)
    inputs = {
        "stripes": (clr, feats, feats.iloc[:1_000]),
        "by_window": (clr, feats, feats.iloc[:1_000]),
        "bedpe": (clr, bedpe, bedpe.iloc[:10_000]),
        "trans": (clr2, tfeats,
                  tfeats.iloc[list(range(k)) + list(range(n_t, n_t + k))]),
    }
    launches = {}
    for cell, kw in MODES_CELLS.items():
        mclr, f, small = inputs[cell]
        # by_window's checked and plain-swapped runs fetch float32
        # accumulators: both sides round to float16 otherwise
        checked_kw = F32_FETCH if kw.get("by_window") else {}

        def run(f, mclr=mclr, kw=kw, **extra):
            return pileup(mclr, f, device=dev, **kw, **extra)

        t, warm = timed(lambda: run(small), sync)
        print(f"modes {cell} warm-up ({len(small)} rows): "
              f"{int(all_row(warm)['n'])} snips in {t:.2f} s")

        # the checked run; the stripes cell also records its stripe gathers
        # (one a chunk where the region streams)
        gathers = []
        gather = qg.QuadPileupSession.stripes_device

        def recording(self, r1, r2, f16=False):
            out = gather(self, r1, r2, f16=f16)
            gathers.append((self, r1, r2, out))
            return out

        qg.QuadPileupSession.stripes_device = recording
        try:
            qg.LAUNCHES = 0
            qg.VARIANT_LAUNCHES.update(staged=0, direct=0)
            with launch_shapes() as called:
                t, checked = timed(lambda: run(f, **checked_kw), sync)
            launches[cell] = qg.LAUNCHES
        finally:
            qg.QuadPileupSession.stripes_device = gather
        route = checked["accumulate"].iloc[0]
        if launches[cell] < 1 or route != "cuda_kernel":
            raise AssertionError(f"modes {cell}: {launches[cell]} launches, "
                                 f"route {route!r}; the kernel did not run")
        check_variant(f"modes {cell}", dev, launches[cell])
        row = all_row(checked)
        n_snips = int(row["n"])
        data = np.stack(checked["data"].to_list())
        if data.shape[1:] != (21, 21) or not np.isfinite(data).any():
            raise AssertionError(f"modes {cell} output: shape {data.shape}")
        print(f"modes {cell} checked run: {n_snips} snips, {len(checked)} "
              f"rows, launches {launches[cell]}, route {route}, {t:.2f} s")
        if cell == "stripes":
            check_stripe_sample(gathers, row, n_snips)
        del gathers

        plain = plain_swapped(f"modes {cell}", lambda: run(f, **checked_kw))
        err = compare_tables(checked, plain, rtol=ENGINE_RTOL, atol=1e-7,
                             what=f"modes {cell} kernel vs plain")
        print(f"modes {cell} kernel vs plain (whole run): counts exact, data "
              f"max_abs_err {err:.3g} (rtol {ENGINE_RTOL}) ok")
        del plain, checked

        # the timed runs build the PileUpper that pileup(**kw) builds, to
        # read its phase timers
        def run_timed(f=f, mclr=mclr, kw=kw):
            cc_kw = {k: v for k, v in kw.items()
                     if k not in ("store_stripes", "by_window")}
            cc = CoordCreator(f, mclr.binsize, nshifts=0, **cc_kw)
            pu = PileUpper(mclr, cc, store_stripes=kw.get("store_stripes",
                                                          False), device=dev)
            if kw.get("by_window"):
                return pu, pu.pileupsByWindowWithControl()
            return pu, pu.pileupsWithControl()

        timed_runs(f"modes {cell}", run_timed, MODES_REPEATS, n_snips, sync,
                   card)
        prof = profile_run(lambda: run(f), sync)
        print(f"modes {cell} device busy share of one run: " + prof["text"])
        rec = shape_record(f"modes {cell}", called.calls, prof["kernel_ms"],
                           launches[cell], card)
        if shapes is not None:
            shapes[cell] = rec
    return launches


def check_stripe_sample(gathers, row, n_snips):
    """The stripes cell: the stripe rows the card gathered (the chunks of
    one region's session), held against ``stripes_host`` on the fetched
    stack for a sample of snips (cast to float16 where the rows came back
    on the float16 stripe wire: bit for bit either way), and the table's
    planes against the gathered rows' count."""
    from coolpuppy_tpu_torch.ops.quad_gather import stripes_host

    if not gathers or len({id(g[0]) for g in gathers}) != 1:
        raise AssertionError(f"stripes: {len(gathers)} stripe gathers from "
                             f"{len({id(g[0]) for g in gathers})} sessions")
    sess = gathers[0][0]
    r1, r2 = (np.concatenate([g[i] for g in gathers]) for i in (1, 2))
    hv = np.concatenate([g[3].cpu().numpy() for g in gathers])
    if hv.shape != (n_snips, 2 * sess.W) or row["horizontal_stripe"].shape \
            != (n_snips, sess.W):
        raise AssertionError(f"stripes: planes {hv.shape}, table "
                             f"{row['horizontal_stripe'].shape}")
    rng = np.random.default_rng(0)
    pick = np.sort(rng.choice(len(r1), min(STRIPE_SAMPLE, len(r1)),
                              replace=False))
    want = stripes_host(sess.stiles.cpu().numpy(), sess.tile_stack.tile_map,
                        r1[pick], r2[pick], sess.W).astype(hv.dtype)
    np.testing.assert_array_equal(hv[pick], want,
                                  err_msg="stripes vs stripes_host")
    print(f"modes stripes: {len(pick)} of {len(r1)} stripe rows equal "
          f"stripes_host on the fetched stack ({hv.dtype} rows, "
          f"{int(np.isnan(want).sum())} NaN) ok")


def engine_snips(pups):
    """ROI n + control_n of the 'all' row (bench_engine's count)."""
    row = pups.loc[pups["orientation"] == "all"].iloc[0]
    return int(row["n"]) + int(row["control_n"])


def check_variant(what, dev, launches):
    """On the card, a checked run at W = 21 must have taken the staged
    kernel for every launch (a CPU rehearsal launches none)."""
    import coolpuppy_tpu_torch.ops.quad_gather as qg

    if dev.type == "cuda" and qg.VARIANT_LAUNCHES != {"staged": launches,
                                                      "direct": 0}:
        raise AssertionError(f"{what}: {launches} launches, by variant "
                             f"{qg.VARIANT_LAUNCHES}; expected the staged "
                             "kernel")


def check_engine(dev, sync, card, shapes=None):
    """Phase 5b: the engine at bench_engine's size. Returns the checked
    run's kernel launch count; ``shapes``, a dict, gets the cell's
    ``shape_record``."""
    import coolpuppy_tpu_torch.ops.quad_gather as qg
    from coolpuppy_tpu_torch import CoordCreator, PileUpper, pileup

    t, (clr, feats) = timed(engine_workload, lambda: None)
    print(f"engine workload: {clr.n_bins} bins, {clr.n_pixels} pixels, "
          f"{len(feats)} sites in {t:.1f} s")

    def run(f):
        return pileup(clr, f, device=dev, **ENGINE_KW)

    t, warm = timed(lambda: run(feats.iloc[:ENGINE_WARMUP_SITES]), sync)
    print(f"engine warm-up ({ENGINE_WARMUP_SITES} sites): "
          f"{engine_snips(warm)} snips in {t:.2f} s")

    qg.LAUNCHES = 0
    qg.VARIANT_LAUNCHES.update(staged=0, direct=0)
    with launch_shapes() as called:
        t, checked = timed(lambda: run(feats), sync)
    launches = qg.LAUNCHES
    route = checked["accumulate"].iloc[0]
    if launches < 1 or route != "cuda_kernel":
        raise AssertionError(f"engine run: {launches} launches, route "
                             f"{route!r}; the kernel did not run")
    check_variant("engine run", dev, launches)
    n_snips = engine_snips(checked)
    data = np.stack(checked["data"].to_list())
    if data.shape[1:] != (21, 21) or not np.isfinite(data).any():
        raise AssertionError(f"engine output: shape {data.shape}, finite "
                             f"{int(np.isfinite(data).sum())}")
    print(f"engine checked run: {n_snips} snips, {len(checked)} rows "
          f"({list(checked['orientation'])}), launches {launches}, route "
          f"{route}, {t:.2f} s")

    ENGINE["checked"] = (clr, feats, checked)
    plain = plain_swapped("engine", lambda: run(feats))
    err = compare_tables(checked, plain, rtol=ENGINE_RTOL, atol=1e-7,
                         what="engine kernel vs plain")
    print(f"engine kernel vs plain (whole run): n/control_n/num exact, "
          f"data max_abs_err {err:.3g} (rtol {ENGINE_RTOL}) ok")

    # the timed runs build the PileUpper that pileup(**ENGINE_KW) builds,
    # to read its phase timers
    def run_timed():
        kw = dict(ENGINE_KW)
        del kw["by_strand"]
        nshifts = kw.pop("nshifts")
        cc = CoordCreator(feats, clr.binsize, nshifts=nshifts, **kw)
        pu = PileUpper(clr, cc, control=nshifts > 0, device=dev)
        return pu, pu.pileupsByStrandWithControl()

    timed_runs("engine", run_timed, ENGINE_REPEATS, n_snips, sync, card,
               engine_snips)
    prof = profile_run(lambda: run(feats), sync)
    print("engine device busy share of one run: " + prof["text"])
    rec = shape_record("engine", called.calls, prof["kernel_ms"], launches,
                       card)
    if shapes is not None:
        shapes["engine"] = rec
    return launches


def toy_tads():
    """Toy TADs for the rescale modes: toy_features() 3 Mb wide (as
    tests/test_combo_matrix.py widens them)."""
    feats = toy_features()
    return feats.assign(end=feats["start"] + 3_000_000)


def toy_chrom_view(clr):
    """The toy map's whole chromosomes as a view, named after them."""
    import pandas as pd

    return pd.DataFrame({"chrom": list(clr.chromsizes),
                         "start": [0] * len(clr.chromsizes),
                         "end": list(clr.chromsizes.values()),
                         "name": list(clr.chromsizes)})


def phase7_inputs(group, name, clr, dense, weights):
    """``(features, view, pileup() keywords)`` of one RESCALE_MODES or
    WIDE_MODES entry on the toy map."""
    if group == "rescale":
        kw = dict(RESCALE_KW, **RESCALE_MODES[name])
        features, view = toy_tads(), toy_regions()
    else:
        kw = dict(WIDE_KW, **WIDE_MODES[name])
        features, view = toy_features(), toy_chrom_view(clr)
    if kw.pop("features", None) == "bedpe":
        bp = toy_bedpe()
        features = bp.assign(end1=bp["start1"] + 2_000_000,
                             end2=bp["start2"] + 2_000_000)
        kw["features_format"] = "bedpe"
    if kw.get("expected_df") is True:
        kw["expected_df"] = toy_expected(clr, dense, weights, view)
    return features, view, kw


def check_rescale_wide_toy(dev):
    """Phase 7a: the rescale and wide-window modes of the port's pileup()
    on the toy map, on ``dev`` against the plain PyTorch run on the CPU
    (``compare_tables``: counts exact, ``data`` and stripe planes within
    rtol 1e-5)."""
    from coolpuppy_tpu_torch import pileup

    import coolpuppy_tpu_torch.ops.gather as ga

    clr, dense, weights = toy_cooler()
    wide = "generic_cuda" if dev.type == "cuda" else "generic_torch"
    for group, modes, route, cpu_route in (
            ("rescale", RESCALE_MODES, "rescale_torch", "rescale_torch"),
            ("wide", WIDE_MODES, wide, "generic_torch")):
        for name in modes:
            features, view, kw = phase7_inputs(group, name, clr, dense,
                                               weights)
            ga.LAUNCHES = 0
            got = pileup(clr, features, view_df=view, device=dev, **kw,
                         **F32_WIRE)
            launches = ga.LAUNCHES
            want = pileup(clr, features, view_df=view, device="cpu", **kw)
            err = compare_tables(got, want, what=f"{group} mode {name}",
                                 **ENGINE_MODES_TOL)
            routes = (got["accumulate"].iloc[0], want["accumulate"].iloc[0])
            if routes != (route, cpu_route) or (
                    route == "generic_cuda") != (launches > 0):
                raise AssertionError(f"{group} mode {name}: routes {routes}"
                                     f", {launches} wide kernel launches")
            shape = np.asarray(got["data"].iloc[0]).shape
            print(f"{group} mode {name}: {len(got)} rows, n "
                  f"{list(got['n'])}, data {shape}, route {route}, "
                  f"wide kernel launches {launches}, max_abs_err {err:.3g} "
                  "ok")


def rescale_workload(n_tads=2_000, n_bins=20_000, n_contacts=12_000_000,
                     seed=0):
    """``bench.py --rescale``'s inputs (``bench_rescale``) with its RNG
    calls: the engine map (``_bench_cooler``) and ``n_tads`` TADs 20-200
    bins wide at sorted distinct starts. Returns ``(Cooler, features)``."""
    import pandas as pd

    clr = bench_cooler(np.random.default_rng(0), n_bins, n_contacts)
    binsize = clr.binsize
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(np.arange(100, clr.n_bins - 300), n_tads,
                                replace=False)) * binsize
    widths = rng.integers(20, 200, n_tads) * binsize
    return clr, pd.DataFrame({"chrom": "chr1", "start": starts,
                              "end": starts + widths})


def resize_op32(n_in, R):
    """The area-overlap operator [R, n_in] built with the float32 steps of
    ``ops/rescale.resize_matrix`` (numpy float32 arithmetic), returned as
    float64. Where an output cell's edge falls on an input cell's edge,
    float32 rounding leaves an overlap of up to ~1e-5 that the exact
    operator (``area_resize_host``) does not have, and that overlap decides
    whether a NaN pixel there touches the output pixel: the host loop uses
    the device's operator so that counts compare exactly."""
    f32 = np.float32
    i = np.arange(R, dtype=f32)[:, None]
    k = np.arange(n_in, dtype=f32)[None, :]
    cell = f32(n_in) * (f32(1) / f32(R))
    overlap = np.maximum(f32(0), np.minimum((i + f32(1)) * cell, k + f32(1))
                         - np.maximum(i * cell, k))
    return (overlap / max(cell, f32(1e-30))).astype(np.float64)


def rescale_host_oracle(clr, feats, R, expected=None, ignore_diags=2):
    """``bench.py``'s reference-style host loop (bench.py:387-414) as the
    engine defines a rescaled local pileup: per TAD (``rescale_flank=1``)
    the CSR slice of the balanced map, bad bins and |diag| < ignore_diags
    NaN, division by the expected of each diagonal when ``expected`` (a
    by-distance table) is given, symmetrization, and the NaN-aware area
    resize in float64 with the engine's rules (``resize_op32``): an output
    pixel the resized NaN plane touches by more than 1e-6 adds nothing, an
    all-NaN snip adds 0 with count 1. Returns the per-pixel mean (then
    symmetrized, as the engine finalizes local pileups) and count."""
    import warnings

    from coolpuppy_tpu_torch.ops.rescale import TOUCH_EPS

    csr = clr.fetch_coo("chr1", balance="weight").tocsr()
    bad = clr.bad_bin_mask("chr1")
    evec = None
    if expected is not None:
        evec = np.full(clr.n_bins, np.nan)
        evec[expected["dist"].to_numpy(int)] = expected["balanced.avg"]
    total = np.zeros((R, R))
    count = np.zeros((R, R))
    bs = clr.binsize
    for st, en in zip(feats["start"] // bs, feats["end"] // bs):
        w = int(en - st)
        lo, hi = int(st) - w, int(en) + w
        if lo < 0 or hi > clr.n_bins:
            continue
        data = csr[lo:hi, lo:hi].toarray().astype(float)
        data[bad[lo:hi], :] = np.nan
        data[:, bad[lo:hi]] = np.nan
        d = np.abs(np.subtract.outer(np.arange(hi - lo), np.arange(hi - lo)))
        data[d < ignore_diags] = np.nan
        if evec is not None:
            with np.errstate(divide="ignore", invalid="ignore"):
                data = data / evec[d]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            data = np.nanmean(np.dstack((data, data.T)), 2)
        nans = ~np.isfinite(data)
        if nans.all():
            count += 1
            continue
        op = resize_op32(hi - lo, R)
        rs = op @ np.where(nans, 0.0, data) @ op.T
        touched = op @ nans.astype(float) @ op.T > TOUCH_EPS
        total += np.where(touched, 0.0, rs)
        count += ~touched
    with np.errstate(divide="ignore", invalid="ignore"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        mean = total / count
        mean = np.nanmean(np.dstack((mean, mean.T)), 2)
    return mean, count


def check_oracle(table, want, what):
    """The 'all' row of a pileup table against a host oracle's (mean,
    count): count and mean within ORACLE_RTOL, NaN positions equal."""
    row = all_row(table)
    mean, count = want
    np.testing.assert_allclose(np.asarray(row["num"], float), count,
                               rtol=ORACLE_RTOL, atol=0,
                               err_msg=f"{what}: count")
    np.testing.assert_allclose(np.asarray(row["data"], float), mean,
                               rtol=ORACLE_RTOL, atol=1e-9, equal_nan=True,
                               err_msg=f"{what}: mean")
    fin = np.isfinite(mean)
    err = float(np.abs(np.asarray(row["data"], float)[fin]
                       - mean[fin]).max(initial=0.0))
    return err, int(fin.sum())


class step_timer:
    """Device-timeline span of every call of an engine step
    (``rescale_accumulate`` or ``generic_accumulate``, looked up in the
    engine module at call time) during a block: CUDA events around each
    call on a CUDA device (the span includes the device's idle gaps while
    the host launches), the host clock elsewhere. ``ms`` and ``calls``
    after the block."""

    MODULE = "coolpuppy_tpu_torch.engine.pileup"

    def __init__(self, name, dev):
        self.name, self.dev = name, dev
        self.ms, self.calls = 0.0, 0

    def __enter__(self):
        import torch

        engine = importlib.import_module(self.MODULE)
        self.step = step = getattr(engine, self.name)
        spans = self.spans = []

        def timed_step(*a, **k):
            if self.dev.type == "cuda":
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                out = step(*a, **k)
                t1.record()
                spans.append((t0, t1))
            else:
                t = time.perf_counter()
                out = step(*a, **k)
                spans.append(time.perf_counter() - t)
            return out

        setattr(engine, self.name, timed_step)
        return self

    def __exit__(self, *exc):
        import torch

        engine = importlib.import_module(self.MODULE)
        setattr(engine, self.name, self.step)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            self.ms = sum(a.elapsed_time(b) for a, b in self.spans)
        else:
            self.ms = 1e3 * sum(self.spans)
        self.calls = len(self.spans)


def time_cell(what, run_timed, count, n_snips, step, dev, sync, card,
              profiled):
    """CELL_REPEATS timed runs of ``run_timed`` (returns ``(PileUpper,
    table)``; ``count(table)`` must give ``n_snips``): median wall, snips/s,
    the engine's phase breakdown of the median run, the device time of the
    engine ``step`` in one run and the busy share of one profiled run of
    ``profiled``."""
    timed_runs(what, run_timed, CELL_REPEATS, n_snips, sync, card, count)
    with step_timer(step, dev) as st:
        run_timed()
    print(f"{what} {step}: device span {st.ms:.3f} ms (CUDA events around "
          f"each of {st.calls} calls, idle gaps included) in one run")
    print(f"{what} device busy share of one run: "
          + busy_share(profiled, sync))
    return st.ms


def check_rescale_cell(dev, sync, card, workload=None):
    """Phase 7b: ``bench.py --rescale`` on the card: a warm-up, a checked
    run (route ``rescale_torch``), the first RESCALE_ORACLE_TADS TADs held
    against ``rescale_host_oracle``, the same with the expected table of
    the map (BASELINE's variant) against the oracle that divides by it,
    and timed runs of both. Returns the rescale step's device ms of one
    run of each variant."""
    import torch

    from coolpuppy_tpu_torch import CoordCreator, PileUpper, pileup
    from coolpuppy_tpu_torch.expected import expected_cis

    t, (clr, feats) = timed(workload or rescale_workload, lambda: None)
    print(f"rescale workload: {clr.n_bins} bins, {clr.n_pixels} pixels, "
          f"{len(feats)} TADs in {t:.1f} s")
    R = RESCALE_CELL_KW["rescale_size"]
    t, exp = timed(lambda: expected_cis(clr), lambda: None)
    print(f"rescale expected_cis: {len(exp)} diagonals in {t:.2f} s")

    def run(f, **kw):
        return pileup(clr, f, device=dev, **dict(RESCALE_CELL_KW, **kw))

    t, warm = timed(lambda: run(feats), sync)
    print(f"rescale warm-up: {int(all_row(warm)['n'])} snips in {t:.2f} s")
    ms = {}
    for variant, kw in (("local", {}), ("local_ooe", {"expected_df": exp})):
        what = f"rescale {variant}"
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is enabled for float32 matmuls")
        t, checked = timed(lambda: run(feats, **kw), sync)
        route = checked["accumulate"].iloc[0]
        row = all_row(checked)
        n_snips = int(row["n"])
        data = np.asarray(row["data"], float)
        if route != "rescale_torch" or data.shape != (R, R) or \
                not np.isfinite(data).any() or str(dev) not in \
                checked["device"].iloc[0]:
            raise AssertionError(f"{what}: route {route!r}, device "
                                 f"{checked['device'].iloc[0]!r}, data "
                                 f"{data.shape}")
        print(f"{what} checked run: {n_snips} snips, route {route} on "
              f"{checked['device'].iloc[0]}, tf32 "
              f"{torch.backends.cuda.matmul.allow_tf32}, {t:.2f} s")
        sub = feats.iloc[:RESCALE_ORACLE_TADS]
        t, want = timed(lambda: rescale_host_oracle(
            clr, sub, R, expected=kw.get("expected_df")), lambda: None)
        err, n_fin = check_oracle(run(sub, **kw, **F32_WIRE), want, what)
        print(f"{what} vs the host loop ({len(sub)} TADs, {t:.1f} s): "
              f"count and mean within rtol {ORACLE_RTOL}, {n_fin} finite "
              f"pixels, max_abs_err {err:.3g} ok")

        def run_timed(kw=kw):
            cc_kw = {k: v for k, v in RESCALE_CELL_KW.items()
                     if k not in ("rescale", "rescale_size")}
            cc = CoordCreator(feats, clr.binsize, nshifts=0, **cc_kw)
            pu = PileUpper(clr, cc, rescale=True, rescale_size=R,
                           expected=kw.get("expected_df", False),
                           device=dev)
            return pu, pu.pileupsWithControl()

        ms[variant] = time_cell(
            what, run_timed, lambda p: int(all_row(p)["n"]), n_snips,
            "rescale_accumulate", dev, sync, card,
            lambda kw=kw: run(feats, **kw),
        )
    return ms


class wide_calls:
    """Record the arguments of every call of the engine's generic step
    (``generic_accumulate``, looked up in the engine module at call time)
    during a block (``calls``: ``(args, kwargs)``), for the kernel's bound
    on that run's inputs and for holding the kernel against its plain
    version on the same inputs after the block."""

    MODULE = "coolpuppy_tpu_torch.engine.pileup"

    def __enter__(self):
        engine = importlib.import_module(self.MODULE)
        self.inner = inner = engine.generic_accumulate
        self.calls = calls = []

        def recording(*args, **kw):
            calls.append((args, kw))
            return inner(*args, **kw)

        engine.generic_accumulate = recording
        return self

    def __exit__(self, *exc):
        importlib.import_module(self.MODULE).generic_accumulate = self.inner


def wide_call_shape(stiles, tile_map, r1, r2, cid, W, C, **_):
    """The bound's record of one ``generic_accumulate`` call: its work
    items (``wide_items``), the stack pixels its windows cover, the groups
    it adds to, its snips, W and C."""
    import torch

    from coolpuppy_tpu_torch.ops.gather import wide_items, wide_slots

    slots, istart, icount, snips = wide_items(tile_map, r1, r2, cid, W, C)
    return dict(pixels=covered_pixels(slots, istart, icount, snips, W),
                groups=int(torch.unique(cid).numel()),
                items=int(istart.shape[0]), slots=wide_slots(W) ** 2,
                snips=int(snips.shape[0]), W=int(W), C=int(C))


def wide_bound(calls):
    """The least time the card could take for the generic step's ``calls``
    (``wide_call_shape`` records): the bytes it must move (the stack pixels
    its windows cover, the snip words and each item's span and R x R slots
    read once; float32 ``sum``, ``num`` and ``poison`` of the groups it adds
    to written once) over the card's memory rate, against one float add
    per window pixel over its float32 rate. Returns ``(ms, "bytes" or
    "operations", bytes, operations)``."""
    nbytes = sum(4 * c["pixels"] + 4 * c["snips"]
                 + c["items"] * (8 + 4 * c["slots"])
                 + 12 * c["groups"] * c["W"] ** 2 for c in calls)
    ops = sum(c["snips"] * c["W"] ** 2 for c in calls)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, nbytes, ops


def wide_shape_record(what, shapes, kernel_ms, launches, plain_ms, card):
    """Print and return one shape's row of the wide kernel's table (as
    ``shape_record`` does for the quad kernel's)."""
    ms, by, nbytes, ops = wide_bound(shapes)
    rec = dict(launches=launches, bound_ms=ms, bound_by=by, ms=kernel_ms,
               plain_ms=plain_ms,
               **{key: sum(c[key] for c in shapes)
                  for key in ("pixels", "groups", "items", "snips")},
               W=max(c["W"] for c in shapes),
               C=max(c["C"] for c in shapes))
    share = ("not measured" if not kernel_ms
             else f"{kernel_ms:.3f} ms, bound/kernel {ms / kernel_ms:.4f}")
    print(f"{what} wide kernel bound: {ms:.5f} ms by {by} ({nbytes} bytes, "
          f"{ops} adds; W {rec['W']}, pixels {rec['pixels']}, groups "
          f"{rec['groups']}, items {rec['items']}, snips {rec['snips']}, C "
          f"{rec['C']}, launches {launches}); kernel {share}; plain version "
          f"{'not measured' if plain_ms is None else f'{plain_ms:.3f} ms'} "
          f"on {card}")
    return rec


def compare_wide(got, want, what, rtol=WIDE_RTOL, atol=1e-6):
    """The wide kernel's accumulators (and stripes) against the plain
    version's: ``num`` and ``poison`` exact, ``sum`` within tolerance,
    stripe planes bit for bit with NaN positions equal. Returns the largest
    absolute difference of the sums."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: keys {sorted(got)} vs {sorted(want)}")
    for k in ("num", "poison"):
        g, w = got[k].cpu().numpy(), want[k].cpu().numpy()
        if not np.array_equal(g, w):
            raise AssertionError(f"{what}: {k} differs at "
                                 f"{int((g != w).sum())} entries")
    gs, ws = got["sum"].cpu().numpy(), want["sum"].cpu().numpy()
    if not np.isfinite(gs).all() or not np.isfinite(ws).all():
        raise AssertionError(f"{what}: a sum is not finite")
    np.testing.assert_allclose(gs, ws, rtol=rtol, atol=atol, err_msg=what)
    for k in ("horizontal_stripe", "vertical_stripe"):
        if k in got:
            np.testing.assert_array_equal(got[k].cpu().numpy(),
                                          want[k].cpu().numpy(),
                                          err_msg=f"{what} {k}")
    return float(np.abs(gs - ws).max(initial=0.0))


def wide_case(W, seed, n_snips=60, groups=4, missing=2, long_run=0):
    """A wide-kernel input on the CPU: a normalized cis stack of W + 330
    bins with +inf poison (zero ``evec`` entries) and NaN-masked bins, a
    snip stream whose windows cross tile edges, a tile that holds snips of
    every group, ``long_run`` more snips in the first tile and the last
    group (a run cut into items at ``ITEM_MAX``), and ``missing`` tiles the
    windows touch removed from the map (slot 0, all NaN). Returns
    ``(stiles, tile_map, r1, r2, cid)`` as CPU tensors (int64 map and
    snips)."""
    import torch
    from scipy import sparse as sp

    from coolpuppy_tpu_torch.ops.tiles import build_tile_stack, normalized_stack

    rng = np.random.default_rng(seed)
    n = W + 330
    dense = rng.gamma(1.0, 1.0, (n, n)) * (rng.random((n, n)) < 0.3)
    dense = np.triu(dense) + np.triu(dense, 1).T
    r1 = rng.integers(0, n - W + 1, n_snips)
    r2 = rng.integers(0, n - W + 1, n_snips)
    r1[:8], r2[:8] = 3 + np.arange(8), 5 + np.arange(8)  # one tile
    r1[8:12] = (0, 127, 128, n - W)
    cid = rng.integers(0, groups, n_snips)
    cid[:8] = np.arange(8) % groups
    # the long run's windows at offsets drawn in the first tile: one window
    # repeated a thousand times would add one value to itself in float32,
    # whose rounding error grows with the count in any order of adds
    r1 = np.r_[r1, rng.integers(0, B, long_run)]
    r2 = np.r_[r2, rng.integers(0, B, long_run)]
    cid = np.r_[cid, np.full(long_run, groups - 1)]
    ts = build_tile_stack(sp.coo_matrix(dense), B, r1=r1, r2=r2, window1=W,
                          window2=W)
    valid = np.zeros(n + 512, np.float32)
    valid[:n] = rng.random(n) > 0.05
    evec = np.full(n + 512, np.nan, np.float32)
    evec[:n] = 4.0 / (1.0 + np.arange(n))
    evec[rng.integers(3, n, 3)] = 0.0
    stiles = normalized_stack(ts, valid, valid, evec, "cpu", ooe=True,
                              cis=True, ignore_diags=2)
    tmap = np.asarray(ts.tile_map, np.int64).copy()
    used = np.flatnonzero(tmap.ravel())
    tmap.ravel()[rng.choice(used, missing, replace=False)] = 0
    return (stiles, *(torch.from_numpy(np.asarray(a, np.int64))
                      for a in (tmap, r1, r2, cid)))


def wide_kernel_cases():
    """Phase 7e's inputs: ``(name, W, C, case)`` per WIDE_KERNEL_W, with
    ``case`` a ``wide_case`` of WIDE_CASE_SNIPS snips in 5 groups and 3
    missing tiles; at W = 201 and 401 a run of ``ITEM_MAX + 77`` more snips
    in one tile and group."""
    from coolpuppy_tpu_torch.ops.gather import ITEM_MAX

    for i, W in enumerate(WIDE_KERNEL_W):
        long_run = ITEM_MAX + 77 if W in (201, 401) else 0
        yield (f"W={W}", W, 8, wide_case(W, 300 + i, n_snips=WIDE_CASE_SNIPS,
                                          groups=5, missing=3,
                                          long_run=long_run))


def check_wide_case(name, W, C, case, dev, sync):
    """One phase-7e case on ``dev``: ``generic_accumulate`` with stripes
    (the wide kernel on a card: it must launch once) against
    ``generic_accumulate_plain`` on the same tensors (``compare_wide``),
    then each timed once: the kernel between CUDA events around its launch,
    the plain version between CUDA events. Returns ``(max_abs_err,
    launches, kernel ms, plain ms, want)``."""
    import coolpuppy_tpu_torch.ops.gather as ga

    args = tuple(x.to(dev) for x in case)
    want = ga.generic_accumulate_plain(*args, W, C, stripes=True)
    before = ga.LAUNCHES
    got = ga.generic_accumulate(*args, W, C, stripes=True)
    sync()
    launches = ga.LAUNCHES - before
    if launches != 1:
        raise AssertionError(f"wide kernel {name}: {launches} launches; "
                             "the kernel did not run")
    err = compare_wide(got, want, what=f"wide kernel vs plain {name}")
    with quad_kernel_events(entries=WIDE_ENTRIES) as ev:
        ga.generic_accumulate(*args, W, C)
        sync()
    plain_ms = event_ms(lambda: ga.generic_accumulate_plain(*args, W, C),
                        sync)
    return err, launches, sum(ev.ms), plain_ms, want


def check_wide_kernels(dev, sync, card):
    """Phase 7e: the wide kernel against its plain version at every W of
    WIDE_KERNEL_W (``wide_kernel_cases``: missing tiles, +inf poison,
    NaN-masked pixels, several groups in one tile, a run cut at
    ``ITEM_MAX``, stripes), each with its bound. Returns ``(max_abs_err,
    {name: shape record})``."""
    from coolpuppy_tpu_torch.ops.gather import wide_bands, wide_slots

    errs, shapes = [], {}
    for name, W, C, case in wide_kernel_cases():
        err, launches, ms, plain_ms, want = check_wide_case(
            name, W, C, case, dev, sync)
        errs.append(err)
        shape = wide_call_shape(*(x.to(dev) for x in case), W, C)
        print(f"wide kernel vs plain {name}: R {wide_slots(W)}, bands "
              f"{wide_bands(W)}, items {shape['items']}, snips "
              f"{shape['snips']}, C {C}, launches {launches}, num "
              f"{int(want['num'].sum())}, poison {int(want['poison'].sum())}"
              f", stripes equal, max_abs_err {err:.3g} ok")
        shapes[f"7e {name}"] = wide_shape_record(
            f"7e {name}", [shape], ms, launches, plain_ms, card)
    return max(errs), shapes


def check_wide_cell(dev, sync, card, workload=None):
    """Phase 7c: 201-bin windows on the engine map (``engine_workload``
    with WIDE_CELL_SITES sites): a checked run whose generic step must
    launch the wide kernel (route ``generic_cuda`` on a card), each of its
    calls held against the plain version on the same inputs (counts exact,
    ``sum`` rtol 1e-4), the same run with the plain version in the engine's
    step (``data`` rtol 1e-4, counts exact), the same call on
    WIDE_SUBSET_SITES sites on the card against the CPU, timed runs, and
    the kernel's time over its launches beside its bound and the plain
    version's. Returns the wide kernel's record (launches, ms, plain_ms,
    bound, max_abs_err, ``shapes``), with the generic step's device span of
    one run as ``step_ms``."""
    import torch

    import coolpuppy_tpu_torch.ops.gather as ga
    from coolpuppy_tpu_torch import CoordCreator, PileUpper, pileup

    t, (clr, feats) = timed(
        workload or (lambda: engine_workload(n_sites=WIDE_CELL_SITES)),
        lambda: None,
    )
    print(f"wide workload: {clr.n_bins} bins, {clr.n_pixels} pixels, "
          f"{len(feats)} sites in {t:.1f} s")

    def run(f, device=dev):
        return pileup(clr, f, device=device, **WIDE_CELL_KW)

    W = 2 * (WIDE_CELL_KW["flank"] // clr.binsize) + 1
    expect = "generic_cuda" if dev.type == "cuda" else "generic_torch"
    ga.LAUNCHES = 0
    with wide_calls() as called, \
            quad_kernel_events(entries=WIDE_ENTRIES) as ev:
        t, checked = timed(lambda: run(feats), sync)
    launches = ga.LAUNCHES
    route = checked["accumulate"].iloc[0]
    n_snips = engine_snips(checked)
    data = np.stack(checked["data"].to_list())
    if launches < 1 or route != expect or data.shape[1:] != (W, W) or \
            not np.isfinite(data).any():
        raise AssertionError(f"wide checked run: {launches} launches, route "
                             f"{route!r}, data {data.shape}")
    kernel_ms = sum(ev.ms)
    print(f"wide checked run: {n_snips} snips, {len(checked)} rows, W {W}, "
          f"route {route} on {checked['device'].iloc[0]}, launches "
          f"{launches} in {len(called.calls)} step calls, {t:.2f} s")

    errs, shapes = [], []
    for args, kw in called.calls:
        got = ga.generic_accumulate(*args, **kw)
        want = ga.generic_accumulate_plain(*args, **kw)
        errs.append(compare_wide(got, want, rtol=HEADLINE_RTOL,
                                 what="wide step call vs plain"))
        shapes.append(wide_call_shape(*args))
        del got, want
    print(f"wide step calls vs plain on the same inputs ({len(errs)} "
          f"calls): counts exact, sum max_abs_err {max(errs):.3g} (rtol "
          f"{HEADLINE_RTOL}) ok")
    del called

    spans = []
    engine = importlib.import_module(wide_calls.MODULE)
    routed = engine.generic_accumulate

    def plain(*a, **k):
        if dev.type != "cuda":
            t0 = time.perf_counter()
            out = ga.generic_accumulate_plain(*a, **k)
            spans.append(1e3 * (time.perf_counter() - t0))
            return out
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = ga.generic_accumulate_plain(*a, **k)
        t1.record()
        spans.append((t0, t1))
        return out

    engine.generic_accumulate = plain
    try:
        ga.LAUNCHES = 0
        swapped = run(feats)
        if ga.LAUNCHES != 0:
            raise AssertionError("wide plain-swapped run launched the kernel")
    finally:
        engine.generic_accumulate = routed
    sync()
    PLAIN_MS["wide"] = sum(x if isinstance(x, float) else
                           x[0].elapsed_time(x[1]) for x in spans)
    err = compare_tables(checked, swapped, rtol=ENGINE_RTOL, atol=1e-7,
                         what="wide kernel vs plain")
    print(f"wide kernel vs plain (whole run, plain version "
          f"{PLAIN_MS['wide']:.1f} ms): counts exact, data max_abs_err "
          f"{err:.3g} (rtol {ENGINE_RTOL}) ok")
    del swapped

    sub = feats.iloc[:WIDE_SUBSET_SITES]
    got = run(sub)
    t, want = timed(lambda: run(sub, device="cpu"), lambda: None)
    err = compare_tables(got, want, rtol=ENGINE_RTOL, atol=1e-7,
                         what="wide subset card vs cpu")
    print(f"wide subset ({len(sub)} sites, {engine_snips(want)} snips, CPU "
          f"{t:.1f} s) card vs CPU: counts exact, data max_abs_err "
          f"{err:.3g} (rtol {ENGINE_RTOL}) ok")

    def run_timed():
        kw = {k: v for k, v in WIDE_CELL_KW.items()
              if k not in ("by_strand", "nshifts")}
        cc = CoordCreator(feats, clr.binsize,
                          nshifts=WIDE_CELL_KW["nshifts"], **kw)
        pu = PileUpper(clr, cc, control=True, device=dev)
        return pu, pu.pileupsByStrandWithControl()

    timed_runs("wide", run_timed, CELL_REPEATS, n_snips, sync, card,
               engine_snips)
    with step_timer("generic_accumulate", dev) as st:
        run_timed()
    print(f"wide generic_accumulate: device span {st.ms:.3f} ms (CUDA "
          f"events around each of {st.calls} calls, idle gaps included) in "
          "one run")
    print("wide device busy share of one run: "
          + busy_share(lambda: run(feats), sync, "wide_accumulate"))
    rec = wide_shape_record("7c", shapes, kernel_ms, launches,
                            PLAIN_MS["wide"], card)
    print(f"wide kernel (summed over the checked run's launches, CUDA "
          f"events): {kernel_ms:.3f} ms in {launches} launches; plain "
          f"version {PLAIN_MS['wide']:.3f} ms; bound {rec['bound_ms']:.5f} ms"
          f" by {rec['bound_by']} on {card}")
    return dict(launches=launches, max_abs_err=max(errs), ms=kernel_ms,
                plain_ms=PLAIN_MS["wide"], bound_ms=rec["bound_ms"],
                bound_by=rec["bound_by"], step_ms=st.ms,
                shapes={"wide": rec})


def direct_swapped(what, run):
    """``run`` with ``quad_accumulate`` swapped for the direct kernel, the
    first design, routed nowhere since the staged kernel took every W: each
    call's items cut into single-group runs (``split_runs``, as the direct
    kernel takes them) and launched there, the launch counts set to 0 just
    before. Every launch must be the direct kernel's. Returns ``(table,
    launches)``."""
    import torch

    import coolpuppy_tpu_torch.ops.quad_gather as qg

    def direct(stiles, k, qstart, qcount, snips, W, C):
        items = qg.split_runs(*(a.cpu().numpy()
                                for a in (snips, k, qstart, qcount)))
        items = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
                 .to(stiles.device) for a in items]
        s, n = qg.quad_accumulate_direct(stiles, *items, snips, W, C)
        return s.to(torch.float64), n.to(torch.float64)

    routed = qg.quad_accumulate
    qg.quad_accumulate = direct
    try:
        qg.LAUNCHES = 0
        qg.VARIANT_LAUNCHES.update(staged=0, direct=0)
        table = run()
        launches, took = qg.LAUNCHES, dict(qg.VARIANT_LAUNCHES)
    finally:
        qg.quad_accumulate = routed
    if launches < 1 or took != {"staged": 0, "direct": launches} or \
            table["accumulate"].iloc[0] != "cuda_kernel":
        raise AssertionError(f"{what}: direct-swapped run launched {took}, "
                             f"route {table['accumulate'].iloc[0]!r}")
    return table, launches


def check_w119_cell(dev, sync, card, shapes=None, workload=None):
    """Phase 7d: 119-bin windows over the engine cell's sites
    (``W119_CELL_KW``), where the staged kernel runs two bands an item: a
    warm-up, a checked run that must launch the staged kernel only, the
    same run with the direct kernel in its place (counts exact, ``data``
    rtol 1e-4), W119_SUBSET_SITES sites card against CPU, timed runs and a
    profiled run (busy share); each kernel's device time is the sum over
    its launches in the checked and the direct-swapped run, between CUDA
    events around each launch (``quad_kernel_events``), beside the bound
    and the plain-swapped run's plain version (counts exact, ``data`` rtol
    1e-4 against the checked run).
    Returns the checked run's launches; ``shapes``, a dict, gets the cell's
    ``shape_record`` with the direct kernel's ms beside it."""
    import coolpuppy_tpu_torch.ops.quad_gather as qg
    from coolpuppy_tpu_torch import CoordCreator, PileUpper, pileup

    t0 = time.perf_counter()
    t, (clr, feats) = timed(workload or engine_workload, lambda: None)
    W = 2 * (W119_CELL_KW["flank"] // clr.binsize) + 1
    print(f"w119 workload: {clr.n_bins} bins, {clr.n_pixels} pixels, "
          f"{len(feats)} sites, W {W} in {t:.1f} s")

    def run(f, device=dev, **extra):
        return pileup(clr, f, device=device, **W119_CELL_KW, **extra)

    def since():
        return f"(at {time.perf_counter() - t0:.1f} s)"

    t, warm = timed(lambda: run(feats.iloc[:ENGINE_WARMUP_SITES]), sync)
    print(f"w119 warm-up ({ENGINE_WARMUP_SITES} sites): "
          f"{engine_snips(warm)} snips in {t:.2f} s")
    with quad_kernel_events() as staged_ev:
        checked, launches, calls, t = kernel_run(
            "w119 run", lambda: run(feats), dev)
    n_snips = engine_snips(checked)
    data = np.stack(checked["data"].to_list())
    if data.shape[1:] != (W, W) or not np.isfinite(data).any():
        raise AssertionError(f"w119 output: shape {data.shape}, finite "
                             f"{int(np.isfinite(data).sum())}")
    print(f"w119 checked run: {n_snips} snips, {len(checked)} rows, W {W}, "
          f"launches {launches} (staged only), route "
          f"{checked['accumulate'].iloc[0]}, {t:.2f} s {since()}")

    with quad_kernel_events() as direct_ev:
        direct, direct_launches = direct_swapped("w119", lambda: run(feats))
    err = compare_tables(checked, direct, rtol=ENGINE_RTOL, atol=1e-7,
                         what="w119 staged vs direct kernel")
    print(f"w119 staged vs direct kernel (whole run, {direct_launches} "
          f"direct launches): counts exact, data max_abs_err {err:.3g} (rtol "
          f"{ENGINE_RTOL}) ok {since()}")
    chunk = qg.PLAIN_CHUNK
    qg.PLAIN_CHUNK = 8192  # bounds the plain version's index tensors
    try:
        plain = plain_swapped("w119", lambda: run(feats))
    finally:
        qg.PLAIN_CHUNK = chunk
    err = compare_tables(checked, plain, rtol=ENGINE_RTOL, atol=1e-7,
                         what="w119 kernel vs plain")
    print(f"w119 kernel vs plain (whole run, plain version "
          f"{PLAIN_MS['w119']:.1f} ms): counts exact, data max_abs_err "
          f"{err:.3g} (rtol {ENGINE_RTOL}) ok {since()}")
    del plain, direct

    sub = feats.iloc[:W119_SUBSET_SITES]
    got = run(sub, **F32_WIRE)
    t, want = timed(lambda: run(sub, device="cpu"), lambda: None)
    err = compare_tables(got, want, rtol=ENGINE_RTOL, atol=1e-7,
                         what="w119 subset card vs cpu")
    print(f"w119 subset ({len(sub)} sites, {engine_snips(want)} snips, CPU "
          f"{t:.1f} s) card vs CPU: counts exact, data max_abs_err "
          f"{err:.3g} (rtol {ENGINE_RTOL}) ok {since()}")

    def run_timed():
        kw = {k: v for k, v in W119_CELL_KW.items()
              if k not in ("by_strand", "nshifts")}
        cc = CoordCreator(feats, clr.binsize,
                          nshifts=W119_CELL_KW["nshifts"], **kw)
        pu = PileUpper(clr, cc, control=True, device=dev)
        return pu, pu.pileupsByStrandWithControl()

    timed_runs("w119", run_timed, CELL_REPEATS, n_snips, sync, card,
               engine_snips)
    prof = profile_run(lambda: run(feats), sync)
    print(f"w119 device busy share of one run: {prof['text']} {since()}")
    staged_ms, direct_ms = sum(staged_ev.ms), sum(direct_ev.ms)
    rec = shape_record("w119", calls, staged_ms, launches, card)
    rec["direct_ms"] = direct_ms
    print(f"w119 kernels (summed over each run's launches, CUDA events): "
          f"staged {staged_ms:.3f} ms in {launches} launches, direct "
          f"{direct_ms:.3f} ms in {direct_launches}, direct/staged "
          f"{direct_ms / staged_ms:.2f}; bound {rec['bound_ms']:.5f} ms by "
          f"{rec['bound_by']} on {card} {since()}")
    if shapes is not None:
        shapes["w119"] = rec
    return launches


def center_snip(snip):
    """bench_extension's per-snip hook: the nansum of a central block (rows
    and columns 8:13 of a 21-bin window; the toy's whole 5-bin window)."""
    lo = 8 if snip["data"].shape[0] > 13 else 0
    snip["center"] = float(np.nansum(snip["data"][lo : lo + 5, lo : lo + 5]))
    yield snip


def center_batch(frame, data):
    """bench_extension's batch hook: ``center_snip`` for a whole chunk."""
    lo = 8 if data.shape[1] > 13 else 0
    frame = frame.copy(deep=False)
    frame["center"] = np.nansum(data[:, lo : lo + 5, lo : lo + 5],
                                axis=(1, 2))
    return frame


def domain_score(snip):
    from coolpuppy_tpu_torch.lib.numutils import get_domain_score

    snip["domain_score"] = get_domain_score(snip["data"], 1)
    return snip


def per_anchor(snip):
    """One copy of the snip per anchor, grouped by the anchor's window (the
    reference's per-snip ``group_by_region`` pattern)."""
    for side in ("1", "2"):
        yield dict(snip, group=tuple(
            snip[c + side] for c in ("chrom", "start", "end")))


def count_snips(acc, snip):
    """An opaque extra sum func: no ``accumulate_values`` partial, so the
    strictly per-snip host fold."""
    acc["snipcount"] = acc.get("snipcount", 0) + 1
    return acc


def hook_run_kwargs(run):
    """``pileupsWithControl`` keywords of a HOOK_MODES ``run`` entry, with
    the hooks and extras resolved by name."""
    from functools import partial

    from coolpuppy_tpu_torch.lib.puputils import (
        accumulate_values,
        group_by_region_frame,
    )

    hooks = {"group_by_region": group_by_region_frame, "noop": lambda s: s,
             "center_snip": center_snip, "center_batch": center_batch,
             "domain_score": domain_score, "per_anchor": per_anchor}
    kw = {k: hooks.get(v, v) if isinstance(v, str) else v
          for k, v in run.items() if k != "extras"}
    key = run.get("extras")
    if key == "count_snips":
        kw["extra_sum_funcs"] = {"snipcount": count_snips}
    elif key:
        kw["extra_sum_funcs"] = {key: partial(accumulate_values, key=key)}
    return kw


def hook_mode_table(name, clr, dense, weights, device):
    """One HOOK_MODES entry on the toy map on ``device``."""
    from coolpuppy_tpu_torch import CoordCreator, PileUpper

    spec = HOOK_MODES[name]
    kind = spec.get("features", "bed")
    if kind == "bed":
        features = toy_features().assign(score=[1.5, 2.5, 3.5, 4.5, 5.5, 6.5])
    elif kind == "tads":
        features = toy_tads()
    else:
        features = toy_bedpe()
        if kind == "bedpe_tads":
            features = features.assign(end1=features["start1"] + 2_000_000,
                                       end2=features["start2"] + 2_000_000)
    cc_kw = dict(features_format="bedpe" if "bedpe" in kind else "bed",
                 mindist=0, nshifts=0)
    cc_kw.update(spec.get("cc", {}))
    if "rescale_flank" not in cc_kw:
        cc_kw["flank"] = TOY_KW["flank"]
    pu_kw = dict(spec.get("pu", {}))
    if pu_kw.get("expected") is True:
        pu_kw["expected"] = toy_expected(clr, dense, weights, toy_regions())
    cc = CoordCreator(features, clr.binsize, **cc_kw)
    pu = PileUpper(clr, cc, view_df=toy_regions(),
                   control=cc_kw["nshifts"] > 0, device=device, **pu_kw,
                   **F32_WIRE)
    if spec.get("by_window"):
        return pu.pileupsByWindowWithControl()
    return pu.pileupsWithControl(**hook_run_kwargs(spec.get("run", {})))


def check_hook_modes(dev):
    """Phase 8a: every extension route and every by-window case that groups
    through the frame hook, on the toy map on ``dev`` against the CPU:
    ``compare_tables`` as in 5a, the extras by ``compare_extras``, and the
    accumulate route each side took."""
    clr, dense, weights = toy_cooler()
    for name, spec in HOOK_MODES.items():
        got = hook_mode_table(name, clr, dense, weights, dev)
        want = hook_mode_table(name, clr, dense, weights, "cpu")
        err = compare_tables(got, want, what=f"hook mode {name}",
                             **ENGINE_MODES_TOL)
        keys, rtol = spec.get("extras", ([], None))
        compare_extras(got, want, keys, f"hook mode {name}", rtol=rtol)
        routes = (got["accumulate"].iloc[0], want["accumulate"].iloc[0])
        if dev.type == "cuda" and routes != spec["routes"]:
            raise AssertionError(f"hook mode {name}: routes {routes}")
        extras = "".join(
            f", {k} {[None if v is None else len(np.atleast_1d(v)) for v in got[k]]}"
            for k in keys)
        print(f"hook mode {name}: {len(got)} rows, n {list(got['n'])}, "
              f"route {routes[0]}, max_abs_err {err:.3g}{extras} ok")


def extension_workload(n_big=EXTENSION_SITES[0], n_small=EXTENSION_SITES[1],
                       n_bins=20_000, n_contacts=12_000_000, seed=0):
    """``bench.py:575`` ``bench_extension``'s inputs with its RNG calls: the
    engine map (``_bench_cooler``), then ``make_feats(20_000)`` and
    ``make_feats(6_000)`` from one generator: sorted distinct starts, a
    score in [0, 1) rounded to 4 places, a strand. Returns ``(Cooler,
    feats_big, feats_small)``."""
    import pandas as pd

    clr = bench_cooler(np.random.default_rng(0), n_bins, n_contacts)
    length = clr.n_bins * clr.binsize
    rng = np.random.default_rng(seed)

    def make_feats(n):
        starts = np.sort(rng.choice(length - 10_000, n, replace=False))
        return pd.DataFrame({
            "chrom": "chr1", "start": starts, "end": starts + 1_000,
            "name": ".", "score": rng.uniform(0, 1, n).round(4),
            "strand": rng.choice(["+", "-"], n),
        })

    return clr, make_feats(n_big), make_feats(n_small)


def extension_run(clr, feats, route, device, **wire):
    """One ``bench_extension`` run of ``route`` ("frame", "batch" or
    "snip"), with the wire keywords ``wire``: ``(PileUpper, table)``."""
    from coolpuppy_tpu_torch import CoordCreator, PileUpper

    run = {"frame": {"extras": "score1"},
           "batch": {"postprocess_batch_func": "center_batch",
                     "extras": "center"},
           "snip": {"postprocess_snip_func": "center_snip",
                    "extras": "center"}}[route]
    cc = CoordCreator(feats, clr.binsize, **EXTENSION_KW)
    pu = PileUpper(clr, cc, expected=False, control=False, device=device,
                   **wire)
    return pu, pu.pileupsWithControl(**hook_run_kwargs(run))


def timed_runs(what, run_timed, repeats, n_snips, sync, card,
               count=lambda pups: int(all_row(pups)["n"])):
    """``repeats`` timed runs of ``run_timed`` (returns ``(PileUpper,
    table)``; ``count(table)``, by default the 'all' row's ``n``, must give
    ``n_snips``): the walls, the engine's phase breakdown of the median run
    and snips/s. Returns ``(median wall, its phases)``."""
    walls, phases = [], []
    for _ in range(repeats):
        t, (pu, pups) = timed(run_timed, sync)
        if count(pups) != n_snips:
            raise AssertionError(f"{what}: a timed run counted other snips")
        walls.append(t)
        ph = dict(pu.timers.seconds)
        ph["outside_phases"] = t - sum(ph.values())
        phases.append(ph)
        del pu, pups
    med = statistics.median(walls)
    mid = phases[int(np.argsort(walls)[len(walls) // 2])]
    print(f"{what} timing: wall_s " + json.dumps([round(x, 4) for x in walls]))
    print(f"{what} phases (median run, s): " + json.dumps(
        {k: round(v, 4) for k, v in sorted(mid.items())}))
    print(f"{what} snips/s: {n_snips / med:.0f} ({n_snips} snips, median "
          f"{med:.3f} s of {repeats}) on {card}")
    return med, mid


def kernel_run(what, run, dev):
    """A checked run that must go through the staged quad kernel: the launch
    counts set to 0 just before it and read just after. Returns ``(table,
    launches, the recorded call shapes, seconds)``."""
    import coolpuppy_tpu_torch.ops.quad_gather as qg

    qg.LAUNCHES = 0
    qg.VARIANT_LAUNCHES.update(staged=0, direct=0)
    t0 = time.perf_counter()
    with launch_shapes() as called:
        table = run()
    t = time.perf_counter() - t0
    launches = qg.LAUNCHES
    route = table["accumulate"].iloc[0]
    if launches < 1 or route != "cuda_kernel":
        raise AssertionError(f"{what}: {launches} launches, route {route!r}; "
                             "the kernel did not run")
    check_variant(what, dev, launches)
    return table, launches, called.calls, t


# the plain version's time in each plain-swapped run, by the run's name
# (``shape_record`` of the same name reports it beside the kernel's)
PLAIN_MS = {}


def plain_swapped(what, run, route="plain"):
    """``run`` with ``quad_accumulate`` swapped for the plain version: no
    launch, route ``route`` (``plain``; a run whose regions take other
    routes too names them all). The plain calls' time (CUDA events around
    each call on a card, the host clock on the CPU), summed, goes to
    ``PLAIN_MS[what]``."""
    import torch

    import coolpuppy_tpu_torch.ops.quad_gather as qg

    spans = []

    def plain(stiles, *args):
        if not stiles.is_cuda:
            t = time.perf_counter()
            out = qg.quad_accumulate_plain(stiles, *args)
            spans.append(1e3 * (time.perf_counter() - t))
            return out
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = qg.quad_accumulate_plain(stiles, *args)
        t1.record()
        spans.append((t0, t1))
        return out

    kernel = qg.quad_accumulate
    qg.quad_accumulate = plain
    try:
        qg.LAUNCHES = 0
        table = run()
        launches = qg.LAUNCHES
    finally:
        qg.quad_accumulate = kernel
    if launches != 0 or table["accumulate"].iloc[0] != route:
        raise AssertionError(f"{what}: plain-swapped run launched {launches}")
    if any(isinstance(x, tuple) for x in spans):
        torch.cuda.synchronize()
    PLAIN_MS[what] = sum(x if isinstance(x, float) else x[0].elapsed_time(x[1])
                         for x in spans)
    return table


def check_extension(dev, sync, card, shapes=None, workload=None):
    """Phase 8b: ``bench_extension``'s three routes at its own size. Per
    route a warm-up, a checked run and timed runs; the frame-column run
    must launch the staged kernel and is held against the plain-swapped
    run, the batch route against the port on the CPU at EXTENSION_CPU_SITES
    sites, the snip route's ``center`` list against the batch route's; the
    three routes count the same snips on the same sites. Returns
    ``(launches of the frame-column run, the workload's map)``."""
    t, (clr, feats_big, feats_small) = timed(workload or extension_workload,
                                             lambda: None)
    print(f"extension workload: {clr.n_bins} bins, {clr.n_pixels} pixels, "
          f"{len(feats_big)} + {len(feats_small)} sites in {t:.1f} s")
    feats = {"frame": feats_big, "batch": feats_small, "snip": feats_small}
    tables = {}
    launches = 0
    for route in ("frame", "batch", "snip"):
        what = f"extension {route}"
        f = feats[route]

        def run(f=f, route=route, device=dev):
            return extension_run(clr, f, route, device)[1]

        warm = f.iloc[:EXTENSION_WARMUP[route]]
        t, w = timed(lambda: run(warm), sync)
        print(f"{what} warm-up ({len(warm)} sites): "
              f"{int(all_row(w)['n'])} snips in {t:.2f} s")
        if route == "frame":
            checked, launches, calls, t = kernel_run(what, run, dev)
            plain = plain_swapped(what, run)
            err = compare_tables(checked, plain, rtol=ENGINE_RTOL, atol=1e-7,
                                 what=f"{what} kernel vs plain")
            compare_extras(checked, plain, ["score1"], what)
            print(f"{what} kernel vs plain (whole run): counts exact, "
                  f"score1 lists equal, data max_abs_err {err:.3g} (rtol "
                  f"{ENGINE_RTOL}) ok")
            del plain
        else:
            t, checked = timed(run, sync)
            want_route = "batch_hook" if route == "batch" else "host_stream"
            if checked["accumulate"].iloc[0] != want_route or \
                    str(dev) not in checked["device"].iloc[0]:
                raise AssertionError(
                    f"{what}: route {checked['accumulate'].iloc[0]!r} on "
                    f"{checked['device'].iloc[0]!r}")
        row = all_row(checked)
        n_snips = int(row["n"])
        key = "score1" if route == "frame" else "center"
        data = np.asarray(row["data"], float)
        if data.shape != (21, 21) or not np.isfinite(data).any() or \
                len(row[key]) != n_snips:
            raise AssertionError(f"{what} output: data {data.shape}, "
                                 f"{len(row[key])} {key} values of {n_snips}")
        print(f"{what} checked run: {n_snips} snips, {len(row[key])} {key} "
              f"values, route {checked['accumulate'].iloc[0]}"
              + (f", launches {launches}" if route == "frame" else "")
              + f", {t:.2f} s")
        tables[route] = checked
        if route == "batch":
            sub = f.iloc[:EXTENSION_CPU_SITES]
            got = run(sub)
            t, want = timed(lambda: run(sub, device="cpu"), lambda: None)
            err = compare_tables(got, want, rtol=ENGINE_RTOL, atol=1e-7,
                                 what=f"{what} card vs cpu")
            compare_extras(got, want, ["center"], f"{what} card vs cpu",
                           rtol=EXTRAS_RTOL)
            print(f"{what} subset ({len(sub)} sites, "
                  f"{int(all_row(want)['n'])} snips, CPU {t:.1f} s) card vs "
                  f"CPU: counts exact, center rtol {EXTRAS_RTOL}, data "
                  f"max_abs_err {err:.3g} (rtol {ENGINE_RTOL}) ok")
        med, mid = timed_runs(
            what, lambda f=f, route=route: extension_run(clr, f, route, dev),
            EXTENSION_REPEATS[route], n_snips, sync, card)
        if route == "batch":
            share = mid.get("device", 0.0) / med
            print(f"{what} device phase (upload, normalize, cut + fetch): "
                  f"{mid.get('device', 0.0):.3f} s = {share:.3f} of the wall")
        if route != "snip":
            prof = profile_run(run, sync)
            print(f"{what} device busy share of one run: " + prof["text"])
        if route == "frame":
            rec = shape_record(what, calls, prof["kernel_ms"], launches, card)
            if shapes is not None:
                shapes["extension_frame_column"] = rec
    # the same sites through the three routes (the hook routes upload
    # float32, so the kernel route's run does too)
    small = extension_run(clr, feats_small, "frame", dev, **F32_WIRE)[1]
    ns = {r: int(all_row(t)["n"]) for r, t in tables.items() if r != "frame"}
    ns["frame"] = int(all_row(small)["n"])
    if len(set(ns.values())) != 1:
        raise AssertionError(f"extension: the routes counted {ns}")
    for route in ("batch", "snip"):
        err = compare_tables(tables[route], small, rtol=ENGINE_RTOL,
                             atol=1e-7, what=f"extension {route} vs frame")
    compare_extras(tables["snip"], tables["batch"], ["center"],
                   "extension snip vs batch", rtol=EXTRAS_RTOL)
    print(f"extension routes on the same {len(feats_small)} sites: n "
          f"{ns['frame']} on all three, data equal to the kernel route's "
          f"(rtol {ENGINE_RTOL}), the snip route's center list equal to the "
          f"batch route's (rtol {EXTRAS_RTOL}) ok")
    return launches, clr


def bedpe_window_workload(clr, n_sites=BEDPE_WINDOW_SITES, seed=1):
    """``n_sites`` 1 kb sites on ``clr``'s chromosome and every pair of
    them whose centres lie within BEDPE_WINDOW_KW's ``maxdist``, first
    before second, as BEDPE rows in coordinate order. Returns ``(features,
    bedpe)``."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    length = clr.n_bins * clr.binsize
    starts = np.sort(rng.choice(length - 10_000, n_sites, replace=False))
    feats = pd.DataFrame({"chrom": "chr1", "start": starts,
                          "end": starts + 1_000})
    last = np.searchsorted(starts, starts + BEDPE_WINDOW_KW["maxdist"],
                           side="right")
    counts = last - np.arange(n_sites) - 1
    i = np.repeat(np.arange(n_sites), counts)
    j = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts,
                                            counts) + i + 1
    bedpe = pd.DataFrame({
        "chrom1": "chr1", "start1": starts[i], "end1": starts[i] + 1_000,
        "chrom2": "chr1", "start2": starts[j], "end2": starts[j] + 1_000,
    })
    return feats, bedpe


def check_bedpe_by_window(dev, sync, card, clr, shapes=None, n_sites=None):
    """Phase 8c: by-window pileups of BEDPE rows at a size users run, through
    the ``group_by_region_frame`` frame hook: a warm-up, a checked run that
    must launch the staged kernel, held on every row against the
    plain-swapped run on the same inputs and window by window against the
    BED dual-anchor run over the same pairs (counts exact, ``data`` rtol
    1e-4), and timed runs. Returns the checked run's launches."""
    from coolpuppy_tpu_torch import CoordCreator, PileUpper, pileup

    feats, bedpe = bedpe_window_workload(
        clr, n_sites or BEDPE_WINDOW_SITES)
    print(f"bedpe by-window workload: {len(feats)} sites, {len(bedpe)} rows "
          f"within {BEDPE_WINDOW_KW['maxdist']} bp")
    what = "bedpe by-window"

    def run_timed(rows=bedpe, **wire):
        cc = CoordCreator(rows, clr.binsize, features_format="bedpe",
                          nshifts=0, **BEDPE_WINDOW_KW)
        pu = PileUpper(clr, cc, device=dev, **wire)
        return pu, pu.pileupsByWindowWithControl()

    t, (_, warm) = timed(lambda: run_timed(bedpe.iloc[:10_000]), sync)
    print(f"{what} warm-up (10000 rows): {int(all_row(warm)['n'])} snips in "
          f"{t:.2f} s")
    # the checked, plain-swapped and dual-anchor runs fetch float32
    # accumulators (F32_FETCH): their sums differ by the atomics' order
    checked, launches, calls, t = kernel_run(
        what, lambda: run_timed(**F32_FETCH)[1], dev)
    n_snips = int(all_row(checked)["n"])
    print(f"{what} checked run: {n_snips} snips, {len(checked)} rows, "
          f"launches {launches}, route {checked['accumulate'].iloc[0]}, "
          f"{t:.2f} s")
    plain = plain_swapped(what, lambda: run_timed(**F32_FETCH)[1])
    err = compare_tables(checked, plain, rtol=ENGINE_RTOL, atol=1e-7,
                         what=f"{what} kernel vs plain")
    print(f"{what} kernel vs plain (whole run, {len(plain)} rows): windows, "
          f"n and num exact, data max_abs_err {err:.3g} (rtol {ENGINE_RTOL}) "
          "ok")
    del plain
    t, dual = timed(lambda: pileup(clr, feats, features_format="bed",
                                   by_window=True, device=dev,
                                   **BEDPE_WINDOW_KW, **F32_FETCH), sync)
    err = compare_tables(checked, dual, rtol=ENGINE_RTOL, atol=1e-7,
                         what=f"{what} vs the BED dual-anchor run")
    print(f"{what} vs the BED dual-anchor run over the same pairs "
          f"({len(dual)} rows, {t:.2f} s): windows, n and num exact, data "
          f"max_abs_err {err:.3g} (rtol {ENGINE_RTOL}) ok")
    del dual
    timed_runs(what, run_timed, CELL_REPEATS, n_snips, sync, card)
    prof = profile_run(lambda: run_timed()[1], sync)
    print(f"{what} device busy share of one run: " + prof["text"])
    rec = shape_record(what, calls, prof["kernel_ms"], launches, card)
    if shapes is not None:
        shapes["by_window_bedpe"] = rec
    return launches


# phase 9: the coolpup-torch CLI (``cli/coolpup_cli.pileup_from_args``).
# 9a: its flag sets on the toy map, card against CPU. Each set is the
# features argument and its flags; CLI_TOY_ARGS follow them. "{name}" is a
# file of write_cli_inputs, and "-" reads the BED file from standard input.
# The toy's windows are 5 bins wide, so every set but the rescaled one
# takes the quad kernel on the card (CLI_ROUTES)
CLI_TOY_ARGS = ("--view", "{regions}", "--flank", "2000000", "--mindist",
                "0", "--seed", "0")
CLI_FLAG_SETS = {
    "bed": ("{bed}",),
    "bed_header": ("{bed_header}",),
    "bedpe": ("{bedpe}", "--features_format", "bedpe"),
    "stdin": ("-", "--features_format", "bed"),
    "by_strand": ("{bed}", "--by_strand", "--nshifts", "1"),
    "expected_column": ("{bed}", "--expected", "{expected}::balanced.avg"),
    "expected_index": ("{bed}", "--expected", "{expected}::6"),
    "by_distance": ("{bed}", "--by_distance"),
    "by_distance_edges": ("{bed}", "--by_distance", "0", "4000000",
                          "50000000"),
    "groupby": ("{bed}", "--groupby", "name1", "name2"),
    "flip_negative_strand": ("{bed}", "--flip_negative_strand",
                             "--by_strand"),
    "by_window": ("{bed}", "--by_window"),
    "trans": ("{bed}", "--trans"),
    "store_stripes": ("{bed}", "--store_stripes"),
    "local_rescale": ("{tads}", "--local", "--rescale", "--rescale_size",
                      "9"),
    "coverage_norm": ("{bed}", "--coverage_norm", "--clr_weight_name"),
    "not_ooe": ("{bed}", "--expected", "{expected}", "--not_ooe"),
    "unbalanced": ("{bed}", "--clr_weight_name", "--nshifts", "2"),
}
CLI_ROUTES = {"local_rescale": "rescale_torch"}
# sets that both packages refuse, with the error: ``validate_csv`` turns a
# column index into an int that ``read_expected_from_file`` then looks up
# as a column name (the JAX package does the same)
CLI_REFUSED = {"expected_index": "expected lacks value column 6"}
# 9b: bench.py --engine's cell (ENGINE_KW) through the CLI's flags, without
# and with an expected file
CLI_ENGINE_ARGS = ("--flank", "100000", "--maxdist", "2000000", "--nshifts",
                   "1", "--seed", "0", "--by_strand")
CLI_REPEATS = 2
# the functions of cli/coolpup_cli.py that read the features, view and
# expected files
CLI_READERS = ("_read_features", "read_viewframe_from_file",
               "read_expected_from_file")


def write_cli_inputs(d, clr, dense, weights):
    """Write the inputs of CLI_FLAG_SETS for the toy map into directory
    ``d``: the toy features (names alternating "a" and "b", distinct scores)
    as BED without and with a header line, the toy BEDPE rows, the toy TADs,
    the toy view and its expected table (TSV). Returns the paths by name;
    ``cool`` names the map (held in memory, not written)."""
    paths = {name: os.path.join(d, f) for name, f in (
        ("cool", "toy.cool"), ("bed", "features.bed"),
        ("bed_header", "features_header.bed"), ("bedpe", "loops.bedpe"),
        ("tads", "tads.bed"), ("regions", "regions.bed"),
        ("expected", "expected.tsv"))}
    feats = toy_features().assign(name=["a", "b"] * 3, score=np.arange(6))
    bed = dict(sep="\t", header=False, index=False)
    feats.to_csv(paths["bed"], **bed)
    feats.to_csv(paths["bed_header"], sep="\t", index=False)
    toy_bedpe().to_csv(paths["bedpe"], **bed)
    toy_tads().to_csv(paths["tads"], **bed)
    toy_regions().to_csv(paths["regions"], **bed)
    toy_expected(clr, dense, weights, toy_regions()).to_csv(
        paths["expected"], sep="\t", index=False)
    return paths


def cli_argv(name, paths):
    """The coolpup-torch arguments of one CLI_FLAG_SETS entry."""
    features, *flags = CLI_FLAG_SETS[name]
    return [a.format(**paths)
            for a in ("{cool}", features, *flags, *CLI_TOY_ARGS)]


def cli_pileup(argv, clr, stdin_path=None):
    """``pileup_from_args`` on the parsed ``argv`` and ``clr``: ``(pups,
    outname)``. Features given as "-" are read from ``stdin_path``."""
    from coolpuppy_tpu_torch.cli.coolpup_cli import (
        parse_args_coolpuppy,
        pileup_from_args,
    )

    args = parse_args_coolpuppy().parse_args(argv)
    if args.features != "-":
        return pileup_from_args(args, clr)
    stdin = sys.stdin
    with open(stdin_path) as f:
        sys.stdin = f
        try:
            return pileup_from_args(args, clr)
        finally:
            sys.stdin = stdin


def check_cli_toy(dev):
    """Phase 9a: every CLI_FLAG_SETS entry through ``pileup_from_args`` on
    the toy map with ``--device`` the card and with ``--device cpu``:
    ``compare_tables`` as in 5a, the same output name, and the route the
    card took; then a ``.txt`` round trip of one ``all`` row."""
    from coolpuppy_tpu_torch.io import (
        load_array_with_header,
        save_array_with_header,
    )

    clr, dense, weights = toy_cooler()
    with tempfile.TemporaryDirectory() as d:
        paths = write_cli_inputs(d, clr, dense, weights)
        clr.filename = paths["cool"]
        tables = {}
        for name in CLI_FLAG_SETS:
            argv = cli_argv(name, paths)
            if name in CLI_REFUSED:
                for device in (str(dev), "cpu"):
                    try:
                        cli_pileup(argv + ["--device", device], clr)
                    except ValueError as e:
                        if str(e) != CLI_REFUSED[name]:
                            raise
                    else:
                        raise AssertionError(f"cli {name}: accepted on "
                                             f"{device}")
                print(f"cli {name}: refused on both devices "
                      f"({CLI_REFUSED[name]!r}) ok")
                continue
            with wires_off():
                got, got_name = cli_pileup(argv + ["--device", str(dev)],
                                           clr, paths["bed"])
            want, want_name = cli_pileup(argv + ["--device", "cpu"], clr,
                                         paths["bed"])
            err = compare_tables(got, want, what=f"cli {name}",
                                 **ENGINE_MODES_TOL)
            if got_name != want_name:
                raise AssertionError(f"cli {name}: output names {got_name} "
                                     f"!= {want_name}")
            route = got["accumulate"].iloc[0]
            want_route = CLI_ROUTES.get(name, "cuda_kernel")
            if dev.type == "cuda" and route != want_route:
                raise AssertionError(f"cli {name}: route {route}, not "
                                     f"{want_route}")
            print(f"cli {name}: {len(got)} rows, n {list(got['n'])}, route "
                  f"{route}, max_abs_err {err:.3g}, output {got_name} ok")
            tables[name] = got
        row = all_row(tables["groupby"])
        header = {k: row[k] for k in ("n", "flank", "resolution", "nshifts",
                                      "local", "maxdist", "clr_weight_name",
                                      "cooler", "features", "groupby")}
        path = os.path.join(d, "all.txt")
        save_array_with_header(row["data"], header, path)
        back = load_array_with_header(path)
        data = back.pop("data")
        if not (data.dtype == row["data"].dtype
                and np.array_equal(data, row["data"], equal_nan=True)):
            raise AssertionError("cli .txt round trip: the array differs")
        if back != header:
            raise AssertionError(f"cli .txt round trip: header {back} != "
                                 f"{header}")
        print(f"cli .txt round trip of the groupby all row: array bit for "
              f"bit, header of {len(header)} keys equal ok")


class cli_probe:
    """During a block, record what ``pileup_from_args`` does: the keywords
    it passes to ``pileup()`` (``pileup_kw``), the ``PileUpper`` that
    ``pileup()`` builds (``pileupper``, for its phase timers) and the
    seconds spent in each of the CLI's file readers (``read_s``)."""

    def __enter__(self):
        cli = importlib.import_module("coolpuppy_tpu_torch.cli.coolpup_cli")
        engine = importlib.import_module(engine_patch.MODULE)
        self.saved = [(cli, name, getattr(cli, name))
                      for name in (*CLI_READERS, "pileup")]
        self.saved.append((engine, "PileUpper", engine.PileUpper))
        self.read_s = dict.fromkeys(CLI_READERS, 0.0)
        probe = self

        def reader(name, fn):
            def timed_read(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    probe.read_s[name] += time.perf_counter() - t0
            return timed_read

        inner_pileup = cli.pileup

        def recording_pileup(**kw):
            probe.pileup_kw = kw
            return inner_pileup(**kw)

        class RecordedPileUpper(engine.PileUpper):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                probe.pileupper = self

        for name in CLI_READERS:
            setattr(cli, name, reader(name, getattr(cli, name)))
        cli.pileup = recording_pileup
        engine.PileUpper = RecordedPileUpper
        return self

    def __exit__(self, *exc):
        for module, name, value in self.saved:
            setattr(module, name, value)


def cli_snips(pups):
    """ROI n + control_n of the 'all' orientation (``engine_snips``; no
    control_n without controls)."""
    row = pups.loc[pups["orientation"] == "all"].iloc[0]
    return int(row["n"]) + (int(row["control_n"])
                            if "control_n" in pups.columns else 0)


def check_cli_cell(what, argv, clr, dev, sync, card, shapes=None):
    """One 9b variant: a checked run of ``argv`` through ``pileup_from_args``
    that must launch the staged kernel (profiled: the busy share), held
    against the plain-swapped run and against ``pileup()`` called with the
    keywords the CLI resolved (counts exact, ``data`` rtol 1e-4); timed
    runs (the wall from entering ``pileup_from_args`` to its return, with
    the file reads in it), the seconds of the file reads and the kernel's
    time beside its bound. Returns the checked run's launches."""
    from coolpuppy_tpu_torch import pileup

    def run():
        return cli_pileup(argv, clr)[0]

    # the checked run is also the profiled one (the busy share)
    checked = {}
    with cli_probe() as probe:
        prof = profile_run(
            lambda: checked.update(run=kernel_run(what, run, dev)), sync)
    checked, launches, calls, t = checked["run"]
    n_snips = cli_snips(checked)
    data = np.stack(checked["data"].to_list())
    if data.shape[1:] != (21, 21) or not np.isfinite(data).any():
        raise AssertionError(f"{what} output: shape {data.shape}")
    print(f"{what} checked run: {n_snips} snips, {len(checked)} rows "
          f"({list(checked['orientation'])}), launches {launches}, route "
          f"{checked['accumulate'].iloc[0]}, {t:.2f} s (profiled)")
    print(f"{what} device busy share of that run: " + prof["text"])
    plain = plain_swapped(what, run)
    err = compare_tables(checked, plain, rtol=ENGINE_RTOL, atol=1e-7,
                         what=f"{what} kernel vs plain")
    print(f"{what} kernel vs plain (whole run): n/control_n/num exact, data "
          f"max_abs_err {err:.3g} (rtol {ENGINE_RTOL}) ok")
    del plain
    t, direct = timed(lambda: pileup(**probe.pileup_kw), sync)
    err = compare_tables(checked, direct, rtol=ENGINE_RTOL, atol=1e-7,
                         what=f"{what} vs pileup()")
    print(f"{what} vs pileup() with the keywords the CLI resolved ("
          f"{t:.2f} s): n/control_n/num exact, data max_abs_err {err:.3g} "
          f"(rtol {ENGINE_RTOL}) ok")
    del direct, probe
    reads = []

    def run_timed():
        with cli_probe() as probe:
            pups = run()
        reads.append(probe.read_s)
        return probe.pileupper, pups

    timed_runs(what, run_timed, CLI_REPEATS, n_snips, sync, card, cli_snips)
    print(f"{what} file reads (s, per timed run): " + json.dumps(
        [{k.strip("_"): round(v, 5) for k, v in r.items()} for r in reads]))
    rec = shape_record(what, calls, prof["kernel_ms"], launches, card)
    if shapes is not None:
        shapes[what.replace(" ", "_")] = rec
    return launches


def check_cli(dev, sync, card, shapes=None, workload=None):
    """Phase 9b: bench.py --engine's cell through ``pileup_from_args`` at
    full size: the sites and the map's view written as BED files, a
    1,000-site warm-up, then ``check_cli_cell`` without and with an
    expected file (``expected_cis`` of the map, written as TSV). Returns
    the checked runs' launches by variant."""
    from coolpuppy_tpu_torch.expected import expected_cis
    from coolpuppy_tpu_torch.genomics.intervals import make_cooler_view

    t, (clr, feats) = timed(workload or engine_workload, lambda: None)
    print(f"cli workload: {clr.n_bins} bins, {clr.n_pixels} pixels, "
          f"{len(feats)} sites in {t:.1f} s")
    clr = copy.copy(clr)  # the map another phase may hold, named here
    launches = {}
    with tempfile.TemporaryDirectory() as d:
        clr.filename = os.path.join(d, "engine.cool")
        sites, warm, views, exp = (os.path.join(d, f) for f in (
            "sites.bed", "warmup.bed", "views.bed", "expected.tsv"))
        bed = dict(sep="\t", header=False, index=False)
        feats.to_csv(sites, **bed)
        feats.iloc[:ENGINE_WARMUP_SITES].to_csv(warm, **bed)
        # with its header line: the CLI's header sniffing (both packages')
        # takes the one line of a one-region view without it for a header
        view = make_cooler_view(clr)
        view.to_csv(views, sep="\t", index=False)
        t, expected = timed(lambda: expected_cis(clr, view), lambda: None)
        expected.to_csv(exp, sep="\t", index=False)
        print(f"cli inputs: {len(feats)} sites, {len(view)} view regions, "
              f"expected_cis {len(expected)} rows in {t:.2f} s")
        tail = ["--view", views, *CLI_ENGINE_ARGS, "--device", str(dev)]
        t, pups = timed(lambda: cli_pileup([clr.filename, warm, *tail],
                                           clr)[0], sync)
        print(f"cli warm-up ({ENGINE_WARMUP_SITES} sites): "
              f"{cli_snips(pups)} snips in {t:.2f} s")
        for variant, extra in (("controls", []),
                               ("expected", ["--expected",
                                             f"{exp}::balanced.avg"])):
            launches[variant] = check_cli_cell(
                f"cli {variant}", [clr.filename, sites, *tail, *extra], clr,
                dev, sync, card, shapes)
    return launches


# the genome cell's map and its single-device table, kept by phase 10 for
# phase 11, and phase 4's workload, kept for phase 11c
GENOME = {}
SLICE = {}


def genome_workload(n_chroms=20, bins_per=13_500, contacts_per=7_500_000,
                    n_sites=37_000, binsize=10_000, seed=0):
    """``bench.py:866`` ``bench_genome``'s map and sites with its RNG calls,
    as an in-memory Cooler: ``n_chroms`` chromosomes of ``bins_per`` bins
    at 10 kb, ``contacts_per`` zipf(1.35) contacts each (bench's 18M draws
    scale with it), Poisson(3)+1 counts, 3% NaN-weight bins; ``n_sites``
    stranded 1 kb sites, an equal share per chromosome at sampled bins. Each
    chromosome's pixels are sorted on their own, so ``from_arrays`` finds
    them in order (and skips its own sort). Returns ``(Cooler,
    features)``."""
    import pandas as pd

    from coolpuppy_tpu_torch import Cooler

    chroms = [f"chr{i + 1}" for i in range(n_chroms)]
    rng = np.random.default_rng(seed)
    pix1, pix2, cnt = [], [], []
    off = 0
    for _ in chroms:
        d = rng.zipf(1.35, contacts_per * 12 // 5)
        d = d[d < bins_per][:contacts_per]
        i = rng.integers(0, bins_per, len(d)) + off
        j = np.minimum(i + d, off + bins_per - 1)
        v = rng.poisson(3.0, len(d)) + 1
        if v.max(initial=0) >= 256:
            raise AssertionError("genome_workload: a count past 8 bits")
        # one sort of (bin1, bin2, count) packed in an int64 (4x faster than
        # an argsort); duplicate pixels end up ordered by count
        key = np.sort(((i - off) * bins_per + (j - off)) << 8 | v)
        ij = key >> 8
        pix1.append(ij // bins_per + off)
        pix2.append(ij % bins_per + off)
        cnt.append((key & 0xFF).astype(np.int32))
        off += bins_per
    weights = rng.uniform(0.5, 1.5, off)
    weights[rng.random(off) < 0.03] = np.nan
    clr = Cooler.from_arrays(
        {c: bins_per * binsize for c in chroms}, binsize,
        (np.concatenate(pix1), np.concatenate(pix2), np.concatenate(cnt)),
        weights=weights,
    )
    del pix1, pix2, cnt
    per = n_sites // n_chroms
    rng_f = np.random.default_rng(seed + 1)
    frames = []
    bins_ok = np.arange(1, bins_per - 2)
    for c in chroms:
        starts = np.sort(rng_f.choice(bins_ok, per, replace=False)) * binsize
        frames.append(pd.DataFrame({
            "chrom": c, "start": starts, "end": starts + 1_000,
            "name": ".", "score": 0,
            "strand": rng_f.choice(["+", "-"], per),
        }))
    return clr, pd.concat(frames, ignore_index=True)


def genome_run(clr, feats, dev, mesh=None, **kw):
    """One genome-cell run: the PileUpper that ``pileup(**GENOME_KW)``
    builds, by strand, on ``mesh`` where given. Returns ``(PileUpper,
    table)``."""
    from coolpuppy_tpu_torch import CoordCreator, PileUpper

    args = dict(GENOME_KW, **kw)
    del args["by_strand"]
    nshifts = args.pop("nshifts")
    cc = CoordCreator(feats, clr.binsize, nshifts=nshifts, **args)
    pu = PileUpper(clr, cc, control=nshifts > 0, device=dev, mesh=mesh)
    return pu, pu.pileupsByStrandWithControl()


class collected_path:
    """Every region on the collected two-phase path: no stream opens."""

    def __enter__(self):
        self.eng = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")
        self.saved = self.eng.PileUpper._maybe_open_stream
        self.eng.PileUpper._maybe_open_stream = lambda *a, **k: None
        return self

    def __exit__(self, *exc):
        self.eng.PileUpper._maybe_open_stream = self.saved


def scatter_f32_in_order(slab, tmap, B, K):
    """What the native scatter computes for an unmirrored slab where it adds
    in input order (its two-pass branch, past 2^19 pixels; any branch at
    one thread), in numpy: weights folded in float32 as ``v * (w[row] *
    w[col])``, each cell's pixels added in float32 in input order
    (``np.add.at``)."""
    n1, n2 = slab.shape
    rows, cols = slab.rows - slab.lo1, slab.cols - slab.lo2
    vals = slab.vals.astype(np.float32)
    if slab.weights is not None:
        w = slab.weights.astype(np.float32)
        vals = vals * (w[slab.rows] * w[slab.cols])
    inb = (rows >= 0) & (rows < n1) & (cols >= 0) & (cols < n2)
    rows, cols, vals = rows[inb], cols[inb], vals[inb]
    k = tmap[rows // B, cols // B].astype(np.int64)
    keep = k > 0
    flat = np.zeros((K + 1) * B * B, np.float32)
    np.add.at(flat, (k * B + rows % B)[keep] * B + (cols % B)[keep],
              vals[keep])
    return flat.reshape(K + 1, B, B)


def best_of(fn, runs=NATIVE_RUNS):
    """The least of ``runs`` walls of ``fn`` (seconds) and its last
    result."""
    walls = []
    for _ in range(runs):
        t, out = timed(fn, lambda: None)
        walls.append(t)
    return min(walls), out


def check_native(genome, engine, dev):
    """Phase 10, the host ingest at full size: each native entry against its
    numpy branch on real inputs, with the seconds of both (the least of
    NATIVE_RUNS): ``tile_scatter_wtri`` on the upper band tiles of one
    genome chromosome's slab (as its stream stages it) and on the engine
    map's whole slab at the engine cell's touched tiles, the two-pass
    ``sort_quads`` on the engine cell's words (recorded from a collected
    engine run), and ``enumerate_pairs`` on one chromosome's sites. The
    scatters are held bit for bit against ``scatter_f32_in_order`` and
    within NATIVE_RTOL against the numpy branch. Returns ``{entry: (native
    s, numpy s)}``."""
    from coolpuppy_tpu_torch import CoordCreator, native, pileup
    from coolpuppy_tpu_torch.ops import quad_gather as qg
    from coolpuppy_tpu_torch.ops import tiles

    gclr, gfeats = genome
    eclr, efeats = engine
    out = {}
    W = 2 * GENOME_KW["flank"] // gclr.binsize + 1

    def scatter(what, slab, want):
        n1 = slab.shape[0]
        _, utmap, _, _, _, Ku = tiles._sym_maps(want, -(-n1 // B),
                                                -(-n1 // B))
        tn, got = best_of(lambda: tiles.scatter_slab(slab, utmap, B, Ku,
                                                     False))
        tp, ref = best_of(lambda: tiles.scatter_slab_plain(slab, utmap, B,
                                                           Ku, False))
        np.testing.assert_array_equal(
            got, scatter_f32_in_order(slab, utmap, B, Ku),
            err_msg=f"{what}: native vs float32 in input order")
        np.testing.assert_allclose(got, ref, rtol=NATIVE_RTOL, atol=1e-6,
                                   err_msg=f"{what}: native vs numpy")
        fin = ref != 0
        rel = float((np.abs(got - ref)[fin] / np.abs(ref[fin])).max(
            initial=0.0))
        out[what] = (tn, tp)
        print(f"native {what}: {slab.nnz} pixels, {Ku} upper tiles, native "
              f"{tn:.4f} s vs numpy {tp:.4f} s ({tp / tn:.1f}x); bit for bit "
              f"the float32 sums in input order, numpy's float64 sums within "
              f"rtol {NATIVE_RTOL} (largest {rel:.3g}) ok")

    slab = gclr.fetch_slab(gclr.chromnames[0], balance="weight")
    band = min(GENOME_KW["maxdist"] // gclr.binsize + W + 8, slab.shape[0])
    scatter("tile_scatter_wtri genome chromosome",
            slab, tiles.band_tiles(band, B, slab.shape)[0])

    # the engine cell's collected run: its touched tiles and quad words
    calls = []
    sort = qg.sort_quads

    def recording(r1, r2, cid, tile_map, b):
        calls.append((r1, r2, cid, tile_map))
        return sort(r1, r2, cid, tile_map, b)

    qg.sort_quads = recording
    try:
        with collected_path():
            t, _ = timed(lambda: pileup(eclr, efeats, device=dev,
                                        **ENGINE_KW), lambda: None)
    finally:
        qg.sort_quads = sort
    if len(calls) != 1:
        raise AssertionError(f"engine collected run: {len(calls)} sorts")
    r1, r2, cid, tmap = calls[0]
    eslab = eclr.fetch_slab(eclr.chromnames[0], balance="weight")
    scatter("tile_scatter_wtri engine map", eslab,
            tiles.touched_tiles(r1, r2, W, W, B, eslab.shape)[0])
    tn, got = best_of(lambda: qg.sort_quads(r1, r2, cid, tmap, B))
    tp, ref = best_of(lambda: qg.sort_quads_plain(r1, r2, cid, tmap, B))
    for g, w, name in zip(got, ref, ("snips", "k", "qstart", "qcount")):
        np.testing.assert_array_equal(g, w, err_msg=f"sort_quads {name}")
    out["quad_sort"] = (tn, tp)
    print(f"native quad_sort (two passes, sort_quads) on the engine cell's "
          f"{len(r1)} words ({t:.2f} s collected run): native {tn:.4f} s vs "
          f"argsort {tp:.4f} s ({tp / tn:.1f}x), equal bit for bit ok")

    cc = CoordCreator(gfeats[gfeats["chrom"] == gclr.chromnames[0]],
                      gclr.binsize, features_format="bed",
                      flank=GENOME_KW["flank"], maxdist=GENOME_KW["maxdist"])
    centers = cc.intervals["center"].to_numpy()
    tn, (li, ri) = best_of(lambda: native.enumerate_pairs(
        centers, cc.mindist, cc.maxdist))
    lazy = type(cc).LAZY_PAIR_THRESHOLD
    type(cc).LAZY_PAIR_THRESHOLD = 0
    try:
        tp, chunks = best_of(lambda: list(cc._iter_cis_pair_chunks(centers)))
    finally:
        type(cc).LAZY_PAIR_THRESHOLD = lazy
    np.testing.assert_array_equal(li, np.concatenate([c[0] for c in chunks]))
    np.testing.assert_array_equal(ri, np.concatenate([c[1] for c in chunks]))
    out["enumerate_pairs"] = (tn, tp)
    print(f"native enumerate_pairs on one chromosome's {len(centers)} sites: "
          f"{len(li)} pairs, native {tn:.5f} s vs numpy {tp:.5f} s, equal in "
          f"order ok")
    return out


def check_genome(dev, sync, card, shapes=None, workload=None,
                 engine=None):
    """Phase 10: ``bench.py``'s genome cell through the streamed multi-region
    path. Returns the checked run's launches."""
    import torch

    from coolpuppy_tpu_torch import native

    chunk_snips = importlib.import_module(
        "coolpuppy_tpu_torch.engine.pileup")._STREAM_CHUNK
    t, (clr, feats) = timed(workload or genome_workload, lambda: None)
    if workload is None:
        GENOME["map"] = (clr, feats)
    print(f"genome workload: {len(clr.chromnames)} chromosomes, {clr.n_bins} "
          f"bins, {clr.n_pixels} pixels, {len(feats)} sites in {t:.1f} s")
    t, eng = timed(engine or engine_workload, lambda: None)
    print(f"engine workload for the native checks: {eng[0].n_pixels} pixels "
          f"in {t:.1f} s")
    check_native((clr, feats), eng, dev)
    del eng
    print(f"threads: torch {torch.get_num_threads()}, native "
          f"{native.threads()}; OpenMP runtimes loaded: "
          f"{sorted(openmp_runtimes())}")

    per = len(feats) // len(clr.chromnames)
    t, (_, warm) = timed(lambda: genome_run(clr, feats.iloc[:per], dev), sync)
    print(f"genome warm-up (one chromosome's {per} sites): "
          f"{engine_snips(warm)} snips in {t:.2f} s")

    pus = []

    def run():
        pu, table = genome_run(clr, feats, dev)
        pus.append(pu)
        return table

    # the checked run is also the profiled one (the busy share)
    checked = {}
    prof = profile_run(
        lambda: checked.update(run=kernel_run("genome", run, dev)), sync)
    checked, launches, calls, t = checked["run"]
    counts = dict(pus[-1].timers.counts)
    n_snips = engine_snips(checked)
    if (counts.get("stream_regions") != len(clr.chromnames)
            or counts.get("stream_aborts", 0) != 0
            or counts.get("stream_chunks") != launches):
        raise AssertionError(f"genome run: {launches} launches, counts "
                             f"{counts}; expected a stream in every region "
                             "and one launch a chunk")
    data = np.stack(checked["data"].to_list())
    if data.shape[1:] != (21, 21) or not np.isfinite(data).any():
        raise AssertionError(f"genome output: shape {data.shape}")
    if workload is None:
        GENOME["table"] = checked
    print(f"genome checked run: {n_snips} snips, {len(checked)} rows "
          f"({list(checked['orientation'])}), launches {launches} (one a "
          f"chunk of at most {chunk_snips} snips), stream_regions "
          f"{counts['stream_regions']}, stream_aborts "
          f"{counts.get('stream_aborts', 0)}, route "
          f"{checked['accumulate'].iloc[0]}, {t:.2f} s (profiled)")
    print("genome device busy share of that run: " + prof["text"])

    plain = plain_swapped("genome", run)
    err = compare_tables(checked, plain, rtol=ENGINE_RTOL, atol=1e-7,
                         what="genome kernel vs plain")
    print(f"genome kernel vs plain (whole run): n/control_n/num exact, data "
          f"max_abs_err {err:.3g} (rtol {ENGINE_RTOL}) ok")
    del plain
    with collected_path():
        t, collected = timed(run, sync)
    if pus[-1].timers.counts.get("stream_regions", 0):
        raise AssertionError("genome collected run streamed")
    err = compare_tables(checked, collected, rtol=ENGINE_RTOL, atol=1e-7,
                         what="genome stream vs collected")
    print(f"genome stream vs the collected path ({t:.2f} s): n/control_n/num "
          f"exact, data max_abs_err {err:.3g} (rtol {ENGINE_RTOL}) ok")
    del collected

    def run_timed():
        pu, table = genome_run(clr, feats, dev)
        pus.append(pu)
        return pu, table

    timed_runs("genome", run_timed, CELL_REPEATS, n_snips, sync, card,
               engine_snips)
    for pu in pus[-CELL_REPEATS:]:
        sec = dict(pu.timers.seconds)
        print("genome phases of a timed run (s): " + json.dumps(
            {k: round(v, 4) for k, v in sorted(sec.items())})
            + f", their sum {sum(sec.values()):.4f} (ingest runs on the "
            "prefetch threads, tiles and stage on the staging worker, beside "
            "the main thread's coords, device and wait); counts "
            + json.dumps(dict(pu.timers.counts)))
    calls = [call_shape(*c) for c in calls]
    rec = shape_record("genome", calls, prof["kernel_ms"], launches, card)
    chunk = max(calls, key=lambda c: c["snips"])
    shape_record("genome stream chunk", [chunk],
                 prof["kernel_ms"] and prof["kernel_ms"] / launches, 1, card)
    if shapes is not None:
        shapes["genome"] = rec
        shapes["genome_chunk"] = dict(
            kernel_bound_ms=kernel_bound([chunk])[0], **chunk)
    return launches


# -- phase 11: the mesh ----------------------------------------------------

# (a) per mode: the map ("toy": toy_cooler() with toy_features() in the toy
# view; "dry": the dry run's 1,408 + 704-bin map and its 72 sites,
# parallel/dryrun.py, whose chr1 bands over 2 and 4 devices), the pileup()
# keywords ("expected_df": True for the toy expected table), BEDPE rows
# (toy_bedpe()), engine constants for the mode (a block of 8 groups at
# W = 7), whether a region must band, and the route on the card
MESH_SIZES = (2, 4)
MESH_MODES = {
    "cis_banded": dict(map="dry", kw=dict(
        flank=3_000_000, mindist=0, maxdist=120_000_000, nshifts=1, seed=0,
        by_strand=True), banded=True),
    "cis_replicated": dict(map="toy", kw=dict(TOY_KW, nshifts=1, seed=0,
                                               by_strand=True)),
    "expected": dict(map="toy", kw=dict(TOY_KW, expected_df=True)),
    "coverage": dict(map="toy", kw=dict(TOY_KW, clr_weight_name=None,
                                        coverage_norm=True)),
    "trans": dict(map="dry", kw=dict(flank=3_000_000, nshifts=1, seed=0,
                                     trans=True), banded=True),
    "rescale": dict(map="toy", kw=dict(RESCALE_KW, local=True),
                    route="rescale_torch"),
    "wide_banded": dict(map="dry", kw=dict(
        flank=61_000_000, mindist=0, maxdist=200_000_000, nshifts=1, seed=0,
        by_strand=True), banded=True, route="generic"),
    "wide_replicated": dict(map="toy_whole", kw=dict(WIDE_KW, nshifts=1,
                                                      seed=0, by_strand=True),
                            route="generic"),
    "stripes_banded": dict(map="dry", kw=dict(
        flank=3_000_000, mindist=0, maxdist=60_000_000, store_stripes=True),
        banded=True),
    "stripes_replicated": dict(map="toy", kw=dict(TOY_KW,
                                                   store_stripes=True)),
    "by_window_blocked": dict(map="dry", kw=dict(
        flank=3_000_000, mindist=0, maxdist=60_000_000, nshifts=1, seed=0,
        by_window=True), patch={"_BLOCK_BYTES": 2 * 7 * 7 * 8 * 8},
        banded=True),
    "bedpe": dict(map="toy", kw=dict(TOY_KW, features_format="bedpe"),
                  bedpe=True),
}
# (b) the genome cell on meshes of these sizes
GENOME_MESH_SIZES = (1, 2, 4)
# (c) bench.py:673 bench_scaling's workload through the mesh session alone
SCALING_LOCI = 262_144
SCALING_RUNS = 3
# (d) two ranks on the card: each builds this genome map (the genome
# cell's chromosome size and sites per chromosome) and gets this long
RANK_WORKLOAD = dict(n_chroms=4, n_sites=7_400)
RANK_SECONDS = 600
RANK_RTOL = 1e-5


class last_upper:
    """The ``PileUpper`` whose ``pileupsWithControl`` runs last in a block
    (``pu``): ``pileup()`` builds its own, and its counters and
    ``mesh_stats`` are read after the call."""

    def __enter__(self):
        eng = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")
        self.cls = eng.PileUpper
        self.saved = inner = self.cls.pileupsWithControl
        self.pu = None
        outer = self

        def recording(pu, *args, **kw):
            outer.pu = pu
            return inner(pu, *args, **kw)

        self.cls.pileupsWithControl = recording
        return self

    def __exit__(self, *exc):
        self.cls.pileupsWithControl = self.saved


def mesh_maps():
    """The two maps of ``MESH_MODES``: name -> (Cooler, features, view,
    expected table)."""
    from coolpuppy_tpu_torch.parallel.dryrun import toy_map, toy_sites

    clr, dense, weights = toy_cooler()
    return {
        "toy": (clr, toy_features(), toy_regions(),
                toy_expected(clr, dense, weights, toy_regions())),
        "toy_whole": (clr, toy_features(), toy_chrom_view(clr), None),
        "dry": (toy_map(), toy_sites(), None, None),
    }


def mesh_mode_run(name, maps, device, mesh=None):
    """One ``MESH_MODES`` entry through ``pileup()`` on ``device`` (and
    ``mesh``). Returns ``(PileUpper, table)``."""
    from coolpuppy_tpu_torch import pileup

    spec = MESH_MODES[name]
    clr, feats, view, expected = maps[spec["map"]]
    kw = dict(spec["kw"])
    if kw.get("expected_df") is True:
        kw["expected_df"] = expected
    if spec.get("bedpe"):
        feats = toy_bedpe()
    with engine_patch(**spec.get("patch", {})), last_upper() as cap:
        table = pileup(clr, feats, view_df=view, device=device, mesh=mesh,
                       **kw, **F32_WIRE)
    return cap.pu, table


def check_mesh_modes(dev):
    """Phase 11a: every ``MESH_MODES`` entry on ``LociMesh([dev] * n)`` for
    n in MESH_SIZES, held against the single-device run on ``dev`` and the
    ``LociMesh(["cpu"] * n)`` run as in 5a; the ``_rowshard_*`` counters
    equal to the CPU run's; on the quad route a launch on every device that
    holds snips; on the generic route (``generic_cuda`` on the card) the
    wide kernel launched, through the row-sharded step where the mode bands
    and the loci-sharded one where it replicates; the current CUDA device
    unchanged after the runs. Returns ``{mode: launches per device}`` of
    the largest mesh (the quad kernel's; the wide kernel's launches of
    each mesh are printed)."""
    import torch

    import coolpuppy_tpu_torch.ops.gather as ga
    import coolpuppy_tpu_torch.ops.quad_gather as qg
    from coolpuppy_tpu_torch.parallel import LociMesh

    cuda = dev.type == "cuda"
    current = torch.cuda.current_device() if cuda else None
    maps = mesh_maps()
    launches = {}
    for name, spec in MESH_MODES.items():
        _, single = mesh_mode_run(name, maps, dev)
        for n in MESH_SIZES:
            qg.LAUNCHES = ga.LAUNCHES = 0
            pu, got = mesh_mode_run(name, maps, dev, LociMesh([dev] * n))
            launched, wide = qg.LAUNCHES, ga.LAUNCHES
            cpu_pu, want = mesh_mode_run(name, maps, "cpu",
                                         LociMesh(["cpu"] * n))
            # the quad route must launch on the card (and where a CPU
            # rehearsal counts its plain version as launches); the generic
            # route on the card must launch the wide kernel
            route = spec.get("route") or (
                "cuda_kernel" if cuda or launched else "plain")
            if route == "generic":
                route = "generic_cuda" if cuda else "generic_torch"
                if cuda and wide < 1:
                    raise AssertionError(f"mesh mode {name} n={n}: the wide "
                                         "kernel did not launch")
            what = f"mesh mode {name} n={n}"
            err = compare_tables(got, single, what=what + " vs one device",
                                 **ENGINE_MODES_TOL)
            err_cpu = compare_tables(got, want, what=what + " vs the CPU",
                                     **ENGINE_MODES_TOL)
            counters = (pu._rowshard_regions, pu._rowshard_fallbacks)
            if counters != (cpu_pu._rowshard_regions,
                            cpu_pu._rowshard_fallbacks):
                raise AssertionError(f"{what}: counters {counters} on the "
                                     "card, CPU other")
            if got["accumulate"].iloc[0] != route:
                raise AssertionError(f"{what}: route "
                                     f"{got['accumulate'].iloc[0]}")
            st = pu.mesh_stats
            if route == "cuda_kernel" and (
                    sum(st["launches"]) != launched
                    or any(s and not k for s, k in zip(st["snips"],
                                                      st["launches"]))):
                raise AssertionError(f"{what}: launches {st['launches']} "
                                     f"({launched} in all) for snips "
                                     f"{st['snips']}")
            if spec.get("banded") and not pu._rowshard_regions:
                raise AssertionError(f"{what}: no region banded")
            launches[name] = st["launches"]
            print(f"{what}: {len(got)} rows, n {list(got['n'])}, route "
                  f"{route}, banded {counters[0]}, fallbacks {counters[1]}, "
                  f"wide kernel launches {wide}, "
                  f"replicated {st['replicated']}, snips per device "
                  f"{st['snips']}, launches per device {st['launches']}, "
                  f"stack bytes per device {st['stack_bytes']}, halo bytes "
                  f"{st['halo_bytes']}; max_abs_err vs one device {err:.3g},"
                  f" vs the CPU {err_cpu:.3g} ok")
    if cuda and torch.cuda.current_device() != current:
        raise AssertionError(f"current CUDA device {current} became "
                             f"{torch.cuda.current_device()}")
    print(f"mesh modes: current device unchanged ({current})")
    return launches


def mesh_line(what, t, pu, n_snips, card):
    """Print one mesh run: the wall, the phases and what the mesh did."""
    st = pu.mesh_stats
    sec = {k: round(v, 4) for k, v in sorted(pu.timers.seconds.items())}
    print(f"{what}: {n_snips} snips in {t:.3f} s ({n_snips / t:.0f} snips/s "
          f"on {card}); phases {json.dumps(sec)}; regions banded "
          f"{st['banded']}, replicated {st['replicated']} (fallbacks "
          f"{pu._rowshard_fallbacks}); launches per device {st['launches']},"
          f" snips per device {st['snips']}; largest stack per device "
          f"{st['stack_bytes']} bytes; halo copies {st['halo_bytes']} bytes")


def check_mesh_genome(dev, sync, card, shapes=None, workload=None):
    """Phase 11b: the genome cell (phase 10's map and single-device table,
    or built here where phase 10 did not run) on ``LociMesh([dev] * n)``
    for n in GENOME_MESH_SIZES: each run held against the single-device
    table (counts exact, ``data`` rtol 1e-4), with its wall, phases and
    what the mesh did; then the largest mesh's run again, profiled, with
    the kernel's shapes and bound. Returns ``{n: launches}``."""
    import coolpuppy_tpu_torch.ops.quad_gather as qg
    from coolpuppy_tpu_torch.parallel import LociMesh

    if workload is None and "map" in GENOME:
        clr, feats = GENOME["map"]
    else:
        t, (clr, feats) = timed(workload or genome_workload, lambda: None)
        print(f"genome workload for the mesh: {clr.n_pixels} pixels, "
              f"{len(feats)} sites in {t:.1f} s")
    single = GENOME.get("table") if workload is None else None
    if single is None:
        t, (_, single) = timed(lambda: genome_run(clr, feats, dev), sync)
        print(f"genome single-device table: {t:.2f} s")
    n_snips = engine_snips(single)
    out = {}
    for n in GENOME_MESH_SIZES:
        mesh = LociMesh([dev] * n)
        qg.LAUNCHES = 0
        t, (pu, table) = timed(lambda: genome_run(clr, feats, dev, mesh=mesh),
                               sync)
        err = compare_tables(table, single, rtol=ENGINE_RTOL, atol=1e-7,
                             what=f"genome mesh of {n}")
        if table["accumulate"].iloc[0] != (
                "cuda_kernel" if dev.type == "cuda" or qg.LAUNCHES
                else "plain"):
            raise AssertionError(f"genome mesh of {n}: route "
                                 f"{table['accumulate'].iloc[0]}")
        st = pu.mesh_stats
        if sum(st["launches"]) != qg.LAUNCHES or any(
                s and not k for s, k in zip(st["snips"], st["launches"])):
            raise AssertionError(f"genome mesh of {n}: launches "
                                 f"{st['launches']} for snips {st['snips']}")
        out[n] = st["launches"]
        mesh_line(f"genome mesh of {n}", t, pu, n_snips, card)
        print(f"genome mesh of {n} vs one device: n/control_n/num exact, data "
              f"max_abs_err {err:.3g} (rtol {ENGINE_RTOL}) ok")
    n = GENOME_MESH_SIZES[-1]
    mesh = LociMesh([dev] * n)
    qg.LAUNCHES = 0
    ran = {}
    with launch_shapes() as called:
        prof = profile_run(lambda: ran.update(run=genome_run(
            clr, feats, dev, mesh=mesh)), sync)
    print(f"genome mesh of {n} device busy share of one run: {prof['text']}")
    rec = shape_record(f"genome mesh of {n}", called.calls,
                       prof["kernel_ms"], qg.LAUNCHES, card)
    if shapes is not None:
        shapes[f"genome_mesh_{n}"] = rec
    return out


def scaling_workload(n_loci=SCALING_LOCI, **kw):
    """``bench.py:673`` ``bench_scaling``'s inputs at its size:
    ``make_workload`` at ``n_loci`` loci and W = 21 (``kw``: its other
    sizes), or, where phase 4 left its 1M-locus workload (the same map),
    that workload's first ``n_loci`` loci; with the port's dense B=128 stack
    of the touched tiles. Returns ``(TileStack, r1, r2, cid, valid,
    evec)``, ``cid`` the group plus 4 for a flipped snip."""
    from bench import make_workload
    from coolpuppy_tpu_torch import build_tile_stack

    if "workload" in SLICE and not kw:
        _, coo, *loci, valid, evec = SLICE.pop("workload")
        r1, r2, gid, flip = (a[:n_loci] for a in loci)
    else:
        _, coo, r1, r2, gid, flip, valid, evec = make_workload(
            n_loci=n_loci, W=21, **kw)
    ts = build_tile_stack(coo, B, r1=r1, r2=r2, window1=21, window2=21)
    return ts, r1, r2, (gid + 4 * flip).astype(np.int32), valid, evec


def check_mesh_session(dev, sync, card, workload=None):
    """Phase 11c: ``QuadMeshSession.run_chunk`` on ``LociMesh([dev] * n)``
    at bench_scaling's size against ``QuadPileupSession.run_many`` on
    ``dev``: ``num`` exact, poison planes equal, ``sum`` rtol 1e-5; snips/s
    (best of SCALING_RUNS, fetch included) and its retention against the
    mesh of one. Returns ``{n: snips/s}``."""
    import coolpuppy_tpu_torch.ops.quad_gather as qg
    from coolpuppy_tpu_torch.parallel import (
        LociMesh,
        QuadMeshSession,
        build_row_partition,
        route_snips,
    )

    t, (ts, r1, r2, cid, valid, evec) = timed(workload or scaling_workload,
                                              lambda: None)
    print(f"mesh session workload: {len(r1)} snips, {ts.n_tiles} tiles in "
          f"{t:.1f} s")
    cfg = dict(W=21, capacity=8, ooe=True)
    one = qg.QuadPileupSession(ts, valid, valid, evec, cfg, dev)
    want = one.run_many(r1, r2, cid)
    t1 = min(timed(lambda: one.run_many(r1, r2, cid), sync)[0]
             for _ in range(SCALING_RUNS))
    print(f"mesh session: QuadPileupSession {len(r1) / t1:.0f} snips/s "
          f"({t1:.4f} s)")
    rates = {}
    for n in GENOME_MESH_SIZES:
        part = build_row_partition(ts, r1, n)
        order, counts = route_snips(part, r1)
        items = np.split(order, np.cumsum(counts)[:-1])
        session = QuadMeshSession(LociMesh([dev] * n), ts, part, valid,
                                  valid, evec, cfg)
        rows = [[a[it] for it in items] for a in (r1, r2, cid)]

        def run():
            return qg.QuadPileupSession.finalize([session.run_chunk(*rows)])

        got = run()
        split = list(session.snips)
        if not np.array_equal(got["num"], want["num"]):
            raise AssertionError(f"mesh session n={n}: num differs")
        pois = want["poison"] > 0
        if not np.array_equal(got["poison"] > 0, pois):
            raise AssertionError(f"mesh session n={n}: poison differs")
        np.testing.assert_allclose(got["sum"][~pois], want["sum"][~pois],
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"mesh session n={n}")
        t = min(timed(run, sync)[0] for _ in range(SCALING_RUNS))
        rates[n] = len(r1) / t
        print(f"mesh session n={n}: {rates[n]:.0f} snips/s ({t:.4f} s, best "
              f"of {SCALING_RUNS}), retention {rates[n] / rates[1]:.3f} of "
              f"the mesh of one; snips per device {split}, stack "
              f"bytes per device {session.stack_bytes}, halo bytes "
              f"{session.halo_bytes}; num exact, sum rtol 1e-5 vs "
              f"QuadPileupSession ok. All {n} devices are one card whose SMs "
              f"they share: this is the partition + halo + sum overhead, not "
              f"scaling ({card})")
    return rates


def map_hash(clr, feats):
    """A sha256 of a map's pixels and weights and of the sites."""
    import hashlib

    h = hashlib.sha256()
    for a in clr.pixels_chunk(0, clr.n_pixels):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(np.ascontiguousarray(
        clr.bins_df()["weight"].to_numpy()).tobytes())
    h.update(feats.to_csv(index=False).encode())
    return h.hexdigest()


def rank_main(rank, port, out, device, workload):
    """One rank of phase 11d: joins the gloo group of two ranks, builds the
    genome map of ``workload`` from seed 0, checks that both ranks hold the
    same map (their hashes over ``all_gather_object``), runs the genome
    cell on its loci mesh (``make_loci_mesh()`` on the card, one CPU device
    for ``device="cpu"``) and prints its region pairs and the exchange's
    bytes and seconds; rank 0 writes its table's groups, ``n`` and ``data``
    to ``out``."""
    import datetime

    import torch.distributed as dist

    from coolpuppy_tpu_torch.parallel import (
        LociMesh,
        init_distributed,
        local_region_pairs,
        make_loci_mesh,
    )

    init_distributed(init_method=f"tcp://localhost:{port}", world_size=2,
                     rank=rank, timeout=datetime.timedelta(
                         seconds=RANK_SECONDS // 2))
    try:
        clr, feats = genome_workload(**workload)
        hashes = [None, None]
        dist.all_gather_object(hashes, map_hash(clr, feats))
        if hashes[0] != hashes[1]:
            raise AssertionError(f"rank {rank}: the ranks' maps differ")
        mesh = (make_loci_mesh() if device == "cuda"
                else LociMesh([device]))
        t, (pu, table) = timed(lambda: genome_run(clr, feats, mesh.devices[0],
                                                  mesh=mesh), lambda: None)
        pairs = local_region_pairs(pu._region_pairs())
        print(f"rank {rank}: map {hashes[rank][:12]} equal on both ranks; "
              f"mesh {[str(d) for d in mesh.devices]}; region pairs {pairs} "
              f"({len(pairs)}); {engine_snips(table)} snips in {t:.2f} s; "
              f"exchange {pu.timers.counts.get('exchange_bytes', 0)} bytes in "
              f"{pu.timers.seconds.get('exchange', 0.0):.4f} s", flush=True)
        if rank == 0:
            np.savez(out, groups=np.asarray([str(g) for g in table["group"]]),
                     n=table["n"].to_numpy(float),
                     control_n=table["control_n"].to_numpy(float),
                     data=np.stack([np.asarray(d, float)
                                    for d in table["data"]]))
    finally:
        dist.destroy_process_group()


def check_two_ranks(dev, sync, card, workload=None):
    """Phase 11d: this script started twice as ranks of a gloo group
    (``rank_main``), each on ``dev``'s type, while this process builds the
    same map and runs it alone; rank 0's table is held against that run:
    group keys, ``n`` and ``control_n`` exact, ``data`` rtol 1e-5. A rank
    that fails or outlasts RANK_SECONDS fails the phase (and is killed)."""
    import socket

    workload = dict(workload or RANK_WORKLOAD)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.makedirs("build", exist_ok=True)
    out = os.path.abspath(os.path.join("build", "chip_smoke_rank0.npz"))
    if os.path.exists(out):
        os.remove(out)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--port",
         str(port), "--out", out, "--device", dev.type, "--workload",
         json.dumps(workload)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        clr, feats = genome_workload(**workload)
        _, want = genome_run(clr, feats, dev)
        outs = [p.communicate(timeout=RANK_SECONDS)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{text[-3000:]}")
        lines = [ln for ln in text.splitlines() if ln.startswith("rank ")]
        if len(lines) != 1:
            raise AssertionError(f"rank {r} printed no result:\n"
                                 f"{text[-3000:]}")
        print(lines[0])
    got = np.load(out)
    if list(got["groups"]) != [str(g) for g in want["group"]]:
        raise AssertionError("two ranks: groups differ from one process")
    for col in ("n", "control_n"):
        np.testing.assert_array_equal(got[col], want[col].to_numpy(float),
                                      err_msg=f"two ranks: {col}")
    data = np.stack([np.asarray(d, float) for d in want["data"]])
    np.testing.assert_allclose(got["data"], data, rtol=RANK_RTOL, atol=1e-8,
                               equal_nan=True, err_msg="two ranks: data")
    print(f"two ranks == one process: {len(want)} rows, n {list(want['n'])},"
          f" data rtol {RANK_RTOL} ok ({wall:.1f} s with both ranks' builds; "
          f"{card})")


def parse_rank(argv):
    """The options of a phase-11d rank (``check_two_ranks`` starts this
    script with them)."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--workload", default=json.dumps(RANK_WORKLOAD))
    args = parser.parse_args(argv)
    return (args.rank, args.port, args.out, args.device,
            json.loads(args.workload))


# -- phase 12: the reader's fetch path and the public surface --------------

# the seeded fuzz search: phase 12b runs FUZZ_CARD_SEEDS at FUZZ_ENGINE's
# scale on the card, tests/test_torch_fuzz.py runs FUZZ_SEEDS at FUZZ_TOY's
# against the JAX package on the CPU. Scales: the chromosomes, the site
# count, the start range in units (plus 0 or half a unit), the flank range
# in flank units, TAD widths in units, the kinds of case drawn from, and
# keywords every case takes
FUZZ_SEEDS = tuple(range(1000, 1016))
FUZZ_CARD_SEEDS = FUZZ_SEEDS[:8]
FUZZ_KINDS = ("bed", "by_window", "bedpe", "trans", "local_rescale")
FUZZ_TOY = dict(chroms=("chr1", "chr2"), n=(6, 30), start=(101, 148),
                unit=1_000_000, flank=(2, 4), flank_unit=1_000_000,
                tad=(3, 8), kinds=FUZZ_KINDS, kw={})
# the engine map: one 200 Mb chromosome at 10 kb, 2,000-6,000 sites,
# flanks of 50-200 kb (W = 11-41), pairs within 1 Mb, TADs 20-200 bins
# wide; no trans kind on one chromosome
FUZZ_ENGINE = dict(chroms=("chr1",), n=(2_000, 6_001), start=(100, 19_900),
                   unit=10_000, flank=(5, 21), flank_unit=10_000,
                   tad=(20, 201),
                   kinds=tuple(k for k in FUZZ_KINDS if k != "trans"),
                   kw=dict(maxdist=1_000_000))
FUZZ_RTOL = 1e-4
FUZZ_TOL = dict(rtol=FUZZ_RTOL, atol=1e-7)
FUZZ_CPU_SITES = 300
# phase 12c: by-distance APA of the engine cell's sites through the
# notebook alias coolpuppy_tpu_torch.coolpup.pileup; the sleep ahead of each
# timed launch (~0.5 ms) outlasts the host side of a streamed launch
BY_DISTANCE_KW = dict(ENGINE_KW, by_distance=True)
BY_DISTANCE_SLEEP_CYCLES = 1_000_000


def fuzz_base(rng, expected_cis, scale=FUZZ_TOY):
    """The draws of tests/test_fuzz_parity.py::random_case, at FUZZ_TOY's
    scale the same numbers: ``(features, pileup keywords)`` of stranded
    sites, a flank, controls or an expected table or coverage
    normalization, by strand (flipped or not), stripes, by distance."""
    import pandas as pd

    n = int(rng.integers(*scale["n"]))
    chroms = rng.choice(list(scale["chroms"]), n)
    unit, half = scale["unit"], scale["unit"] // 2
    starts = (rng.integers(*scale["start"], n).astype(np.int64) * unit
              + rng.integers(0, 2, n) * half)
    feats = pd.DataFrame({
        "chrom": chroms, "start": starts,
        "end": starts + int(rng.integers(1, 3)) * half, "name": "f",
        "score": rng.uniform(0, 1, n).round(3),
        "strand": rng.choice(["+", "-"], n),
    }).sort_values(["chrom", "start"], kind="stable", ignore_index=True)
    kw = dict(features_format="bed", mindist=0,
              flank=int(rng.integers(*scale["flank"])) * scale["flank_unit"])
    mode = rng.integers(0, 4)
    if mode == 0:
        kw["nshifts"] = int(rng.integers(1, 3))
        kw["seed"] = int(rng.integers(0, 100))
    elif mode == 1:
        kw["expected_df"] = expected_cis
        kw["ooe"] = bool(rng.integers(0, 2))
    elif mode == 2:
        kw["clr_weight_name"] = None
        kw["coverage_norm"] = True
    if rng.integers(0, 2):
        kw["by_strand"] = True
        if rng.integers(0, 2):
            kw["flip_negative_strand"] = True
    if rng.integers(0, 3) == 0:
        kw["store_stripes"] = True
    if rng.integers(0, 3) == 0 and "expected_df" not in kw:
        kw["by_distance"] = True
    return feats, kw


def fuzz_case(rng, expected, scale=FUZZ_TOY):
    """One seeded case of the fuzz search: ``(features, pileup keywords)``.
    ``expected`` maps "cis" (and "trans", where ``scale`` draws trans cases)
    to expected tables of the map. ``fuzz_base``'s draws come first; the
    draws after them widen the flag space, each made whatever the case:
    the kind of case (``scale["kinds"]``: BED as drawn, by window, BEDPE
    rows of consecutive sites, trans, or local rescaled TADs), a class
    column to group by (with its order ignored or not) and ``min_diag``.
    What the packages refuse together gives way to the kind: by distance
    under trans or local, a groupby under by-window (which ignores it), an
    ignored group order under BEDPE or local."""
    import pandas as pd

    feats, kw = fuzz_base(rng, expected["cis"], scale)
    n, unit = len(feats), scale["unit"]
    kinds = scale["kinds"]
    kind = kinds[int(rng.integers(0, len(kinds)))]
    feats["cls"] = rng.choice(["a", "b", "c"], n)
    group = rng.integers(0, 3) == 0
    ignore_order = bool(rng.integers(0, 2)) and kind in ("bed", "trans")
    with_min_diag = rng.integers(0, 3) == 0
    min_diag = int(rng.integers(0, 4))
    rescale_size = 2 * int(rng.integers(4, 17)) + 1
    widths = rng.integers(*scale["tad"], n) * unit
    kw.update(scale["kw"])
    if kind == "by_window":
        kw["by_window"] = True
        group = False
    elif kind == "trans":
        kw["trans"] = True
        kw.pop("by_distance", None)
        if "expected_df" in kw:
            kw["expected_df"] = expected["trans"]
    elif kind == "local_rescale":
        kw.update(local=True, rescale=True, rescale_flank=1,
                  rescale_size=rescale_size)
        kw.pop("by_distance", None)
        feats["end"] = feats["start"] + widths
    elif kind == "bedpe":
        a = feats.iloc[:-1].reset_index(drop=True)
        b = feats.iloc[1:].reset_index(drop=True)
        same = (a["chrom"] == b["chrom"]).to_numpy()
        a, b = a[same], b[same]
        feats = pd.DataFrame({
            **{f"{c}1": a[c].to_numpy() for c in ("chrom", "start", "end")},
            **{f"{c}2": b[c].to_numpy() for c in ("chrom", "start", "end")},
            "strand1": a["strand"].to_numpy(),
            "strand2": b["strand"].to_numpy(),
            "cls1": a["cls"].to_numpy(), "cls2": b["cls"].to_numpy(),
        })
        kw["features_format"] = "bedpe"
    if group:
        kw["groupby"] = ["cls1", "cls2"]
        if ignore_order:
            kw["ignore_group_order"] = ["cls1", "cls2"]
    if with_min_diag:
        kw["min_diag"] = min_diag
    return feats, kw


def fuzz_flags(kw):
    """A case's keywords as one short line (an expected table by name)."""
    return " ".join(f"{k}={'table' if k == 'expected_df' else v}"
                    for k, v in kw.items() if k != "features_format") \
        + f" ({kw['features_format']})"


class CountingStore:
    """A ``Cooler`` store that records every read of a pixel column of the
    store it wraps (a file or arrays): ``reads`` holds ``(thread id,
    column, start, stop)``."""

    def __init__(self, inner):
        self.inner = inner
        self.filename = inner.filename
        self.group = inner.group
        self.reads = []
        self.lock = threading.Lock()

    @contextlib.contextmanager
    def open(self):
        with self.inner.open() as grp:
            yield _CountingGroup(grp, self)


class _CountingGroup:
    def __init__(self, grp, store):
        self._grp = grp
        self._store = store
        self.attrs = grp.attrs

    def keys(self):
        return self._grp.keys()

    def __getitem__(self, path):
        node = self._grp[path]
        if path.startswith("pixels/"):
            return _CountingColumn(node, path[len("pixels/"):], self._store)
        return node


class _CountingColumn:
    def __init__(self, column, name, store):
        self._column = column
        self._name = name
        self._store = store
        self.shape = column.shape
        self.dtype = column.dtype

    def __getitem__(self, rows):
        out = self._column[rows]
        with self._store.lock:
            self._store.reads.append((threading.get_ident(), self._name,
                                      rows.start, rows.stop))
        return out


class fetch_log:
    """Every ``fetch_slab`` of a ``Cooler`` read through a CountingStore
    during a block: ``fetches`` holds ``(row extent, column extent, reads,
    thread id)``, with the ``(column, start, stop)`` reads the fetch made on
    its own thread."""

    def __init__(self, clr):
        self.clr = clr

    def __enter__(self):
        clr, store = self.clr, self.clr.store
        inner = clr.fetch_slab
        self.fetches = fetches = []

        def logged(region1, region2=None, *args, **kw):
            tid = threading.get_ident()
            with store.lock:
                mark = len(store.reads)
            slab = inner(region1, region2, *args, **kw)
            with store.lock:
                mine = [r[1:] for r in store.reads[mark:] if r[0] == tid]
            fetches.append((clr.extent(region1), clr.extent(
                region2 if region2 is not None else region1), mine, tid))
            return slab

        clr.fetch_slab = logged
        return self

    def __exit__(self, *exc):
        del self.clr.fetch_slab


def fetch_spans(clr, fetches):
    """Hold each logged fetch to its row spans: every pixel column read
    once a span, exactly rows [bin1_offset[lo], bin1_offset[hi]) of it (a
    cis fetch one span, a rectangle of two extents both), an empty span not
    at all. Returns the pixels each fetch read."""
    from coolpuppy_tpu_torch.io.cool import PIXEL_COLUMNS

    off = clr.bin1_offset()
    read = []
    for ext1, ext2, reads, _ in fetches:
        spans = [ext1] if ext1 == ext2 else [ext1, ext2]
        want = [(int(off[lo]), int(off[hi])) for lo, hi in spans
                if off[hi] > off[lo]]
        for col in PIXEL_COLUMNS:
            got = [(a, b) for c, a, b in reads if c == col]
            if got != want:
                raise AssertionError(f"fetch of {ext1} x {ext2} read {col} "
                                     f"rows {got}, not its spans {want}")
        read.append(sum(b - a for a, b in want))
    return read


def table_snips(table):
    """ROI n + control_n of a pileup table's 'all' row, or of all its rows
    where it has none."""
    for key in ("orientation", "group", "chrom"):
        if key in table:
            rows = table.loc[table[key].astype(str) == "all"]
            if len(rows):
                table = rows.iloc[:1]
                break
    control = table["control_n"] if "control_n" in table else 0
    return int(np.nansum(table["n"].to_numpy(float))
               + np.nansum(np.asarray(control, float)))


def check_reader(dev, sync, card, workload=None):
    """Phase 12a: the engine cell through a ``Cooler`` whose store counts
    its reads (``CountingStore`` over the engine map's arrays): a checked
    run that must launch the staged kernel, every fetch held to its row
    spans (``fetch_spans``), the pixels read per fetch and in all, the
    threads that fetched, and the table against phase 5b's checked run (or
    the same run on the map's own Cooler where phase 5 did not run): keys
    and counts exact, ``data`` rtol 1e-4. Returns the launches."""
    from coolpuppy_tpu_torch import Cooler, pileup

    engine = importlib.import_module(engine_patch.MODULE)
    t, (clr, feats) = timed(workload or engine_workload, lambda: None)
    reader = Cooler(CountingStore(clr.store))
    with fetch_log(reader) as log:
        table, launches, _, t = kernel_run(
            "reader run", lambda: pileup(reader, feats, device=dev,
                                         **ENGINE_KW), dev)
    per_fetch = fetch_spans(reader, log.fetches)
    threads = len({f[3] for f in log.fetches})
    print(f"reader run: {table_snips(table)} snips, launches {launches}, "
          f"route {table['accumulate'].iloc[0]}, {t:.2f} s; {len(per_fetch)} "
          f"fetches, each exactly its span's rows; pixels read per fetch "
          f"{per_fetch}, in all {sum(per_fetch)} of the map's "
          f"{reader.n_pixels}; fetching threads {threads} (the prefetch pool "
          f"takes at most {engine._PREFETCH_MAX})")
    held = ENGINE.get("checked")
    if held is not None and held[0] is clr and held[1].equals(feats):
        want, source = held[2], "phase 5b's checked run"
    else:
        want = kernel_run("engine run", lambda: pileup(
            clr, feats, device=dev, **ENGINE_KW), dev)[0]
        source = "the engine cell's checked run on the map's own Cooler"
    err = compare_tables(table, want, rtol=ENGINE_RTOL, atol=1e-7,
                         what="reader run vs " + source)
    print(f"reader run vs {source}: keys and counts exact, data max_abs_err "
          f"{err:.3g} (rtol {ENGINE_RTOL}) ok")
    return launches


def check_fuzz(dev, sync, card, workload=None, scale=FUZZ_ENGINE,
               seeds=FUZZ_CARD_SEEDS):
    """Phase 12b: the seeded fuzz cases (``fuzz_case`` at ``scale``) on the
    engine map, each through a counting reader of its own: per case a
    checked run (the staged kernel launched where the route is the quad
    kernel, every fetch held to its spans), the plain-swapped run (keys and
    counts exact, NaN positions equal, ``data`` and stripes rtol 1e-4) and
    the first FUZZ_CPU_SITES features card against CPU (rtol 1e-5, counts
    exact). Returns the checked runs' launches by seed."""
    import coolpuppy_tpu_torch.ops.quad_gather as qg
    from coolpuppy_tpu_torch import Cooler, pileup
    from coolpuppy_tpu_torch.expected import expected_cis

    clr = (workload or engine_workload)()[0]
    t, exp = timed(lambda: expected_cis(clr), lambda: None)
    print(f"fuzz map: {clr.n_bins} bins, {clr.n_pixels} pixels; "
          f"expected_cis {len(exp)} rows in {t:.2f} s")
    launches = {}
    for seed in seeds:
        feats, kw = fuzz_case(np.random.default_rng(seed), {"cis": exp},
                              scale)
        # a reader of its own a case: a coverage column one pileup stores
        # on its Cooler is reused by the next, whatever its min_diag
        reader = Cooler(CountingStore(clr.store))

        # a by-window case's checked and plain-swapped runs fetch float32
        # accumulators (F32_FETCH); the CPU subset's card run takes no wire
        fetch = F32_FETCH if kw.get("by_window") else {}

        def run(f, device=dev, **extra):
            return pileup(reader, f, device=device, **kw, **extra)

        qg.LAUNCHES = 0
        qg.VARIANT_LAUNCHES.update(staged=0, direct=0)
        with fetch_log(reader) as log:
            t, checked = timed(lambda: run(feats, **fetch), sync)
        n = launches[seed] = qg.LAUNCHES
        route = checked["accumulate"].iloc[0]
        if "cuda_kernel" in route:
            if n < 1:
                raise AssertionError(f"fuzz {seed}: route {route!r}, no "
                                     "launch")
            check_variant(f"fuzz {seed}", dev, n)
        elif n:
            raise AssertionError(f"fuzz {seed}: route {route!r} but {n} "
                                 "launches")
        per_fetch = fetch_spans(reader, log.fetches)
        plain = plain_swapped(f"fuzz {seed}", lambda: run(feats, **fetch),
                              route.replace("cuda_kernel", "plain"))
        err = compare_tables(checked, plain, what=f"fuzz {seed} vs plain",
                             stripe_tol=FUZZ_TOL, **FUZZ_TOL)
        sub = feats.iloc[:FUZZ_CPU_SITES]
        sub_err = compare_tables(run(sub, **F32_WIRE), run(sub, device="cpu"),
                                 what=f"fuzz {seed} subset card vs cpu",
                                 **ENGINE_MODES_TOL)
        print(f"fuzz {seed}: {fuzz_flags(kw)}; {len(feats)} features, "
              f"{table_snips(checked)} snips, {len(checked)} rows, wall "
              f"{t:.2f} s, route {route}, launches {n}; {len(per_fetch)} "
              f"fetches read {sum(per_fetch)} pixels, each its spans; vs "
              f"plain max_abs_err {err:.3g} (rtol {FUZZ_RTOL}); first "
              f"{len(sub)} card vs CPU max_abs_err {sub_err:.3g} (rtol "
              f"{ENGINE_MODES_TOL['rtol']}) ok")
    return launches


def check_by_distance(dev, sync, card, shapes=None, workload=None):
    """Phase 12c: by-strand by-distance APA of the engine cell's sites
    through the notebook alias ``coolpuppy_tpu_torch.coolpup.pileup``
    (``BY_DISTANCE_KW``, the default band edges): a warm-up, a checked run
    that must launch the staged kernel (each launch between CUDA events),
    the plain-swapped run (counts exact, ``data`` rtol 1e-4), two timed runs
    with the phases (snips/s: the ``all`` row's n + control_n over the
    wall, median), the busy share of a profiled run and the kernel's time
    over its launches beside its bound. Returns the launches; ``shapes``,
    a dict, gets the cell's ``shape_record``."""
    from coolpuppy_tpu_torch import CoordCreator, PileUpper
    from coolpuppy_tpu_torch.coolpup import pileup

    t, (clr, feats) = timed(workload or engine_workload, lambda: None)

    def run(f):
        return pileup(clr, f, device=dev, **BY_DISTANCE_KW)

    t, warm = timed(lambda: run(feats.iloc[:ENGINE_WARMUP_SITES]), sync)
    print(f"by-distance warm-up ({ENGINE_WARMUP_SITES} sites): "
          f"{engine_snips(warm)} snips in {t:.2f} s")
    with quad_kernel_events(BY_DISTANCE_SLEEP_CYCLES) as ev:
        checked, launches, calls, t = kernel_run(
            "by-distance run", lambda: run(feats), dev)
    n_snips = engine_snips(checked)
    bands = sorted(set(checked["distance_band"].astype(str)) - {"all"})
    print(f"by-distance checked run: {n_snips} snips, {len(checked)} rows "
          f"({len(bands)} distance bands x orientations), launches "
          f"{launches}, route {checked['accumulate'].iloc[0]}, {t:.2f} s")
    plain = plain_swapped("by_distance", lambda: run(feats))
    err = compare_tables(checked, plain, rtol=ENGINE_RTOL, atol=1e-7,
                         what="by-distance kernel vs plain")
    print(f"by-distance kernel vs plain (whole run): counts exact, data "
          f"max_abs_err {err:.3g} (rtol {ENGINE_RTOL}) ok")
    del plain

    def run_timed():
        kw = {k: v for k, v in BY_DISTANCE_KW.items()
              if k not in ("by_strand", "by_distance", "nshifts")}
        cc = CoordCreator(feats, clr.binsize,
                          nshifts=BY_DISTANCE_KW["nshifts"], **kw)
        pu = PileUpper(clr, cc, control=True, device=dev)
        return pu, pu.pileupsByStrandByDistanceWithControl()

    timed_runs("by_distance", run_timed, CELL_REPEATS, n_snips, sync, card,
               engine_snips)
    prof = profile_run(lambda: run(feats), sync)
    print("by-distance device busy share of one run: " + prof["text"])
    kernel_ms = sum(ev.ms)
    rec = shape_record("by_distance", calls, kernel_ms, launches, card)
    rec["profiled_ms"] = prof["kernel_ms"]
    print(f"by-distance kernel (summed over the checked run's {launches} "
          f"launches, CUDA events): {kernel_ms:.3f} ms (the profiled run's "
          f"{prof['kernel_ms']} ms); bound {rec['bound_ms']:.5f} ms by "
          f"{rec['bound_by']} on {card}")
    if shapes is not None:
        shapes["by_distance"] = rec
    return launches


# -- phase 13: the transfer wires ---------------------------------------------

# 13a: each wire on the toy maps, the card against the CPU forced onto the
# same wire (``_tile_f16_mode`` replaced on the instance, as the reference's
# own tests force it, tests/test_pallas_modes.py:242-261); ``mode`` is what
# ``_tile_wire_plan`` must return on both sides, ``coo`` that the stack goes
# over the COO wire
WIRE_TOY = {
    "lossy": dict(mode="lossy"),
    "exact": dict(mode="exact", pu=dict(clr_weight_name=None)),
    "int8": dict(mode="int8", map="small_counts"),
    "coo_trans": dict(mode="lossy", cc=dict(trans=True), coo=True),
}
# 13b: the full-size cells on the engine map (its 20,000 sites), wire on
# (the default) against off (F32_WIRE): keywords, the map ("int8": the
# engine map's counts clipped to 127), the plan's mode and the tolerance of
# ``data`` (the lossy wires: the reference's own bound for them,
# tests/test_pallas_modes.py:258-261; "exact" and int8: rtol 1e-4, the
# atomics' order); stripe planes within float16's half ulp (2^-11) or
# atol 6e-8 (its subnormals)
LOSSY_TOL = dict(rtol=2e-3, atol=1e-5)
WIRE_STRIPE_TOL = dict(rtol=2.0 ** -11, atol=6e-8)
WIRE_CELLS = {
    "engine": dict(kw=ENGINE_KW, mode="lossy", tol=LOSSY_TOL),
    "unbalanced": dict(kw=dict(ENGINE_KW, clr_weight_name=None),
                       mode="exact", tol=dict(rtol=1e-4, atol=1e-7)),
    "int8": dict(kw=ENGINE_KW, mode="int8", map="int8",
                 tol=dict(rtol=1e-4, atol=1e-7)),
    "by_window": dict(kw=MODES_CELLS["by_window"], mode="lossy",
                      tol=LOSSY_TOL, k9=True),
    "stripes": dict(kw=MODES_CELLS["stripes"], mode="lossy", tol=LOSSY_TOL,
                    stripe_tol=WIRE_STRIPE_TOL),
}
# 13c: cells timed twice more (off, on) after 13b's profiled on and off
WIRE_TIMED = ("engine", "unbalanced", "int8", "by_window")


def small_counts_map(seed=23):
    """The reference's int8 test map (tests/test_pallas.py:591-622) in
    memory: 60 bins of 1 Mb on one chromosome, Poisson counts <= 127, 5%
    NaN-weight bins, 12 stranded sites; ``counts_are_int`` set (an
    in-memory map takes the int8 wire only where a caller sets it).
    Returns ``(Cooler, features)``."""
    import pandas as pd

    from coolpuppy_tpu_torch import Cooler

    rng = np.random.default_rng(seed)
    binsize, n = 1_000_000, 60
    i, j = np.triu_indices(n)
    vals = rng.poisson(10.0 / (1.0 + np.abs(i - j)) + 0.5)
    keep = vals > 0
    weights = rng.uniform(0.5, 1.5, n)
    weights[rng.random(n) < 0.05] = np.nan
    clr = Cooler.from_arrays({"chrT": n * binsize}, binsize,
                             (i[keep], j[keep], vals[keep]), weights=weights)
    clr.counts_are_int = True
    starts = np.sort(rng.choice(np.arange(5, n - 5), 12, replace=False))
    feats = pd.DataFrame({
        "chrom": "chrT", "start": starts * binsize,
        "end": (starts + 1) * binsize, "name": "x", "score": 0,
        "strand": rng.choice(["+", "-"], 12),
    })
    return clr, feats


def int8_map(clr):
    """The engine map with each pixel's count (its stored entries summed)
    clipped to 127, an integer the int8 wire ships exactly; the same
    weights, ``counts_are_int`` set."""
    from coolpuppy_tpu_torch import Cooler

    b1, b2, count = clr.pixels_chunk(0, clr.n_pixels)
    key, inv = np.unique(b1.astype(np.int64) * clr.n_bins + b2,
                         return_inverse=True)
    count = np.minimum(np.bincount(inv, weights=count), 127).astype(np.int64)
    out = Cooler.from_arrays(clr.chromsizes, clr.binsize,
                             (key // clr.n_bins, key % clr.n_bins, count),
                             weights=clr.bins_df()["weight"].to_numpy())
    out.counts_are_int = True
    return out


class wire_spy:
    """What the wires did in a block: the modes ``_tile_wire_plan``
    returned (``plans``), the dtype each tile upload shipped (``uploads``),
    the COO wire's ``f16_mode`` per build (``coo``), the ``f16`` of each
    flip-merged accumulator fetch (``merges``) and the dtypes of the stripe
    gathers (``stripes``). It keeps the largest ``normalized_stack`` call
    (``stack_call``) and the first fetch's arguments (``merge_call``) for
    ``wire_pass_ms``. ``int8`` sets ``tile_int8`` on every PileUpper;
    ``forced`` makes every PileUpper take the card's wires (a CPU
    rehearsal)."""

    def __init__(self, int8=False, forced=False):
        self.int8, self.forced = int8, forced

    def __enter__(self):
        from coolpuppy_tpu_torch.ops import tiles

        eng = importlib.import_module(engine_patch.MODULE)
        qg = importlib.import_module("coolpuppy_tpu_torch.ops.quad_gather")
        self.plans, self.uploads, self.coo = [], [], []
        self.merges, self.stripes = [], set()
        self.stack_call = self.merge_call = None
        saved = self.saved = []

        def patch(obj, name, new):
            saved.append((obj, name, obj.__dict__.get(name, saved)))
            setattr(obj, name, new)

        plan, upload, norm = (eng.PileUpper._tile_wire_plan,
                              tiles.upload_tiles, tiles.normalized_stack)
        coo, merge = eng.build_tile_stack_coo, eng._stack_merge_fetch
        gather = qg.QuadPileupSession.stripes_device

        def plan_spy(pu, dev):
            out = plan(pu, dev)
            self.plans.append(out[0])
            return out

        def upload_spy(a, f16_mode, device):
            out = upload(a, f16_mode, device)
            self.uploads.append(str(out[0].dtype).replace("torch.", ""))
            return out

        def norm_spy(ts, *args, **kw):
            k = ts.n_tiles
            if self.stack_call is None or k > self.stack_call[0].n_tiles:
                self.stack_call = (ts, args, kw)
            return norm(ts, *args, **kw)

        def coo_spy(slab, B, want, f16_mode=False):
            self.coo.append(f16_mode)
            return coo(slab, B, want, f16_mode=f16_mode)

        def merge_spy(outs, half, **kw):
            self.merges.append(bool(kw.get("f16")))
            if self.merge_call is None:
                self.merge_call = (outs, half, kw)
            return merge(outs, half, **kw)

        def gather_spy(sess, r1, r2, f16=False):
            out = gather(sess, r1, r2, f16=f16)
            self.stripes.add(str(out.dtype).replace("torch.", ""))
            return out

        patch(eng.PileUpper, "_tile_wire_plan", plan_spy)
        patch(tiles, "upload_tiles", upload_spy)
        patch(tiles, "normalized_stack", norm_spy)
        patch(eng, "build_tile_stack_coo", coo_spy)
        patch(eng, "_stack_merge_fetch", merge_spy)
        patch(qg.QuadPileupSession, "stripes_device", gather_spy)
        if self.int8:
            patch(eng.PileUpper, "tile_int8", True)
        if self.forced:
            patch(eng.PileUpper, "_on_accelerator", lambda pu: True)
        return self

    def __exit__(self, *exc):
        for obj, name, old in reversed(self.saved):
            if old is self.saved:  # the attribute was not there
                delattr(obj, name)
            else:
                setattr(obj, name, old)

    def line(self):
        def kinds(a):
            return sorted(set(map(str, a)))

        return (f"plans {kinds(self.plans)}, uploads {kinds(self.uploads)}, "
                f"coo {kinds(self.coo)}, f16 fetches "
                f"{self.merges.count(True)} of {len(self.merges)}, stripes "
                f"{sorted(self.stripes)}")


def wire_toy_run(name, device, force):
    """One WIRE_TOY case on ``device``: ``(table, wire_spy)``; ``force``
    replaces ``_tile_f16_mode`` on the instance with the case's mode (the
    int8 case forces "lossy", from which the plan takes int8)."""
    from coolpuppy_tpu_torch import CoordCreator, PileUpper

    spec = WIRE_TOY[name]
    if spec.get("map") == "small_counts":
        clr, feats = small_counts_map()
        view, flank = None, 3_000_000
    else:
        clr, feats, view, flank = (toy_cooler()[0], toy_features(),
                                   toy_regions(), TOY_KW["flank"])
    cc = CoordCreator(feats, clr.binsize, features_format="bed", flank=flank,
                      mindist=0, nshifts=0, seed=0, **spec.get("cc", {}))
    pu = PileUpper(clr, cc, view_df=view, control=False, device=device,
                   **spec.get("pu", {}))
    if force:
        mode = "lossy" if spec["mode"] == "int8" else spec["mode"]
        pu._tile_f16_mode = lambda: mode
    with wire_spy(int8=spec["mode"] == "int8") as spy:
        table = pu.pileupsWithControl()
    return table, spy


def check_wires_toy(dev):
    """Phase 13a: every WIRE_TOY case on ``dev`` (its own wire on the
    card; forced where ``dev`` is the CPU) against the CPU forced onto the
    same wire: the plan's mode on both sides, the COO wire where asked,
    counts exact, ``data`` within rtol 1e-5."""
    for name, spec in WIRE_TOY.items():
        got, gspy = wire_toy_run(name, dev, force=dev.type != "cuda")
        want, wspy = wire_toy_run(name, "cpu", force=True)
        what = f"wire toy {name}"
        for side, spy in (("card", gspy), ("cpu", wspy)):
            if not spy.plans or set(spy.plans) != {spec["mode"]}:
                raise AssertionError(f"{what}: {side} plans {spy.plans}")
            if spec.get("coo") and set(spy.coo) != {spec["mode"]}:
                raise AssertionError(f"{what}: {side} COO builds {spy.coo}")
        if sorted(gspy.uploads) != sorted(wspy.uploads):
            raise AssertionError(f"{what}: uploads {gspy.uploads} on the "
                                 f"card, {wspy.uploads} on the CPU")
        err = compare_tables(got, want, what=what, **ENGINE_MODES_TOL)
        print(f"{what}: {len(got)} rows, n {list(got['n'])}; card "
              f"{gspy.line()}; the CPU's the same; max_abs_err {err:.3g} "
              f"(rtol {ENGINE_MODES_TOL['rtol']}) ok")


def device_split(fn, sync, dev):
    """``fn()`` once under ``torch.profiler`` (device activity only; its
    chrome trace read back): ``(out, wall_s, info)`` with ``info`` the
    device ms of kernels and of copies, the copies' count, bytes and ms by
    direction and the largest copy; ``info`` is None where ``dev`` is not a
    card or the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        t, out = timed(fn, sync)
        return out, t, None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    info = dict(kernel_ms=0.0, copy_ms=0.0, largest=None, big=[],
                HtoD=[0, 0, 0.0], DtoH=[0, 0, 0.0], DtoD=[0, 0, 0.0])
    for e in events:
        cat, ms = e.get("cat", ""), float(e.get("dur", 0.0)) / 1e3
        if cat == "kernel":
            info["kernel_ms"] += ms
        elif cat == "gpu_memcpy":
            name = e.get("name", "")
            nbytes = int((e.get("args") or {}).get("bytes", 0))
            info["copy_ms"] += ms
            for d in ("HtoD", "DtoH", "DtoD"):
                if d in name:
                    acc = info[d]
                    acc[0] += 1
                    acc[1] += nbytes
                    acc[2] += ms
            if info["largest"] is None or ms > info["largest"][2]:
                info["largest"] = (name, nbytes, ms)
            info["big"].append((nbytes, ms, name))
    if info["kernel_ms"] + info["copy_ms"] <= 0:
        return out, wall, None
    return out, wall, info


def split_line(info):
    if info is None:
        return "device split not measured"
    big = info["largest"]
    dirs = ", ".join(f"{d} {n} copies {b} bytes {ms:.3f} ms"
                     for d in ("HtoD", "DtoH")
                     for n, b, ms in [info[d]])
    most = sorted(info["big"], reverse=True)[:4]
    return (f"kernels {info['kernel_ms']:.3f} ms, copies "
            f"{info['copy_ms']:.3f} ms ({dirs}); largest copy: "
            + (f"{big[0]} {big[1]} bytes {big[2]:.3f} ms" if big else "none")
            + "; most bytes: " + ", ".join(
                f"{name} {b} bytes {ms:.3f} ms" for b, ms, name in most))


def pass_split(fn, sync, dev):
    """``fn`` once untimed (its first call allocates), then under the
    profiler (``device_split``): ``(info, text)``, with the time between
    CUDA events around a third call as ``text`` where the profiler saw no
    device time (short traces have come back empty on the card)."""
    fn()
    sync()
    info = device_split(fn, sync, dev)[2]
    if info is not None:
        return info, None
    return None, (f"{event_ms(fn, sync):.3f} ms between CUDA events (the "
                  "profiler saw no device time)")


def wire_pass_ms(spy, sync, dev):
    """The device ms of the wire's torch passes on the inputs ``spy`` kept
    from the run, each beside its float32 twin (``pass_split``): the
    largest stack's expansion + normalization from an already uploaded
    payload (the upconvert × inv, and the weight fold of the int8 wire),
    and the first flip-merged accumulator fetch with and without the
    float16 cast (kernels: merge + scale + cast; copies: the DtoH). Lines,
    or "not measured" off the card."""
    from coolpuppy_tpu_torch.ops import tiles

    if dev.type != "cuda":
        return ["not measured (no card)"]
    lines = []
    if spy.stack_call is not None:
        ts, args, kw = spy.stack_call
        raw = ts.upper if hasattr(ts, "upper") else getattr(ts, "tiles", None)
        for mode in ((kw.get("f16_mode"), False) if raw is not None
                     else ()):
            payload = tiles.upload_tiles(raw, mode, dev)
            run_kw = dict(kw, f16_mode=mode,
                          fold_weights=kw.get("fold_weights") and bool(mode))
            saved = tiles.upload_tiles
            tiles.upload_tiles = lambda *a, p=payload: p
            try:
                info, text = pass_split(
                    lambda: tiles.normalized_stack(ts, *args, **run_kw),
                    sync, dev)
            finally:
                tiles.upload_tiles = saved
            lines.append(
                f"expand + normalize of {ts.n_tiles + 1} tiles from a "
                f"{str(payload[0].dtype).replace('torch.', '')} payload "
                f"(fold {bool(run_kw['fold_weights'])}): "
                + (text or f"{info['kernel_ms']:.3f} ms of kernels"))
    if spy.merge_call is not None:
        eng = importlib.import_module(engine_patch.MODULE)
        outs, half, kw = spy.merge_call
        for f16 in (True, False):
            info, text = pass_split(
                lambda: eng._stack_merge_materialize(eng._stack_merge_fetch(
                    outs, half, **dict(kw, f16=f16))), sync, dev)
            lines.append(
                f"flip-merged fetch of {tuple(outs[0]['sum'].shape)} x "
                f"{len(outs)} block(s), f16 {f16}: "
                + (text or split_line(info)))
    return lines


def check_wires(dev, sync, card, workload=None):
    """Phase 13b/13c: every WIRE_CELLS cell on the engine map, wire on (the
    default) against off (``F32_WIRE``), each run under the profiler with
    the launch counts set to 0 just before it and read just after: the
    plan's mode (spy), the wires taken (f16 fetches in by_window, float16
    stripe gathers in stripes), ``n``, ``control_n`` and ``num`` exact,
    ``data`` within the cell's tolerance, stripe planes within
    WIRE_STRIPE_TOL with NaN and inf positions equal; then, for the cells
    of WIRE_TIMED, an off and an on run more (turns on, off, off, on) with
    the walls and phases, the copies by direction and the largest one, and
    the wire's passes (``wire_pass_ms``). Returns the on runs' launches by
    cell."""
    import coolpuppy_tpu_torch.ops.quad_gather as qg
    from coolpuppy_tpu_torch import pileup

    t, (clr, feats) = timed(workload or engine_workload, lambda: None)
    t8, clr8 = timed(lambda: int8_map(clr), lambda: None)
    print(f"wire cells: the engine map ({clr.n_bins} bins, {clr.n_pixels} "
          f"pixels, {len(feats)} sites, {t:.1f} s), its counts clipped to "
          f"127 for int8 ({t8:.1f} s); on {card}")
    forced = dev.type != "cuda"
    launches = {}
    for cell, spec in WIRE_CELLS.items():
        mclr = clr8 if spec.get("map") == "int8" else clr
        int8 = spec["mode"] == "int8"

        def run(wire, mclr=mclr, spec=spec, int8=int8):
            with wire_spy(int8=int8, forced=forced) as spy, \
                    last_upper() as cap:
                table = pileup(mclr, feats, device=dev, **spec["kw"],
                               **wire)
            return table, cap.pu, spy

        runs = []
        for turn, wire in (("on", {}), ("off", F32_WIRE)):
            qg.LAUNCHES = 0
            out, wall, info = device_split(lambda: run(wire), sync, dev)
            runs.append((turn, wall, out, info, qg.LAUNCHES))
        (_, _, (on, pu_on, spy), on_info, n_on), \
            (_, _, (off, _, off_spy), _, n_off) = runs
        what = f"wire {cell}"
        if n_on < 1 or on["accumulate"].iloc[0] != \
                off["accumulate"].iloc[0]:
            raise AssertionError(f"{what}: {n_on} launches, routes "
                                 f"{on['accumulate'].iloc[0]} / "
                                 f"{off['accumulate'].iloc[0]}")
        launches[cell] = n_on
        if not spy.plans or set(spy.plans) != {spec["mode"]} or \
                set(off_spy.plans) != {False}:
            raise AssertionError(f"{what}: plans {spy.plans} on, "
                                 f"{off_spy.plans} off")
        if spec.get("k9") and (not spy.merges or not all(spy.merges)
                               or any(off_spy.merges)):
            raise AssertionError(f"{what}: f16 fetches {spy.merges} on, "
                                 f"{off_spy.merges} off")
        if spec.get("stripe_tol") and (spy.stripes != {"float16"}
                                       or off_spy.stripes != {"float32"}):
            raise AssertionError(f"{what}: stripe gathers {spy.stripes} on,"
                                 f" {off_spy.stripes} off")
        err = compare_tables(on, off, what=f"{what} on vs off",
                             stripe_tol=spec.get("stripe_tol"),
                             **spec["tol"])
        print(f"{what} on vs off: {len(on)} rows, {table_snips(on)} snips, "
              f"{n_on} launches; on: {spy.line()}; counts exact, data "
              f"max_abs_err {err:.3g} (rtol {spec['tol']['rtol']}"
              + (", stripes rtol 2^-11 / atol 6e-8" if spec.get("stripe_tol")
                 else "") + ") ok")
        if cell in WIRE_TIMED:
            for turn, wire in (("off", F32_WIRE), ("on", {})):
                wall, (table, pu, _) = timed(lambda: run(wire), sync)
                runs.append((turn, wall, (table, pu, None), None, None))
        for i, (turn, wall, out, info, _) in enumerate(runs):
            sec = {k: round(v, 4) for k, v in
                   sorted(out[1].timers.seconds.items())}
            print(f"{what} run {i + 1} ({turn}"
                  + (", profiled" if i < 2 and info else "")
                  + f"): wall {wall:.4f} s on {card}; phases "
                  f"{json.dumps(sec)}"
                  + (f"; {split_line(info)}" if i < 2 else ""))
        for line in wire_pass_ms(spy, sync, dev):
            print(f"{what} pass: {line} on {card}")
        del runs, on, off, spy, off_spy, pu_on
    return launches


def openmp_runtimes():
    """The OpenMP runtime libraries mapped into this process."""
    import re

    with open("/proc/self/maps") as f:
        paths = {ln.split()[-1] for ln in f if len(ln.split()) > 5}
    return {p for p in paths
            if re.match(r"lib[gi]?omp", os.path.basename(p))}


PHASES = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13)


def parse_phases(argv):
    """The phases to run from ``--phases 4,8`` (default: all). The probe
    and the build, phases 1 and 2, always run."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--phases", default=",".join(map(str, PHASES)),
        help="comma-separated phases to run of %(default)s; 1 (probe) and 2 "
             "(build) always run")
    args = parser.parse_args(argv)
    try:
        chosen = {int(x) for x in args.phases.split(",") if x.strip()}
    except ValueError:
        parser.error(f"--phases takes numbers, got {args.phases!r}")
    unknown = chosen - {1, 2, *PHASES}
    if unknown:
        parser.error(f"no phase {sorted(unknown)}; choose from {PHASES}")
    if not chosen & set(PHASES):
        parser.error(f"--phases {args.phases!r} names no phase of {PHASES}: "
                     "the run would check nothing")
    return chosen


def main(argv=None):
    import torch

    argv = sys.argv[1:] if argv is None else list(argv)
    if "--rank" in argv:
        rank_main(*parse_rank(argv))
        return 0
    phases = parse_phases(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1

    # bench.py is the JAX package's frozen benchmark script; its top level
    # imports only numpy, and make_workload imports scipy alone: nothing of
    # jax or of the JAX package comes in with it
    from bench import make_workload
    from coolpuppy_tpu_torch.kernels.build import build, load_kernels
    from coolpuppy_tpu_torch.ops import gather as ga
    from coolpuppy_tpu_torch.ops import quad_gather as qg

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    card = smi_line()
    kind = torch.cuda.get_device_name(0)

    # -- 1. probe ---------------------------------------------------------
    import pandas as pd

    print(f"probe: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} pandas {pd.__version__} "
          f"numpy {np.__version__} device {kind} "
          f"count {torch.cuda.device_count()}")
    print(f"probe: nvidia-smi {card}")
    print(f"probe: nvcc {nvcc_line()}")
    print("probe: importable " + " ".join(
        f"{m}={importable(m)}" for m in ("triton", "pandas", "h5py",
                                         "matplotlib", "scipy", "yaml"))
        + f"; jax installed={importable('jax')} (looked up, not imported)")

    # -- 2. build ---------------------------------------------------------
    t, lib = timed(lambda: build(verbose=True), lambda: None)
    load_kernels()
    print(f"build: {lib} in {t:.1f} s")
    last_single, first_banded = band_limit()
    for W in (21, 33, 65, last_single, first_banded, qg.W_MAX):
        lay = qg.corner_layout(W)
        pixels, threads = qg.pixels_per_thread(W)
        print(f"staged kernel W={W}: {lay.bands} band(s) of {lay.band_rows} "
              f"rows, corner {lay.side} x {lay.stride} floats, staged rows "
              f"{B - 1 + lay.band_rows}, smem_bytes {lay.smem_bytes}, threads "
              f"{threads}, pixels/thread {pixels}, blocks/SM "
              f"{qg.staged_occupancy(W, dev)}")
    print(f"staged kernel: largest one-band W {last_single}, first banded W "
          f"{first_banded} ({qg.SMEM_MAX} bytes of shared memory a block)")
    for W in WIDE_KERNEL_W:
        bands = load_kernels().wide_accumulate_bands(W)
        if bands != ga.wide_bands(W):
            raise AssertionError(f"wide kernel W={W}: the library cuts "
                                 f"{bands} bands, the wrapper "
                                 f"{ga.wide_bands(W)}")
        print(f"wide kernel W={W}: slots {ga.wide_slots(W)} x "
              f"{ga.wide_slots(W)}, {bands} blocks an item of "
              f"{ga.WIDE_BAND} pixels, 256 threads")

    # the kernel's record: phase 4 fills it; a run without phase 4 lists
    # the kernel with the shapes of the phases it did run, and null for
    # every number it did not measure
    record = dict(KERNEL, launches=None, max_abs_err=None, ms=None,
                  plain_ms=None, bound_ms=None, bound_by=None,
                  library_ms=None, shapes={})
    # the wide kernel's record: phase 7 fills it (7c the main path, 7e the
    # kernel at every W); no single PyTorch call computes its function
    wide_record = dict(WIDE_KERNEL, launches=None, max_abs_err=None, ms=None,
                       plain_ms=None, bound_ms=None, bound_by=None,
                       library_ms=None, shapes={})
    # each phase's seconds, printed as it ends: the script must stay well
    # inside the time limit as phases are added
    mark = [time.perf_counter()]

    def phase_done(n):
        now = time.perf_counter()
        print(f"phase {n}: {now - mark[0]:.1f} s")
        mark[0] = now

    # -- 3. kernel vs plain at small shapes -------------------------------
    if 3 in phases:
        check_kernels(dev, sync)
        phase_done(3)

    # -- 4. the slice at the headline size --------------------------------
    if 4 in phases:
        t, workload = timed(make_workload, lambda: None)
        coo, r1 = workload[1], workload[2]
        print(f"workload: {coo.shape[0]} bins, {coo.nnz} nnz, {len(r1)} "
              f"snips in {t:.1f} s")
        record = check_slice(dev, sync, workload, card)
        check_sweep(dev, sync, workload, card)
        if 11 in phases:
            SLICE["workload"] = workload
        del workload, coo, r1
        phase_done(4)

    # -- 5. the engine: pileup() modes, then bench_engine's size ----------
    if 5 in phases:
        check_engine_modes(dev)
        record["engine_launches"] = check_engine(dev, sync, card,
                                                 record["shapes"])
        phase_done(5)

    # -- 6. the 2D modes: toy map, then bench.py --modes' cells ---------
    if 6 in phases:
        check_modes_2d(dev)
        record["modes_launches"] = check_modes(dev, sync, card,
                                               record["shapes"])
        phase_done(6)

    # -- 7. rescale and W > 120: toy map, the two cells; the W = 119 cell;
    # the wide kernel against its plain version ---------------------------
    if 7 in phases:
        check_rescale_wide_toy(dev)
        check_rescale_cell(dev, sync, card)
        wide_record.update(check_wide_cell(dev, sync, card))
        record["w119_launches"] = check_w119_cell(dev, sync, card,
                                                  record["shapes"])
        err, shapes = check_wide_kernels(dev, sync, card)
        wide_record["max_abs_err"] = max(wide_record["max_abs_err"], err)
        wide_record["shapes"].update(shapes)
        phase_done(7)

    # -- 8. the extension hooks: toy map, bench_extension, BEDPE windows --
    if 8 in phases:
        check_hook_modes(dev)
        frame_launches, clr = check_extension(dev, sync, card,
                                              record["shapes"])
        record["extension_launches"] = {
            "frame_column": frame_launches,
            "by_window_bedpe": check_bedpe_by_window(dev, sync, card, clr,
                                                     record["shapes"]),
        }
        del clr
        phase_done(8)

    # -- 9. the coolpup-torch CLI: toy flag sets, then the engine cell ------
    if 9 in phases:
        check_cli_toy(dev)
        record["cli_launches"] = check_cli(dev, sync, card, record["shapes"])
        phase_done(9)

    # -- 10. the genome cell: native ingest, prefetch, streams -------------
    if 10 in phases:
        record["genome_launches"] = check_genome(dev, sync, card,
                                                 record["shapes"])
        phase_done(10)

    # -- 11. the mesh: toy modes, the genome cell, the session, two ranks --
    if 11 in phases:
        record["mesh_launches"] = {
            "modes": check_mesh_modes(dev),
            "genome": check_mesh_genome(dev, sync, card, record["shapes"]),
        }
        GENOME.clear()
        record["mesh_session_snips_s"] = check_mesh_session(dev, sync, card)
        check_two_ranks(dev, sync, card)
        phase_done(11)

    # -- 12. the reader's fetch path, the fuzz cases, by distance ----------
    if 12 in phases:
        record["reader_launches"] = {
            "fetch_path": check_reader(dev, sync, card),
            "fuzz": check_fuzz(dev, sync, card),
            "by_distance": check_by_distance(dev, sync, card,
                                             record["shapes"]),
        }
        phase_done(12)

    # -- 13. the transfer wires: toy cases, the full-size cells, times ----
    if 13 in phases:
        check_wires_toy(dev)
        record["wire_launches"] = check_wires(dev, sync, card)
        phase_done(13)

    # -- result -----------------------------------------------------------
    print(card)
    print(json.dumps({"kernels": [record, wide_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
