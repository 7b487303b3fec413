"""CPU rehearsals of ``chip_smoke.py``'s phases at a tiny size (5b, 6b,
7b-7e, 3, 4, 8a-8c, 9a/9b, 10, 11a-11d, 12a-12c, 13a-13c): the same control
flow, checks and timing lines,
with the kernels' wrappers swapped for plain versions that count their
calls as launches (the CUDA kernels cannot run here)."""

import importlib
import sys
from pathlib import Path

import pytest
import torch

import coolpuppy_tpu_torch.ops.gather as ga
import coolpuppy_tpu_torch.ops.quad_gather as qg

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
try:
    import chip_smoke
finally:
    sys.path.remove(str(REPO))


def test_modes_phase_rehearsal(monkeypatch, capsys):
    plain = qg.quad_accumulate_plain

    def counted(*args):
        qg.LAUNCHES += 1
        return plain(*args)

    monkeypatch.setattr(qg, "quad_accumulate", counted)
    full = chip_smoke.modes_workload
    monkeypatch.setattr(chip_smoke, "modes_workload", lambda: full(
        n_sites=120, n_bins=1_200, n_contacts=60_000, n_trans=40,
        trans_size=(600, 500, 30_000, 20_000),
    ))
    launches = chip_smoke.check_modes(torch.device("cpu"), lambda: None,
                                      "cpu rehearsal")
    assert launches == {"stripes": 1, "by_window": 1, "bedpe": 1, "trans": 1}
    out = capsys.readouterr().out
    for cell in chip_smoke.MODES_CELLS:
        assert f"modes {cell} kernel vs plain (whole run)" in out
        assert f"modes {cell} snips/s:" in out
    assert "stripe rows equal stripes_host" in out


def _fake_wide_kernel(monkeypatch):
    """The wide kernel's stand-in: ``generic_accumulate``, in the gather
    module and where the engine looked it up, runs the plain version on the
    CPU and counts a launch where the kernel's wrapper would; the CUDA
    events around each launch read one millisecond."""
    engine = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")
    plain = ga.generic_accumulate_plain
    fired = []  # one entry a launch, never reset

    def launched(stiles, tile_map, r1, r2, cid, W, C, stripes=False,
                 block=None):
        if len(r1):
            ga.LAUNCHES += 1
            fired.append(W)
        return plain(stiles, tile_map, r1, r2, cid, W, C, stripes=stripes,
                     block=block)

    class trace:
        def __init__(self, cycles=None, entries=None):
            assert entries == chip_smoke.WIDE_ENTRIES

        def __enter__(self):
            self.before = len(fired)
            return self

        def __exit__(self, *exc):
            self.ms = [1.0] * (len(fired) - self.before)

    monkeypatch.setattr(ga, "generic_accumulate", launched)
    monkeypatch.setattr(engine, "generic_accumulate", launched)
    monkeypatch.setattr(chip_smoke, "quad_kernel_events", trace)
    monkeypatch.setattr(chip_smoke, "event_ms",
                        lambda fn, sync: chip_smoke.timed(fn, sync)[0] * 1e3)
    return fired


def test_rescale_and_wide_phase_rehearsal(monkeypatch, capsys):
    """Phase 7b, 7c and 7e at a tiny size: 50 TADs (widths cut to a quarter
    so the extents stay within two 128-bin buckets) held against the host
    loop, 200 sites at W = 123 through the wide kernel's stand-in (its
    calls, the plain-swapped run, the bound), and the wide kernel's cases
    at every W on 40 snips, with runs cut at 30."""
    full_rescale = chip_smoke.rescale_workload

    def rescale_workload():
        clr, feats = full_rescale(n_tads=50, n_bins=1_500, n_contacts=150_000)
        bins = (feats["end"] - feats["start"]) // clr.binsize
        return clr, feats.assign(end=feats["start"] + bins // 4 * clr.binsize)

    ms = chip_smoke.check_rescale_cell(torch.device("cpu"), lambda: None,
                                       "cpu rehearsal",
                                       workload=rescale_workload)
    assert sorted(ms) == ["local", "local_ooe"]
    fired = _fake_wide_kernel(monkeypatch)
    monkeypatch.setattr(chip_smoke, "WIDE_CELL_KW", dict(
        chip_smoke.WIDE_CELL_KW, flank=610_000, maxdist=1_500_000))
    rec = chip_smoke.check_wide_cell(
        torch.device("cpu"), lambda: None, "cpu rehearsal",
        workload=lambda: chip_smoke.engine_workload(
            n_sites=200, n_bins=1_500, n_contacts=150_000),
    )
    out = capsys.readouterr().out
    for variant in ("local", "local_ooe"):
        assert f"rescale {variant} checked run:" in out
        assert f"rescale {variant} vs the host loop" in out
        assert f"rescale {variant} rescale_accumulate: device span" in out
        assert f"rescale {variant} snips/s:" in out
    assert "W 123, route generic_torch" in out
    assert "wide generic_accumulate: device span" in out
    assert "wide snips/s:" in out
    assert "wide step calls vs plain on the same inputs" in out
    assert "wide kernel vs plain (whole run, plain version" in out
    assert rec["launches"] >= 1 and rec["ms"] == float(rec["launches"])
    assert rec["plain_ms"] == chip_smoke.PLAIN_MS["wide"] > 0
    assert rec["bound_by"] in ("bytes", "operations") and rec["bound_ms"] > 0
    shape = rec["shapes"]["wide"]
    assert shape["W"] == 123 and shape["snips"] > 200
    assert shape["snips"] * 123 < shape["pixels"] < shape["snips"] * 123 ** 2

    monkeypatch.setattr(chip_smoke, "WIDE_CASE_SNIPS", 40)
    monkeypatch.setattr(ga, "ITEM_MAX", 30)
    before = len(fired)
    err, shapes = chip_smoke.check_wide_kernels(
        torch.device("cpu"), lambda: None, "cpu rehearsal")
    assert fired[before:] == [W for W in chip_smoke.WIDE_KERNEL_W
                              for _ in range(2)]
    assert err == 0.0
    out = capsys.readouterr().out
    for W in chip_smoke.WIDE_KERNEL_W:
        rec = shapes[f"7e W={W}"]
        assert rec["launches"] == 1 and rec["W"] == W and rec["ms"] == 1.0
        assert rec["snips"] == 40 + (107 if W in (201, 401) else 0)
        assert f"wide kernel vs plain W={W}: R " in out
        assert f"7e W={W} wide kernel bound:" in out



def _fake_kernels(monkeypatch):
    """Stand-ins for the two CUDA launchers and the routed wrapper that run
    the plain version on the CPU and count launches as the launchers do."""
    plain = qg.quad_accumulate_plain
    fired = []  # one entry a launch, never reset

    def launcher(variant):
        def launch(stiles, k, qstart, qcount, snips, W, C, **kw):
            assert set(kw) <= {"pixels"}
            if variant == "staged":
                assert qg.corner_layout(W).staged
            else:  # the direct kernel takes single-group items only
                g = (snips & 0x1FFFF).tolist()
                for s, c in zip(qstart.tolist(), qcount.tolist()):
                    assert len(set(g[s:s + c])) <= 1
            if k.shape[0]:
                qg.LAUNCHES += 1
                qg.VARIANT_LAUNCHES[variant] += 1
                fired.append(variant)
            s, n = plain(stiles, k, qstart, qcount, snips, W, C)
            return s.to(torch.float32), n.to(torch.int32)
        return launch

    staged, direct = launcher("staged"), launcher("direct")

    def routed(stiles, k, qstart, qcount, snips, W, C):
        s, n = staged(stiles, k, qstart, qcount, snips, W, C)
        return s.to(torch.float64), n.to(torch.float64)

    monkeypatch.setattr(qg, "quad_accumulate_staged", staged)
    monkeypatch.setattr(qg, "quad_accumulate_direct", direct)
    monkeypatch.setattr(qg, "quad_accumulate", routed)
    monkeypatch.setattr(qg, "staged_occupancy", lambda *a, **k: 2)
    monkeypatch.setattr(chip_smoke, "event_ms",
                        lambda fn, sync: chip_smoke.timed(fn, sync)[0] * 1e3)

    class trace:
        """One fake kernel time per launch made during the block."""

        def __init__(self, cycles=None):
            pass

        def __enter__(self):
            self.before = len(fired)
            return self

        def __exit__(self, *exc):
            self.ms = [1.0] * (len(fired) - self.before)

    monkeypatch.setattr(chip_smoke, "quad_kernel_events", trace)


def test_kernel_phase_rehearsal(monkeypatch, capsys):
    """Phase 3 with the launchers replaced by counting plain versions: every
    case reaches both kernels, with the items each takes, and the routed
    wrapper takes the staged kernel, in two bands from W = 111 on."""
    _fake_kernels(monkeypatch)
    chip_smoke.check_kernels(torch.device("cpu"), lambda: None)
    out = capsys.readouterr().out
    last_single, first_banded = chip_smoke.band_limit()
    assert (last_single, first_banded) == (110, 111)
    assert qg.corner_layout(last_single).bands == 1
    assert qg.corner_layout(first_banded).bands == 2
    for name in ("W=11", "W=21", "W=21 empty", "W=65", "W=115", "W=120",
                 f"W={last_single}", f"W={first_banded}",
                 "W=21 by-window runs", "W=21 ITEM_MAX cuts",
                 "W=21 item longer than the chunk", "W=33 missing tiles",
                 f"W={first_banded} missing tiles", "W=120 missing tiles"):
        assert f"kernel vs plain {name}: " in out
    lines = {ln.split(": ")[0]: ln for ln in out.splitlines()}
    for W in (21, 111, 115, 120):
        line = lines[f"kernel vs plain W={W}"]
        assert "[direct; staged; staged, whole quads; routed]" in line
        assert f"bands {1 if W <= 110 else 2} " in line


def test_slice_phase_rehearsal(monkeypatch, capsys):
    """Phase 4 (the slice and the W sweep) at a tiny size on the CPU, with
    the launchers replaced: control flow, checks, the bound and the JSON
    record's keys."""
    from bench import make_workload

    _fake_kernels(monkeypatch)
    monkeypatch.setattr(chip_smoke, "SWEEP_LOCI", 300)
    monkeypatch.setattr(chip_smoke, "ITEM_MAX_SWEEP", (64, 1024))
    monkeypatch.setattr(chip_smoke, "KERNEL_ROUNDS", 1)
    monkeypatch.setattr(chip_smoke, "REPEATS", 1)
    monkeypatch.setattr(chip_smoke, "PLAIN_REPEATS", 1)
    workload = make_workload(n_bins=1_500, nnz_target=100_000, n_loci=3_000)
    dev = torch.device("cpu")
    rec = chip_smoke.check_slice(dev, lambda: None, workload, "cpu rehearsal")
    assert set(rec) >= {"name", "route", "source", "replaces", "launches",
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "direct_ms", "variant"}
    assert rec["variant"] == "staged" and rec["library_ms"] is None
    assert rec["launches"] == 1 and rec["bound_by"] == "bytes"
    shape = rec["shapes"]["slice"]
    # the stack pixels the windows cover, and the 8 groups (4 and their
    # flip bank) written
    want_bytes = (4 * shape["pixels"] + 4 * 3_000 + 24 * shape["items"]
                  + 8 * 8 * 21 * 21)
    assert shape["snips"] == 3_000 and shape["C"] == 16
    assert shape["groups"] == 8
    assert 3_000 * 21 < shape["pixels"] < 3_000 * 21 * 21
    assert rec["bound_ms"] == 1e3 * want_bytes / chip_smoke.PEAK_BYTES_S
    chip_smoke.check_sweep(dev, lambda: None, workload, "cpu rehearsal")
    out = capsys.readouterr().out
    assert "slice: launches 1 variant staged" in out
    assert "kernel timing in turns (direct, staged, staged, direct" in out
    assert "staged by ITEM_MAX in turns" in out
    lines = {ln.split(": ")[0]: ln for ln in out.splitlines()
             if ln.startswith("sweep W=")}
    for W in (11, 33, 65, 110, 111, 115, 120):
        assert f"sweep W={W}: 300 snips" in out
        line = next(ln for ln in lines.values()
                    if ln.startswith(f"sweep W={W}: 300 snips"))
        assert "routed staged" in line
        assert f"bands {1 if W <= 110 else 2} of " in line
        assert "direct: kernel" in line and "staged: kernel" in line
    assert "sweep W=11: 3000 snips" in out


def test_w119_phase_rehearsal(monkeypatch, capsys):
    """Phase 7d at a tiny size: 60 sites of a 1,500-bin map at W = 119
    through the staged kernel's stand-in, the direct-swapped run (the
    direct launcher's stand-in, which takes single-group items only), the
    CPU subset, the timings and the bound."""
    _fake_kernels(monkeypatch)
    monkeypatch.setattr(chip_smoke, "ENGINE_WARMUP_SITES", 20)
    monkeypatch.setattr(chip_smoke, "W119_SUBSET_SITES", 30)
    shapes = {}
    launches = chip_smoke.check_w119_cell(
        torch.device("cpu"), lambda: None, "cpu rehearsal", shapes,
        workload=lambda: chip_smoke.engine_workload(
            n_sites=60, n_bins=1_500, n_contacts=150_000))
    assert launches >= 1
    rec = shapes["w119"]
    assert rec["launches"] == launches and rec["snips"] > 60
    assert rec["bound_by"] in ("bytes", "operations")
    out = capsys.readouterr().out
    assert "W 119 in " in out
    assert f"launches {launches} (staged only), route cuda_kernel" in out
    assert "w119 staged vs direct kernel (whole run, " in out
    assert "w119 subset (30 sites" in out
    assert "w119 kernel vs plain (whole run, plain version " in out
    assert rec["plain_ms"] == chip_smoke.PLAIN_MS["w119"] > 0
    assert "w119 snips/s:" in out
    assert f"w119 kernels (summed over each run's launches, CUDA events): " \
        f"staged {float(launches):.3f} ms in {launches} launches" in out


def _counted_plain(monkeypatch):
    """``quad_accumulate`` swapped for the plain version, counting its calls
    as launches (the engine then records ``cuda_kernel``)."""
    plain = qg.quad_accumulate_plain

    def counted(*args):
        qg.LAUNCHES += 1
        return plain(*args)

    monkeypatch.setattr(qg, "quad_accumulate", counted)


def test_hook_modes_phase_rehearsal(capsys):
    """Phase 8a on the CPU: every extension route and by-window case runs
    and agrees with itself, with the extras' columns present."""
    chip_smoke.check_hook_modes(torch.device("cpu"))
    out = capsys.readouterr().out
    for name, spec in chip_smoke.HOOK_MODES.items():
        route = "plain" if spec["routes"][0] == "cuda_kernel" else \
            spec["routes"][0]
        assert f"hook mode {name}: " in out
        line = next(ln for ln in out.splitlines()
                    if ln.startswith(f"hook mode {name}: "))
        assert f"route {route}," in line and line.endswith(" ok")
    # (two regions of 3 pairs: extra funcs replace the merge of their pups,
    # the reference's sum_pups quirk, so n is one region's and the lists
    # are both regions')
    assert ("hook mode frame_column_controls: 1 rows, n [3], route plain, "
            "max_abs_err 0, score1 [6], control_score1 [10] ok") in out


def test_extension_phase_rehearsal(monkeypatch, capsys):
    """Phases 8b and 8c at a tiny size: ``bench_extension``'s three routes
    on 300 and 120 sites of a 1,500-bin map, then by-window of the BEDPE
    rows of 150 sites against the BED dual-anchor run."""
    _counted_plain(monkeypatch)
    monkeypatch.setattr(chip_smoke, "EXTENSION_WARMUP",
                        {"frame": 60, "batch": 40, "snip": 40})
    monkeypatch.setattr(chip_smoke, "EXTENSION_CPU_SITES", 60)
    shapes = {}
    dev = torch.device("cpu")
    launches, clr = chip_smoke.check_extension(
        dev, lambda: None, "cpu rehearsal", shapes,
        workload=lambda: chip_smoke.extension_workload(
            n_big=300, n_small=120, n_bins=1_500, n_contacts=150_000),
    )
    assert launches == 1
    assert shapes["extension_frame_column"]["launches"] == 1
    assert shapes["extension_frame_column"]["snips"] > 300
    assert chip_smoke.check_bedpe_by_window(
        dev, lambda: None, "cpu rehearsal", clr, shapes, n_sites=150) == 1
    assert shapes["by_window_bedpe"]["snips"] > 300
    out = capsys.readouterr().out
    for route in ("frame", "batch", "snip"):
        assert f"extension {route} checked run:" in out
        assert f"extension {route} snips/s:" in out
    assert "extension frame kernel vs plain (whole run)" in out
    assert "extension batch subset (60 sites" in out
    assert "extension routes on the same 120 sites: n " in out
    assert "bedpe by-window kernel vs plain (whole run, " in out
    assert "bedpe by-window vs the BED dual-anchor run over the same" in out
    assert "bedpe by-window snips/s:" in out


def test_phases_option():
    assert chip_smoke.parse_phases([]) == {3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
                                           13}
    assert chip_smoke.parse_phases(["--phases", "1,2,8"]) == {1, 2, 8}
    assert chip_smoke.parse_phases(["--phases", "9"]) == {9}
    assert chip_smoke.parse_phases(["--phases", "10"]) == {10}
    assert chip_smoke.parse_phases(["--phases", "11"]) == {11}
    assert chip_smoke.parse_phases(["--phases", "12"]) == {12}
    assert chip_smoke.parse_phases(["--phases", "13"]) == {13}
    for bad in ("14", "x", "", "1,2", ","):
        try:
            chip_smoke.parse_phases(["--phases", bad])
        except SystemExit as e:
            assert e.code == 2
        else:
            raise AssertionError(f"--phases {bad} was accepted")


def test_engine_phase_rehearsal(monkeypatch, capsys):
    """Phase 5b at a tiny size: 200 sites on a 1,500-bin map."""
    _counted_plain(monkeypatch)
    full = chip_smoke.engine_workload
    monkeypatch.setattr(chip_smoke, "engine_workload", lambda: full(
        n_sites=200, n_bins=1_500, n_contacts=150_000))
    monkeypatch.setattr(chip_smoke, "ENGINE_WARMUP_SITES", 50)
    shapes = {}
    assert chip_smoke.check_engine(torch.device("cpu"), lambda: None,
                                   "cpu rehearsal", shapes) == 1
    assert shapes["engine"]["launches"] == 1
    out = capsys.readouterr().out
    assert "engine kernel vs plain (whole run)" in out
    assert "engine timing: wall_s" in out and "engine snips/s:" in out


def test_cli_phase_rehearsal(monkeypatch, capsys):
    """Phase 9 on the CPU: every CLI flag set of 9a (card and CPU sides
    both the plain version here) with the ``.txt`` round trip, then 9b at a
    tiny size: 200 sites on a 1,500-bin map, without and with an expected
    file, each side of it held against the plain-swapped run and the direct
    ``pileup()`` call, with timings, file reads and the kernel's bound."""
    chip_smoke.check_cli_toy(torch.device("cpu"))
    out = capsys.readouterr().out
    for name in chip_smoke.CLI_FLAG_SETS:
        line = next(ln for ln in out.splitlines()
                    if ln.startswith(f"cli {name}: "))
        assert line.endswith(" ok"), line
    assert "cli expected_index: refused on both devices" in out
    assert ("cli local_rescale: 1 rows, n [4], route rescale_torch" in out)
    assert "cli .txt round trip of the groupby all row" in out

    _counted_plain(monkeypatch)
    monkeypatch.setattr(chip_smoke, "ENGINE_WARMUP_SITES", 50)
    shapes = {}
    launches = chip_smoke.check_cli(
        torch.device("cpu"), lambda: None, "cpu rehearsal", shapes,
        workload=lambda: chip_smoke.engine_workload(
            n_sites=200, n_bins=1_500, n_contacts=150_000))
    assert launches == {"controls": 1, "expected": 1}
    # both stream, into the stream's bank of 512 groups; controls add
    # their snips, the expected file run has none (nshifts 0)
    ctrl, exp = shapes["cli_controls"], shapes["cli_expected"]
    assert (ctrl["C"], exp["C"]) == (1024, 1024)
    assert ctrl["snips"] > exp["snips"] > 0
    out = capsys.readouterr().out
    for variant in ("controls", "expected"):
        what = f"cli {variant}"
        assert f"{what} checked run: " in out
        assert f"{what} device busy share of that run: " in out
        assert f"{what} kernel vs plain (whole run): " in out
        assert f"{what} vs pileup() with the keywords the CLI resolved" in out
        assert f"{what} timing: wall_s" in out
        assert f"{what} snips/s: " in out
        assert f"{what} file reads (s, per timed run): " in out
        assert f"{what} kernel bound: " in out
    reads = [ln for ln in out.splitlines() if "file reads" in ln]
    assert '"read_expected_from_file": 0.0}' in reads[0]
    assert '"read_expected_from_file": 0.0}' not in reads[1]


def test_genome_phase_rehearsal(monkeypatch, capsys):
    """Phase 10 at a tiny size: 3 chromosomes of 1,200 bins, 360 sites, with
    stream chunks of 2,000 snips so every region launches several times; the
    native entries against their numpy branches on a 1,500-bin engine map."""
    from coolpuppy_tpu_torch import native

    _counted_plain(monkeypatch)
    engine = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")
    monkeypatch.setattr(engine, "_STREAM_CHUNK", 2_000)
    # the tiny slabs take the scatter's threaded branches, which add in
    # input order at one thread only (at full size: the two-pass branch)
    before = native.threads()
    native.set_threads(1)
    shapes = {}
    try:
        launches = chip_smoke.check_genome(
            torch.device("cpu"), lambda: None, "cpu rehearsal", shapes,
            workload=lambda: chip_smoke.genome_workload(
                n_chroms=3, bins_per=1_200, contacts_per=50_000,
                n_sites=360),
            engine=lambda: chip_smoke.engine_workload(
                n_sites=200, n_bins=1_500, n_contacts=150_000))
    finally:
        native.set_threads(before)
    assert launches > 3 and shapes["genome"]["launches"] == launches
    assert shapes["genome_chunk"]["snips"] == 2_000
    out = capsys.readouterr().out
    for line in ("native tile_scatter_wtri genome chromosome: ",
                 "native tile_scatter_wtri engine map: ",
                 "native quad_sort (two passes, sort_quads) on the engine",
                 "native enumerate_pairs on one chromosome's 120 sites",
                 "threads: torch ", "genome warm-up (one chromosome's 120 ",
                 "stream_regions 3, stream_aborts 0, route cuda_kernel",
                 "genome kernel vs plain (whole run)",
                 "genome stream vs the collected path",
                 "genome snips/s: ", "genome phases of a timed run (s): ",
                 "genome kernel bound: ", "genome stream chunk kernel bound: "):
        assert line in out, line


@pytest.mark.parametrize("W,n", [(21, 400), (201, 20)],
                         ids=["quad W21", "wide W201"])
def test_covered_pixels_counts_each_stack_pixel_once(W, n):
    """The kernel bound's bytes read: the union of the pixels every window
    covers, through each work item's tile slots (a quad item's four, a wide
    item's R x R), against a brute-force count over the cut windows."""
    import numpy as np

    rng = np.random.default_rng(3)
    nt = 5
    tmap = np.zeros((nt + 1, nt + 1), np.int32)
    tmap[:nt, :nt] = rng.permutation(nt * nt).reshape(nt, nt) + 1
    tmap[2, 3] = 0  # a missing tile reads slot 0
    r1 = rng.integers(0, nt * 128 - W, n)
    r2 = rng.integers(0, nt * 128 - W, n)
    cid = rng.integers(0, 5, n)
    if W <= qg.W_MAX:
        snips, k, qs, qc = qg.sort_quads(r1, r2, cid, tmap, 128)
        items = (*qg.split_items(k, qs, qc, item_max=7), snips)
        items = [torch.from_numpy(a) for a in items]
    else:
        items = ga.wide_items(*(torch.from_numpy(np.asarray(a, np.int64))
                                for a in (tmap, r1, r2, cid)), W, 5,
                              item_max=7)
        assert items[0].shape[1] == 9
    got = chip_smoke.covered_pixels(*items, W, block=5)
    cells = set()
    for a, b in zip(r1, r2):
        for i in range(a, a + W):
            for j in range(b, b + W):
                cells.add((int(tmap[i // 128, j // 128]), i % 128, j % 128))
    assert got == len(cells)


def test_mesh_modes_phase_rehearsal(monkeypatch, capsys):
    """Phase 11a with the CPU as the card and the plain version counting
    its calls as launches: every mesh mode on meshes of 2 and 4 against one
    device and the CPU mesh, a launch on every device that holds snips."""
    _counted_plain(monkeypatch)
    launches = chip_smoke.check_mesh_modes(torch.device("cpu"))
    assert set(launches) == set(chip_smoke.MESH_MODES)
    assert all(n > 0 for n in launches["cis_banded"])
    assert launches["wide_banded"] == [0] * 4
    out = capsys.readouterr().out
    for name in chip_smoke.MESH_MODES:
        for n in chip_smoke.MESH_SIZES:
            line = next(ln for ln in out.splitlines()
                        if ln.startswith(f"mesh mode {name} n={n}: "))
            assert line.endswith(" ok")
    assert "route generic_torch, banded 2" in out
    assert "mesh modes: current device unchanged (None)" in out


def test_mesh_genome_and_session_phase_rehearsal(monkeypatch, capsys):
    """Phases 11b and 11c at a tiny size: the genome cell of 3 chromosomes
    of 1,200 bins on meshes of 1, 2 and 4 against one device, and the mesh
    session on 3,000 loci of a 2,000-bin map."""
    _counted_plain(monkeypatch)
    dev = torch.device("cpu")
    shapes = {}
    out_launches = chip_smoke.check_mesh_genome(
        dev, lambda: None, "cpu rehearsal", shapes,
        workload=lambda: chip_smoke.genome_workload(
            n_chroms=3, bins_per=1_200, contacts_per=50_000, n_sites=360))
    assert sorted(out_launches) == [1, 2, 4]
    assert out_launches[1] == [3] and len(out_launches[4]) == 4
    assert shapes["genome_mesh_4"]["launches"] == sum(out_launches[4])
    rates = chip_smoke.check_mesh_session(
        dev, lambda: None, "cpu rehearsal",
        workload=lambda: chip_smoke.scaling_workload(
            n_loci=3_000, n_bins=2_000, nnz_target=100_000))
    assert sorted(rates) == [1, 2, 4]
    out = capsys.readouterr().out
    for n in (1, 2, 4):
        assert f"genome mesh of {n}: " in out
        assert f"genome mesh of {n} vs one device: " in out
        assert f"mesh session n={n}: " in out
    assert "genome mesh of 4 device busy share of one run: " in out
    assert "genome mesh of 4 kernel bound: " in out


def test_two_ranks_phase_rehearsal(capsys):
    """Phase 11d on the CPU: two gloo ranks started from the script, each on
    a 2-chromosome map, against this process's one-process run."""
    chip_smoke.check_two_ranks(
        torch.device("cpu"), lambda: None, "cpu rehearsal",
        workload=dict(n_chroms=2, bins_per=1_200, contacts_per=50_000,
                      n_sites=240))
    out = capsys.readouterr().out
    assert "rank 0: map " in out and "rank 1: map " in out
    assert "region pairs [('chr1', 'chr1')] (1)" in out
    assert "region pairs [('chr2', 'chr2')] (1)" in out
    assert "two ranks == one process: " in out


def test_reader_phase_rehearsal(monkeypatch, capsys):
    """Phase 12 at a tiny size on a 1,500-bin map: 12a (200 sites through
    the counting reader, every fetch its spans, against the engine run),
    12b (the eight card seeds at 40-80 sites) and 12c (by distance through
    the notebook alias), with the launchers replaced by counting plain
    versions."""
    _fake_kernels(monkeypatch)
    monkeypatch.setattr(chip_smoke, "ENGINE_WARMUP_SITES", 20)
    monkeypatch.setattr(chip_smoke, "FUZZ_CPU_SITES", 30)
    dev = torch.device("cpu")

    def workload():
        return chip_smoke.engine_workload(n_sites=200, n_bins=1_500,
                                          n_contacts=150_000)

    assert chip_smoke.check_reader(dev, lambda: None, "cpu rehearsal",
                                   workload=workload) >= 1
    out = capsys.readouterr().out
    assert "fetches, each exactly its span's rows; pixels read per fetch" \
        in out
    assert "reader run vs " in out and "keys and counts exact" in out
    scale = dict(chip_smoke.FUZZ_ENGINE, n=(40, 80), start=(100, 1_400),
                 tad=(5, 30))
    launches = chip_smoke.check_fuzz(dev, lambda: None, "cpu rehearsal",
                                     workload=workload, scale=scale)
    assert sorted(launches) == list(chip_smoke.FUZZ_CARD_SEEDS)
    out = capsys.readouterr().out
    for seed in chip_smoke.FUZZ_CARD_SEEDS:
        assert f"fuzz {seed}: " in out
    assert out.count(" ok\n") == len(chip_smoke.FUZZ_CARD_SEEDS)
    shapes = {}
    n = chip_smoke.check_by_distance(dev, lambda: None, "cpu rehearsal",
                                     shapes, workload=workload)
    assert n >= 1 and shapes["by_distance"]["launches"] == n
    out = capsys.readouterr().out
    assert "by-distance kernel vs plain (whole run)" in out
    assert "by_distance snips/s:" in out
    assert f"summed over the checked run's {n} launches" in out



def test_wires_phase_rehearsal(monkeypatch, capsys):
    """Phase 13 at a tiny size with every wire forced on the CPU: 13a's
    four toy cases (the plan's mode on both sides, the COO wire) and 13b/13c
    on a 1,500-bin map (200 sites; the reference's bank lowered to 8 groups
    so by_window's blocks take the float16 fetch)."""
    _counted_plain(monkeypatch)
    dev = torch.device("cpu")
    chip_smoke.check_wires_toy(dev)
    out = capsys.readouterr().out
    for name, spec in chip_smoke.WIRE_TOY.items():
        assert f"wire toy {name}: " in out
        assert f"card plans ['{spec['mode']}']" in out
    assert "coo ['lossy']" in out and "uploads ['int8']" in out
    engine = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")
    monkeypatch.setattr(engine, "_bank_groups", lambda W: 8)
    launches = chip_smoke.check_wires(
        dev, lambda: None, "cpu rehearsal",
        workload=lambda: chip_smoke.engine_workload(
            n_sites=200, n_bins=1_500, n_contacts=150_000))
    assert launches == {cell: 1 for cell in chip_smoke.WIRE_CELLS}
    out = capsys.readouterr().out
    for cell in chip_smoke.WIRE_CELLS:
        assert f"wire {cell} on vs off: " in out
        assert f"wire {cell} run 2 (off): " in out
    for cell in chip_smoke.WIRE_TIMED:
        assert f"wire {cell} run 4 (on): " in out
    assert "uploads ['int8']" in out
    assert "f16 fetches 1 of 1" in out and "stripes ['float16']" in out
