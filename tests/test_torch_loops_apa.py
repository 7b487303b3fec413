"""Loop APA over a raw map with coverage normalization and shifted BEDPE
controls (the benchmark's ``loops_10kb.apa_bedpe`` cell) on the CPU, at a
small size: three chromosomes of 600 bins of the benchmark's ``cis_zipf``
map, 120 loops, through ``pileup()`` with the cell's own keywords, against
the benchmark's plain reference (``pupbench/reference``: ``cis_raw``
values, ``square_coverage`` windows, ``coverage_groups`` table).

The float16 wire runs on the card only; here ``_on_accelerator`` is
patched so the CPU takes it too: the exact wire must hand raw counts back
bit for bit, and a region holding a count that float16 cannot carry falls
back to float32. Also: the reference's coverage against a direct
bincount of the map's pixels, the bfloat16 control failing the cell's
limits, the ``coverage`` phase, the ``prepare/coverage`` span and the
counters, and the harness finding the new configuration, cell and
reader."""

import copy
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

import coolpuppy_tpu_torch as port
from coolpuppy_tpu_torch.coverage import coverage as program_coverage
from coolpuppy_tpu_torch.observability import PhaseTimers

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
try:
    from pupbench import compare, control, harness, reference, spec
    from pupbench.gen import features as gen_features
    from pupbench.harness import Context
    from pupbench.reference.pileup import reference_pileup
finally:
    sys.path.remove(str(REPO))

engine = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")
NAME = "loops_10kb.apa_bedpe"
SEED = 2**31 + 4_242
COVERAGE_COUNTS = ("coverage_regions", "coverage_hist_regions",
                   "coverage_scatter_regions")
WIRE_COUNTS = ("tile_wire_exact_f16_regions", "tile_wire_f32_regions",
               "tile_cast_native_regions")


def small():
    """(config, cell) of the loops cell cut to 3 chromosomes of 600 bins
    and 120 loops; every width and keyword as the cell has them."""
    cfg = spec.config(spec.workload(NAME)["config"])
    cfg["map"] = dict(cfg["map"], chromosomes=3, bins_per_chromosome=600,
                      contacts_per_chromosome=100_000)
    cfg["features"] = dict(cfg["features"], count=120)
    cell = spec.cell(NAME)
    cell["pool_jobs"] = 2
    return cfg, cell


@pytest.fixture(scope="module")
def loops():
    """The small cell's inputs: ``harness.Cell`` on the CPU."""
    cfg, cell = small()
    return harness.Cell(NAME, SEED, "cpu", cfg, cell)


def fresh_clr(c, cmap=None):
    """A new reader of the cell's map (the coverage columns are stored on
    the reader by its first coverage pileup)."""
    cmap = cmap or c.cmap
    return port.Cooler.from_arrays(cmap.chromsizes, cmap.binsize,
                                   (cmap.bin1, cmap.bin2, cmap.count),
                                   weights=cmap.weights)


def with_big_count(cmap):
    """The map with one pixel of chr2 set to 4097: odd and above 2048, so
    the float16 cast cannot carry it."""
    cmap = copy.copy(cmap)
    cmap.count = cmap.count.copy()
    lo, hi = cmap.chrom_pixel_offset[1], cmap.chrom_pixel_offset[2]
    d = cmap.bin2[lo:hi] - cmap.bin1[lo:hi]
    cmap.count[lo + int(np.argmax(d >= 3))] = 4097
    return cmap


def run(c, clr, feats, job, timers=None, **extra):
    kw = dict(c.cell["pileup"], **extra)
    return port.pileup(clr, feats, device="cpu", timers=timers,
                       seed=gen_features.job_seed(SEED, job), **kw)


def reference_rows(c, cmap, job):
    return reference_pileup(cmap, c.pool[job], c.job_kw(job), "cpu",
                            c.parts)


@pytest.mark.parametrize("wire", ["float32", "exact_f16", "f16_fallback"])
def test_loops_match_the_reference(loops, wire, monkeypatch):
    """Counts ``n``/``control_n``, ``num`` and the NaN pixels exact; the
    data within rtol 1e-4, as the engine tests hold the port to its
    references: the program sums float32 windows and normalizes in its own
    order of operations, the reference in float64. ``exact_f16`` ships
    every region's raw tiles as float16 and must read the same table as
    float32, bit for bit; ``f16_fallback`` puts a count that float16
    cannot carry in chr2, whose region must then go float32."""
    c = loops
    cmap = with_big_count(c.cmap) if wire == "f16_fallback" else c.cmap
    clr = fresh_clr(c, cmap)
    feats = c.pool[1]
    base = run(c, clr, feats, 1)
    if wire != "float32":
        monkeypatch.setattr(engine.PileUpper, "_on_accelerator",
                            lambda self: True)
    timers = PhaseTimers()
    table = run(c, clr, feats, 1, timers=timers)
    got = compare.program_rows(table, c.parts)
    ref = reference_rows(c, cmap, 1)
    nums = compare.compare(got, ref)
    assert nums["rows"] == nums["n_gap"] == nums["num_gap"] == 0
    assert nums["nan_gap"] == 0
    row = got["all"]
    assert row["n"] > 0
    # controls shifted past a chromosome's end are dropped on both sides
    assert 0 < row["control_n"] < 10 * row["n"]
    np.testing.assert_allclose(row["data"], ref["all"]["data"], rtol=1e-4)
    for a, b in zip(table["data"], base["data"]):
        np.testing.assert_array_equal(np.asarray(a, float),
                                      np.asarray(b, float))
    counts = {k: timers.counts.get(k, 0) for k in WIRE_COUNTS}
    want = {"float32": {k: 0 for k in WIRE_COUNTS},
            "exact_f16": {"tile_wire_exact_f16_regions": 3,
                          "tile_wire_f32_regions": 0,
                          "tile_cast_native_regions": 3},
            "f16_fallback": {"tile_wire_exact_f16_regions": 2,
                             "tile_wire_f32_regions": 1,
                             "tile_cast_native_regions": 2}}[wire]
    assert counts == want


@pytest.mark.parametrize("source", ["reference", "program"])
def test_coverage_is_a_bincount(loops, source):
    """Each chromosome's total coverage, the row sums of the symmetric raw
    map without the diagonals |r - c| < 2 (the diagonal counted once),
    equals a direct bincount of the map's pixels: the reference's
    (``cis_raw``, from a dense matrix) and the program's
    (``coverage.coverage``, stored in the reader's bins)."""
    c = loops
    cmap = c.cmap
    n = cmap.bins_per
    if source == "program":
        clr = fresh_clr(c)
        _, tot = program_coverage(clr, ignore_diags=2, chunksize=50_000,
                                  store=True)
        np.testing.assert_array_equal(clr.bins()["cov_tot_raw"].fetch(
            "chr1").values, tot[:n])
    for k, chrom in enumerate(cmap.chroms):
        b1, b2, cnt = cmap.chrom_pixels(k)
        keep = np.abs(b2 - b1) >= 2
        b1, b2, cnt = b1[keep], b2[keep], cnt[keep].astype(np.float64)
        want = (np.bincount(b1, cnt, minlength=n)
                + np.bincount(b2, cnt, minlength=n))
        if source == "reference":
            got = c.parts.values.make(cmap, (chrom, chrom), c.job_kw(0),
                                      None, "float64", "cpu").cov.numpy()
        else:
            got = tot[k * n:(k + 1) * n]
        np.testing.assert_array_equal(got, want)


def test_bfloat16_control_fails(loops):
    """The reference through bfloat16 (window values and coverage
    vectors) in the program's place fails the cell's limits on the small
    copy; the program passes them, with gaps a third of the control's or
    less."""
    cfg, cell = small()
    prog, ctrl = control.readings(NAME, SEED, True, "cpu", cfg, cell)
    assert compare.judge(prog, cell["limits"])[0]
    assert not compare.judge(ctrl, cell["limits"])[0]
    for k in ("data_gap", "data_mean_gap"):
        assert ctrl[k] >= 3 * prog[k]


@pytest.mark.parametrize("coverage_norm", [True, False])
def test_coverage_phase_and_counters(loops, coverage_norm, monkeypatch):
    """Under ``coverage_norm``: the phase ``coverage`` (nested in
    ``ingest`` and ``device``), the ``prepare/coverage`` span of the first
    job on a reader only, one ``coverage_regions`` and one histogram or
    scatter count a region. Without it none of them; the wire's counters
    follow the raw counts either way."""
    monkeypatch.setattr(engine.PileUpper, "_on_accelerator",
                        lambda self: True)
    c = loops
    clr = fresh_clr(c)
    jobs = []
    for job in (0, 1):
        timers = PhaseTimers(spans=True)
        run(c, clr, c.pool[job], job, timers=timers,
            coverage_norm=coverage_norm)
        jobs.append(timers)
    for i, timers in enumerate(jobs):
        names = {s.name for s in timers.spans}
        counts = dict(timers.counts)
        assert counts.get("tile_wire_exact_f16_regions") == 3
        if not coverage_norm:
            assert "coverage" not in timers.seconds
            assert "coverage" not in names and "prepare/coverage" not in names
            assert not set(COVERAGE_COUNTS) & set(counts)
            continue
        assert timers.seconds["coverage"] > 0
        assert ("prepare/coverage" in names) == (i == 0)
        assert counts["coverage_regions"] == 3
        assert (counts.get("coverage_hist_regions", 0)
                + counts.get("coverage_scatter_regions", 0)) == 3
        by_id = {s.id: s for s in timers.spans}
        parents = {by_id[s.parent].name for s in timers.spans
                   if s.name == "coverage"}
        assert parents == {"ingest", "device"}


@pytest.mark.parametrize("what", ["config", "cell", "reader"])
def test_spec_finds_the_loops_cell(what):
    w = spec.workload(NAME)
    if what == "config":
        cfg = spec.config(w["config"])
        entry = [c for c in spec.benchmark()["configs"]
                 if c["name"] == "loops_10kb"][0]
        assert cfg["name"] == entry["name"] == "loops_10kb"
        assert cfg["features"]["count"] == 3330
        assert entry["reduced"] == cfg["reduced"]
    elif what == "cell":
        cell = spec.cell(NAME)
        assert cell["pileup"]["coverage_norm"] is True
        assert cell["pileup"]["clr_weight_name"] is None
        parts = reference.parts(cell["reference"])
        assert set(vars(parts)) == set(reference.ROLES)
        assert w["chips"] == 1
    else:
        names = [m["name"] for m in spec.metrics_for(NAME, "per_layer")]
        assert "coverage_s" in names and "quad_roofline" in names
        read = spec.reader("coverage_s")
        assert read(Context()) is None
        assert read(Context(phases=[{"ingest": 1.0}])) is None
        assert read(Context(phases=[{"coverage": 0.25},
                                    {"coverage": 0.75}])) == 0.5
