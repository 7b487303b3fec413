"""The port's native host ingest (coolpuppy_tpu_torch/native) against the
JAX package's checked-in library (coolpuppy_tpu/native/_ingest.so) and
against the port's numpy branches, on the CPU.

Every entry is held bit for bit against the reference's where both are
deterministic: at one OpenMP thread, or on the two-pass scatter branch
(nnz > 2^19), which adds each tile's entries in input order at any thread
count; and within rtol 1e-6 against the numpy branch (float64 sums and
weight folds where the C++ works in float32). Then the two-pass
``sort_quads`` against the argsort order, the capacity regrow of the pair
sweep, a first build from several processes at once, and the build errors:
no compiler, a refused source, and no quiet numpy route when the library
cannot be built."""

import contextlib
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu.native as ref_native
import coolpuppy_tpu_torch as port
import coolpuppy_tpu_torch.native.build as native_build
import coolpuppy_tpu_torch.ops.quad_gather as qg
from coolpuppy_tpu_torch import native
from coolpuppy_tpu_torch.io.cool import PixelSlab
from coolpuppy_tpu_torch.ops import tiles

REPO = Path(__file__).resolve().parent.parent
B = 128
PLAIN_RTOL = 1e-6
TWO_PASS_NNZ = (1 << 19) + 50_000


@contextlib.contextmanager
def one_thread():
    """Both packages' native entries at one OpenMP thread: the port's through
    its setter, the reference's through the calling thread's OpenMP runtime
    (its library reads ``omp_get_max_threads``; the process has one runtime,
    which torch loads first)."""
    gomp = ctypes.CDLL("libgomp.so.1")
    before, port_before = gomp.omp_get_max_threads(), native.threads()
    native.set_threads(1)
    gomp.omp_set_num_threads(1)
    try:
        yield
    finally:
        native.set_threads(port_before)
        gomp.omp_set_num_threads(before)


def _coo(n, nnz, seed, idx_dtype, val_dtype, mapped=0.8):
    """``nnz`` random pixels (duplicates included) of an n x n region and a
    tile map that maps ``mapped`` of its tiles."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz).astype(idx_dtype)
    cols = rng.integers(0, n, nnz).astype(idx_dtype)
    vals = rng.gamma(1.0, 1.0, nnz).astype(val_dtype)
    nt = -(-n // B)
    tmap = np.zeros((nt + 1, nt + 1), np.int32)
    pick = np.flatnonzero(rng.random(nt * nt) < mapped)
    tmap[pick // nt, pick % nt] = np.arange(1, len(pick) + 1)
    return rows, cols, vals, tmap, len(pick)


def _assert_plain(got, want):
    np.testing.assert_allclose(got, want, rtol=PLAIN_RTOL, atol=1e-6)


# branch of tile_scatter_impl: (region bins, nnz) -> thread-private copies
# (small stack, many pixels), atomics, the two-pass counting sort
SCATTER_BRANCHES = {
    "private": (300, 60_000),
    "atomic": (1_400, 60_000),
    "two_pass": (2_000, TWO_PASS_NNZ),
}


@pytest.mark.parametrize("branch", sorted(SCATTER_BRANCHES))
@pytest.mark.parametrize("dtypes", [(np.int32, np.float32),
                                    (np.int32, np.float64),
                                    (np.int64, np.float64)],
                         ids=["i32f32", "i32f64", "i64f64"])
def test_tile_scatter(dtypes, branch):
    n, nnz = SCATTER_BRANCHES[branch]
    rows, cols, vals, tmap, K = _coo(n, nnz, 1, *dtypes)
    nc = tmap.shape[1] - 1
    ctx = contextlib.nullcontext() if branch == "two_pass" else one_thread()
    with ctx:
        got = native.tile_scatter(rows, cols, vals, tmap, B, K)
        want = ref_native.tile_scatter(rows, cols, vals, tmap, B, K, nc)
    assert got.dtype == np.float32 and got.shape == (K + 1, B, B)
    np.testing.assert_array_equal(got, want)
    _assert_plain(got, tiles.scatter_plain(rows, cols, vals, tmap, B, K))
    assert (got[0] == 0).all() and got.sum() > 0


def _slab(n1, n2, nnz, seed, mirror, weighted):
    """A stored-triangle (``mirror``) or rectangle slab in global bin ids,
    with a few pixels outside the rectangle and zeroed (bad) weights."""
    rng = np.random.default_rng(seed)
    lo1 = 40
    lo2 = lo1 if mirror else lo1 + n1 + 25
    r = rng.integers(lo1 - 5, lo1 + n1, nnz)
    c = rng.integers(lo2, lo2 + n2 + 5, nnz)
    if mirror:
        r, c = np.minimum(r, c), np.maximum(r, c)
    w = None
    if weighted:
        w = rng.uniform(0.5, 1.5, lo2 + n2 + 64).astype(np.float32)
        w[rng.random(len(w)) < 0.05] = 0.0
    vals = (rng.poisson(3.0, nnz) + 1).astype(np.float32)
    return PixelSlab(rows=r.astype(np.int64), cols=c.astype(np.int64),
                     vals=vals, lo1=lo1, lo2=lo2, shape=(n1, n2),
                     mirror=mirror, weights=w)


@pytest.mark.parametrize("two_pass", [False, True], ids=["small", "two_pass"])
@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_tile_scatter_wtri(weighted, mirror, two_pass):
    n = 1_900 if two_pass else 500
    nnz = TWO_PASS_NNZ if two_pass else 40_000
    slab = _slab(n, n + 37, nnz, 3, mirror, weighted)
    n1, n2 = slab.shape
    want_t, _, _ = tiles.touched_tiles(np.arange(0, n1 - 21, 7),
                                       np.arange(0, n1 - 21, 7) + 30, 21, 21,
                                       B, (n1, n2))
    tmap = tiles._dense_map(want_t, -(-n1 // B), -(-n2 // B))
    K = len(want_t)
    args = (slab.rows, slab.cols, slab.vals, slab.lo1, slab.lo2, n1, n2,
            slab.weights, tmap, B, K, mirror)
    ctx = contextlib.nullcontext() if two_pass else one_thread()
    with ctx:
        got = native.tile_scatter_wtri(*args)
        want = ref_native.tile_scatter_wtri(*args)
        via_tiles = tiles.scatter_slab(slab, tmap, B, K, mirror)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, via_tiles)
    _assert_plain(got, tiles.scatter_slab_plain(slab, tmap, B, K, mirror))
    assert got.sum() > 0


@pytest.mark.parametrize("n", [5_000, 300_000], ids=["one_thread",
                                                      "threads"])
def test_quad_sort_stable_with_histogram(n):
    rng = np.random.default_rng(n)
    nb = 5_000
    keys = rng.integers(0, nb, n).astype(np.int32)
    payload = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    got, counts = native.quad_sort(keys, payload, nb)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got, payload[order])
    np.testing.assert_array_equal(counts, np.bincount(keys, minlength=nb))
    want, want_counts = ref_native.quad_sort(keys, payload, nb)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(counts, want_counts)


@pytest.mark.parametrize("cap", [None, 1], ids=["default_cap", "regrow"])
def test_enumerate_pairs_matches_numpy_sweep(monkeypatch, cap):
    """The native sweep's pairs, in order, against the port's numpy sweep
    (the lazy per-diagonal one, forced) and the reference's library; with
    ``cap=1`` the output buffers regrow until they hold every pair."""
    rng = np.random.default_rng(11)
    centers = np.sort(rng.choice(100_000_000, 3_000, replace=False)) \
        .astype(np.float64)
    mindist, maxdist = 30_000.0, 2_000_000.0
    li, ri = native.enumerate_pairs(centers, mindist, maxdist, cap=cap)
    cc = port.CoordCreator(
        pd.DataFrame(
            {"chrom": "chr1", "start": centers - 500, "end": centers + 500}),
        10_000, features_format="bed", flank=50_000, mindist=int(mindist),
        maxdist=int(maxdist), nshifts=0, chunk_size=4_096)
    monkeypatch.setattr(port.CoordCreator, "LAZY_PAIR_THRESHOLD", 0)
    chunks = list(cc._iter_cis_pair_chunks(centers))
    np.testing.assert_array_equal(li, np.concatenate([c[0] for c in chunks]))
    np.testing.assert_array_equal(ri, np.concatenate([c[1] for c in chunks]))
    wl, wr = ref_native.enumerate_pairs(centers, mindist, maxdist)
    np.testing.assert_array_equal(li, wl)
    np.testing.assert_array_equal(ri, wr)
    assert len(li) > 10_000


@pytest.mark.parametrize("n", [0, 3_000, 200_000])
def test_sort_quads_two_passes_match_argsort(n):
    """Two stable counting sorts (by group, then by quad) give the argsort
    of ``(quad << 17) | group`` bit for bit, with the same quad spans."""
    rng = np.random.default_rng(n)
    N = 3_000
    nt = -(-N // B)
    tmap = np.zeros((nt + 1, nt + 1), np.int32)
    tmap[:nt, :nt] = np.arange(1, nt * nt + 1).reshape(nt, nt)
    r1 = rng.integers(0, N - 21, n)
    r2 = rng.integers(0, N - 21, n)
    cid = rng.integers(0, 1_000, n)
    got = qg.sort_quads(r1, r2, cid, tmap, B)
    want = qg.sort_quads_plain(r1, r2, cid, tmap, B)
    for g, w, name in zip(got, want, ("snips", "k", "qstart", "qcount")):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _run_build(root, env=None):
    """``native/build.py`` loaded from its file in a fresh interpreter (no
    package import), building into ``root``."""
    code = (
        "import importlib.util, sys; from pathlib import Path\n"
        f"spec = importlib.util.spec_from_file_location('b', "
        f"{str(native_build.__file__)!r})\n"
        "b = importlib.util.module_from_spec(spec); "
        "spec.loader.exec_module(b)\n"
        "b.BUILD_ROOT = Path(sys.argv[1])\n"
        "print(b.build())\n"
    )
    return subprocess.Popen([sys.executable, "-c", code, str(root)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def test_concurrent_first_build(tmp_path):
    """Four processes build into an empty root at once: one compiles under
    the lock, all get the same library, and no temporary file is left."""
    procs = [_run_build(tmp_path) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    lib = Path(paths.pop())
    assert lib.parent.parent == tmp_path
    assert sorted(p.name for p in lib.parent.iterdir()) == [lib.name]
    loaded = ctypes.CDLL(str(lib))
    assert loaded.ingest_set_threads(0) >= 1


def _env_without(*names, **extra):
    env = {k: v for k, v in os.environ.items() if k not in names}
    env.update(extra)
    return env


def test_build_without_compiler_raises(tmp_path):
    p = _run_build(tmp_path, _env_without("CXX", PATH=str(tmp_path / "none")))
    _, err = p.communicate(timeout=120)
    assert p.returncode != 0
    assert "NativeBuildError: no C++ compiler" in err
    p = _run_build(tmp_path, _env_without("CXX", CXX="false"))
    _, err = p.communicate(timeout=120)
    assert p.returncode != 0 and "NativeBuildError: false failed (1)" in err
    assert not list(tmp_path.glob("*/*.so"))


def test_no_numpy_route_when_the_build_fails(monkeypatch, tmp_path):
    """A source the compiler refuses fails every native caller with the
    compiler's output: the port has no fallback."""
    bad = tmp_path / "_ingest.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "SRC", bad)
    monkeypatch.setattr(native_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    rows, cols, vals, tmap, K = _coo(300, 1_000, 2, np.int32, np.float32)
    with pytest.raises(native_build.NativeBuildError, match="error"):
        tiles.scatter(rows, cols, vals, tmap, B, K)
    with pytest.raises(native_build.NativeBuildError):
        qg.sort_quads(rows, cols, np.zeros(len(rows), np.int32), tmap, B)


@pytest.mark.parametrize("omp", [None, "3"])
def test_thread_count_at_load(omp):
    """At load the team size is set to the cores less one, unless the user
    set OMP_NUM_THREADS, which the OpenMP runtime then takes; the
    environment itself is left alone."""
    env = _env_without("OMP_NUM_THREADS")
    if omp:
        env["OMP_NUM_THREADS"] = omp
    code = ("import os; from coolpuppy_tpu_torch import native; "
            "print(native.threads(), os.environ.get('OMP_NUM_THREADS'))")
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=300, check=True,
                         cwd=REPO)
    got, seen = out.stdout.split()
    want = omp or str(max(1, (os.cpu_count() or 2) - 1))
    assert (got, seen) == (want, omp or "None")


def test_wrappers_refuse_out_of_range_input():
    """Indices the C loops would use unchecked are refused in Python."""
    rows, cols, vals, tmap, K = _coo(300, 1_000, 5, np.int64, np.float64)
    bad = rows.copy()
    bad[3] = tmap.shape[0] * B
    with pytest.raises(ValueError, match="rows outside"):
        native.tile_scatter(bad, cols, vals, tmap, B, K)
    with pytest.raises(ValueError, match="does not cover"):
        native.tile_scatter(rows, cols, vals, tmap, B, K - 1)
    slab = _slab(200, 237, 2_000, 6, True, True)
    with pytest.raises(ValueError, match="rows outside"):
        native.tile_scatter_wtri(slab.rows, slab.cols, slab.vals, slab.lo1,
                                 slab.lo2, 200, 237, slab.weights[:50], tmap,
                                 B, K, True)
    with pytest.raises(ValueError, match="keys outside"):
        native.quad_sort(np.array([0, 5], np.int32), np.zeros(2, np.int32),
                         5)
