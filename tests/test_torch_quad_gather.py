"""The port's quad gather-accumulate (coolpuppy_tpu_torch/ops/quad_gather.py)
against the JAX package's Pallas path (coolpuppy_tpu/ops/pallas_gather.py,
run with interpret=True as its own tests run it) and against the dense
oracle of tests/test_pallas.py, on the CPU, where quad_accumulate runs its
plain PyTorch version."""

from collections import Counter

import numpy as np
import pytest
import torch
from scipy import sparse as sp

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

from coolpuppy_tpu.ops import pallas_gather as ref
from coolpuppy_tpu.ops import tiles as ref_tiles
from coolpuppy_tpu_torch.ops import quad_gather as qg
from coolpuppy_tpu_torch.ops.tiles import build_tile_stack, from_reference
from test_pallas import _oracle_sums

B = 128


def _edge_words():
    o1 = np.array([0, 127, 5, 64, 127, 0], np.int32)
    o2 = np.array([0, 127, 9, 1, 0, 127], np.int32)
    cid = np.array([0, (1 << 17) - 1, 600, 513, 1, 70000], np.int32)
    return o1, o2, cid


def test_pack_snips_bit_identical():
    rng = np.random.default_rng(0)
    o1 = rng.integers(0, 128, 5000)
    o2 = rng.integers(0, 128, 5000)
    cid = rng.integers(0, 1 << 17, 5000)
    for args in ((o1, o2, cid), _edge_words()):
        got = qg.pack_snips(*args)
        want = ref.pack_snips(*args)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("field", [0, 1, 2])
def test_pack_snips_range_asserts(field):
    args = list(_edge_words())
    args[field] = args[field].copy()
    args[field][2] = (1 << 17) if field == 2 else 128
    with pytest.raises(AssertionError):
        qg.pack_snips(*args)


def _stream(seed, n=700, S=1500, C=600, W=11):
    rng = np.random.default_rng(seed)
    r1 = np.concatenate([
        np.full(900, 3, np.int32) + rng.integers(0, 5, 900).astype(np.int32),
        rng.integers(0, n - W, S - 900).astype(np.int32),
    ])
    r2 = np.concatenate([
        np.full(900, 9, np.int32) + rng.integers(0, 5, 900).astype(np.int32),
        rng.integers(0, n - W, S - 900).astype(np.int32),
    ])
    cid = rng.integers(0, C, S).astype(np.int32)
    return r1, r2, cid


def test_sort_quads_matches_pack_stream():
    """Same quads, same tile slots, same per-quad snip multisets (snip
    order inside a quad is not fixed, even in the reference)."""
    n, W = 700, 11
    r1, r2, cid = _stream(1, n=n, W=W)
    dense = np.ones((n, n))
    ts = build_tile_stack(sp.coo_matrix(dense), B, r1=r1, r2=r2, window1=W,
                          window2=W)
    snips, k, qstart, qcount = qg.sort_quads(r1, r2, cid, ts.tile_map, B)
    rsnips, packs = ref.pack_stream(r1, r2, cid, ts.tile_map, B, 4096, 1 << 20)
    assert len(packs) == 1
    ks, rstart, rcount, lo, used = packs[0]
    nq = len(qstart)
    assert used == len(snips) == len(r1)
    assert int((rcount > 0).sum()) == nq
    np.testing.assert_array_equal(k, np.stack([a[:nq] for a in ks], axis=1))
    np.testing.assert_array_equal(qstart, rstart[:nq])
    np.testing.assert_array_equal(qcount, rcount[:nq])
    for s, c in zip(qstart, qcount):
        assert Counter(snips[s:s + c].tolist()) == Counter(
            rsnips[s:s + c].tolist())
        g = snips[s:s + c] & 0x1FFFF
        assert np.all(np.diff(g) >= 0)  # one run per group


@pytest.mark.parametrize("ooe", [False, True])
def test_run_quad_pileup_matches_pallas(ooe):
    """test_pallas_matches_xla's inputs through both packages."""
    rng = np.random.default_rng(0)
    n = 300
    W = 11
    dense = rng.gamma(1.0, 1.0, (n, n)) * (rng.random((n, n)) < 0.3)
    dense = np.triu(dense) + np.triu(dense, 1).T
    coo = sp.coo_matrix(dense)
    S = 256
    r1 = rng.integers(0, n - W, S).astype(np.int32)
    r2 = rng.integers(0, n - W, S).astype(np.int32)
    dd0 = (r1 - r2).astype(np.int32)
    cid = rng.integers(0, 6, S).astype(np.int32)
    valid = np.zeros(512, np.float32)
    valid[:n] = (rng.random(n) > 0.1).astype(np.float32)
    evec = np.full(512, np.nan, np.float32)
    evec[:n] = (10.0 / (1.0 + np.arange(n))).astype(np.float32)
    evec[rng.integers(0, n, 5)] = 0.0  # exercise poison

    ts = ref_tiles.build_tile_stack(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    kw = dict(W=W, capacity=8, cis=True, ignore_diags=2, ooe=ooe)
    want = ref.run_pallas_pileup(ts, r1, r2, dd0, cid, valid[:n], valid[:n],
                                 evec[:n], dict(kw, interpret=True))
    got = qg.run_quad_pileup(from_reference(ts), r1, r2, dd0, cid, valid[:n],
                             valid[:n], evec[:n], kw, device="cpu")
    np.testing.assert_array_equal(got["poison"], want["poison"])
    np.testing.assert_array_equal(got["num"], want["num"])
    pois = want["poison"] > 0
    assert pois.any() == ooe
    assert np.all(np.isinf(got["sum"][pois]))
    np.testing.assert_allclose(got["sum"][~pois], want["sum"][~pois],
                               rtol=1e-5, atol=1e-5)


def test_matches_oracle_on_packed_dispatch_edges():
    """test_packed_dispatch_edges's inputs: C=600 groups (ids above 512), a
    900-snip quad, and an empty stream."""
    rng = np.random.default_rng(7)
    n, W = 700, 11
    dense = rng.gamma(1.0, 1.0, (n, n)) * (rng.random((n, n)) < 0.2)
    dense = np.triu(dense) + np.triu(dense, 1).T
    coo = sp.coo_matrix(dense)
    valid = (rng.random(n) > 0.05).astype(np.float32)
    evec = (5.0 / (1.0 + np.arange(n))).astype(np.float32)
    C, S = 600, 1500
    r1 = np.concatenate([
        np.full(900, 3, np.int32) + rng.integers(0, 5, 900).astype(np.int32),
        rng.integers(0, n - W, S - 900).astype(np.int32),
    ])
    r2 = np.concatenate([
        np.full(900, 9, np.int32) + rng.integers(0, 5, 900).astype(np.int32),
        rng.integers(0, n - W, S - 900).astype(np.int32),
    ])
    cid = rng.integers(0, C, S).astype(np.int32)
    cid[:10] = C - 1

    ts = build_tile_stack(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    session = qg.QuadPileupSession(
        ts, valid, valid, evec,
        dict(W=W, capacity=C, cis=True, ignore_diags=2, ooe=True), "cpu",
    )
    got = session.run_many(r1, r2, cid)
    want_s, want_m = _oracle_sums(coo, r1, r2, cid, valid, evec, W, C)
    assert not got["poison"].any()
    np.testing.assert_allclose(got["sum"], want_s, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["num"], want_m)

    empty = np.array([], np.int32)
    out = session.run_many(empty, empty, empty)
    assert out["sum"].shape == (C, W, W) and out["sum"].dtype == np.float64
    assert float(out["sum"].sum()) == 0.0 and float(out["num"].sum()) == 0.0


def test_dispatch_on_cpu_runs_the_plain_version():
    """quad_accumulate on CPU tensors is quad_accumulate_plain: over short
    work items (``split_items`` at 7 snips) it equals the plain version
    over whole quads, and it never counts a launch; bad arguments raise
    before any work."""
    n, W, C = 700, 11, 600
    rng = np.random.default_rng(3)
    dense = rng.gamma(1.0, 1.0, (n, n)) * (rng.random((n, n)) < 0.2)
    coo = sp.coo_matrix(np.triu(dense) + np.triu(dense, 1).T)
    r1, r2, cid = _stream(3, n=n, W=W, C=C)
    ts = build_tile_stack(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    stiles = torch.from_numpy(ts.tiles)
    snips, k, qstart, qcount = qg.sort_quads(r1, r2, cid, ts.tile_map, B)
    t = [torch.from_numpy(a) for a in (k, qstart, qcount, snips)]
    items = qg.split_items(k, qstart, qcount, item_max=7)
    ti = [torch.from_numpy(a) for a in items]
    before = qg.LAUNCHES
    s1, n1 = qg.quad_accumulate(stiles, *ti, t[3], W, C)
    s2, n2 = qg.quad_accumulate_plain(stiles, *t, W, C)
    assert qg.LAUNCHES == before
    assert s1.dtype == n1.dtype == torch.float64
    torch.testing.assert_close(s1, s2, rtol=1e-12, atol=1e-9)
    assert torch.equal(n1, n2) and int(n1.sum()) > 0

    with pytest.raises(ValueError):
        qg.quad_accumulate(stiles, *t, 121, C)
    with pytest.raises(ValueError):
        qg.quad_accumulate(stiles, *t, W, (1 << 17) + 1)
    with pytest.raises(ValueError):
        qg.quad_accumulate(stiles.double(), *t, W, C)
    with pytest.raises(ValueError):
        qg.quad_accumulate(stiles, t[0].long(), *t[1:], W, C)
    with pytest.raises(ValueError):
        qg.quad_accumulate(stiles, t[0][:, :2], *t[1:], W, C)
    with pytest.raises(ValueError):
        qg.quad_accumulate(stiles.to("meta"), *(x.to("meta") for x in t), W, C)


def test_kernel_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No nvcc, or an nvcc that fails: the build raises (no fallback), with
    the compiler's output in the message, and leaves no library behind."""
    from coolpuppy_tpu_torch.kernels import build as kb

    monkeypatch.setattr(kb, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_toolkit"))
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    with pytest.raises(kb.KernelBuildError, match="nvcc not found"):
        kb.build()
    assert not (tmp_path / "kernels").exists()

    fake = tmp_path / "no_toolkit" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: sm_90a refused' >&2\nexit 2\n")
    fake.chmod(0o755)
    with pytest.raises(kb.KernelBuildError, match="sm_90a refused"):
        kb.build()
    out_dir = tmp_path / "kernels" / kb.source_hash()
    assert list(out_dir.iterdir()) == []
