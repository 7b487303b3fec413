"""The port's stripe gather and rectangle tile stacks against the JAX
package's, on the CPU: ``QuadPileupSession.run_stripes`` against its host
oracle ``stripes_host`` and the reference session's ``run_stripes`` on
windows that straddle tile edges, ``build_tile_stack_slab`` against the
reference's numpy branch, and stripes pileups against the reference's."""

import importlib

import numpy as np
import pytest

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu as ref
import coolpuppy_tpu_torch as port
from coolpuppy_tpu.ops.pallas_gather import PallasPileupSession
from coolpuppy_tpu_torch.ops.quad_gather import QuadPileupSession, stripes_host
from coolpuppy_tpu_torch.ops.tiles import build_tile_stack_slab
from fixtures import make_toy_cooler, toy_features, toy_regions
from test_torch_native import one_thread
from torch_cases import compare_tables

B = 128


def _rect(n1, n2, seed, density=0.3):
    """A random trans-like rectangle as a port Cooler over two chromosomes
    (``n1`` x ``n2`` bins, 5% NaN weights), and its slab."""
    rng = np.random.default_rng(seed)
    i, j = np.nonzero(rng.random((n1, n2)) < density)
    vals = rng.poisson(3.0, len(i)) + 1
    weights = rng.uniform(0.5, 1.5, n1 + n2)
    weights[rng.random(n1 + n2) < 0.05] = np.nan
    clr = port.Cooler.from_arrays({"a": n1 * 1000, "b": n2 * 1000}, 1000,
                                  (i, j + n1, vals), weights=weights)
    return clr, clr.fetch_slab("a", "b", balance="weight")


def _edge_windows(n1, n2, W, S, seed):
    """Window starts that mostly straddle the 128-bin tile edges."""
    rng = np.random.default_rng(seed)
    r1 = np.concatenate([rng.integers(128 - W + 1, 128, S // 2),
                         rng.integers(0, n1 - W, S - S // 2)])
    r2 = np.concatenate([rng.integers(256 - W + 1, 256, S // 2),
                         rng.integers(0, n2 - W, S - S // 2)])
    return r1.astype(np.int32), r2.astype(np.int32)


@pytest.mark.parametrize("W", [11, 21])
def test_run_stripes_matches_host_oracle_and_reference(W):
    n1, n2 = 300, 420
    _, slab = _rect(n1, n2, seed=W)
    r1, r2 = _edge_windows(n1, n2, W, 600, seed=W)
    ts = build_tile_stack_slab(slab, B, r1, r2, W, W)
    valid1 = (np.random.default_rng(1).random(n1 + 512) > 0.05).astype(
        np.float32
    )
    valid2 = np.ones(n2 + 512, np.float32)
    evec = np.array([0.7], np.float32)
    cfg = dict(W=W, capacity=8, cis=False, ooe=True)
    sess = QuadPileupSession(ts, valid1, valid2, evec, cfg, "cpu")
    got = sess.run_stripes(r1, r2, chunk=97)
    assert got.shape == (len(r1), 2 * W) and got.dtype == np.float32
    want = stripes_host(sess.stiles.numpy(), ts.tile_map, r1, r2, W)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).any() and np.isfinite(got).any()
    ref_sess = PallasPileupSession(ts, valid1, valid2, evec,
                                   dict(cfg, interpret=True))
    np.testing.assert_array_equal(
        got, ref_sess.run_stripes(r1, r2, hv=True, f16=False)
    )
    assert sess.run_stripes(r1[:0], r2[:0]).shape == (0, 2 * W)


@pytest.mark.parametrize("mirror", [False, True])
def test_build_tile_stack_slab_matches_reference_numpy(monkeypatch, mirror):
    """Both packages' numpy branches (the port's plain ``scatter_slab``), bit
    for bit; then the port's native build against the reference's native
    build, bit for bit at one OpenMP thread."""
    ref_tiles = importlib.import_module("coolpuppy_tpu.ops.tiles")
    port_tiles = importlib.import_module("coolpuppy_tpu_torch.ops.tiles")
    native_want = ref_tiles.build_tile_stack_slab
    monkeypatch.setattr(ref_tiles, "_native_tile_scatter_wtri", None)
    monkeypatch.setattr(port_tiles, "scatter_slab",
                        port_tiles.scatter_slab_plain)
    W = 21
    if mirror:
        clr, _ = _rect(300, 420, seed=4)
        slab = clr.fetch_slab("b", "b", balance="weight")
        n1 = n2 = 420
    else:
        _, slab = _rect(300, 420, seed=4)
        n1, n2 = 300, 420
    assert slab.mirror == mirror
    r1, r2 = _edge_windows(n1, n2, W, 500, seed=5)
    got = build_tile_stack_slab(slab, B, r1, r2, W, W)
    want = ref_tiles.build_tile_stack_slab(slab, B, r1=r1, r2=r2, window1=W,
                                           window2=W)
    np.testing.assert_array_equal(got.tile_map, want.tile_map)
    assert got.tiles.dtype == want.tiles.dtype == np.float32
    np.testing.assert_array_equal(got.tiles, want.tiles)
    assert got.shape == want.shape and got.n_tiles > 0
    monkeypatch.undo()
    with one_thread():
        got = build_tile_stack_slab(slab, B, r1, r2, W, W)
        want = native_want(slab, B, r1=r1, r2=r2, window1=W, window2=W)
    np.testing.assert_array_equal(got.tiles, want.tiles)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cool") / "toy.cool")
    ref_clr, _, _ = make_toy_cooler(path, seed=8)
    return ref_clr, port.Cooler.from_cool(path)


@pytest.mark.parametrize(
    "kw",
    [dict(nshifts=2, seed=1), dict(local=True), dict(trans=True),
     dict(by_window=True, nshifts=1, seed=2)],
    ids=["controls", "local", "trans", "by_window_controls"],
)
def test_stripes_pileup_matches_reference(toy, kw):
    """Stripe planes (rtol 1e-5, NaN positions equal), their [n, 6]
    coordinates (exact) and the pups against the reference."""
    ref_clr, clr = toy
    args = dict(features_format="bed", mindist=0, flank=3_000_000,
                store_stripes=True, view_df=toy_regions(), **kw)
    want = ref.pileup(ref_clr, toy_features(), **args)
    got = port.pileup(clr, toy_features(), device="cpu", **args)
    compare_tables(got, want, what=str(kw), rtol=1e-4, atol=1e-7)
    row = got.iloc[-1]
    n = int(row["n"])
    assert row["horizontal_stripe"].shape == (n, 7)
    assert row["coordinates"].shape == (n, 6)
