"""The port's tile stacks (coolpuppy_tpu_torch/ops/tiles.py) against the
JAX package's (coolpuppy_tpu/ops/tiles.py), on the CPU: the host builds
array for array, the device expansion exactly, and the device normalization
with identical NaN masks and finite values within rtol/atol 1e-6."""

import dataclasses

import numpy as np
import pytest
import torch
from scipy import sparse as sp

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

from coolpuppy_tpu.ops import tiles as ref
from coolpuppy_tpu_torch.ops import tiles as port

B = 128


def _region(n, seed, density=0.3, W=11, S=64, upper_only=False):
    rng = np.random.default_rng(seed)
    dense = rng.gamma(1.0, 1.0, (n, n)) * (rng.random((n, n)) < density)
    dense = np.triu(dense)
    if not upper_only:
        dense = dense + np.triu(dense, 1).T
    coo = sp.coo_matrix(dense)
    r1 = rng.integers(0, n - W, S).astype(np.int32)
    r2 = rng.integers(0, n - W, S).astype(np.int32)
    valid = (rng.random(n) > 0.1).astype(np.float32)
    evec = (10.0 / (1.0 + np.arange(n))).astype(np.float32)
    return coo, r1, r2, valid, evec


@pytest.mark.parametrize("windows", [True, False])
@pytest.mark.parametrize("build_fn",
                         ["build_tile_stack", "build_tile_stack_sym"])
def test_build_matches_reference(build_fn, windows):
    W = 21
    coo, r1, r2, _, _ = _region(700, 3, density=0.1, W=W, S=300)
    kw = dict(r1=r1, r2=r2, window1=W, window2=W) if windows else {}
    want = getattr(ref, build_fn)(coo, B, **kw)
    got = getattr(port, build_fn)(coo, B, **kw)
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("diag_full", [True, False])
def test_expand_sym_matches_reference(diag_full):
    """expand_sym == SymTileStack.expand_host == expand_sym_device, exactly.
    With diag_full false the scatter holds only the upper half of diagonal
    tiles, and the expansion must symmetrize them."""
    W = 21
    coo, r1, r2, _, _ = _region(600, 5, W=W, upper_only=not diag_full)
    sym_ref = ref.build_tile_stack_sym(coo, B, r1=r1, r2=r2, window1=W,
                                       window2=W)
    sym_ref = dataclasses.replace(sym_ref, diag_full=diag_full)
    sym = port.from_reference(sym_ref)
    got = port.expand_sym(sym, "cpu").numpy()
    K1 = sym.n_tiles + 1
    np.testing.assert_array_equal(got, sym_ref.expand_host())
    np.testing.assert_array_equal(got, sym.expand_host())
    np.testing.assert_array_equal(
        got, np.asarray(ref.expand_sym_device(sym_ref))[:K1]
    )
    if not diag_full:
        mirrored = sp.coo_matrix(coo + sp.triu(coo, 1).T)
        full = ref.build_tile_stack(mirrored, B, r1=r1, r2=r2, window1=W,
                                    window2=W)
        np.testing.assert_array_equal(got, full.tiles)


NORM_CASES = {
    "plain": dict(ooe=False),
    "ooe": dict(ooe=True),
    "ooe_padded_valid": dict(ooe=True, pad=16384),
    "ooe_scalar_evec": dict(ooe=True, scalar=True),
    "trans_shift": dict(ooe=True, cis=False, frame_shift=5),
}


@pytest.mark.parametrize("case", sorted(NORM_CASES))
def test_normalize_matches_reference(case):
    c = dict(NORM_CASES[case])
    pad = c.pop("pad", None)
    scalar = c.pop("scalar", False)
    n, W = 300, 11
    coo, r1, r2, valid, evec = _region(n, 1, W=W)
    ts_ref = ref.build_tile_stack(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    ts = port.from_reference(ts_ref)
    evec[np.random.default_rng(2).integers(0, n, 5)] = 0.0  # poison
    if scalar:
        evec = np.array([2.5], np.float32)
    kw = dict(dict(cis=True, ignore_diags=2), **c)
    want_host = ref.normalize_tile_stack(ts_ref, valid, valid, evec=evec, **kw)
    if pad:  # pow2-padded per-bin vectors, longer than the tiled extent
        vpad = np.zeros(pad, np.float32)
        vpad[:n] = valid
        epad = np.full(pad, np.nan, np.float32)
        epad[:n] = evec
        valid, evec = vpad, epad
    want_dev = np.asarray(ref.normalize_tile_stack_device(
        ts_ref, valid, valid, evec=evec, slab=4, **kw
    ))
    want_tiles_dev = np.asarray(ref.normalize_tiles_device(
        ts_ref.tiles, ts_ref.tile_map, B, valid, valid, evec=evec, slab=4,
        **kw
    ))
    tiles = torch.from_numpy(ts.tiles)
    got = port.normalize_tiles(
        tiles, ts.tile_map, B, valid, valid, evec=evec, slab=4, **kw
    ).numpy()
    got2 = port.normalize_tile_stack_device(
        ts, valid, valid, evec=evec, device="cpu", **kw
    ).numpy()
    np.testing.assert_array_equal(got, got2)
    host_port = port.normalize_tile_stack(ts, valid, valid, evec=evec, **kw)
    for want in (want_host, want_dev, want_tiles_dev, host_port):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        fin = ~np.isnan(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    assert np.isnan(got[0]).all()
    if c.get("ooe") and not scalar:
        assert np.isinf(got).any()


def test_normalize_options_of_the_wire():
    """The session's wire options against the reference's device
    normalization: ``tile_f16="lossy"`` on a dense stack equals
    ``normalize_tile_stack_device(f16_mode="lossy")``, and
    ``fold_weights`` with an int8 payload of raw counts on an
    upper-triangle stack equals ``normalize_tiles_device(fold_weights=
    True)`` over ``expand_sym_device(f16_mode="int8")`` (NaN masks equal,
    rtol 2e-6, the reference's own bound for the int8 fold); unknown keys
    still raise."""
    from coolpuppy_tpu_torch.ops.quad_gather import QuadPileupSession

    coo, r1, r2, valid, evec = _region(300, 4)
    ts = port.build_tile_stack(coo, B, r1=r1, r2=r2, window1=11, window2=11)
    ts_ref = ref.build_tile_stack(coo, B, r1=r1, r2=r2, window1=11,
                                  window2=11)
    kw = dict(W=11, capacity=8, ooe=True)
    got = QuadPileupSession(ts, valid, valid, evec,
                            dict(kw, tile_f16="lossy"), "cpu").stiles
    assert got.dtype == torch.float32
    want = np.asarray(ref.normalize_tile_stack_device(
        ts_ref, valid, valid, evec=evec, ooe=True, f16_mode="lossy"))
    np.testing.assert_array_equal(got.numpy(), want)

    rng = np.random.default_rng(4)
    ints = sp.coo_matrix(np.triu(rng.poisson(3.0, (300, 300))
                                 * (rng.random((300, 300)) < 0.3)))
    sym = port.build_tile_stack_sym(ints, B, r1=r1, r2=r2, window1=11,
                                    window2=11)
    sym_ref = ref.build_tile_stack_sym(ints, B, r1=r1, r2=r2, window1=11,
                                       window2=11)
    w = rng.uniform(0.5, 1.5, 300).astype(np.float32) * valid
    got = QuadPileupSession(sym, w, w, evec,
                            dict(kw, tile_f16="int8", fold_weights=True),
                            "cpu").stiles.numpy()
    k1 = sym.n_tiles + 1
    full = ref.expand_sym_device(sym_ref, f16_mode="int8")
    want = np.asarray(ref.normalize_tiles_device(
        full, sym_ref.tile_map, B, w, w, evec=evec, ooe=True,
        fold_weights=True))[:k1]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-6, atol=1e-7)
    with pytest.raises(TypeError):
        QuadPileupSession(ts, valid, valid, evec, dict(kw, interpret=True),
                          "cpu")


def test_from_reference_types():
    coo, r1, r2, _, _ = _region(300, 6)
    ts_ref = ref.build_tile_stack(coo, B, r1=r1, r2=r2, window1=11, window2=11)
    sym_ref = ref.build_tile_stack_sym(coo, B)
    assert isinstance(port.from_reference(ts_ref), port.TileStack)
    sym = port.from_reference(sym_ref)
    assert isinstance(sym, port.SymTileStack)
    np.testing.assert_array_equal(sym.upper, sym_ref.upper)
    with pytest.raises(TypeError):
        port.from_reference(object())


def test_assemble_windows_batch_matches_reference():
    n, W = 500, 21
    coo, r1, r2, valid, evec = _region(n, 8, W=W, S=400)
    ts_ref = ref.build_tile_stack(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    stiles = ref.normalize_tile_stack(ts_ref, valid, valid, evec=evec,
                                      ooe=True)
    want = ref.assemble_windows_batch(stiles, ts_ref.tile_map, B, r1, r2, W)
    got = port.assemble_windows_batch(stiles, ts_ref.tile_map, B, r1, r2, W)
    np.testing.assert_array_equal(got, want)
