"""The port's transfer wires against the JAX package's, on the CPU.

- the host casts of the tile upload (``f16_wire_plan``, ``cast_slab_f16``,
  ``cast_tiles_f16``, ``cast_tiles_int8``) bit for bit;
- the native float16 cast (``native.cast_f16`` through ``cast_slab_f16``)
  bit for bit against numpy's, ``cast_slab_f16_plain``: NaN, +-0, +-inf,
  ties, float16 subnormals, refusals on one thread and in a team, lengths
  off the vector width, strided input, its own slab of a buffer only; the
  scan ``native.abs_max`` against ``nanmax``; the engine's
  ``tile_cast_native_regions`` counter with the wire forced on the CPU;
- the device side of the upload: ``expand_sym`` of a float16 and an int8
  payload, the normalization with and without ``fold_weights``, the dense
  wire and the COO wire's scatter;
- the float16 stripe gather (``stripes_device(f16=True)``) bit for bit
  against ``make_stripe_gather_hv(W, B, True)``;
- the flip-merged accumulator fetch (``_stack_merge_fetch`` +
  ``_stack_merge_materialize``) bit for bit, float16 on and off, with
  ``f16_keys``, +inf poison, ``lazy``, and maxima at and just below a power
  of two;
- the engine: the port's ``pileup()`` on the CPU with the upload wire
  forced (``_tile_f16_mode`` replaced on the instance, as the reference's
  own tests force it) against the reference's ``pallas-interpret`` run
  forced the same way, for ``"lossy"``, ``"exact"`` and int8 (a spy on
  ``_tile_wire_plan`` sees the mode): counts exact, ``data`` rtol 1e-5;
- the defaults: on the CPU every transfer stays float32.
"""

import importlib
import os

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse as sp

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu as ref
import coolpuppy_tpu_torch as port
from coolpuppy_tpu.ops import tiles as ref_tiles
from coolpuppy_tpu_torch.ops import quad_gather
from coolpuppy_tpu_torch.ops import tiles as port_tiles
from fixtures import make_toy_cooler, toy_features, toy_regions

ref_engine = importlib.import_module("coolpuppy_tpu.engine.pileup")
port_engine = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")

B = 128
WIRE_TOL = dict(rtol=1e-5, atol=1e-7)


def _payload(case, seed=0):
    """A [4, 16, 16] float32 payload of one kind."""
    rng = np.random.default_rng(seed)
    shape = (4, 16, 16)
    if case == "counts_small":
        return rng.poisson(40.0, shape).clip(max=2048).astype(np.float32)
    if case == "counts_large":
        a = rng.poisson(40.0, shape).astype(np.float32)
        a[0, 0, 0] = 5001.0  # an odd integer past 2048: not f16-exact
        return a
    if case == "balanced":
        return (rng.gamma(1.0, 0.01, shape)
                * (rng.random(shape) < 0.5)).astype(np.float32)
    if case == "nan":
        a = rng.gamma(1.0, 0.01, shape).astype(np.float32)
        a[rng.random(shape) < 0.2] = np.nan
        return a
    if case == "posinf":
        a = rng.gamma(1.0, 0.01, shape).astype(np.float32)
        a[1, 2, 3] = np.inf
        return a
    if case == "neginf":
        a = rng.gamma(1.0, 0.01, shape).astype(np.float32)
        a[2, 0, 1] = -np.inf
        return a
    if case == "zero":
        return np.zeros(shape, np.float32)
    if case == "empty":
        return np.zeros((0, 16, 16), np.float32)
    if case == "pow2_max":
        a = rng.uniform(0, 1024, shape).astype(np.float32)
        a[3, 3, 3] = 1024.0
        return a
    if case == "int8_range":
        return rng.integers(-127, 128, shape).astype(np.float32)
    raise ValueError(case)


CASES = ("counts_small", "counts_large", "balanced", "nan", "posinf",
         "neginf", "zero", "empty", "pow2_max", "int8_range")


def _same(a, b):
    """Both None, or arrays of one dtype, shape and bit pattern."""
    assert (a is None) == (b is None)
    if a is None:
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                  np.atleast_1d(b).view(np.uint8))


@pytest.mark.parametrize("case", CASES)
def test_host_casts_bit_for_bit(case):
    tiles = _payload(case)
    for mode in (False, "exact", "lossy"):
        pw, rw = (port_tiles.f16_wire_plan(tiles, mode),
                  ref_tiles.f16_wire_plan(tiles, mode))
        assert (pw is None) == (rw is None)
        if pw is not None:
            _same(np.float32(pw[0]), np.float32(rw[0]))
            _same(np.float32(pw[1]), np.float32(rw[1]))
            if mode:
                _same(port_tiles.cast_slab_f16(tiles[:2], pw[0], mode),
                      ref_tiles.cast_slab_f16(tiles[:2], rw[0], mode))
        pc, rc = (port_tiles.cast_tiles_f16(tiles, mode),
                  ref_tiles.cast_tiles_f16(tiles, mode))
        assert (pc is None) == (rc is None)
        if pc is not None:
            _same(pc[0], rc[0])
            _same(np.float32(pc[1]), np.float32(rc[1]))
    _same(port_tiles.cast_tiles_int8(tiles), ref_tiles.cast_tiles_int8(tiles))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", [False, "exact", "lossy", "int8"])
def test_upload_tiles_equals_the_whole_cast(case, mode, monkeypatch):
    """Slab by slab (two tiles a slab here) the upload ships what the
    reference's whole-payload cast ships, in its dtype, and the same
    inverse scale."""
    monkeypatch.setattr(port_tiles, "UPLOAD_SLAB", 2)
    tiles = _payload(case)
    got, inv = port_tiles.upload_tiles(tiles, mode, "cpu")
    cast = None
    if mode == "int8":
        wire = ref_tiles.cast_tiles_int8(tiles)
        cast = ((wire, np.float32(1.0)) if wire is not None
                else ref_tiles.cast_tiles_f16(tiles, "exact"))
    elif mode:
        cast = ref_tiles.cast_tiles_f16(tiles, mode)
    want, want_inv = cast if cast is not None else (tiles, np.float32(1.0))
    _same(got.numpy(), want)
    _same(np.float32(inv), np.float32(want_inv))


def _native_case(case):
    """``(payload, scale)`` of one case of the native cast: float32, any
    shape, the scale a power of two as ``f16_wire_plan`` picks it."""
    rng = np.random.default_rng(7)
    f16 = np.float16
    if case == "specials":  # NaN, +-0, +-inf among counts
        a = rng.poisson(30.0, 64).astype(np.float32)
        a[[3, 17, 40]] = np.nan
        a[[5, 33]] = [0.0, -0.0]
        a[[9, 50]] = [np.inf, -np.inf]
        return a, np.float32(8.0)
    if case == "halfway":  # exactly between two float16 values, both parities
        lo = rng.uniform(1, 60000, 96).astype(f16)
        lo = lo[np.isfinite(lo) & (lo < f16(65504))]
        hi = np.nextafter(lo, f16(np.inf))
        mid = (lo.astype(np.float32) + hi.astype(np.float32)) / 2
        return np.concatenate([mid, -mid, [2049.0, 2051.0, 1 + 2**-11]]) \
            .astype(np.float32), np.float32(1.0)
    if case == "subnormal":  # results below 2^-14, ties among them
        k = np.arange(0, 1024, 3, dtype=np.float32)
        a = np.concatenate([k * 2.0**-24, (k + 0.5) * 2.0**-24,
                            rng.uniform(0, 2.0**-14, 64), [2.0**-25,
                            3 * 2.0**-26, 2.0**-26, 2.0**-14 - 2.0**-25]])
        a = np.concatenate([a, -a]).astype(np.float32)
        return a * np.float32(2.0**-6), np.float32(2.0**6)
    if case == "counts_above_2048":  # odd counts: the exact wire refuses
        a = rng.poisson(40.0, (3, 16, 16)).astype(np.float32)
        a[2, 9, 4] = 4097.0
        return a, np.float32(2.0**0)
    if case == "refused_in_a_team":  # a team's later chunk refuses
        a = rng.poisson(3.0, (72, 128, 128)).astype(np.float32)
        a[61, 100, 7] = 2049.0
        return a, np.float32(2.0)
    if case == "team":  # 2^20 values and more: an OpenMP team
        a = rng.poisson(3.0, (72, 128, 128)).astype(np.float32)
        a[rng.random(a.shape) < 0.5] = 0.0
        return a, np.float32(2.0**10)
    if case == "empty":
        return np.zeros((0, 128, 128), np.float32), np.float32(1.0)
    if case.startswith("len"):  # not a multiple of 8 or 16: the scalar tail
        n = int(case[3:])
        return (rng.gamma(1.0, 0.01, n) * (rng.random(n) < 0.7)) \
            .astype(np.float32), np.float32(2.0**17)
    if case == "strided":  # a non-contiguous float32 slice
        a = rng.poisson(12.0, (6, 16, 40)).astype(np.float32)
        return a[1::2, :, 3:37:3], np.float32(4.0)
    raise ValueError(case)


NATIVE_CASES = ("specials", "halfway", "subnormal", "counts_above_2048",
                "refused_in_a_team", "team", "empty", "len1", "len7", "len9",
                "len15", "len17", "len31", "len33", "strided")


@pytest.mark.parametrize("mode", ["exact", "lossy"])
@pytest.mark.parametrize("case", NATIVE_CASES)
def test_native_cast_equals_the_plain_cast(case, mode):
    """``cast_slab_f16`` (``native.cast_f16``) against
    ``cast_slab_f16_plain``, numpy's cast: the same float16 bits, or None
    for both; written into its part of a larger buffer, it leaves the rest
    as it was. ``native.abs_max`` is numpy's ``nanmax`` of ``|a|`` (0
    where no value is a number)."""
    a, scale = _native_case(case)
    with np.errstate(over="ignore", invalid="ignore"):
        want = port_tiles.cast_slab_f16_plain(a, scale, mode)
    got = port_tiles.cast_slab_f16(a, scale, mode)
    assert (got is None) == (want is None)
    if case in ("counts_above_2048", "refused_in_a_team"):
        assert (got is None) == (mode == "exact")
    if want is not None:
        assert got.dtype == np.float16 and got.shape == a.shape
        np.testing.assert_array_equal(got.view(np.uint16),
                                      want.view(np.uint16))
    pad = 13
    buf = np.full(a.size + 2 * pad, np.float16(-7.0))
    dst = buf[pad:pad + a.size].reshape(a.shape)
    res = port_tiles.cast_slab_f16(a, scale, mode, out=dst)
    assert (res is None) == (want is None)
    if want is not None:
        assert res is dst
        np.testing.assert_array_equal(dst.view(np.uint16),
                                      want.view(np.uint16))
    assert (buf[:pad] == -7.0).all() and (buf[pad + a.size:] == -7.0).all()
    with np.errstate(invalid="ignore"):
        amax = np.nanmax(np.abs(a)) if a.size and not np.isnan(a).all() \
            else 0.0
    assert port_tiles.native.abs_max(a) == amax


def _int_region(n, seed, W=11, S=64):
    """An upper-triangle map of small integer counts, windows and
    weights."""
    rng = np.random.default_rng(seed)
    dense = np.triu(rng.poisson(3.0, (n, n)) * (rng.random((n, n)) < 0.3))
    r1 = rng.integers(0, n - W, S).astype(np.int32)
    r2 = rng.integers(0, n - W, S).astype(np.int32)
    valid = (rng.random(n) > 0.1).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, n).astype(np.float32) * valid
    evec = (10.0 / (1.0 + np.arange(n))).astype(np.float32)
    return sp.coo_matrix(dense.astype(np.float64)), r1, r2, valid, weights, \
        evec


@pytest.mark.parametrize("mode", ["exact", "lossy", "int8"])
def test_expand_sym_of_a_wire_payload(mode):
    """``expand_sym`` of a float16 or int8 payload equals
    ``expand_sym_device(f16_mode=...)`` bit for bit (the upconvert and the
    pow2 unscale are exact)."""
    coo, r1, r2, *_ = _int_region(400, 1)
    if mode == "lossy":
        coo = sp.coo_matrix(coo.toarray() * 0.0137)
    sym = port_tiles.build_tile_stack_sym(coo, B, r1=r1, r2=r2, window1=11,
                                          window2=11)
    sym_ref = ref_tiles.build_tile_stack_sym(coo, B, r1=r1, r2=r2,
                                             window1=11, window2=11)
    got = port_tiles.expand_sym(sym, "cpu", f16_mode=mode).numpy()
    want = np.asarray(ref_tiles.expand_sym_device(sym_ref, f16_mode=mode))
    np.testing.assert_array_equal(got, want[: sym.n_tiles + 1])
    if mode != "lossy":  # integer counts ride the wire exactly
        np.testing.assert_array_equal(got, sym.expand_host())


@pytest.mark.parametrize("ooe", [False, True])
@pytest.mark.parametrize("fold", [False, True])
def test_normalize_with_and_without_fold(ooe, fold):
    """``normalized_stack`` of an upper-triangle stack of raw counts with
    the int8 wire, against ``normalize_tiles_device`` over
    ``expand_sym_device(f16_mode="int8")``: with ``fold_weights`` the
    weights replace the valid vectors (rtol 2e-6, the reference's own
    bound for the fold), without it the 0/1 vectors (rtol 1e-6)."""
    coo, r1, r2, valid, weights, evec = _int_region(500, 2)
    sym = port_tiles.build_tile_stack_sym(coo, B, r1=r1, r2=r2, window1=11,
                                          window2=11)
    sym_ref = ref_tiles.build_tile_stack_sym(coo, B, r1=r1, r2=r2,
                                             window1=11, window2=11)
    v = weights if fold else valid
    got = port_tiles.normalized_stack(
        sym, v, v, evec, "cpu", f16_mode="int8", fold_weights=fold, ooe=ooe,
    ).numpy()
    full = ref_tiles.expand_sym_device(sym_ref, f16_mode="int8")
    want = np.asarray(ref_tiles.normalize_tiles_device(
        full, sym_ref.tile_map, B, v, v, evec=evec, ooe=ooe,
        fold_weights=fold))[: sym.n_tiles + 1]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    assert fin.sum() > 1000
    np.testing.assert_allclose(got[fin], want[fin],
                               rtol=2e-6 if fold else 1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["exact", "lossy"])
def test_dense_wire_normalize(mode):
    """The dense stack through the wire: ``normalize_tile_stack_device(
    f16_mode=...)`` of both packages, NaN masks equal, rtol 1e-6."""
    coo, r1, r2, valid, _, evec = _int_region(400, 3)
    if mode == "lossy":
        coo = sp.coo_matrix(coo.toarray() * 0.0219)
    ts = port_tiles.build_tile_stack(coo, B, r1=r1, r2=r2, window1=11,
                                     window2=11)
    ts_ref = ref_tiles.build_tile_stack(coo, B, r1=r1, r2=r2, window1=11,
                                        window2=11)
    got = port_tiles.normalize_tile_stack_device(
        ts, valid, valid, evec=evec, ooe=True, f16_mode=mode,
        device="cpu").numpy()
    want = np.asarray(ref_tiles.normalize_tile_stack_device(
        ts_ref, valid, valid, evec=evec, ooe=True, f16_mode=mode))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cool") / "toy.cool")
    clr, dense, weights = make_toy_cooler(path, seed=1)
    return clr, port.Cooler.from_cool(path)


@pytest.mark.parametrize("mode", [False, "exact", "lossy"])
def test_coo_wire_scatter(toy, mode):
    """``build_tile_stack_coo(f16_mode=...)`` of a trans rectangle: index,
    values (float16 on the wire) and inverse scale equal the reference's;
    ``coo_tiles`` equals the reference's jnp scatter-add
    (``_make_coo_scatter``) bit for bit."""
    from coolpuppy_tpu.ops.pallas_gather import _make_coo_scatter

    ref_clr, clr = toy
    regions = toy_regions()
    r1c, r2c = tuple(regions.iloc[0, :3]), tuple(regions.iloc[1, :3])
    balance = "weight" if mode == "lossy" else None
    slab = clr.fetch_slab(r1c, r2c, balance=balance)
    slab_ref = ref_clr.fetch_slab(r1c, r2c, balance=balance)
    nr, nc = -(-slab.shape[0] // B), -(-slab.shape[1] // B)
    want_ids = np.arange(nr * nc)
    got = port_tiles.build_tile_stack_coo(slab, B, want_ids, f16_mode=mode)
    want = ref_tiles.build_tile_stack_coo(slab_ref, B, want_ids,
                                          f16_mode=mode)
    assert got.nnz > 100
    _same(got.idx, want.idx)
    _same(got.vals, want.vals)
    _same(np.float32(got.inv_scale), np.float32(want.inv_scale))
    assert got.vals.dtype == (np.float16 if mode else np.float32)
    dense = port_tiles.coo_tiles(got, "cpu").numpy()
    k1 = got.k1
    K_pad = max(64, 1 << int(np.ceil(np.log2(k1))))
    want_dense = np.asarray(_make_coo_scatter(K_pad, B)(
        want.idx, want.vals, want.inv_scale))[:k1]
    np.testing.assert_array_equal(dense, want_dense)
    np.testing.assert_allclose(got.expand_host(), dense, rtol=1e-6)


@pytest.mark.parametrize("W", [11, 21, 120])
def test_stripes_f16_bit_for_bit(W):
    """``stripes_device(f16=True)`` equals the reference's
    ``make_stripe_gather_hv(W, B, True)`` on the same normalized stack, bit
    for bit (NaN where masked, +inf poison kept); ``run_stripes(f16=True)``
    is its float32 upcast."""
    import jax.numpy as jnp

    from coolpuppy_tpu.ops.pallas_gather import make_stripe_gather_hv

    coo, r1, r2, valid, _, evec = _int_region(600, 4, W=W, S=300)
    coo = sp.coo_matrix(coo.toarray() * 0.031)
    evec[7] = 0.0  # poison: division by a zero expected
    ts = port_tiles.build_tile_stack(coo, B, r1=r1, r2=r2, window1=W,
                                     window2=W)
    session = quad_gather.QuadPileupSession(
        ts, valid, valid, evec, dict(W=W, capacity=8, ooe=True), "cpu")
    got = session.stripes_device(r1, r2, f16=True).numpy()
    assert got.dtype == np.float16
    tmap = np.ascontiguousarray(ts.tile_map.ravel().astype(np.int32))
    want = np.asarray(make_stripe_gather_hv(W, B, True)(
        jnp.asarray(session.stiles.numpy()), jnp.asarray(tmap),
        np.int32(ts.tile_map.shape[1]), jnp.asarray(r1), jnp.asarray(r2)))
    assert want.dtype == np.float16
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).any()
    np.testing.assert_array_equal(session.run_stripes(r1, r2, f16=True),
                                  got.astype(np.float32))


def _banks(seed, nblk, half, W, vmax, posinf=False, exact_max=True):
    """``nblk`` accumulator dicts [2 * half + 8, W, W] float32 whose largest
    finite merged |sum| is ``vmax`` (and a +inf poison pixel)."""
    rng = np.random.default_rng(seed)
    outs = []
    for b in range(nblk):
        s = rng.uniform(0, vmax / 4, (2 * half + 8, W, W)).astype(np.float32)
        n = rng.integers(0, 40, (2 * half + 8, W, W)).astype(np.float32)
        if b == 0 and exact_max:
            s[0, 0, 0] = vmax  # its flip twin, anti-transposed, is 0
            s[half, W - 1, W - 1] = 0.0
        if posinf and b == nblk - 1:
            s[1, 2, 3] = np.inf
        outs.append({"sum": s, "num": n})
    return outs


@pytest.mark.parametrize(
    "f16,keys,vmax,posinf,lazy,nblk",
    [
        (False, None, 17.0, False, False, 3),
        (True, None, 17.0, False, False, 3),
        (True, frozenset({"sum"}), 17.0, True, False, 2),
        (True, None, 1024.0, False, True, 1),
        (True, None, float(np.nextafter(np.float32(1024), np.float32(0))),
         False, True, 2),
        (True, None, 8192.0, True, True, 2),
        (True, None, float(np.nextafter(np.float32(8192), np.float32(0))),
         False, False, 1),
        (True, frozenset({"sum", "num"}), 3.5, True, True, 4),
        (False, None, 3.5, True, True, 1),
    ],
)
def test_stack_merge_fetch_bit_for_bit(f16, keys, vmax, posinf, lazy, nblk):
    """The port's ``_stack_merge_fetch`` + ``_stack_merge_materialize``
    against the reference's on the same accumulators: the float64 arrays
    equal bit for bit, and with ``lazy`` the wires (float16 where cast) and
    inverse scales too, so the scale's exponent is the reference's
    ``floor(log2(max))`` at a maximum that is a power of two and one just
    below it."""
    import jax.numpy as jnp

    half, W = 8, 5
    outs = _banks(7, nblk, half, W, np.float32(vmax), posinf=posinf)
    got = port_engine._stack_merge_fetch(
        tuple({k: torch.from_numpy(v) for k, v in o.items()} for o in outs),
        half, f16=f16, lazy=lazy, f16_keys=keys)
    want = ref_engine._stack_merge_fetch(
        tuple({k: jnp.asarray(v) for k, v in o.items()} for o in outs),
        half, f16=f16, lazy=lazy, f16_keys=keys)
    if lazy:
        for k, (w, inv) in want.items():
            gw, ginv, _ = got[k]
            _same(gw.numpy(), np.asarray(w))
            assert (ginv is None) == (inv is None)
            if inv is not None:
                _same(ginv.numpy(), np.asarray(inv))
        got = port_engine._stack_merge_materialize(got)
        want = ref_engine._stack_merge_materialize(want)
    assert set(got) == set(want) == {"sum", "num"}
    for k in want:
        assert got[k].dtype == np.float64
        assert got[k].shape == (nblk, half, W, W)
        np.testing.assert_array_equal(got[k], want[k])
    assert np.isinf(got["sum"]).any() == posinf


# -- the engine ------------------------------------------------------------


def _force(pu, mode, spy=None):
    """Force the upload wire past the CPU gate, as the reference's tests do
    (tests/test_pallas_modes.py, tests/test_pallas.py); ``spy`` collects
    the modes ``_tile_wire_plan`` returns."""
    pu._tile_f16_mode = lambda: mode
    if spy is not None:
        orig = pu._tile_wire_plan

        def plan(dev):
            out = orig(dev)
            spy.append(out[0])
            return out

        pu._tile_wire_plan = plan
    return pu


def _run_pair(ref_clr, clr, feats, mode, flank, int8=False, view_df=None,
              **kw):
    """The reference's pileupsWithControl on ``pallas-interpret`` and the
    port's on the CPU, each forced onto the wire ``mode`` (with
    ``tile_int8`` set where ``int8``); returns their ``all`` rows and the
    modes each plan took."""
    rows, spies = [], []
    for pkg, c, extra in ((ref, ref_clr, dict(backend="pallas-interpret")),
                          (port, clr, dict(device="cpu"))):
        cc = pkg.CoordCreator(feats, c.binsize, features_format="bed",
                              flank=flank, nshifts=0, mindist=0, seed=0)
        pu = pkg.PileUpper(c, cc, view_df=view_df, control=False, **extra,
                           **kw)
        if int8:
            pu.tile_int8 = True
        spy = []
        _force(pu, mode, spy)
        rows.append(pu.pileupsWithControl().set_index("group").loc["all"])
        spies.append(spy)
    return rows[0], rows[1], spies


def _held(got, want):
    assert got["n"] == want["n"] > 0
    np.testing.assert_array_equal(got["num"], want["num"])
    a = np.asarray(got["data"], float)
    b = np.asarray(want["data"], float)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    fin = np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], **WIRE_TOL)


@pytest.mark.parametrize("mode", ["lossy", "exact"])
def test_engine_wire_matches_reference(toy, mode):
    """``"lossy"`` on the balanced toy map, ``"exact"`` on its raw counts
    (``clr_weight_name=None``): the port forced onto the wire against the
    reference forced the same way, counts exact, ``data`` rtol 1e-5."""
    ref_clr, clr = toy
    kw = dict(clr_weight_name=None) if mode == "exact" else {}
    want, got, spies = _run_pair(ref_clr, clr, toy_features(), mode,
                                 2_000_000, view_df=toy_regions(), **kw)
    assert spies[0] and set(spies[0]) == set(spies[1]) == {mode}
    _held(got, want)


@pytest.fixture(scope="module")
def small_counts(tmp_path_factory):
    """The reference's int8 test map (tests/test_pallas.py): a balanced
    60-bin chromosome of integer counts <= 127, 12 stranded sites."""
    from coolpuppy_tpu.io import write_cool

    rng = np.random.default_rng(23)
    binsize, n = 1_000_000, 60
    path = os.path.join(str(tmp_path_factory.mktemp("i8")), "toy_i8.cool")
    i, j = np.triu_indices(n)
    vals = rng.poisson(10.0 / (1.0 + np.abs(i - j)) + 0.5)
    keep = vals > 0
    weights = rng.uniform(0.5, 1.5, n)
    weights[rng.random(n) < 0.05] = np.nan
    write_cool(path, {"chrT": n * binsize}, binsize,
               (i[keep], j[keep], vals[keep]), weights=weights)
    starts = np.sort(rng.choice(np.arange(5, n - 5), 12, replace=False))
    feats = pd.DataFrame({
        "chrom": "chrT", "start": starts * binsize,
        "end": (starts + 1) * binsize, "name": "x", "score": 0,
        "strand": rng.choice(["+", "-"], 12),
    })
    return ref.Cooler(path), port.Cooler(path), feats


def test_engine_int8_wire_matches_reference(small_counts):
    """``tile_int8 = True`` on a map whose stored counts are integers <=
    127: both plans take ``"int8"`` (the spy), both fold the weights on
    the device, and the tables agree (counts exact, ``data`` rtol
    1e-5)."""
    ref_clr, clr, feats = small_counts
    assert clr.counts_are_int and ref_clr.counts_are_int
    want, got, spies = _run_pair(ref_clr, clr, feats, "lossy", 3_000_000,
                                 int8=True)
    assert spies[0] and set(spies[0]) == set(spies[1]) == {"int8"}
    _held(got, want)
    plain = port.pileup(clr, feats, flank=3_000_000, mindist=0,
                        device="cpu").set_index("group").loc["all"]
    np.testing.assert_array_equal(got["num"], plain["num"])
    np.testing.assert_allclose(np.asarray(got["data"], float),
                               np.asarray(plain["data"], float),
                               rtol=2e-6, atol=1e-7)


def test_engine_int8_gate(small_counts):
    """The int8 gate: without ``counts_are_int``, or without the
    attribute, the forced plan stays ``"lossy"``."""
    _, clr, feats = small_counts
    cc = port.CoordCreator(feats, clr.binsize, features_format="bed",
                           flank=3_000_000, mindist=0, seed=0)
    for int8, as_int in ((True, False), (False, True)):
        pu = port.PileUpper(clr, cc, control=False, device="cpu")
        if int8:
            pu.tile_int8 = True
        spy = []
        _force(pu, "lossy", spy)
        saved = clr.counts_are_int
        clr.counts_are_int = as_int
        try:
            pu.pileupsWithControl()
        finally:
            clr.counts_are_int = saved
        assert spy and set(spy) == {"lossy"}


def test_cpu_defaults_are_float32(toy, monkeypatch):
    """``device="cpu"`` takes no wire whatever the flags: the plan is
    False, no fetch is float16, and a pileup with the wires on equals one
    with them off exactly."""
    _, clr = toy
    feats = toy_features()
    cc = port.CoordCreator(feats, clr.binsize, features_format="bed",
                           flank=2_000_000, mindist=0, seed=0)
    pu = port.PileUpper(clr, cc, view_df=toy_regions(), device="cpu",
                        store_stripes=True)
    assert pu._tile_f16_mode() is False and not pu._fetch_f16()
    seen = []
    inner = port_tiles.upload_tiles

    def spy(tiles, f16_mode, device):
        seen.append(f16_mode)
        out = inner(tiles, f16_mode, device)
        assert out[0].dtype == torch.float32
        return out

    monkeypatch.setattr(port_tiles, "upload_tiles", spy)
    on = port.pileup(clr, feats, view_df=toy_regions(), flank=2_000_000,
                     mindist=0, device="cpu", store_stripes=True)
    off = port.pileup(clr, feats, view_df=toy_regions(), flank=2_000_000,
                      mindist=0, device="cpu", store_stripes=True,
                      tile_f16=False, stripe_f16=False)
    assert seen and not any(seen)
    for col in ("n", "num", "data", "horizontal_stripe", "vertical_stripe"):
        for a, b in zip(on[col], off[col]):
            np.testing.assert_array_equal(np.asarray(a, float),
                                          np.asarray(b, float))
    assert on["ignored"].iloc[0] == "chunk_size=32768, tile_size=None"


def _raw_count_map(big):
    """Two 160-bin chromosomes at 1 Mb of raw integer counts near the
    diagonal (the toy view's regions lie at bins 100-150); with ``big``,
    chr2's pixel (105, 106) holds 4097, which float16 cannot carry."""
    rng = np.random.default_rng(11)
    n = 160
    i, j = np.triu_indices(n)
    keep = j - i < 30
    i, j = i[keep], j[keep]
    cnt = rng.poisson(60.0 / (1.0 + j - i) + 1.0)
    bin1, bin2 = np.concatenate([i, i + n]), np.concatenate([j, j + n])
    cnt = np.concatenate([cnt, cnt])
    if big:
        cnt[np.flatnonzero((bin1 == n + 105) & (bin2 == n + 106))] = 4097
    return port.Cooler.from_arrays({"chr1": n * 1_000_000,
                                    "chr2": n * 1_000_000}, 1_000_000,
                                   (bin1, bin2, cnt))


@pytest.mark.parametrize("big", [False, True])
def test_native_cast_counter(big, monkeypatch):
    """With the wire forced on the CPU, a raw-count map takes the exact
    float16 wire: each region whose payload goes over as float16 counts
    ``tile_cast_native_regions`` once and was cast by ``native.cast_f16``;
    a region whose payload the cast refuses (a count of 4097 in chr2)
    counts ``tile_wire_f32_regions`` and not the native cast."""
    from coolpuppy_tpu_torch.observability import PhaseTimers

    monkeypatch.setattr(port_engine.PileUpper, "_on_accelerator",
                        lambda self: True)
    calls = []
    inner = port_tiles.native.cast_f16

    def spy(src, scale, inv, exact, out):
        calls.append(exact)
        return inner(src, scale, inv, exact, out)

    monkeypatch.setattr(port_tiles.native, "cast_f16", spy)
    timers = PhaseTimers()
    port.pileup(_raw_count_map(big), toy_features(), features_format="bed",
                view_df=toy_regions(), flank=2_000_000, mindist=0,
                clr_weight_name=None, device="cpu", timers=timers)
    counts = {k: timers.counts.get(k, 0) for k in (
        "tile_cast_native_regions", "tile_wire_exact_f16_regions",
        "tile_wire_f32_regions")}
    assert counts == {"tile_cast_native_regions": 1 if big else 2,
                      "tile_wire_exact_f16_regions": 1 if big else 2,
                      "tile_wire_f32_regions": 1 if big else 0}
    assert len(calls) >= 2 and all(calls)


def test_k9_and_stripe_wires_forced_on_the_cpu(toy, monkeypatch):
    """The by-window run with every wire forced (``_on_accelerator``
    replaced) and the reference's bank and the port's block lowered to 2
    and 4 groups, so the accumulators run in blocks through
    ``_stack_merge_fetch`` with float16 and the stripe planes come back
    float16: within the lossy wire's bound of the float32 run (rtol 2e-3,
    atol 1e-5, the reference's tests/test_pallas_modes.py), counts
    exact."""
    _, clr = toy
    feats = toy_features()
    monkeypatch.setattr(port_engine, "_bank_groups", lambda W: 2)
    monkeypatch.setattr(port_engine, "_block_half", lambda W: 4)
    calls = []
    inner = port_engine._stack_merge_fetch

    def spy(outs, half, **k):
        calls.append(k.get("f16"))
        return inner(outs, half, **k)

    monkeypatch.setattr(port_engine, "_stack_merge_fetch", spy)

    def run(forced):
        cc = port.CoordCreator(feats, clr.binsize, features_format="bed",
                               flank=2_000_000, mindist=0, seed=0)
        pu = port.PileUpper(clr, cc, view_df=toy_regions(), device="cpu",
                            store_stripes=True)
        if forced:
            pu._on_accelerator = lambda: True
        return pu.pileupsByWindowWithControl()

    want = run(False)
    assert calls and not any(calls)
    calls.clear()
    got = run(True)
    assert len(calls) > 1 and all(calls)
    assert len(got) == len(want) > 4
    for col in ("n", "num"):
        for a, b in zip(got[col], want[col]):
            np.testing.assert_array_equal(a, b)
    for col in ("data", "horizontal_stripe", "vertical_stripe"):
        for a, b in zip(got[col], want[col]):
            a, b = np.asarray(a, float), np.asarray(b, float)
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            fin = np.isfinite(b)
            np.testing.assert_allclose(a[fin], b[fin], rtol=2e-3, atol=1e-5)
