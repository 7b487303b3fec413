"""The port's generic path for windows wider than the quad kernel takes
(W > 120) against the JAX package's, on the CPU.

- The step (``generic_accumulate`` over the normalized B=128 stack, with
  the host side sums for coverage and expected emission) against
  ``make_pileup_step_fn`` over the reference's tiles at W = 123 and 201:
  ``num`` and ``poison`` exact, ``sum`` and the side sums within rtol 1e-5,
  stripes within rtol 1e-5 with NaN positions equal.
- ``pileup()`` at W = 123 against the reference's in every wide mode of
  ``torch_cases.WIDE_MODES`` (counts exact, ``data`` rtol 1e-4), and the
  route choice at the W = 120 / 121 boundary.
"""

import jax
import numpy as np
import pytest
import torch
from scipy import sparse as sp

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu as ref
import coolpuppy_tpu_torch as port
from coolpuppy_tpu.ops.gather import GatherConfig, make_pileup_step_fn
from coolpuppy_tpu.ops.tiles import build_tile_stack as ref_build_tile_stack
from coolpuppy_tpu_torch.ops.gather import (
    coverage_histogram_sums,
    expected_toeplitz_sums,
    generic_accumulate,
)
from coolpuppy_tpu_torch.ops.tiles import normalized_stack
from fixtures import make_toy_cooler, toy_features, toy_regions
import torch_cases
from torch_cases import compare_tables

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
ENGINE_TOL = dict(rtol=1e-4, atol=1e-7)

STEP_CASES = [
    (123, dict(ooe=True, stripes=True)),
    (123, dict(emit_expected=True, coverage=True)),
    (201, dict(ooe=True, stripes=True, coverage=True)),
    (201, dict(cis=False, ooe=True, stripes=True)),
]


@pytest.mark.parametrize("W,opts", STEP_CASES,
                         ids=[f"W{w}-" + "-".join(sorted(o)) for w, o in
                              STEP_CASES])
def test_generic_step_matches_reference(W, opts):
    cfg_kw = dict(cis=True, ignore_diags=2, ooe=False, emit_expected=False,
                  coverage=False, stripes=False)
    cfg_kw.update(opts)
    rng = np.random.default_rng(W + len(opts))
    n, S, G = 600, 48, 5
    dense = rng.gamma(1.0, 1.0, (n, n)) * (rng.random((n, n)) < 0.3)
    if cfg_kw["cis"]:
        dense = np.triu(dense) + np.triu(dense, 1).T
    coo = sp.coo_matrix(dense)
    # starts that put windows across the 128-bin tile edges
    r1 = rng.integers(0, n - W + 1, S)
    r2 = rng.integers(0, n - W + 1, S)
    r1[:6] = (0, 5, 127, 128, 255, n - W)
    pad = n + 512
    valid = np.zeros(pad, np.float32)
    valid[:n] = rng.random(n) > 0.05
    if cfg_kw["cis"]:
        evec = np.full(pad, np.nan, np.float32)
        evec[:n] = 4.0 / (1.0 + np.arange(n))
        evec[rng.integers(3, n, 3)] = 0.0  # OOE poison: +inf
    else:
        evec = np.array([0.7], np.float32)
    cov = np.zeros(pad, np.float32)
    cov[:n] = rng.uniform(0.5, 2.0, n)
    cov[rng.integers(0, n, 3)] = np.nan
    cid = rng.integers(0, G, S)
    dd0 = r1 - r2
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731

    B = max(64, 1 << int(np.ceil(np.log2(W))))
    ts = ref_build_tile_stack(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    cfg = GatherConfig(W=W, B=B, S=S, block=16, capacity=G, **cfg_kw)
    want = jax.jit(make_pileup_step_fn(cfg))(
        ts.tiles, ts.tile_map.ravel(), np.int32(ts.tile_map.shape[1]), evec,
        valid, valid, cov, cov, i32(r1), i32(r2), i32(dd0), i32(cid),
        np.ones(S, bool),
    )

    pts = port.build_tile_stack(coo, 128, r1=r1, r2=r2, window1=W, window2=W)
    stiles = normalized_stack(pts, valid, valid, evec, "cpu",
                              ooe=cfg_kw["ooe"], cis=cfg_kw["cis"],
                              ignore_diags=2)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))  # noqa: E731
    got = {k: v.numpy() for k, v in generic_accumulate(
        stiles, t(pts.tile_map), t(r1), t(r2), t(cid), W, G,
        stripes=cfg_kw["stripes"], block=11,
    ).items()}
    if cfg_kw["emit_expected"]:
        got["exp_sum"], got["exp_num"] = expected_toeplitz_sums(
            cid, dd0, evec, W, G)
    if cfg_kw["coverage"]:
        got["cov_start"], got["cov_end"] = coverage_histogram_sums(
            cid, r1, r2, cov, cov, W, G)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        if k in ("num", "poison", "exp_num"):
            np.testing.assert_array_equal(v, w, err_msg=k)
        else:
            np.testing.assert_allclose(v, w, equal_nan=True, err_msg=k,
                                       **STEP_TOL)
    assert got["num"].sum() > 0
    if cfg_kw["ooe"] and cfg_kw["cis"]:
        assert got["poison"].sum() > 0


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cool") / "wide.cool")
    ref_clr, dense, weights = make_toy_cooler(path, seed=77)
    return ref_clr, port.Cooler.from_cool(path), dense, weights


@pytest.mark.parametrize("name", list(torch_cases.WIDE_MODES))
def test_wide_pileup_matches_reference(toy, name):
    ref_clr, clr, dense, weights = toy
    feats, view, kw = torch_cases.rescale_wide_inputs("wide", name, clr,
                                                      dense, weights)
    want = ref.pileup(ref_clr, feats, view_df=view, **kw)
    got = port.pileup(clr, feats, view_df=view, device="cpu", **kw)
    compare_tables(got, want, what=name, **ENGINE_TOL)
    assert got["accumulate"].iloc[0] == "generic_torch"
    assert np.asarray(got["data"].iloc[0]).shape == (123, 123)
    assert int(torch_cases.all_row(got)["n"]) > 0


@pytest.mark.parametrize("flank,route,by_window", [
    (59_000_000, "plain", False), (60_000_000, "generic_torch", False),
    (55_000_000, "plain", False), (57_000_000, "plain", True),
], ids=["W119", "W121", "W111", "W115-by_window"])
def test_route_at_the_kernel_limit(toy, flank, route, by_window):
    """Windows up to 120 bins stay on the quad kernel (its plain version on
    the CPU; on the card the staged kernel, in two bands from W = 111 on);
    wider ones take the generic path, as the reference's ``_use_pallas``
    routes them (:993). All match the reference, by window too."""
    ref_clr, clr, _, _ = toy
    view = torch_cases.toy_chrom_view(clr)
    kw = dict(features_format="bed", mindist=0, flank=flank, nshifts=1,
              seed=2)
    if by_window:
        kw = dict(kw, by_window=True, nshifts=0)
    want = ref.pileup(ref_clr, toy_features(), view_df=view, **kw)
    got = port.pileup(clr, toy_features(), view_df=view, device="cpu", **kw)
    compare_tables(got, want, what=route, **ENGINE_TOL)
    assert got["accumulate"].iloc[0] == route
    W = 2 * flank // 1_000_000 + 1
    assert np.asarray(got["data"].iloc[0]).shape == (W, W)
    assert int(np.asarray(got["num"].iloc[-1]).sum()) > 0
    if by_window:
        assert len(got) > 1


def test_wide_windows_outside_the_view_are_dropped(toy):
    """In the 50-bin toy view no 123-bin window fits: every snip is out of
    bounds and the table has an empty 'all' row, as in the reference."""
    ref_clr, clr, _, _ = toy
    kw = dict(features_format="bed", mindist=0, flank=61_000_000)
    want = ref.pileup(ref_clr, toy_features(), view_df=toy_regions(), **kw)
    got = port.pileup(clr, toy_features(), view_df=toy_regions(),
                      device="cpu", **kw)
    assert list(got["n"]) == list(want["n"]) == [0]
