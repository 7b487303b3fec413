"""The port's rescaled pileups against the JAX package's, on the CPU.

- The area-overlap operators (``resize_matrix``, ``resize2d``,
  ``resize1d``, ``area_resize_host``) against ``coolpuppy_tpu.ops.rescale``.
- The rescale step (``rescale_accumulate`` over the normalized B=128
  stack) against ``make_rescale_step_fn`` over the reference's Hmax tiles,
  on random stacks, with ooe, local, expected emission, coverage and
  stripes on and off, Hmax 64, 128 and 256, cis and trans: ``num`` counts
  exact, planes within rtol 1e-5.
- ``pileup(rescale=True)`` against the reference's on the toy map in every
  rescale mode of ``torch_cases.RESCALE_MODES`` and the rescale rows of
  tests/test_combo_matrix.py (counts exact, ``data`` rtol 1e-4), and
  against host oracles: tests/oracle.py's, and ``torch_cases``' host loop
  on TADs whose windows span more than two 128-bin tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse as sp

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu as ref
import coolpuppy_tpu_torch as port
from coolpuppy_tpu.expected import expected_cis
from coolpuppy_tpu.ops import rescale as ref_rescale
from coolpuppy_tpu.ops.tiles import build_tile_stack as ref_build_tile_stack
from coolpuppy_tpu_torch.ops import rescale as port_rescale
from coolpuppy_tpu_torch.ops.tiles import normalized_stack
from fixtures import make_toy_cooler, toy_features, toy_regions
from oracle import oracle_rescale
from test_combo_matrix import BASE, COMBOS
import torch_cases
from torch_cases import compare_tables

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
ENGINE_TOL = dict(rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("h,w,R,Hmax", [
    (1, 1, 9, 32), (32, 32, 9, 32), (13, 7, 33, 64), (64, 5, 99, 64),
    (1, 64, 1, 64), (100, 77, 99, 128),
])
def test_resize_ops_match_reference(h, w, R, Hmax):
    rng = np.random.default_rng(h * 1000 + w)
    got = port_rescale.resize_matrix(h, R, Hmax).numpy()
    # bit for bit the operator of the reference's jitted step (XLA folds
    # h / R into h * fl32(1/R)); within float32 rounding of the eager one
    jitted = jax.jit(lambda x: ref_rescale.resize_matrix(x, R, Hmax))
    np.testing.assert_array_equal(got, np.asarray(jitted(jnp.int32(h))))
    want = np.asarray(ref_rescale.resize_matrix(jnp.int32(h), R, Hmax))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    win = np.zeros((Hmax, Hmax), np.float32)
    win[:h, :w] = rng.normal(size=(h, w))
    got = port_rescale.resize2d(torch.from_numpy(win), h, w, R, Hmax)
    want = ref_rescale.resize2d(jnp.asarray(win), jnp.int32(h), jnp.int32(w),
                                R, Hmax)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)
    vec = np.zeros(Hmax, np.float32)
    vec[:h] = rng.normal(size=h)
    got = port_rescale.resize1d(torch.from_numpy(vec), h, R, Hmax)
    want = ref_rescale.resize1d(jnp.asarray(vec), jnp.int32(h), R, Hmax)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)
    for shape, arr in (((R, R), win[:h, :w]), ((R,), vec[:h])):
        np.testing.assert_array_equal(
            port_rescale.area_resize_host(arr, shape),
            ref_rescale.area_resize_host(arr, shape),
        )


def test_resize_batches_and_preserves_the_mean():
    """A batch of windows resizes like each alone; the operator's rows
    sum to 1."""
    rng = np.random.default_rng(3)
    h = torch.tensor([5, 17, 32])
    w = torch.tensor([9, 17, 3])
    win = torch.from_numpy(rng.uniform(size=(3, 32, 32)).astype(np.float32))
    batch = port_rescale.resize2d(win, h, w, 9, 32)
    for b in range(3):
        one = port_rescale.resize2d(win[b], int(h[b]), int(w[b]), 9, 32)
        np.testing.assert_allclose(batch[b].numpy(), one.numpy(), rtol=1e-6)
    L = port_rescale.resize_matrix(h, 9, 32)
    np.testing.assert_allclose(L.sum(-1).numpy(), 1.0, rtol=1e-6)


def _step_problem(Hmax, seed, cis, local, S=24):
    """A random region (symmetric under ``cis``), per-bin vectors padded
    past the last window like the engine pads them, and S snips of logical
    sizes 1..Hmax (the first of size 1, the second of Hmax; square and on
    the diagonal under ``local``)."""
    rng = np.random.default_rng(seed)
    n = 2 * Hmax + 90
    dense = rng.gamma(1.0, 1.0, (n, n)) * (rng.random((n, n)) < 0.3)
    if cis:
        dense = np.triu(dense) + np.triu(dense, 1).T
    coo = sp.coo_matrix(dense)
    h1 = rng.integers(1, Hmax + 1, S)
    h1[:2] = (1, Hmax)
    w2 = h1.copy() if local else rng.integers(1, Hmax + 1, S)
    r1 = rng.integers(0, n - h1 + 1)
    r2 = r1.copy() if local else rng.integers(0, n - w2 + 1)
    pad = n + Hmax + 8
    valid = np.zeros(pad, np.float32)
    valid[:n] = rng.random(n) > 0.05
    if cis:
        evec = np.full(pad, np.nan, np.float32)
        evec[:n] = 4.0 / (1.0 + np.arange(n))
        evec[rng.integers(3, n, 3)] = 0.0  # OOE poison: +inf, counted NaN
    else:
        evec = np.array([0.7], np.float32)
    cov = np.zeros(pad, np.float32)
    cov[:n] = rng.uniform(0.5, 2.0, n)
    cov[rng.integers(0, n, 3)] = np.nan
    cid = rng.integers(0, 6, S)
    return dict(coo=coo, r1=r1, r2=r2, h1=h1, w2=w2, dd0=r1 - r2, cid=cid,
                valid=valid, evec=evec, cov=cov)


STEP_CASES = [
    (64, dict(ooe=True, local=True)),
    (64, dict(emit_expected=True, coverage=True)),
    (128, dict(ooe=True, local=True, stripes=True)),
    (128, dict(emit_expected=True, local=True, coverage=True, stripes=True)),
    (256, dict(ooe=True, coverage=True, stripes=True)),
    (256, dict(local=True)),
    (128, dict(cis=False, ooe=True, stripes=True)),
    (128, dict(cis=False, emit_expected=True, coverage=True)),
]


@pytest.mark.parametrize("Hmax,opts", STEP_CASES,
                         ids=[f"H{h}-" + "-".join(sorted(o)) for h, o in
                              STEP_CASES])
def test_rescale_step_matches_reference(Hmax, opts):
    cfg_kw = dict(R=33, Hmax=Hmax, cis=True, ignore_diags=2, ooe=False,
                  emit_expected=False, coverage=False, stripes=False,
                  local=False)
    cfg_kw.update(opts)
    p = _step_problem(Hmax, seed=Hmax + len(opts), cis=cfg_kw["cis"],
                      local=cfg_kw["local"])
    S, C = len(p["r1"]), 8
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731

    B = max(64, Hmax)
    ts = ref_build_tile_stack(p["coo"], B, r1=p["r1"], r2=p["r2"],
                              window1=p["h1"], window2=p["w2"])
    step = jax.jit(ref_rescale.make_rescale_step_fn(
        ref_rescale.RescaleConfig(B=B, S=S, block=8, capacity=C, **cfg_kw)
    ))
    want = step(ts.tiles, ts.tile_map.ravel(), np.int32(ts.tile_map.shape[1]),
                p["evec"], p["valid"], p["valid"], p["cov"], p["cov"],
                i32(p["r1"]), i32(p["r2"]), i32(p["h1"]), i32(p["w2"]),
                i32(p["dd0"]), i32(p["cid"]), np.ones(S, bool))

    pts = port.build_tile_stack(p["coo"], 128, r1=p["r1"], r2=p["r2"],
                                window1=p["h1"], window2=p["w2"])
    stiles = normalized_stack(pts, p["valid"], p["valid"], p["evec"], "cpu",
                              ooe=cfg_kw["ooe"], cis=cfg_kw["cis"],
                              ignore_diags=2)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))  # noqa: E731
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    got = port_rescale.rescale_accumulate(
        stiles, t(pts.tile_map), f(p["evec"]), f(p["cov"]), f(p["cov"]),
        t(p["r1"]), t(p["r2"]), t(p["h1"]), t(p["w2"]), t(p["dd0"]),
        t(p["cid"]),
        port_rescale.RescaleConfig(capacity=C, **{
            k: v for k, v in cfg_kw.items()
            if k not in ("cis", "ignore_diags", "ooe")  # set in the stack
        }),
        block=7,
    )
    assert sorted(got) == sorted(k for k in want if k != "poison")
    for k, v in got.items():
        w = np.asarray(want[k])
        if k in ("num", "exp_num"):
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), w, equal_nan=True,
                                       err_msg=k, **STEP_TOL)
    assert float(got["num"].sum()) > 0


# -- the engine -------------------------------------------------------------


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cool") / "rescale.cool")
    ref_clr, dense, weights = make_toy_cooler(path, seed=77)
    return ref_clr, port.Cooler.from_cool(path), dense, weights


# every rescale mode of torch_cases.RESCALE_MODES (ids "7a_<mode>"), and
# the rescale rows of tests/test_combo_matrix.py (toy_features() widened by
# 3 Mb, as there)
ENGINE_CASES = [("7a_" + n, None) for n in torch_cases.RESCALE_MODES] + [
    (n, kw) for n, kw in COMBOS if "rescale" in n
]


@pytest.mark.parametrize("name,kw", ENGINE_CASES,
                         ids=[c[0] for c in ENGINE_CASES])
def test_rescale_pileup_matches_reference(toy, name, kw):
    ref_clr, clr, dense, weights = toy
    if kw is None:
        feats, view, kw = torch_cases.rescale_wide_inputs(
            "rescale", name[3:], clr, dense, weights)
    else:
        feats, view = torch_cases.toy_tads(), toy_regions()
        kw = dict(BASE, **kw)
    want = ref.pileup(ref_clr, feats, view_df=view, **kw)
    got = port.pileup(clr, feats, view_df=view, device="cpu", **kw)
    compare_tables(got, want, what=name, **ENGINE_TOL)
    assert got["accumulate"].iloc[0] == "rescale_torch"
    assert np.asarray(got["data"].iloc[0]).shape == (kw["rescale_size"],) * 2
    assert np.isfinite(np.asarray(got["data"].iloc[-1])).any()


def test_rescale_ooe_matches_reference_with_its_expected(toy):
    """Observed-over-expected with the reference's own expected_cis table
    (BASELINE's rescale config, cut to the toy map)."""
    ref_clr, clr, _, _ = toy
    exp = expected_cis(ref_clr, view_df=toy_regions())
    kw = dict(torch_cases.RESCALE_KW, local=True, expected_df=exp,
              rescale_size=99)
    feats = torch_cases.toy_tads()
    want = ref.pileup(ref_clr, feats, view_df=toy_regions(), **kw)
    got = port.pileup(clr, feats, view_df=toy_regions(), device="cpu", **kw)
    compare_tables(got, want, what="rescale ooe", **ENGINE_TOL)


def test_rescale_argument_checks(toy):
    _, clr, _, _ = toy
    cc = port.CoordCreator(toy_features(), 1_000_000, features_format="bed",
                           local=True, mindist=0)
    with pytest.raises(ValueError, match="rescale_flank"):
        port.PileUpper(clr, cc, rescale=True, device="cpu")
    with pytest.raises(ValueError, match="odd rescale_size"):
        port.pileup(clr, toy_features(), features_format="bed", local=True,
                    rescale=True, rescale_size=32, device="cpu")
    # rescale_flank only acts under rescale (reference :3832-3833)
    plain = port.pileup(clr, toy_features(), features_format="bed",
                        view_df=toy_regions(), mindist=0, flank=2_000_000,
                        rescale_flank=3, device="cpu")
    assert plain["rescale_flank"].iloc[0] is None
    assert plain["accumulate"].iloc[0] == "plain"


@pytest.fixture(scope="module")
def oracle_toy(tmp_path_factory):
    path = tmp_path_factory.mktemp("cool") / "toy.cool"
    make_toy_cooler(str(path), chromsizes={"chr1": 60_000_000},
                    binsize=1_000_000, seed=7, trans=False)
    return port.Cooler.from_cool(str(path))


def test_local_rescale_vs_oracle(oracle_toy):
    """tests/test_rescale.py::test_local_rescale_vs_oracle on the port."""
    import pandas as pd

    clr = oracle_toy
    R = 9
    tads = pd.DataFrame({
        "chrom": ["chr1"] * 4,
        "start": [5_000_000, 15_000_000, 30_000_000, 42_000_000],
        "end": [10_000_000, 24_000_000, 37_000_000, 55_000_000],
    })
    cc = port.CoordCreator(tads, 1_000_000, features_format="bed",
                           local=True, rescale_flank=1.0, nshifts=0,
                           mindist=0)
    pu = port.PileUpper(clr, cc, expected=False, ooe=False, rescale=True,
                        rescale_size=R, ignore_diags=2, device="cpu")
    pup = pu.pileupsWithControl()
    got = pup.loc[pup["group"] == "all", "data"].iloc[0]
    assert got.shape == (R, R)

    csr = clr.fetch_coo(("chr1", 0, 60_000_000), balance="weight").tocsr()
    isnan = clr.bad_bin_mask("chr1")
    accs, num = [], np.zeros((R, R))
    for _, row in cc.intervals.iterrows():
        st, en = int(row["stBin"]), int(row["endBin"])
        if st < 0 or en > 60:
            continue
        data = csr[st:en, st:en].toarray().astype(float)
        data[isnan[st:en], :] = np.nan
        data[:, isnan[st:en]] = np.nan
        d = np.abs(np.subtract.outer(np.arange(en - st), np.arange(en - st)))
        data[d < 2] = np.nan
        rs = oracle_rescale(data, R, local=True)
        accs.append(np.nan_to_num(rs))
        num += np.isfinite(rs)
    want = np.sum(accs, axis=0) / num
    want = np.nanmean(np.dstack((want, want.T)), 2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6,
                               equal_nan=True)


@pytest.mark.parametrize("expected", [False, True], ids=["local", "ooe"])
def test_wide_extents_vs_host_loop(expected):
    """TADs 20-200 bins wide at 10 kb (extents 60-600 bins, windows over up
    to six 128-bin tiles per axis, buckets 128-1024): the port against
    ``torch_cases``' host loop (counts and means within rtol 1e-4), with
    and without the map's expected table."""
    from coolpuppy_tpu_torch.expected import expected_cis as port_expected

    clr, feats = torch_cases.rescale_workload(n_tads=30, n_bins=1_500,
                                              n_contacts=300_000)
    extent = 3 * (feats["end"] - feats["start"]) // clr.binsize
    assert extent.max() > 256
    kw = dict(torch_cases.RESCALE_CELL_KW, rescale_size=33)
    exp = port_expected(clr) if expected else None
    if expected:
        kw["expected_df"] = exp
    got = port.pileup(clr, feats, device="cpu", **kw)
    want = torch_cases.rescale_host_oracle(clr, feats, 33, expected=exp)
    torch_cases.check_oracle(got, want, "wide extents")
