"""The port's multi-device layer (``coolpuppy_tpu_torch.parallel``) against
the JAX package's ``coolpuppy_tpu.parallel``, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices, the port on
``LociMesh([cpu] * n)``; inputs are made from numpy seeds.

- The host half of ``rowshard`` (``build_row_partition``, ``route_snips``)
  and ``local_tile_coords`` bit for bit for n = 1, 2, 4, 8.
- ``sharded_normalize_halo`` against ``make_sharded_normalize_halo`` (rtol
  1e-6, NaN positions equal), ``QuadMeshSession.run_chunk`` and
  ``run_stripes`` against ``PallasMeshSession``'s in interpret mode, banded
  and replicated (``num`` exact, ``sum`` rtol 1e-5).
- The sharded generic, row-sharded and rescale steps against their JAX
  twins, and ``sharded_pileup_step`` over (2, 4) against
  ``make_sharded_pileup_step`` with the factorization check of
  tests/test_parallel.py.
- Every engine case of tests/test_parallel.py (plus a W = 123 banded case)
  for mesh sizes 1, 2, 4 and 8: group keys, ``n``, ``control_n`` and
  ``num`` exact, ``data`` rtol 1e-4 (that file's tolerance), stripes and
  their coordinates, against the JAX package's single-device table; the
  ``_rowshard_regions`` / ``_rowshard_fallbacks`` counters equal to the JAX
  package's on the route the port takes (the Pallas mesh route for W <=
  120, read with its session stubbed out; the XLA row-sharded route for W >
  120).
- ``dryrun_multichip(4, device="cpu")``, the launches per device, the
  argument errors and the single-process ``distributed`` helpers.
"""

import importlib

import jax
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
from coolpuppy_tpu.coords import CoordCreator as RefCC
from coolpuppy_tpu.engine.pileup import PileUpper as RefPU
from coolpuppy_tpu.ops.gather import GatherConfig
from coolpuppy_tpu.ops.tiles import build_tile_stack as ref_build_tile_stack
from coolpuppy_tpu.parallel import mesh as ref_mesh
from coolpuppy_tpu.parallel import pallas_mesh as ref_pm
from coolpuppy_tpu.parallel import rowshard as ref_rs
from coolpuppy_tpu_torch.ops import quad_gather as qg
from coolpuppy_tpu_torch.ops.tiles import from_reference, normalized_stack
from coolpuppy_tpu_torch.parallel import distributed
from coolpuppy_tpu_torch.parallel import mesh as pmesh
from coolpuppy_tpu_torch.parallel import quad_mesh as pqm
from coolpuppy_tpu_torch.parallel import rowshard as prs
from fixtures import make_toy_cooler, toy_expected, toy_features, toy_regions
from torch_cases import compare_tables

engine = importlib.import_module("coolpuppy_tpu_torch.engine.pileup")

MESH_SIZES = (1, 2, 4, 8)
ENGINE_TOL = dict(rtol=1e-4, atol=1e-7)


def ref_loci(n):
    return ref_mesh.make_loci_mesh(jax.devices()[:n])


def port_loci(n):
    return port.parallel.LociMesh(["cpu"] * n)


def _region(seed, n=1408, W=11, S=600, B=128, band=400):
    """A cis region: a symmetric sparse map, windows within ``band`` bins
    of the diagonal, valid bins, a decaying expected vector and groups."""
    rng = np.random.default_rng(seed)
    ij = rng.integers(0, n, (2, 40_000))
    keep = np.abs(ij[0] - ij[1]) < band + 2 * W
    i, j = ij[0][keep], ij[1][keep]
    v = rng.gamma(1.0, 1.0, len(i))
    mat = sp.coo_matrix((np.concatenate([v, v]), (np.concatenate([i, j]),
                                                   np.concatenate([j, i]))),
                        shape=(n, n))
    r1 = rng.integers(0, n - W, S)
    r2 = np.clip(r1 + rng.integers(-band, band, S), 0, n - W)
    pad = n + B
    valid = (rng.random(pad) > 0.05).astype(np.float32)
    evec = (4.0 / (1.0 + np.arange(2 * pad))).astype(np.float32)
    cov = rng.random(pad).astype(np.float32)
    cid = rng.integers(0, 8, S)
    return dict(mat=mat, r1=r1.astype(np.int32), r2=r2.astype(np.int32),
                cid=cid.astype(np.int32), valid=valid, evec=evec, cov=cov,
                n=n, W=W, B=B)


def _tensor(a, dtype=torch.int64):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


# -- the host half of rowshard -----------------------------------------------


@pytest.mark.parametrize("n", MESH_SIZES)
def test_row_partition_matches_reference(n):
    p = _region(n)
    ts = ref_build_tile_stack(p["mat"], p["B"], r1=p["r1"], r2=p["r2"],
                              window1=p["W"], window2=p["W"])
    want = ref_rs.build_row_partition(ts, p["r1"], n)
    got = prs.build_row_partition(from_reference(ts), p["r1"], n)
    assert want is not None and got is not None
    for field in ("tiles", "tile_map", "send_idx", "ncolp", "row_bounds"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert (got.n_dev, got.B) == (want.n_dev, want.B)
    assert got.per_device_tile_bytes == want.per_device_tile_bytes
    for g, w in zip(prs.route_snips(got, p["r1"]),
                    ref_rs.route_snips(want, p["r1"])):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(pqm.local_tile_coords(got),
                    ref_pm.local_tile_coords(want)):
        np.testing.assert_array_equal(g, w)
    # fewer tile rows than devices: no partition on either side
    small = _region(n, n=100, band=30)
    ts = ref_build_tile_stack(small["mat"], 128, r1=small["r1"],
                              r2=small["r2"], window1=11, window2=11)
    assert (prs.build_row_partition(from_reference(ts), small["r1"], n)
            is None) == (ref_rs.build_row_partition(ts, small["r1"], n)
                         is None) == (n > 1)


# -- the normalized halo and the mesh session ---------------------------------


@pytest.mark.parametrize("n,ooe", [(1, True), (2, False), (4, True),
                                   (8, True)])
def test_normalize_halo_matches_reference(n, ooe):
    p = _region(10 + n)
    ts = ref_build_tile_stack(p["mat"], 128, r1=p["r1"], r2=p["r2"],
                              window1=p["W"], window2=p["W"])
    part = ref_rs.build_row_partition(ts, p["r1"], n)
    ncp = int(part.ncolp)
    nrp = part.tile_map.shape[1] // ncp
    v1, v2, epad = ref_pm._normalize_vectors(128, nrp, ncp, p["valid"],
                                             p["valid"], p["evec"], ooe)
    D0, Hcap = part.tiles.shape[1], part.send_idx.shape[1]
    D2 = max(64, ref_pm._ceil_pow2(D0 + Hcap))
    tr, tc = ref_pm.local_tile_coords(part)
    want = np.asarray(ref_pm.make_sharded_normalize_halo(
        128, D0, Hcap, D2, True, 2, ooe, ref_loci(n))(
            part.tiles, tr, tc, part.send_idx, v1, v2, epad))
    got = pqm.sharded_normalize_halo(
        port_loci(n), prs.build_row_partition(from_reference(ts), p["r1"], n),
        p["valid"], p["valid"], p["evec"], ooe=ooe, cis=True, ignore_diags=2)
    assert pqm.halo_depth(part) == (D0, Hcap, D2)
    assert len(got) == n
    for d in range(n):
        np.testing.assert_allclose(got[d].numpy(), want[d], rtol=1e-6,
                                   atol=0, equal_nan=True, err_msg=f"dev {d}")


def _session_inputs(banded, n, seed):
    p = _region(seed, W=11, S=300)
    ts = ref_build_tile_stack(p["mat"], 128, r1=p["r1"], r2=p["r2"],
                              window1=p["W"], window2=p["W"])
    part = ref_rs.build_row_partition(ts, p["r1"], n) if banded else None
    if part is not None:
        order, counts = ref_rs.route_snips(part, p["r1"])
    else:
        order = np.arange(len(p["r1"]))
        counts = np.full(n, len(order) // n)
        counts[: len(order) % n] += 1
    items = np.split(order, np.cumsum(counts)[:-1])
    return p, ts, part, items


@pytest.mark.parametrize("banded,n", [(True, 2), (True, 4), (False, 2),
                                      (False, 4)])
def test_quad_mesh_session_matches_reference(banded, n):
    p, ts, part, items = _session_inputs(banded, n, seed=20 + n)
    C, W = 16, p["W"]
    cfg = dict(W=W, cis=True, ignore_diags=2, ooe=True)
    rows = [[p[k][it] for it in items] for k in ("r1", "r2", "cid")]
    ref_session = ref_pm.PallasMeshSession(
        ref_loci(n), ts, part, p["valid"], p["valid"], p["evec"],
        dict(cfg, capacity=C + 8, interpret=True))
    want = ref_session.run_chunk(*rows, 4096, C)
    pts = from_reference(ts)
    ppart = prs.build_row_partition(pts, p["r1"], n) if banded else None
    session = pqm.QuadMeshSession(port_loci(n), pts, ppart, p["valid"],
                                  p["valid"], p["evec"], dict(cfg, capacity=C))
    got = session.run_chunk(*rows)
    np.testing.assert_array_equal(got["num"].numpy(),
                                  np.asarray(want["num"])[:C])
    np.testing.assert_allclose(got["sum"].numpy(), np.asarray(want["sum"])[:C],
                               rtol=1e-5, atol=1e-6)
    assert got["num"].sum() > 0
    assert session.stack_bytes[0] > 0
    assert (session.halo_bytes > 0) == (banded and n > 1)
    # stripes: every device's rows from its own stack, in its routed order
    want_h = ref_session.run_stripes(rows[0], rows[1], mode="hv", f16=False)
    got_h = session.run_stripes(rows[0], rows[1])
    for d in range(n):
        np.testing.assert_allclose(got_h[d], want_h[d], rtol=1e-6, atol=0,
                                   equal_nan=True)


def test_quad_mesh_launches_per_device(monkeypatch):
    """The quad route launches once per device that holds snips (the plain
    version swapped for one that counts its calls as launches)."""
    plain = qg.quad_accumulate_plain

    def counted(*args):
        qg.LAUNCHES += 1
        return plain(*args)

    monkeypatch.setattr(qg, "quad_accumulate", counted)
    p, ts, part, items = _session_inputs(True, 4, seed=31)
    items[2] = items[2][:0]
    session = pqm.QuadMeshSession(
        port_loci(4), from_reference(ts),
        prs.build_row_partition(from_reference(ts), p["r1"], 4), p["valid"],
        p["valid"], p["evec"], dict(W=p["W"], capacity=16, ooe=True))
    session.run_chunk(*[[p[k][it] for it in items]
                        for k in ("r1", "r2", "cid")])
    assert session.launches == [1, 1, 0, 1]


# -- the steps ----------------------------------------------------------------


@pytest.mark.parametrize("n", (2, 4))
def test_sharded_generic_step_matches_reference(n):
    p = _region(40 + n, n=700, W=21, S=256)
    W, C, B = p["W"], 8, 64
    ts = ref_build_tile_stack(p["mat"], B, r1=p["r1"], r2=p["r2"], window1=W,
                              window2=W)
    cfg = GatherConfig(W=W, B=B, S=256 // n, block=256 // n, capacity=C,
                       cis=True, ignore_diags=2, ooe=True,
                       emit_expected=False, coverage=False, stripes=True)
    dd0 = (p["r1"] - p["r2"]).astype(np.int32)
    want = ref_mesh.make_engine_sharded_step(cfg, ref_loci(n))(
        ts.tiles, ts.tile_map.ravel(), np.int32(ts.tile_map.shape[1]),
        p["evec"], p["valid"], p["valid"], p["cov"], p["cov"], p["r1"],
        p["r2"], dd0, p["cid"], np.ones(256, bool))
    pts = port.build_tile_stack(p["mat"], 128, r1=p["r1"], r2=p["r2"],
                                window1=W, window2=W)
    st = normalized_stack(pts, p["valid"], p["valid"], p["evec"], "cpu",
                          ooe=True, cis=True, ignore_diags=2)
    mesh = port_loci(n)
    got = pmesh.sharded_generic_step(
        mesh, pmesh.replicate(mesh, st),
        pmesh.replicate(mesh, _tensor(pts.tile_map)), _tensor(p["r1"]),
        _tensor(p["r2"]), _tensor(p["cid"]), W, C, stripes=True)
    for k in ("num", "poison"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("sum", "horizontal_stripe", "vertical_stripe"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, equal_nan=True,
                                   err_msg=k)


@pytest.mark.parametrize("n", (4, 8))
def test_row_sharded_step_matches_reference(n):
    p = _region(50 + n, n=1024, W=11, S=512, B=64, band=300)
    W, B, C = p["W"], 64, 8
    ts = ref_build_tile_stack(p["mat"], B, r1=p["r1"], r2=p["r2"], window1=W,
                              window2=W)
    part = ref_rs.build_row_partition(ts, p["r1"], n)
    order, counts = ref_rs.route_snips(part, p["r1"])
    S_dev = prs._next_pow2(counts.max())
    items = np.split(order, np.cumsum(counts)[:-1])
    dd0 = p["r1"] - p["r2"]
    rows = {k: np.zeros((n, S_dev), np.int32) for k in ("r1", "r2", "dd0",
                                                        "cid")}
    smc = np.zeros((n, S_dev), bool)
    for d, it in enumerate(items):
        for k, v in (("r1", p["r1"]), ("r2", p["r2"]), ("dd0", dd0),
                     ("cid", p["cid"])):
            rows[k][d, : len(it)] = v[it]
        smc[d, : len(it)] = True
    cfg = GatherConfig(W=W, B=B, S=S_dev, block=64, capacity=C, cis=True,
                       ignore_diags=2, ooe=True, emit_expected=False,
                       coverage=False, stripes=True)
    want = ref_rs.make_row_sharded_step(cfg, ref_loci(n))(
        part.tiles, part.send_idx, part.tile_map, part.ncolp, p["evec"],
        p["valid"], p["valid"], p["cov"], p["cov"], rows["r1"], rows["r2"],
        rows["dd0"], rows["cid"], smc)

    mesh = port_loci(n)
    ppart = prs.build_row_partition(from_reference(ts), p["r1"], n)
    stacks = pqm.sharded_normalize_halo(mesh, ppart, p["valid"], p["valid"],
                                        p["evec"], ooe=True)
    got = prs.row_sharded_step(
        mesh, stacks, [_tensor(g) for g in ppart.grids()],
        [p["r1"][it] for it in items], [p["r2"][it] for it in items],
        [p["cid"][it] for it in items], W, C, stripes=True)
    for k in ("num", "poison"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got["sum"].numpy(), np.asarray(want["sum"]),
                               rtol=1e-5, atol=1e-5)
    for k in ("horizontal_stripe", "vertical_stripe"):
        w = np.asarray(want[k])
        for d, it in enumerate(items):
            np.testing.assert_allclose(
                got[k][d].numpy(), w[d * S_dev: d * S_dev + len(it)],
                rtol=1e-5, atol=1e-6, equal_nan=True, err_msg=f"{k} dev {d}")


def test_sharded_rescale_step_matches_reference():
    from coolpuppy_tpu.ops import rescale as ref_rescale
    from coolpuppy_tpu_torch.ops import rescale as port_rescale

    n, S, C, R, Hmax = 4, 64, 8, 9, 64
    rng = np.random.default_rng(61)
    N = 400
    dense = rng.gamma(1.0, 1.0, (N, N)) * (rng.random((N, N)) < 0.3)
    coo = sp.coo_matrix(np.triu(dense) + np.triu(dense, 1).T)
    h1 = rng.integers(1, Hmax + 1, S)
    r1 = rng.integers(0, N - h1 + 1)
    pad = N + Hmax + 8
    valid = np.zeros(pad, np.float32)
    valid[:N] = rng.random(N) > 0.05
    evec = np.full(pad, np.nan, np.float32)
    evec[:N] = 4.0 / (1.0 + np.arange(N))
    cov = np.zeros(pad, np.float32)
    cov[:N] = rng.uniform(0.5, 2.0, N)
    cid = rng.integers(0, 6, S)
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    kw = dict(R=R, Hmax=Hmax, ooe=True, emit_expected=False, coverage=True,
              stripes=True, local=True)
    ts = ref_build_tile_stack(coo, Hmax, r1=r1, r2=r1, window1=h1,
                              window2=h1)
    want = ref_mesh.make_engine_sharded_rescale_step(
        ref_rescale.RescaleConfig(B=Hmax, S=S // n, block=8, capacity=C,
                                  cis=True, ignore_diags=2, **kw),
        ref_loci(n))(
        ts.tiles, ts.tile_map.ravel(), np.int32(ts.tile_map.shape[1]), evec,
        valid, valid, cov, cov, i32(r1), i32(r1), i32(h1), i32(h1),
        i32(np.zeros(S)), i32(cid), np.ones(S, bool))
    pts = port.build_tile_stack(coo, 128, r1=r1, r2=r1, window1=h1,
                                window2=h1)
    st = normalized_stack(pts, valid, valid, evec, "cpu", ooe=True, cis=True,
                          ignore_diags=2)
    mesh = port_loci(n)
    f = lambda a: _tensor(a, torch.float32)  # noqa: E731
    per_device = list(zip(*(pmesh.replicate(mesh, t) for t in (
        st, _tensor(pts.tile_map), f(evec), f(cov), f(cov)))))
    got = pmesh.sharded_rescale_step(
        mesh, per_device, _tensor(r1), _tensor(r1), _tensor(h1), _tensor(h1),
        _tensor(np.zeros(S)), _tensor(cid),
        port_rescale.RescaleConfig(capacity=C, **{
            k: v for k, v in kw.items() if k != "ooe"}))
    np.testing.assert_array_equal(got["num"].numpy(), np.asarray(want["num"]))
    for k in ("sum", "cov_start", "cov_end", "horizontal_stripe",
              "vertical_stripe"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, equal_nan=True,
                                   err_msg=k)


def _step_cfg(S):
    return dict(W=11, B=64, S=S, capacity=8, cis=True, ignore_diags=2,
                ooe=True, emit_expected=False, coverage=True)


def test_sharded_pileup_step_matches_reference():
    rmesh = ref_mesh.make_mesh(jax.devices(), regions_axis=2)
    pmesh_ = pmesh.make_mesh(["cpu"] * 8, regions_axis=2)
    assert pmesh_.shape == dict(rmesh.shape) == {"regions": 2, "loci": 4}
    rcfg = GatherConfig(block=128, stripes=False, **_step_cfg(128))
    inputs = ref_mesh.sharded_pileup_demo_inputs(rcfg, rmesh, nr=2, seed=3)
    pinputs = pmesh.sharded_pileup_demo_inputs(
        pmesh.StepConfig(**_step_cfg(128)), pmesh_, nr=2, seed=3)
    for a, b in zip(inputs, pinputs):
        np.testing.assert_array_equal(a, b)
    want = ref_mesh.make_sharded_pileup_step(rcfg, rmesh)(*inputs)
    got = pmesh.sharded_pileup_step(pmesh.StepConfig(**_step_cfg(128)),
                                    pmesh_)(*pinputs)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-4, atol=1e-4, err_msg=k)


def test_sharded_pileup_step_factorization_invariance():
    """1x8 and 2x4 meshes give the same accumulators for one workload."""
    mesh_a = pmesh.make_mesh(["cpu"] * 8, regions_axis=2)
    mesh_b = pmesh.make_mesh(["cpu"] * 8, regions_axis=1)
    inputs = pmesh.sharded_pileup_demo_inputs(
        pmesh.StepConfig(**_step_cfg(128)), mesh_a, nr=2, seed=5)
    out_a = pmesh.sharded_pileup_step(pmesh.StepConfig(**_step_cfg(128)),
                                      mesh_a)(*inputs)
    out_b = pmesh.sharded_pileup_step(pmesh.StepConfig(**_step_cfg(64)),
                                      mesh_b)(*inputs)
    for k in out_a:
        np.testing.assert_allclose(out_a[k].numpy(), out_b[k].numpy(),
                                   rtol=2e-4, atol=1e-4, err_msg=k)


# -- the engine cases of tests/test_parallel.py -------------------------------

BIN = 1_000_000


def _feats(n_bins, n_feats, seed, binsize, chrom="chrA", strand=True,
           lo=10, starts=None):
    rng = np.random.default_rng(seed)
    if starts is None:
        starts = np.sort(rng.choice(np.arange(lo, n_bins - 10), n_feats,
                                    replace=False))
    frame = {"chrom": chrom, "start": starts * binsize,
             "end": (starts + 1) * binsize}
    if strand:
        frame.update(name="x", score=0,
                     strand=rng.choice(["+", "-"], len(starts)))
    return pd.DataFrame(frame)


def _tads():
    return pd.DataFrame({
        "chrom": ["chr1"] * 4,
        "start": [5_000_000, 15_000_000, 30_000_000, 42_000_000],
        "end": [10_000_000, 24_000_000, 37_000_000, 55_000_000],
    })


# per case: the cooler (make_toy_cooler keywords), the features, the
# CoordCreator and PileUpper keywords ("expected": True for the toy expected
# table, "view": the toy view), the grouping ("strand", "window" or "all")
# and, for by-window, the accumulator block of 8 groups
CASES = {
    "equals_single": dict(
        cool=dict(seed=7), feats=toy_features,
        cc=dict(flank=3 * BIN, nshifts=1, seed=0), pu=dict(control=True),
        view=True, group="strand"),
    "uses_rowshard": dict(
        cool=dict(chromsizes={"chrA": 60_000_000}, binsize=100_000, seed=13),
        feats=lambda: _feats(600, 40, 4, 100_000, lo=60),
        cc=dict(flank=500_000, nshifts=0, seed=0)),
    "stripes_and_expected": dict(
        cool=dict(seed=9), feats=toy_features, cc=dict(flank=3 * BIN, seed=0),
        pu=dict(expected=True, ooe=True, store_stripes=True), view=True),
    "fallback_counters": dict(
        cool=dict(chromsizes={"chrA": 60_000_000}, binsize=100_000, seed=13),
        feats=lambda: _feats(600, 0, 0, 100_000, starts=np.concatenate(
            [np.arange(64, 104), [300, 400, 500]])),
        cc=dict(flank=500_000, nshifts=0, seed=0)),
    "pallas_banded": dict(
        cool=dict(chromsizes={"chrA": 120_000_000}, binsize=100_000, seed=5),
        feats=lambda: _feats(1200, 40, 5, 100_000),
        cc=dict(flank=300_000, nshifts=1, seed=0), pu=dict(control=True),
        group="strand"),
    "pallas_replicated": dict(
        cool=dict(chromsizes={"chrA": 30_000_000}, binsize=100_000, seed=6),
        feats=lambda: _feats(300, 30, 6, 100_000),
        cc=dict(flank=300_000, nshifts=1, seed=0), pu=dict(control=True),
        group="strand"),
    "pallas_expected": dict(
        cool=dict(seed=9), feats=toy_features, cc=dict(flank=3 * BIN, seed=0),
        pu=dict(expected=True, ooe=True), view=True),
    "pallas_coverage": dict(
        cool=dict(seed=9), feats=toy_features, cc=dict(flank=3 * BIN, seed=0),
        pu=dict(coverage_norm=True, clr_weight_name=None), view=True),
    "trans": dict(
        cool=dict(seed=11), feats=toy_features,
        cc=dict(flank=2 * BIN, nshifts=1, seed=0, trans=True),
        pu=dict(control=True), view=True),
    "rescale": dict(
        cool=dict(chromsizes={"chr1": 60_000_000}, seed=7, trans=False),
        feats=_tads, cc=dict(local=True, rescale_flank=1.0, nshifts=0),
        pu=dict(rescale=True, rescale_size=9, ignore_diags=2)),
    "stripes_banded": dict(
        cool=dict(chromsizes={"chrA": 120_000_000}, binsize=100_000, seed=15),
        feats=lambda: _feats(1200, 40, 15, 100_000, strand=False),
        cc=dict(flank=300_000, seed=0), pu=dict(store_stripes=True)),
    "stripes_replicated": dict(
        cool=dict(chromsizes={"chrA": 30_000_000}, binsize=100_000, seed=16),
        feats=lambda: _feats(300, 25, 16, 100_000, strand=False),
        cc=dict(flank=300_000, seed=0), pu=dict(store_stripes=True)),
    "by_window_blocked": dict(
        cool=dict(chromsizes={"chrA": 30_000_000}, binsize=100_000, seed=7),
        feats=lambda: _feats(300, 24, 7, 100_000),
        cc=dict(flank=300_000, nshifts=1, seed=0), pu=dict(control=True),
        group="window"),
    "wide_banded": dict(
        cool=dict(chromsizes={"chrA": 140_800_000}, binsize=100_000, seed=3),
        feats=lambda: _feats(1408, 48, 3, 100_000, lo=70),
        cc=dict(flank=6_100_000, nshifts=1, seed=0, maxdist=40_000_000),
        pu=dict(control=True), group="strand"),
}

_COOLERS = {}
_WANT = {}


def _coolers(tmp_path_factory, name):
    spec = CASES[name]
    key = repr(sorted(spec["cool"].items()))
    if key not in _COOLERS:
        path = str(tmp_path_factory.mktemp("cool") / "mesh.cool")
        clr, dense, weights = make_toy_cooler(path, **spec["cool"])
        exp = (toy_expected(clr, dense, toy_regions(), weights=weights)
               if spec.get("view") else None)
        _COOLERS[key] = (clr, port.Cooler.from_cool(path), exp)
    return _COOLERS[key]


def _run(pkg, clr, exp, name, **pu_kw):
    """One case through ``pkg``'s CoordCreator and PileUpper; returns the
    PileUpper and the table."""
    spec = CASES[name]
    CC, PU = ((RefCC, RefPU) if pkg is ref
              else (port.CoordCreator, port.PileUpper))
    cc = CC(features=spec["feats"](), resolution=clr.binsize,
            features_format="bed", mindist=0, **spec["cc"])
    kw = dict(spec.get("pu", {}))
    if kw.get("expected"):
        kw["expected"] = exp
    if spec.get("view"):
        kw["view_df"] = toy_regions()
    pu = PU(clr, cc, **kw, **pu_kw)
    group = spec.get("group", "all")
    if group == "strand":
        return pu, pu.pileupsByStrandWithControl()
    if group == "window":
        return pu, pu.pileupsByWindowWithControl()
    return pu, pu.pileupsWithControl()


class _CountersOnly:
    """Stands in for the JAX package's ``PallasMeshSession``: the counters
    are set before the session is made, so the run reads them without the
    interpret-mode kernel (its data is zeros and is not compared)."""

    def __init__(self, mesh, tile_stack, part, v1, v2, evec, cfg_kw):
        self.shape = (cfg_kw["capacity"], cfg_kw["W"], cfg_kw["W"])
        self.W = cfg_kw["W"]

    def run_chunk(self, r1_rows, *args):
        return {"sum": np.zeros(self.shape, np.float32),
                "num": np.zeros(self.shape, np.float32)}

    def run_stripes(self, r1_rows, r2_rows, **kw):
        return [np.zeros((len(r), 2 * self.W), np.float32) for r in r1_rows]


def _ref_counters(clr, exp, name, n, monkeypatch):
    """The JAX package's ``_rowshard_*`` counters at mesh size n on the
    route the port takes: the Pallas mesh route for W <= 120 (its session
    stubbed), the XLA row-sharded route above."""
    spec = CASES[name]
    if spec.get("pu", {}).get("rescale"):
        return 0, 0
    wide = name.startswith("wide")
    with monkeypatch.context() as m:
        if not wide:
            m.setattr(ref_pm, "PallasMeshSession", _CountersOnly)
        pu, _ = _run(ref, clr, exp, name, mesh=ref_loci(n),
                     backend="xla" if wide else "pallas-interpret")
    return (getattr(pu, "_rowshard_regions", 0),
            getattr(pu, "_rowshard_fallbacks", 0))


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("name", list(CASES))
def test_engine_mesh_matches_reference(tmp_path_factory, monkeypatch, name,
                                       n):
    ref_clr, clr, exp = _coolers(tmp_path_factory, name)
    if name not in _WANT:
        _WANT[name] = _run(ref, ref_clr, exp, name, backend="xla")[1]
    want = _WANT[name]
    if name == "by_window_blocked":
        # 8 groups a block at W = 7, as the reference's
        # _pallas_block_groups = 8 in tests/test_parallel.py
        monkeypatch.setattr(engine, "_BLOCK_BYTES", 2 * 7 * 7 * 8 * 8)
    pu, got = _run(port, clr, exp, name, device="cpu", mesh=port_loci(n))
    # rows in order (by window: matched on chrom/start/end), counts exact,
    # stripe planes and their coordinates
    compare_tables(got, want, what=f"{name} n={n}", **ENGINE_TOL)
    assert got["n"].sum() > 0
    assert (pu._rowshard_regions, pu._rowshard_fallbacks) == _ref_counters(
        ref_clr, exp, name, n, monkeypatch)
    route = got["accumulate"].iloc[0]
    expect = ("rescale_torch" if name == "rescale" else
              "generic_torch" if name.startswith("wide") else "plain")
    assert route == expect
    if name in ("pallas_banded", "stripes_banded", "wide_banded") and n > 1:
        assert pu._rowshard_regions > 0 and pu.mesh_stats["banded"] > 0
        assert pu.mesh_stats["halo_bytes"] > 0
    if name in ("pallas_replicated", "stripes_replicated") and n == 8:
        # 3 tile rows do not band over 8 devices
        assert pu._rowshard_regions == 0 and pu.mesh_stats["replicated"] > 0


# -- the dry run, the arguments, the process helpers --------------------------


def test_dryrun_multichip_on_the_cpu(capsys):
    from coolpuppy_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip ok" in out
    for mode in ("quad", "wide", "by_window", "trans", "stripes"):
        assert f"{mode}: " in out


def _tiny_cooler():
    return port.Cooler.from_arrays({"chr1": 50 * BIN}, BIN,
                                   (np.arange(50), np.arange(50),
                                    np.ones(50, np.int64)),
                                   weights=np.ones(50))


def test_mesh_argument_errors():
    with pytest.raises(ValueError, match="mixed types"):
        port.parallel.LociMesh(["cpu", "cuda"])
    with pytest.raises(ValueError, match="no devices"):
        port.parallel.LociMesh([])
    with pytest.raises(ValueError, match="region rows"):
        port.parallel.LociMesh(["cpu"] * 3, regions=2)


@pytest.mark.parametrize("call", ["make_loci_mesh", "pileup_auto",
                                  "pileup_cuda_mesh", "auto_on_cpu"])
def test_mesh_without_a_card_raises(call):
    """No CUDA device here: every route to one raises, none falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    clr = _tiny_cooler()
    feats = _feats(50, 5, 0, BIN, chrom="chr1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if call == "make_loci_mesh":
            port.parallel.make_loci_mesh()
        elif call == "pileup_auto":
            port.pileup(clr, feats, mesh="auto")
        elif call == "pileup_cuda_mesh":
            port.parallel.LociMesh(["cuda"] * 2)
        else:
            port.pileup(clr, feats, mesh="auto", device="cpu")


def test_mesh_refuses_what_the_reference_refuses():
    clr = _tiny_cooler()
    cc = port.CoordCreator(_feats(50, 5, 0, BIN, chrom="chr1"), BIN,
                           features_format="bed", flank=2 * BIN)
    with pytest.raises(ValueError, match="mesh="):
        port.PileUpper(clr, cc, device="cpu", mesh="all")
    pu = port.PileUpper(clr, cc, device="cpu", mesh=port_loci(2))
    with pytest.raises(ValueError, match="mesh"):
        pu.pileupsWithControl(postprocess_batch_func=lambda f, d: f)


def test_distributed_helpers_single_process():
    assert distributed.init_distributed() == (0, 1)
    assert distributed.world_size() == 1 and distributed.rank() == 0
    pairs = [("a", "a"), ("b", "b"), ("c", "c"), ("d", "d"), ("e", "e")]
    assert distributed.local_region_pairs(pairs) == pairs
    assert distributed.local_region_pairs(pairs, 1, 2) == [("b", "b"),
                                                           ("d", "d")]
    assert distributed.local_region_pairs(
        pairs, 0, 2) == ref.parallel.local_region_pairs(pairs, 0, 2)
    out = [{"ROI": {}}]
    assert distributed.allreduce_region_maps(out) is out
