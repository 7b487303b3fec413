"""The wide kernel's host side and plain versions on the CPU (the kernel
itself runs only on a card: ``tests/test_torch_wide_kernel_cuda.py``).

- ``wide_items`` (the stable (tile, group) sort, the items cut at
  ``ITEM_MAX``, the R x R tile slots) against a numpy oracle at W = 121,
  201 and 401, with a tile of several groups and a run longer than
  ``ITEM_MAX``.
- ``generic_accumulate_plain`` against the JAX package's
  ``make_pileup_step_fn`` at W = 257 and 258 (``num``/``poison`` exact,
  ``sum`` rtol 1e-5).
- ``wide_accumulate_banded_plain``, the kernel's items, bands and slot
  addressing in torch ops, against ``generic_accumulate_plain``: ``num``
  and ``poison`` bit for bit, ``sum`` within rtol 1e-6, with missing tiles,
  +inf poison and NaN-masked pixels; ``wide_stripes`` against the plain
  version's stripes.
- The kernel branch of ``generic_accumulate`` raises and never falls back.
"""

import jax
import numpy as np
import pytest
import torch
from scipy import sparse as sp

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

import coolpuppy_tpu_torch as port
import coolpuppy_tpu_torch.ops.gather as ga
from coolpuppy_tpu.ops.gather import GatherConfig, make_pileup_step_fn
from coolpuppy_tpu.ops.tiles import build_tile_stack as ref_build_tile_stack
from coolpuppy_tpu_torch.ops.quad_gather import pack_snips
from coolpuppy_tpu_torch.ops.tiles import normalized_stack
from torch_cases import wide_case

B = 128
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
ORDER_TOL = dict(rtol=1e-6, atol=0.0)


def t64(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def items_oracle(tile_map, r1, r2, cid, W, C, item_max):
    """numpy: the words stably argsorted by (tile, group), each run cut
    into equal items, each item's R x R slots (0 past the map)."""
    tile_map = np.asarray(tile_map)
    nrm, ncm = tile_map.shape
    r1, r2, cid = (np.asarray(x, np.int64) for x in (r1, r2, cid))
    words = pack_snips(r1 % B, r2 % B, cid)
    key = ((r1 // B) * ncm + r2 // B) * C + cid
    order = np.argsort(key, kind="stable")
    key, words = key[order], words[order]
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    lens = np.diff(np.r_[starts, len(key)])
    R = -(-(127 + W) // 128)
    slots, istart, icount = [], [], []
    for s, c in zip(starts, lens):
        pieces = -(-c // item_max)
        size = -(-c // pieces)
        for q in range(pieces):
            istart.append(s + q * size)
            icount.append(min(size, c - q * size))
            t = key[s] // C
            t1, t2 = t // ncm, t % ncm
            slots.append([tile_map[t1 + u, t2 + v]
                          if t1 + u < nrm and t2 + v < ncm else 0
                          for u in range(R) for v in range(R)])
    return (np.asarray(slots, np.int32).reshape(-1, R * R),
            np.asarray(istart, np.int32), np.asarray(icount, np.int32),
            words.astype(np.int32))


@pytest.mark.parametrize("W", [121, 201, 401])
def test_wide_items_match_numpy_oracle(W):
    stiles, tmap, r1, r2, cid = wide_case(W, W, groups=5)
    # a run of ITEM_MAX + 3 snips in one (tile, group), and the same tile
    # holding other groups, cut into two items of equal length
    m = ga.ITEM_MAX + 3
    r1 = torch.cat([r1, torch.full((m,), 7, dtype=torch.int64)])
    r2 = torch.cat([r2, torch.full((m,), 20, dtype=torch.int64)])
    cid = torch.cat([cid, torch.full((m,), 2, dtype=torch.int64)])
    for item_max in (ga.ITEM_MAX, 5):
        got = ga.wide_items(tmap, r1, r2, cid, W, 8, item_max=item_max)
        want = items_oracle(tmap, r1, r2, cid, W, 8, item_max)
        assert all(g.dtype == torch.int32 for g in got)
        for g, w, what in zip(got, want, ("slots", "istart", "icount",
                                          "snips")):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=what)
        counts = got[2].numpy()
        assert counts.max() <= item_max and counts.sum() == len(r1)
        if item_max == ga.ITEM_MAX:
            # the long run (the added snips, and any of the case's own in
            # that tile and group) in two items of equal length
            top = sorted(counts)[-2:]
            assert sum(top) >= m and top[1] - top[0] <= 1
    assert got[0].shape[1] == ga.wide_slots(W) ** 2
    assert ga.wide_slots(W) == {121: 2, 201: 3, 401: 5}[W]


def test_wide_slots_and_bands():
    assert [ga.wide_slots(W) for W in (1, 2, 121, 257, 258, 385, 386)] == \
        [1, 2, 2, 3, 4, 4, 5]
    assert ga.wide_bands(201) == -(-201 * 201 // 2048) == 20
    assert ga.wide_bands(45) == 1


def test_wide_items_refuse_bad_streams():
    stiles, tmap, r1, r2, cid = wide_case(121, 3)
    n_rows = tmap.shape[0] * B
    with pytest.raises(ValueError, match="leave the tile map"):
        ga.wide_items(tmap, r1 + (n_rows - 121 + 1 - int(r1.max())), r2, cid,
                      121, 8)
    with pytest.raises(ValueError, match="leave the tile map"):
        ga.wide_items(tmap, r1 - int(r1.max()) - 1, r2, cid, 121, 8)
    with pytest.raises(ValueError, match="group ids"):
        ga.wide_items(tmap, r1, r2, cid + 8, 121, 8)
    with pytest.raises(ValueError, match="C="):
        ga.wide_items(tmap, r1, r2, cid, 121, (1 << 17) + 1)
    empty = torch.zeros(0, dtype=torch.int64)
    slots, istart, icount, snips = ga.wide_items(tmap, empty, empty, empty,
                                                 201, 8)
    assert tuple(slots.shape) == (0, 9) and len(istart) == len(snips) == 0


@pytest.mark.parametrize("W", [257, 258])
def test_plain_matches_reference(W):
    """``generic_accumulate_plain`` against the jitted ``make_pileup_step_fn``
    over the reference's own tiles, at the widths where R turns from 3 to
    4."""
    rng = np.random.default_rng(W)
    n, S, G = 640, 40, 4
    dense = rng.gamma(1.0, 1.0, (n, n)) * (rng.random((n, n)) < 0.3)
    dense = np.triu(dense) + np.triu(dense, 1).T
    coo = sp.coo_matrix(dense)
    r1 = rng.integers(0, n - W + 1, S)
    r2 = rng.integers(0, n - W + 1, S)
    r1[:5] = (0, 127, 128, 255, n - W)
    pad = n + 1024
    valid = np.zeros(pad, np.float32)
    valid[:n] = rng.random(n) > 0.05
    evec = np.full(pad, np.nan, np.float32)
    evec[:n] = 4.0 / (1.0 + np.arange(n))
    evec[rng.integers(3, n, 3)] = 0.0
    cid = rng.integers(0, G, S)
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731

    Bref = 512
    ts = ref_build_tile_stack(coo, Bref, r1=r1, r2=r2, window1=W, window2=W)
    cfg = GatherConfig(W=W, B=Bref, S=S, block=8, capacity=G, cis=True,
                       ignore_diags=2, ooe=True, emit_expected=False,
                       coverage=False, stripes=True)
    want = jax.jit(make_pileup_step_fn(cfg))(
        ts.tiles, ts.tile_map.ravel(), np.int32(ts.tile_map.shape[1]), evec,
        valid, valid, valid, valid, i32(r1), i32(r2), i32(r1 - r2), i32(cid),
        np.ones(S, bool),
    )
    pts = port.build_tile_stack(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    stiles = normalized_stack(pts, valid, valid, evec, "cpu", ooe=True,
                              cis=True, ignore_diags=2)
    got = ga.generic_accumulate_plain(stiles, t64(pts.tile_map), t64(r1),
                                      t64(r2), t64(cid), W, G, stripes=True,
                                      block=7)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        if k in ("num", "poison"):
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), w, equal_nan=True,
                                       err_msg=k, **STEP_TOL)
    assert got["num"].sum() > 0 and got["poison"].sum() > 0


@pytest.mark.parametrize("W", [121, 129, 130, 201, 257, 258, 401])
def test_kernel_order_matches_plain(W):
    """The kernel's addressing and order in torch ops equals the plain
    version: counts bit for bit, sums within rtol 1e-6; items of a few
    snips (``item_max`` 3) so that runs are cut and flushed often."""
    stiles, tmap, r1, r2, cid = wide_case(W, 40 + W, n_snips=36)
    C = 6
    want = ga.generic_accumulate_plain(stiles, tmap, r1, r2, cid, W, C)
    items = ga.wide_items(tmap, r1, r2, cid, W, C, item_max=3)
    got = ga.wide_accumulate_banded_plain(stiles, *items, W, C)
    for k in ("num", "poison"):
        assert torch.equal(got[k].float(), want[k]), k
    torch.testing.assert_close(got["sum"].float(), want["sum"], **ORDER_TOL)
    assert want["num"].sum() > 0 and want["poison"].sum() > 0
    # NaN-masked pixels and missing tiles count nowhere
    assert (want["num"] + want["poison"]).sum() < 36 * W * W


@pytest.mark.parametrize("W", [121, 202, 401])
def test_wide_stripes_match_plain(W):
    stiles, tmap, r1, r2, cid = wide_case(W, 70 + W, n_snips=25)
    want = ga.generic_accumulate_plain(stiles, tmap, r1, r2, cid, W, 4,
                                       stripes=True)
    got = ga.wide_stripes(stiles, tmap, r1, r2, W)
    for k in ("horizontal_stripe", "vertical_stripe"):
        assert got[k].shape == (25, W) and got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   equal_nan=True)
        assert torch.isnan(got[k]).any() and not torch.isinf(got[k]).any()


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    stiles, tmap, r1, r2, cid = wide_case(123, 5)
    want = ga.generic_accumulate_plain(stiles, tmap, r1, r2, cid, 123, 4,
                                       stripes=True)

    def no_kernel():
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr("coolpuppy_tpu_torch.kernels.build.load_kernels",
                        no_kernel)
    before = ga.LAUNCHES
    got = ga.generic_accumulate(stiles, tmap, r1, r2, cid, 123, 4,
                                stripes=True)
    assert ga.LAUNCHES == before
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, equal_nan=True)


def test_kernel_branch_raises_without_falling_back(monkeypatch):
    """A tensor off the CPU goes to the kernel: where the library does not
    load, the error comes out and the plain version never runs; a CPU
    tensor handed to the kernel's wrapper is refused."""
    stiles, tmap, r1, r2, cid = wide_case(121, 6)

    class NoLibrary(RuntimeError):
        pass

    def refuse():
        raise NoLibrary("the kernel library did not load")

    def plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr("coolpuppy_tpu_torch.kernels.build.load_kernels",
                        refuse)
    monkeypatch.setattr(ga, "generic_accumulate_plain", plain)
    meta = [x.to("meta") for x in (stiles, tmap, r1, r2, cid)]
    before = ga.LAUNCHES
    with pytest.raises(NoLibrary):
        ga.generic_accumulate(*meta, 121, 4)
    with pytest.raises(NoLibrary):
        ga.generic_accumulate(*meta, 121, 4, stripes=True)
    monkeypatch.setattr("coolpuppy_tpu_torch.kernels.build.load_kernels",
                        lambda: object())
    with pytest.raises(ValueError, match="no kernel for cpu"):
        ga.wide_accumulate(stiles, tmap, r1, r2, cid, 121, 4)
    with pytest.raises(ValueError, match="float32"):
        ga.wide_accumulate(stiles.double(), tmap, r1, r2, cid, 121, 4)
    with pytest.raises(ValueError, match="tile_map on"):
        ga.wide_accumulate(meta[0], tmap, *meta[2:], 121, 4)
    with pytest.raises(ValueError, match="integer"):
        ga.wide_accumulate(stiles, tmap, r1.float(), r2, cid, 121, 4)
    assert ga.LAUNCHES == before
