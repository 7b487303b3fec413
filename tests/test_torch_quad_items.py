"""The staged quad kernel's host side (coolpuppy_tpu_torch/ops/quad_gather.py):
the multi-group work-item split, the shared-memory corner layout with its
row bands (one band up to W = 110, two from 111 to 120) and their plain
PyTorch staging, the items of either kernel, and the entry points' device
defaults, on the CPU, where ``quad_accumulate`` runs its plain version. The
Pallas kernel of the JAX package runs with interpret=True, as its own tests
run it."""

import numpy as np
import pytest
import torch
from scipy import sparse as sp

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

from coolpuppy_tpu.ops import pallas_gather as ref
from coolpuppy_tpu.ops import tiles as ref_tiles
from coolpuppy_tpu_torch.device import resolve_device
from coolpuppy_tpu_torch.ops import quad_gather as qg
from coolpuppy_tpu_torch.ops import tiles as port_tiles
from coolpuppy_tpu_torch.ops.tiles import build_tile_stack, from_reference

B = 128


def _stream(seed, n=700, S=1500, C=600, W=11, heavy=900):
    """``heavy`` snips in one quad, the rest anywhere."""
    rng = np.random.default_rng(seed)
    r1 = np.concatenate([3 + rng.integers(0, 5, heavy),
                         rng.integers(0, n - W, S - heavy)]).astype(np.int32)
    r2 = np.concatenate([9 + rng.integers(0, 5, heavy),
                         rng.integers(0, n - W, S - heavy)]).astype(np.int32)
    return r1, r2, rng.integers(0, C, S).astype(np.int32)


def _sorted_quads(seed, W=11, **kw):
    n = 700
    r1, r2, cid = _stream(seed, n=n, W=W, **kw)
    ts = build_tile_stack(sp.coo_matrix(np.ones((n, n))), B, r1=r1, r2=r2,
                          window1=W, window2=W)
    return qg.sort_quads(r1, r2, cid, ts.tile_map, B)


@pytest.mark.parametrize("item_max", [7, 64, qg.ITEM_MAX])
def test_split_items_covers_every_snip_once(item_max):
    snips, k, qstart, qcount = _sorted_quads(2, C=40)
    ik, istart, icount = qg.split_items(k, qstart, qcount, item_max=item_max)
    assert icount.dtype == istart.dtype == np.int32
    assert icount.max() <= item_max and icount.min() >= 1
    assert icount.sum() == len(snips)
    cover = np.zeros(len(snips), int)
    quad_of = np.repeat(np.arange(len(qstart)), qcount)
    for kk, s, c in zip(ik, istart, icount):
        cover[s:s + c] += 1
        assert len(set(quad_of[s:s + c].tolist())) == 1  # never crosses a quad
        np.testing.assert_array_equal(kk, k[quad_of[s]])
        assert np.all(np.diff(snips[s:s + c] & 0x1FFFF) >= 0)  # groups sorted
    assert np.all(cover == 1)
    # the heavy quad (900 snips and more) holds many groups in one item, and
    # is cut into ceil(n / item_max) items of equal length
    heavy = int(np.argmax(qcount))
    pieces = icount[quad_of[istart] == heavy]
    assert qcount[heavy] >= 900
    assert len(pieces) == -(-int(qcount[heavy]) // item_max)
    assert pieces.max() - pieces.min() <= max(1, len(pieces) - 1)
    if item_max >= 64:
        first = int(np.flatnonzero(quad_of[istart] == heavy)[0])
        span = snips[istart[first]:istart[first] + icount[first]]
        assert len(np.unique(span & 0x1FFFF)) > (30 if item_max > 900 else 1)


@pytest.mark.parametrize("n,want", [
    (0, []), (1, [1]), (qg.ITEM_MAX - 1, [qg.ITEM_MAX - 1]),
    (qg.ITEM_MAX, [qg.ITEM_MAX]),
    (qg.ITEM_MAX + 1, [qg.ITEM_MAX // 2 + 1, qg.ITEM_MAX // 2]),
    (3 * qg.ITEM_MAX, [qg.ITEM_MAX] * 3),
])
def test_split_items_cuts_exactly_at_item_max(n, want):
    """A quad of exactly ITEM_MAX snips is one item; one more makes two."""
    k = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    ik, istart, icount = qg.split_items(
        k, np.array([0, n], np.int32), np.array([n, 5], np.int32))
    assert icount.tolist() == want + [5]
    assert istart.tolist() == np.concatenate(
        [[0], np.cumsum(want + [5])[:-1]]).tolist()
    np.testing.assert_array_equal(ik[:len(want)],
                                  np.tile(k[0], (len(want), 1)))
    np.testing.assert_array_equal(ik[-1], k[1])


def _cdiv(a, b):
    return -(-a // b)


def _pr5_layout(W):
    """The one-band layout as the staged kernel had it before bands: the
    whole (127 + W)-row corner, and the fewest pixels a thread that cover
    the W × W window."""
    def threads(P):
        return _cdiv(_cdiv(W * W, P), 32) * 32

    side = B + W - 1
    corner_bytes = _cdiv(side * (side + 1) * 4, 16) * 16
    P = next(P for P, most in qg._PIXELS_PER_THREAD if threads(P) <= most)
    return ((side, side + 1, corner_bytes, corner_bytes + qg._STAGE_TAIL),
            (P, threads(P)))


def test_corner_layout_fits_and_flips_once():
    """Every W in 1..120 is staged within a block's 232,448 bytes of
    dynamic shared memory, in one band (the whole corner, exactly the
    layout, pixels a thread and threads the kernel had before bands) up to
    W = 110 and in two bands from 111 to 120: the band count flips once, at
    the first W whose whole corner does not fit, and never back. The stride
    keeps its promise (congruent to W mod 32: distinct banks for 32
    consecutive pixels), and every corner offset plus pixel offset of a
    band stays inside the rows that band stages."""
    assert qg.SMEM_MAX == 232_448
    bands = []
    for W in range(1, qg.W_MAX + 1):
        lay = qg.corner_layout(W)
        assert lay.side == B + W - 1
        assert lay.stride % 32 == W % 32 and lay.stride == lay.side + 1
        assert lay.staged and lay.smem_bytes <= qg.SMEM_MAX
        assert lay.corner_bytes % 16 == 0
        rows = B - 1 + lay.band_rows  # the corner rows one band stages
        assert 0 <= lay.corner_bytes - 4 * rows * lay.stride < 16
        assert lay.smem_bytes == lay.corner_bytes + qg._STAGE_TAIL
        assert lay.band_rows == _cdiv(W, lay.bands)
        assert (lay.bands - 1) * lay.band_rows < W  # no empty band
        bands.append(lay.bands)
        P, threads = qg.pixels_per_thread(W)
        if lay.bands == 1:
            assert (lay[:4], (P, threads)) == _pr5_layout(W)
        else:
            # a layout with one band fewer would not fit
            fewer = _cdiv(W, lay.bands - 1)
            assert (_cdiv((B - 1 + fewer) * lay.stride * 4, 16) * 16
                    + qg._STAGE_TAIL) > qg.SMEM_MAX
        for band in range(lay.bands):
            band_rows = min(lay.band_rows, W - band * lay.band_rows)
            # the largest corner offset plus the largest pixel offset of the
            # band stays inside its staged rows
            assert ((127 + band_rows - 1) * lay.stride + 127 + W - 1
                    < (B - 1 + band_rows) * lay.stride)
    first_banded = bands.index(2) + 1
    assert first_banded == 111
    assert bands == [1] * 110 + [2] * 10
    side = B + 110  # the whole corner at W = 111 does not fit
    assert _cdiv(side * (side + 1) * 4, 16) * 16 + qg._STAGE_TAIL > qg.SMEM_MAX
    # the chunk buffers hold an item of ITEM_MAX snips in one pass
    assert qg.ITEM_MAX <= qg.STAGE_CHUNK
    # the headline window leaves room for two blocks on an SM (228 KB, 1 KB
    # reserved per block)
    assert 2 * (qg.corner_layout(21).smem_bytes + 1024) <= 233_472


def test_pixels_per_thread_covers_the_window():
    """One block covers a band of the window (``band_rows`` × W pixels)
    with the fewest pixels a thread: W = 111..120 take 8 with 800..928
    threads."""
    for W in range(1, qg.W_MAX + 1):
        pixels = qg.corner_layout(W).band_rows * W
        P, threads = qg.pixels_per_thread(W)
        assert P in (1, 2, 4, 8, 16) and threads % 32 == 0
        assert P * threads >= pixels and threads <= (1024 if P <= 8 else 768)
        assert P == 1 or (P // 2) * 1024 < pixels  # the fewest a thread
    assert qg.pixels_per_thread(21) == (1, 448)
    assert qg.pixels_per_thread(111) == (8, 800)
    assert qg.pixels_per_thread(120) == (8, 928)


def _corner_accumulate(stiles, k, qstart, qcount, snips, W, C):
    """quad_accumulate through the staged layout with torch ops
    (``quad_accumulate_banded_plain``), after checking the shape of every
    band the layout stages."""
    lay = qg.corner_layout(W)
    for band in range(lay.bands):
        rows = min(lay.band_rows, W - band * lay.band_rows)
        corner = qg.stage_corner_plain(stiles, k[0], W, band)
        assert tuple(corner.shape) == (B - 1 + rows, lay.stride)
    if lay.bands == 1:
        assert tuple(corner.shape) == lay[:2]
    return qg.quad_accumulate_banded_plain(
        stiles, torch.from_numpy(np.asarray(k)), qstart, qcount, snips, W, C)


@pytest.mark.parametrize("W", [1, 11, 21, 33, 110])
def test_staged_corner_reproduces_plain_bit_for_bit(W):
    """The staged layout is only another addressing of the same floats, so
    it must give quad_accumulate_plain's bits: with missing tiles (slot 0,
    all NaN), offsets 127 in both fields, +inf poison and NaN pixels."""
    rng = np.random.default_rng(W)
    K, C = 9, 5
    st = rng.gamma(1.0, 1.0, (K, B, B)).astype(np.float32)
    st[rng.random(st.shape) < 0.1] = np.nan
    st[rng.random(st.shape) < 0.01] = np.inf
    st[0] = np.nan
    stiles = torch.from_numpy(st)
    # items: a full quad, quads with missing tiles, a repeated quad
    k = np.array([[1, 2, 3, 4], [5, 0, 6, 0], [0, 0, 7, 8], [0, 0, 0, 0],
                  [1, 2, 3, 4]], np.int32)
    counts = np.array([40, 30, 30, 5, 25], np.int32)
    n = int(counts.sum())
    o1 = rng.integers(0, 128, n)
    o2 = rng.integers(0, 128, n)
    o1[:4], o2[:4] = [127, 127, 0, 0], [127, 0, 127, 0]
    o1[40:42], o2[40:42] = 127, 127
    g = np.concatenate([np.sort(rng.integers(0, C, c)) for c in counts])
    snips = torch.from_numpy(qg.pack_snips(o1, o2, g))
    qstart = torch.from_numpy((np.cumsum(counts) - counts).astype(np.int32))
    qcount = torch.from_numpy(counts)
    want = qg.quad_accumulate_plain(stiles, torch.from_numpy(k), qstart,
                                    qcount, snips, W, C)
    got = _corner_accumulate(stiles, k, qstart, qcount, snips, W, C)
    assert torch.equal(got[1], want[1]) and int(want[1].sum()) > 0
    assert torch.equal(got[0], want[0])  # +inf compares equal, no NaN in sums
    assert not torch.isnan(want[0]).any()
    if W > 1:
        assert torch.isinf(want[0]).any()


BANDED_CASES = ["missing tiles", "offsets 127", "multi-group items",
                "item longer than the chunk"]


def _banded_case(case, W, C=7):
    """A stack of random tiles (10% NaN, 1% +inf, slot 0 all NaN) and items
    for one case: quads with missing tiles; offsets at 127 in either field
    and both; items holding runs of many groups; one item longer than the
    kernel's STAGE_CHUNK."""
    rng = np.random.default_rng(W)
    st = rng.gamma(1.0, 1.0, (9, B, B)).astype(np.float32)
    st[rng.random(st.shape) < 0.1] = np.nan
    st[rng.random(st.shape) < 0.01] = np.inf
    st[0] = np.nan
    full = [1, 2, 3, 4]
    k, counts = {
        "missing tiles": ([[5, 0, 6, 0], [0, 0, 7, 8], [0, 0, 0, 0],
                           [0, 8, 0, 0], full], [20, 20, 5, 20, 10]),
        "offsets 127": ([full, [5, 6, 7, 8]], [30, 30]),
        "multi-group items": ([full, [5, 6, 7, 8], full], [60, 45, 3]),
        "item longer than the chunk": ([full],
                                       [2 * qg.STAGE_CHUNK + 77]),
    }[case]
    counts = np.asarray(counts, np.int32)
    n = int(counts.sum())
    o1, o2 = rng.integers(0, 128, (2, n))
    if case == "offsets 127":
        o1[::3], o2[1::3] = 127, 127
        o1[2::5] = o2[2::5] = 127
    else:
        o1[::97], o2[::89] = 127, 127
    g = np.concatenate([np.sort(rng.integers(0, C, c)) for c in counts])
    return (torch.from_numpy(st), torch.from_numpy(np.asarray(k, np.int32)),
            torch.from_numpy((np.cumsum(counts) - counts).astype(np.int32)),
            torch.from_numpy(counts),
            torch.from_numpy(qg.pack_snips(o1, o2, g)), W, C)


@pytest.mark.parametrize("case", BANDED_CASES)
@pytest.mark.parametrize("W", [111, 115, 120])
def test_banded_plain_reproduces_plain_bit_for_bit(W, case):
    """The two-band layout of W = 111..120 is only another addressing of
    the same floats: the plain banded accumulate (each band's staged rows,
    then each band's pixels at corner offset + pixel offset) gives
    ``quad_accumulate_plain``'s float64 sums and counts bit for bit."""
    args = _banded_case(case, W)
    assert qg.corner_layout(W).bands == 2
    want = qg.quad_accumulate_plain(*args)
    got = qg.quad_accumulate_banded_plain(*args)
    assert torch.equal(got[1], want[1]) and int(want[1].sum()) > 0
    assert torch.equal(got[0], want[0])  # +inf compares equal, no NaN in sums
    assert not torch.isnan(want[0]).any() and torch.isinf(want[0]).any()
    if case == "multi-group items":
        snips, qstart, qcount = args[4], args[2], args[3]
        assert len(torch.unique(snips[:int(qcount[0])] & 0x1FFFF)) > 3
    if case == "item longer than the chunk":
        assert int(args[3][0]) > qg.STAGE_CHUNK


def _pallas_inputs(W, seed=0):
    rng = np.random.default_rng(seed)
    n, S = 300, 400
    dense = rng.gamma(1.0, 1.0, (n, n)) * (rng.random((n, n)) < 0.3)
    dense = np.triu(dense) + np.triu(dense, 1).T
    r1 = rng.integers(0, n - W, S).astype(np.int32)
    r2 = rng.integers(0, n - W, S).astype(np.int32)
    cid = rng.integers(0, 6, S).astype(np.int32)
    valid = (rng.random(n) > 0.1).astype(np.float32)
    evec = (10.0 / (1.0 + np.arange(n))).astype(np.float32)
    evec[rng.integers(0, n, 5)] = 0.0  # poison
    ts = ref_tiles.build_tile_stack(sp.coo_matrix(dense), B, r1=r1, r2=r2,
                                    window1=W, window2=W)
    return ts, r1, r2, (r1 - r2).astype(np.int32), cid, valid, evec


@pytest.mark.parametrize("staged", [True])
def test_run_quad_pileup_matches_pallas_with_either_split(staged, monkeypatch):
    """The same inputs through the Pallas kernel (interpret mode) and the
    port at W = 11, with the items cut for the staged kernel as the session
    cuts them (``split_items``). Counts and poison are exact. ``sum``: rtol
    1e-5 / atol 1e-5, the tolerance of the reference's own Pallas-vs-XLA
    check: the reference accumulates in float32 in quad order, the plain
    version in float64."""
    assert staged
    W = 11
    splits = []
    fn = qg.split_items
    monkeypatch.setattr(qg, "split_items", lambda *a, **k: (
        splits.append("split_items"), fn(*a, **k))[1])
    ts, r1, r2, dd0, cid, valid, evec = _pallas_inputs(W)
    kw = dict(W=W, capacity=8, cis=True, ignore_diags=2, ooe=True)
    want = ref.run_pallas_pileup(ts, r1, r2, dd0, cid, valid, valid, evec,
                                 dict(kw, interpret=True))
    got = qg.run_quad_pileup(from_reference(ts), r1, r2, dd0, cid, valid,
                             valid, evec, kw, device="cpu")
    assert splits == ["split_items"]
    np.testing.assert_array_equal(got["poison"], want["poison"])
    np.testing.assert_array_equal(got["num"], want["num"])
    pois = want["poison"] > 0
    assert pois.any() and np.all(np.isinf(got["sum"][pois]))
    np.testing.assert_allclose(got["sum"][~pois], want["sum"][~pois],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("W", [115, 120])
def test_run_quad_pileup_matches_pallas_in_two_bands(W):
    """At W = 115 and 120, where the card's staged kernel runs two bands an
    item, ``run_quad_pileup`` (the session's ``split_items`` items, the
    plain version on the CPU) against the Pallas kernel in interpret mode,
    with the tolerances of the W = 11 check above."""
    assert qg.corner_layout(W).bands == 2
    ts, r1, r2, dd0, cid, valid, evec = _pallas_inputs(W, seed=W)
    kw = dict(W=W, capacity=8, cis=True, ignore_diags=2, ooe=True)
    want = ref.run_pallas_pileup(ts, r1, r2, dd0, cid, valid, valid, evec,
                                 dict(kw, interpret=True))
    got = qg.run_quad_pileup(from_reference(ts), r1, r2, dd0, cid, valid,
                             valid, evec, kw, device="cpu")
    np.testing.assert_array_equal(got["poison"], want["poison"])
    np.testing.assert_array_equal(got["num"], want["num"])
    pois = want["poison"] > 0
    assert pois.any() and np.all(np.isinf(got["sum"][pois]))
    assert got["num"].sum() > 0
    np.testing.assert_allclose(got["sum"][~pois], want["sum"][~pois],
                               rtol=1e-5, atol=1e-5)


def test_plain_version_takes_either_item_shape():
    """On the CPU ``quad_accumulate`` gives the same accumulators for long
    multi-group items as for items of at most 3 snips: float64 sums of the
    same float32 values in another order (rtol 1e-12), counts equal."""
    W, C = 11, 40
    snips, k, qstart, qcount = _sorted_quads(5, W=W, C=C)
    rng = np.random.default_rng(5)
    stiles = torch.from_numpy(
        rng.gamma(1.0, 1.0, (int(k.max()) + 1, B, B)).astype(np.float32))
    sn = torch.from_numpy(snips)
    outs = []
    for items in (qg.split_items(k, qstart, qcount, item_max=50),
                  qg.split_items(k, qstart, qcount, item_max=3)):
        t = [torch.from_numpy(np.ascontiguousarray(a)) for a in items]
        outs.append(qg.quad_accumulate(stiles, *t, sn, W, C))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-12, atol=1e-9)
    assert torch.equal(outs[0][1], outs[1][1]) and int(outs[0][1].sum()) > 0


def test_launchers_raise_off_the_card():
    """The staged launcher takes CUDA tensors only, and only a W the
    reference's kernel takes (1..120): no quiet switch to another
    version."""
    W, C = 11, 40
    snips, k, qstart, qcount = _sorted_quads(6, W=W, C=C)
    stiles = torch.zeros((int(k.max()) + 1, B, B))
    t = [torch.from_numpy(a) for a in (k, qstart, qcount, snips)]
    before = qg.LAUNCHES
    with pytest.raises(ValueError, match="no kernel for cpu"):
        qg.quad_accumulate_staged(stiles, *t, W, C)
    with pytest.raises(ValueError, match=r"W=121 outside \[1, 120\]"):
        qg.quad_accumulate_staged(stiles, *t, qg.W_MAX + 1, C)
    assert qg.LAUNCHES == before


def test_entry_points_default_to_the_card(monkeypatch):
    """``run_quad_pileup`` and ``normalize_tile_stack_device`` run on the
    card unless asked for the CPU: without a card the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    W = 11
    ts, r1, r2, dd0, cid, valid, evec = _pallas_inputs(W, seed=1)
    ts = from_reference(ts)
    kw = dict(W=W, capacity=8, cis=True, ignore_diags=2, ooe=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qg.run_quad_pileup(ts, r1, r2, dd0, cid, valid, valid, evec, kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_tiles.normalize_tile_stack_device(ts, valid, valid, evec=evec,
                                               ooe=True)
    got = qg.run_quad_pileup(ts, r1, r2, dd0, cid, valid, valid, evec, kw,
                             device="cpu")
    st = port_tiles.normalize_tile_stack_device(ts, valid, valid, evec=evec,
                                                ooe=True, device="cpu")
    assert st.device.type == "cpu" and got["num"].sum() > 0
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
