"""The port's whole loop-APA slice against the JAX package's, on the CPU:
a SymTileStack with flips (cid = gid + half*flip) through the session,
finalize and merge_flip_banks; the same slice, the engine's pileup()
(cis by strand, and trans), the coolpup CLI's pileup_from_args, the public
surface but ``plotpup`` and the reader's fetch code on an in-memory cooler
in a process where jax, coolpuppy_tpu, h5py and matplotlib cannot be
imported (as on the card's machine); and a source scan for such imports."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy import sparse as sp

# the JAX package, which this module compares against, imports h5py; the
# card's machine has none, and there the module skips
pytest.importorskip("h5py")

from coolpuppy_tpu.ops.gather import merge_flip_banks as ref_merge
from coolpuppy_tpu.ops.pallas_gather import PallasPileupSession
from coolpuppy_tpu.ops.tiles import build_tile_stack_sym as ref_build_sym
from coolpuppy_tpu_torch import (
    QuadPileupSession,
    build_tile_stack_sym,
    from_reference,
    merge_flip_banks,
)
from torch_cases import host_oracle

REPO = Path(__file__).resolve().parent.parent
B = 128


def _slice_inputs(seed=9, n=900, W=21, S=3000):
    rng = np.random.default_rng(seed)
    dense = rng.gamma(1.0, 1.0, (n, n)) * (rng.random((n, n)) < 0.2)
    dense = np.triu(dense) + np.triu(dense, 1).T
    coo = sp.coo_matrix(dense)
    valid = (rng.random(n) > 0.05).astype(np.float32)
    evec = (4.0 / (1.0 + np.arange(n))).astype(np.float32)
    r1 = rng.integers(0, n - W, S).astype(np.int32)
    r2 = np.minimum(r1 + rng.integers(0, 200, S), n - W - 1).astype(np.int32)
    gid = rng.integers(0, 4, S).astype(np.int32)
    flip = rng.random(S) < 0.25
    return coo, valid, evec, r1, r2, gid, flip


def test_slice_matches_reference_session():
    W, half = 21, 4
    C = 2 * half + 8
    coo, valid, evec, r1, r2, gid, flip = _slice_inputs(W=W)
    cid = (gid + half * flip).astype(np.int32)
    cfg_kw = dict(W=W, capacity=C, cis=True, ignore_diags=2, ooe=True)

    sym_ref = ref_build_sym(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    ref_sess = PallasPileupSession(sym_ref, valid, valid, evec,
                                   dict(cfg_kw, interpret=True))
    want = ref_merge(ref_sess.run_many(r1, r2, cid), half)
    # one stack for both packages, and the port's own build of it
    for sym in (from_reference(sym_ref),
                build_tile_stack_sym(coo, B, r1=r1, r2=r2, window1=W,
                                     window2=W)):
        sess = QuadPileupSession(sym, valid, valid, evec, cfg_kw, "cpu")
        total = sess.finalize([sess.run_many(r1, r2, cid, fetch=False)])
        got = merge_flip_banks(total, half)
        for k in ("sum", "num", "poison"):
            assert got[k].shape == (half, W, W) and got[k].dtype == np.float64
        np.testing.assert_array_equal(got["num"], want["num"])
        np.testing.assert_array_equal(got["poison"], want["poison"])
        np.testing.assert_allclose(got["sum"], want["sum"], rtol=1e-5, atol=0)
        assert got["num"].sum() > 0
        # compact keeps the unflipped and flip banks only
        small = sess.finalize([sess.run_many(r1, r2, cid, fetch=False)],
                              compact=(half, half))
        np.testing.assert_array_equal(small["num"], total["num"][: 2 * half])


def test_slice_matches_host_oracle():
    """The session against ``torch_cases.host_oracle`` (numpy normalize,
    window cuts, nansum), as tests/test_torch_cells.py checks it at the
    headline size on the card."""
    W, C = 21, 8
    coo, valid, evec, r1, r2, gid, flip = _slice_inputs(seed=4, W=W, S=1200)
    cid = (gid + 4 * flip).astype(np.int32)
    sym = build_tile_stack_sym(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    sess = QuadPileupSession(sym, valid, valid, evec,
                             dict(W=W, capacity=C, ooe=True), "cpu")
    got = sess.run_many(r1, r2, cid)
    stiles, want_s, want_m = host_oracle(sym, r1, r2, cid, valid, evec, W, C)
    np.testing.assert_array_equal(np.isnan(sess.stiles.numpy()),
                                  np.isnan(stiles))
    np.testing.assert_array_equal(got["num"], want_m)
    np.testing.assert_allclose(got["sum"], want_s, rtol=1e-5, atol=0)


_NO_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["coolpuppy_tpu"] = None
sys.modules["h5py"] = None
sys.modules["matplotlib"] = None
import numpy as np
from scipy import sparse as sp
import coolpuppy_tpu_torch as P

rng = np.random.default_rng(0)
n, W, S, half = 400, 21, 500, 4
dense = rng.gamma(1.0, 1.0, (n, n)) * (rng.random((n, n)) < 0.2)
coo = sp.coo_matrix(np.triu(dense) + np.triu(dense, 1).T)
r1 = rng.integers(0, n - W, S).astype(np.int32)
r2 = rng.integers(0, n - W, S).astype(np.int32)
cid = (rng.integers(0, 4, S) + half * (rng.random(S) < 0.25)).astype(np.int32)
valid = np.ones(n, np.float32)
evec = (4.0 / (1.0 + np.arange(n))).astype(np.float32)
sym = P.build_tile_stack_sym(coo, 128, r1=r1, r2=r2, window1=W, window2=W)
sess = P.QuadPileupSession(sym, valid, valid, evec,
                           dict(W=W, capacity=16, ooe=True), device="cpu")
out = P.merge_flip_banks(sess.run_many(r1, r2, cid), half)
assert out["num"].sum() > 0 and np.isfinite(out["sum"]).all()

# the engine on an in-memory cooler (tests/torch_cases.py's toy map)
sys.path.insert(0, "tests")
from torch_cases import toy_cooler, toy_features, toy_regions
clr = toy_cooler()[0]
pup = P.pileup(clr, toy_features(), view_df=toy_regions(), mindist=0,
               flank=2_000_000, nshifts=1, seed=0, by_strand=True,
               device="cpu")
assert list(pup.sort_values("orientation")["n"]) == [1, 3, 1, 1, 6]
assert pup["accumulate"].iloc[0] == "plain"
# the same run on a loci mesh of two CPU devices
from coolpuppy_tpu_torch.parallel import LociMesh
mp = P.pileup(clr, toy_features(), view_df=toy_regions(), mindist=0,
              flank=2_000_000, nshifts=1, seed=0, by_strand=True,
              device="cpu", mesh=LociMesh(["cpu"] * 2))
assert list(mp.sort_values("orientation")["n"]) == [1, 3, 1, 1, 6]
# and one trans pileup: 3 x 3 features across the two chromosomes
tp = P.pileup(clr, toy_features(), view_df=toy_regions(), flank=2_000_000,
              trans=True, nshifts=1, seed=0, device="cpu")
assert tp[["n", "control_n"]].iloc[0].tolist() == [9, 9]
assert np.isfinite(tp["data"].iloc[0]).any()
# and the extension hooks: a batch hook and the domain-score snip hook
from torch_cases import hook_mode_table, toy_cooler as _toy
_clr, _dense, _weights = _toy()
bh = hook_mode_table("batch_hook", _clr, _dense, _weights, "cpu")
assert bh["accumulate"].iloc[0] == "batch_hook" and len(bh["center"].iloc[0]) == 6
ds = hook_mode_table("snip_domain_score", _clr, _dense, _weights, "cpu")
assert ds["accumulate"].iloc[0] == "host_stream"
assert all(np.isfinite(ds["domain_score"].iloc[0]))
# the file formats and the two CLIs that need no plotting import, and
# coolpup's pileup from BED, view and expected files runs on the toy map
import os, tempfile
import coolpuppy_tpu_torch.io
import coolpuppy_tpu_torch.cli.dividepups_cli
from coolpuppy_tpu_torch.cli.coolpup_cli import (parse_args_coolpuppy,
                                                 pileup_from_args)
from torch_cases import cli_argv, write_cli_inputs
with tempfile.TemporaryDirectory() as d:
    paths = write_cli_inputs(d, _clr, _dense, _weights)
    _clr.filename = paths["cool"]
    for name, n in (("by_strand", [3, 1, 1, 6, 1]), ("expected_column", [6])):
        args = parse_args_coolpuppy().parse_args(cli_argv(name, paths)
                                                 + ["--device", "cpu"])
        cp, outname = pileup_from_args(args, _clr)
        assert list(cp["n"]) == n, (name, list(cp["n"]))
        assert outname.startswith("toy.cool-1000.0K_over_features_")
        assert cp["features"].iloc[0] == paths["bed"]
        assert np.isfinite(cp["data"].iloc[-1]).any()
# the public surface but plotpup (which imports matplotlib), and the
# reader's fetch code over a store of arrays
import coolpuppy_tpu_torch.coolpup as alias
import coolpuppy_tpu_torch.genomics
import coolpuppy_tpu_torch.lib.io
import coolpuppy_tpu_torch.lib.util
from coolpuppy_tpu_torch.io.cool import Cooler, parse_cooler_uri
assert alias.pileup is P.pileup and P.write_cool and P.assign_groups
assert parse_cooler_uri("x.mcool::resolutions/10") == ("x.mcool",
                                                       "/resolutions/10")
again = Cooler(_clr.store)
assert again.n_pixels == _clr.n_pixels and again.extent("chr2") == (198, 380)
slab = again.fetch_slab("chr2")
assert slab.mirror and len(slab.rows) > 0
assert again.matrix(balance=False).fetch("chr1", "chr2").shape == (198, 182)
blocked = ("jax", "coolpuppy_tpu", "h5py", "matplotlib")
loaded = sorted(m for m, v in sys.modules.items()
                if v is not None and m.split(".")[0] in blocked)
assert not loaded, loaded
print("slice ok", int(out["num"].sum()))
"""


def test_slice_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "slice ok" in res.stdout


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top_level_imports(path):
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_and_no_reference():
    """No jax and no coolpuppy_tpu anywhere in the port; h5py (absent on
    the card's machine) only inside functions; matplotlib (absent there
    too) only in plotting.py and cli/plotpup_cli.py."""
    files = sorted((REPO / "coolpuppy_tpu_torch").rglob("*.py"))
    files.append(REPO / "tests" / "torch_cases.py")
    assert len(files) >= 30
    plotters = {REPO / "coolpuppy_tpu_torch" / "plotting.py",
                REPO / "coolpuppy_tpu_torch" / "cli" / "plotpup_cli.py"}
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top != "jax", f"{f} imports {mod}"
            assert top != "coolpuppy_tpu", f"{f} imports {mod}"
            if f not in plotters:
                assert top != "matplotlib", f"{f} imports {mod}"
        for mod in _top_level_imports(f):
            assert mod.split(".")[0] != "h5py", f"{f} imports {mod} at top"
