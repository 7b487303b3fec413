"""A two-process run of the port's ``pileup()`` (the twin of
tests/test_multihost.py): two gloo ranks on the CPU, each with a loci mesh
of its own, take their round-robin share of region pairs
(``parallel.distributed.local_region_pairs``) and exchange the per-region
outputs (``allreduce_region_maps``) before the reduce. Rank 0's table is
held against the JAX package's single-process table: group keys and ``n``
exact, ``data`` rtol 1e-5.

This file is also the worker: ``python tests/test_torch_multihost.py RANK
PORT COOL OUT MODE`` runs one rank. Every process group has a timeout and
every rank a kill on timeout, so a hung rank fails the test instead of
holding the run.
"""

import datetime
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RANK_SECONDS = 240

# per mode: the pileup() keywords (besides the toy view); by_strand splits
# the toy view's two regions one a rank, trans leaves rank 1 no pair
MODES = {
    "by_strand": dict(flank=3_000_000, mindist=0, nshifts=1, seed=0,
                      by_strand=True),
    "trans": dict(flank=2_000_000, nshifts=1, seed=0, trans=True),
}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _table_arrays(table):
    rows = table.reset_index(drop=True)
    key = "orientation" if "orientation" in rows else "group"
    return dict(groups=np.asarray([str(g) for g in rows[key]]),
                n=rows["n"].to_numpy(),
                data=np.stack([np.asarray(d, float) for d in rows["data"]]))


def worker(rank, port, cool_path, out_path, mode):
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import coolpuppy_tpu_torch as P
    from coolpuppy_tpu_torch.parallel import (
        LociMesh,
        distributed,
        init_distributed,
    )
    from fixtures import toy_features, toy_regions

    got = init_distributed(init_method=f"tcp://localhost:{port}",
                           world_size=2, rank=rank,
                           timeout=datetime.timedelta(seconds=120))
    assert got == (rank, 2), got
    clr = P.Cooler(cool_path)
    cc_kw = dict(MODES[mode])
    by_strand = cc_kw.pop("by_strand", False)
    nshifts = cc_kw.pop("nshifts")
    cc = P.CoordCreator(toy_features(), clr.binsize, features_format="bed",
                        nshifts=nshifts, **cc_kw)
    pu = P.PileUpper(clr, cc, view_df=toy_regions(), control=nshifts > 0,
                     device="cpu", mesh=LociMesh(["cpu"]))
    mine = distributed.local_region_pairs(pu._region_pairs())
    print(f"rank {rank} region pairs {mine}", flush=True)
    table = (pu.pileupsByStrandWithControl() if by_strand
             else pu.pileupsWithControl())
    if rank == 0:
        np.savez(out_path, **_table_arrays(table))


def _reference_table(cool_path, mode):
    import coolpuppy_tpu as ref
    from fixtures import toy_features, toy_regions

    kw = dict(MODES[mode])
    return ref.pileup(ref.Cooler(cool_path), toy_features(),
                      features_format="bed", view_df=toy_regions(), **kw)


@pytest.mark.parametrize("mode", list(MODES))
def test_two_ranks_equal_one_process(tmp_path, mode):
    from fixtures import make_toy_cooler

    cool_path = str(tmp_path / "mh.cool")
    make_toy_cooler(cool_path, seed=7)
    out_path = str(tmp_path / "rank0.npz")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(port),
             cool_path, out_path, mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_SECONDS)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    pairs = [next(ln for ln in out.splitlines() if "region pairs" in ln)
             for out in outs]
    if mode == "by_strand":
        assert pairs == ["rank 0 region pairs [('foo', 'foo')]",
                         "rank 1 region pairs [('bar', 'bar')]"]
    else:
        assert pairs == ["rank 0 region pairs [('foo', 'bar')]",
                         "rank 1 region pairs []"]

    got = np.load(out_path)
    want = _table_arrays(_reference_table(cool_path, mode))
    assert list(got["groups"]) == list(want["groups"])
    np.testing.assert_array_equal(got["n"], want["n"])
    np.testing.assert_allclose(got["data"], want["data"], rtol=1e-5,
                               atol=1e-8, equal_nan=True)


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4],
           sys.argv[5])
