"""A two-process run of the port's ``pileup()`` (the twin of
tests/test_multihost.py): two gloo ranks on the CPU, each with a loci mesh
of its own, take their round-robin share of region pairs
(``parallel.distributed.local_region_pairs``) and exchange the per-region
outputs (``allreduce_region_maps``) before the reduce. Rank 0's table is
held against the JAX package's single-process table: group keys and ``n``
exact, ``data`` rtol 1e-5. Then the genome cell on two ranks, on the CPU
and on the card, against the port's own one-process run.

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

import torch_cases as cases

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


@pytest.mark.parametrize("device", cases.DEVICES)
def test_two_ranks_genome_cell(tmp_path, device):
    """The genome cell (``genome_workload``; card: 4 chromosomes of 13,500
    bins and 7,400 sites, ``RANK_WORKLOAD``; CPU: 2 chromosomes of 1,200
    bins and 240 sites) on two gloo ranks on the device, each a process
    that builds the map from seed 0 (hashes equal across ranks) and runs
    its share of region pairs on a loci mesh of its own
    (``torch_cases.rank_main``); rank 0's table against this process's
    one-process run: group keys, ``n`` and ``control_n`` exact, ``data``
    rtol 1e-5."""
    dev = cases.device(device)
    workload = (dict(cases.RANK_WORKLOAD) if dev.type == "cuda" else
                dict(n_chroms=2, bins_per=1_200, contacts_per=50_000,
                     n_sites=240))
    out_path = str(tmp_path / "rank0.npz")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, HERE]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = [
        subprocess.Popen(
            [sys.executable, "-c",
             f"import torch_cases; torch_cases.rank_main({rank}, {port}, "
             f"{out_path!r}, {dev.type!r}, {workload!r})"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for rank in range(2)
    ]
    try:
        clr, feats = cases.genome_workload(**workload)
        want = cases.genome_run(clr, feats, dev)[1]
        outs = [p.communicate(timeout=cases.RANK_SECONDS)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        mine = [ln for ln in out.splitlines() if ln.startswith("rank ")]
        assert len(mine) == 1, out[-3000:]
        lines.append(mine[0])
    if dev.type == "cpu":
        assert "region pairs [('chr1', 'chr1')] (1)" in lines[0]
        assert "region pairs [('chr2', 'chr2')] (1)" in lines[1]
    got = np.load(out_path)
    assert list(got["groups"]) == [str(g) for g in want["group"]]
    for col in ("n", "control_n"):
        np.testing.assert_array_equal(got[col], want[col].to_numpy(float),
                                      err_msg=col)
    data = np.stack([np.asarray(d, float) for d in want["data"]])
    np.testing.assert_allclose(got["data"], data, rtol=cases.RANK_RTOL,
                               atol=1e-8, equal_nan=True)


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4],
           sys.argv[5])
