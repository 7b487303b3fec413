"""Time two trees of the PyTorch port in turns on one card: the engine
cell's keywords (``chip_smoke.ENGINE_KW``) over ``bench.py --modes``' sites
on the engine map, the W = 119 cell's keywords (``chip_smoke.W119_CELL_KW``,
``w119``) over the same sites, the ``--modes`` trans cell, and the staged
quad kernel alone over the slice's map (``sweep``).

    python tools/torch_parent_change.py PARENT_TREE CHANGE_TREE [REPEATS]
        [CELLS]

Each tree is a checkout (e.g. unpacked with ``git archive``). The turns run
parent, change, change, parent, each in a fresh process started in its
tree, which times a warm-up and REPEATS runs (default 3) of each cell of
CELLS (default ``engine,trans``; ``sweep`` adds or, alone, replaces them)
and prints one JSON line; the maps are made once, with bench's RNG calls,
and kept in a cache file beside this script's first tree, so every turn
reads the same pixels. The sweep stages the first ``chip_smoke.SWEEP_LOCI``
loci of ``bench.make_workload``'s map at each W of SWEEP_W, and all 1M at
W = 21, then times the staged kernel's launcher on them 4 * REPEATS times
(``chip_smoke.kernel_and_call_ms``: the kernel between CUDA events around
its launch). Prints the card's name and power limit, every turn's walls,
phases and kernel times, and per cell and side the median of all its runs.
"""

import json
import os
import statistics
import subprocess
import sys
import time

# the staged kernel's widths in the sweep cell: one band up to 110 (the
# kernel as it was before bands), and the two-band widths of a tree that has
# them
SWEEP_W = (11, 21, 33, 65, 110)
SWEEP_FULL_W = 21  # also timed over every locus of the slice


def sweep(cache, repeats, dev):
    """The sweep cell: ``{"W=..": {"snips", "items", "kernel_ms": [..]}}``
    of the staged kernel at each width on the slice's map."""
    import numpy as np
    import torch
    from scipy import sparse

    import chip_smoke as cs
    from coolpuppy_tpu_torch.ops import quad_gather as qg
    from coolpuppy_tpu_torch.ops.tiles import build_tile_stack_sym

    if not os.path.exists(cache):
        from bench import make_workload

        _, coo, r1, r2, gid, flip, valid, evec = make_workload()
        np.savez(cache, row=coo.row, col=coo.col, data=coo.data,
                 n=coo.shape[0], r1=r1, r2=r2, gid=gid, flip=flip,
                 valid=valid, evec=evec)
    z = np.load(cache)
    n = int(z["n"])
    coo = sparse.coo_matrix((z["data"], (z["row"], z["col"])), shape=(n, n))
    r1, r2, gid, flip, valid, evec = (
        z[k] for k in ("r1", "r2", "gid", "flip", "valid", "evec"))
    half = 4
    C = 2 * half + 8
    cid_all = (gid + half * flip).astype(np.int32)
    out = {}
    for W, loci in ((SWEEP_FULL_W, len(r1)),
                    *((W, cs.SWEEP_LOCI) for W in SWEEP_W)):
        a = np.minimum(r1[:loci], n - W - 1)
        b = np.minimum(r2[:loci], n - W - 1)
        ts = build_tile_stack_sym(coo, cs.B, r1=a, r2=b, window1=W,
                                  window2=W)
        sess = qg.QuadPileupSession(
            ts, valid, valid, evec,
            dict(W=W, capacity=C, cis=True, ignore_diags=2, ooe=True), dev)
        args = (sess.stiles, *sess.stage(a, b, cid_all[:loci]), W, C)
        qg.quad_accumulate_staged(*args)  # warm-up
        ms = [cs.kernel_and_call_ms(lambda: qg.quad_accumulate_staged(*args),
                                    torch.cuda.synchronize)[0]
              for _ in range(4 * repeats)]
        out[f"W={W} loci={loci}"] = dict(snips=len(a),
                                         items=int(args[1].shape[0]),
                                         kernel_ms=ms)
        del sess, args
    return out


def worker(cache, repeats, cells):
    """One turn, run from a tree's root: prints one JSON line."""
    import numpy as np
    import pandas as pd
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from coolpuppy_tpu_torch import Cooler, CoordCreator, PileUpper

    dev = torch.device("cuda", 0)
    out = {}
    if "sweep" in cells:
        out["sweep"] = sweep(cache + ".slice.npz", repeats, dev)
        if cells == ["sweep"]:
            print(json.dumps(out))
            return
    t0 = time.perf_counter()
    if not os.path.exists(cache):
        clr, feats, _, clr2, tfeats = cs.modes_workload()
        # every tree's Cooler reads its pixels through pixels_chunk; the
        # counts are integers
        e1, e2, ec = clr.pixels_chunk(0, clr.n_pixels)
        t1, t2, tc = clr2.pixels_chunk(0, clr2.n_pixels)
        np.savez(cache, e1=e1, e2=e2, ec=ec.astype(np.int64),
                 ew=clr.bins_df()["weight"].to_numpy(), t1=t1, t2=t2,
                 tc=tc.astype(np.int64),
                 tw=clr2.bins_df()["weight"].to_numpy())
        feats.to_pickle(cache + ".feats.pkl")
        tfeats.to_pickle(cache + ".tfeats.pkl")
    z = np.load(cache)
    eclr = Cooler.from_arrays({"chr1": 20_000 * 10_000}, 10_000,
                              (z["e1"], z["e2"], z["ec"]), weights=z["ew"])
    tclr = Cooler.from_arrays(
        {"chr1": 10_000 * 10_000, "chr2": 8_000 * 10_000}, 10_000,
        (z["t1"], z["t2"], z["tc"]), weights=z["tw"])
    feats = pd.read_pickle(cache + ".feats.pkl")
    tfeats = pd.read_pickle(cache + ".tfeats.pkl")
    out["load_s"] = time.perf_counter() - t0

    def engine_run(f):
        kw = dict(cs.ENGINE_KW)
        del kw["by_strand"]
        nshifts = kw.pop("nshifts")
        cc = CoordCreator(f, eclr.binsize, nshifts=nshifts, **kw)
        pu = PileUpper(eclr, cc, control=nshifts > 0, device=dev)
        return pu, pu.pileupsByStrandWithControl()

    def w119_run(f):
        kw = {k: v for k, v in cs.W119_CELL_KW.items()
              if k not in ("by_strand", "nshifts")}
        cc = CoordCreator(f, eclr.binsize,
                          nshifts=cs.W119_CELL_KW["nshifts"], **kw)
        pu = PileUpper(eclr, cc, control=True, device=dev)
        return pu, pu.pileupsByStrandWithControl()

    def trans_run(f):
        cc = CoordCreator(f, tclr.binsize, nshifts=0,
                          **cs.MODES_CELLS["trans"])
        pu = PileUpper(tclr, cc, device=dev)
        return pu, pu.pileupsWithControl()

    n_t = len(tfeats) // 2
    small = tfeats.iloc[list(range(200)) + list(range(n_t, n_t + 200))]
    for cell, run, warm, full in (
        ("engine", engine_run, feats.iloc[:1_000], feats),
        ("w119", w119_run, feats.iloc[:1_000], feats),
        ("trans", trans_run, small, tfeats),
    ):
        if cell not in cells:
            continue
        run(warm)
        walls, phases = [], []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pu, pups = run(full)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            phases.append({k: round(v, 4)
                           for k, v in pu.timers.seconds.items()})
        row = pups.iloc[-1]
        snips = int(row["n"]) + int(row.get("control_n", 0) or 0)
        out[cell] = dict(walls=walls, phases=phases, snips=snips)
    print(json.dumps(out))


def main(parent, change, repeats=3, cells="engine,trans"):
    cache = os.path.join(os.path.abspath(parent), "parent_change_cells.npz")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip(), flush=True)
    trees = {"parent": parent, "change": change}
    res = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent"):
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", cache,
             str(repeats), cells], cwd=trees[side], capture_output=True,
            text=True)
        if p.returncode != 0:
            print(p.stdout[-3000:], p.stderr[-6000:])
            return 1
        r = json.loads(p.stdout.strip().splitlines()[-1])
        res[side].append(r)
        print(side, json.dumps(r), flush=True)
    for cell in ("engine", "w119", "trans"):
        if cell not in cells.split(","):
            continue
        for side in ("parent", "change"):
            walls = [w for r in res[side] for w in r[cell]["walls"]]
            print(f"{cell} {side}: walls {[round(w, 4) for w in walls]}, "
                  f"median {statistics.median(walls):.4f} s, snips "
                  f"{res[side][0][cell]['snips']}")
    if "sweep" in cells.split(","):
        for shape in res["parent"][0]["sweep"]:
            for side in ("parent", "change"):
                ms = [x for r in res[side] for x in
                      r["sweep"][shape]["kernel_ms"]]
                print(f"sweep {shape} {side}: staged kernel ms "
                      f"{[round(x, 4) for x in ms]}, median "
                      f"{statistics.median(ms):.4f}, items "
                      f"{res[side][0]['sweep'][shape]['items']}")
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--worker":
        worker(sys.argv[2], int(sys.argv[3]), sys.argv[4].split(","))
    else:
        sys.exit(main(sys.argv[1], sys.argv[2],
                      *(int(a) for a in sys.argv[3:4]), *sys.argv[4:5]))
