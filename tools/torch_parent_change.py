"""Time two trees of the PyTorch port in turns on one card: the engine
cell's keywords (``chip_smoke.ENGINE_KW``) over ``bench.py --modes``' sites
on the engine map, and the ``--modes`` trans cell.

    python tools/torch_parent_change.py PARENT_TREE CHANGE_TREE [REPEATS]

Each tree is a checkout (e.g. unpacked with ``git archive``). The turns run
parent, change, change, parent, each in a fresh process started in its
tree, which times a warm-up and REPEATS runs (default 3) of each cell and
prints one JSON line; the maps are made once, with bench's RNG calls, and
kept in a cache file beside this script's first tree, so every turn reads
the same pixels. Prints the card's name and power limit, every turn's walls
and phases, and per cell and side the median of all its runs.
"""

import json
import os
import statistics
import subprocess
import sys
import time


def worker(cache, repeats):
    """One turn, run from a tree's root: prints one JSON line."""
    import numpy as np
    import pandas as pd
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from coolpuppy_tpu_torch import Cooler, CoordCreator, PileUpper

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    if not os.path.exists(cache):
        clr, feats, _, clr2, tfeats = cs.modes_workload()
        np.savez(cache, e1=clr._bin1, e2=clr._bin2, ec=clr._count,
                 ew=clr.bins_df()["weight"].to_numpy(), t1=clr2._bin1,
                 t2=clr2._bin2, tc=clr2._count,
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
    out = {"load_s": time.perf_counter() - t0}

    def engine_run(f):
        kw = dict(cs.ENGINE_KW)
        del kw["by_strand"]
        nshifts = kw.pop("nshifts")
        cc = CoordCreator(f, eclr.binsize, nshifts=nshifts, **kw)
        pu = PileUpper(eclr, cc, control=nshifts > 0, device=dev)
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
        ("trans", trans_run, small, tfeats),
    ):
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


def main(parent, change, repeats=3):
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
             str(repeats)], cwd=trees[side], capture_output=True, text=True)
        if p.returncode != 0:
            print(p.stdout[-3000:], p.stderr[-6000:])
            return 1
        r = json.loads(p.stdout.strip().splitlines()[-1])
        res[side].append(r)
        print(side, json.dumps(r), flush=True)
    for cell in ("engine", "trans"):
        for side in ("parent", "change"):
            walls = [w for r in res[side] for w in r[cell]["walls"]]
            print(f"{cell} {side}: walls {[round(w, 4) for w in walls]}, "
                  f"median {statistics.median(walls):.4f} s, snips "
                  f"{res[side][0][cell]['snips']}")
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--worker":
        worker(sys.argv[2], int(sys.argv[3]))
    else:
        sys.exit(main(sys.argv[1], sys.argv[2],
                      *(int(a) for a in sys.argv[3:4])))
