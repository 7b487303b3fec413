"""The port's loci mesh across the cards of one host: the dry run over
``cuda:0..3`` (``parallel/dryrun.py``), the current device before and
after it, then ``bench.py:866``'s genome cell (``chip_smoke.genome_workload``)
on one card with its stream, and, twice each, on ``LociMesh`` es of the
first card, the first two, all of them, and the first card four times,
each held against the one-card table (counts exact, ``data`` rtol 1e-4)
with its wall, phases and what the mesh did.

    python tools/torch_mesh_cards.py        # from the root of a checkout

Needs four CUDA devices for the dry run's distinct cards (fewer repeat
them).
"""

import os
import sys

import torch


def main():
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c
    from coolpuppy_tpu_torch.parallel import LociMesh
    from coolpuppy_tpu_torch.parallel.dryrun import dryrun_multichip

    card = c.smi_line()
    print(card, torch.cuda.device_count())
    before = torch.cuda.current_device()
    dryrun_multichip(4, "cuda")
    print("current device before", before, "after",
          torch.cuda.current_device())

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    dev = torch.device("cuda", 0)
    t, (clr, feats) = c.timed(c.genome_workload, lambda: None)
    print(f"genome map {t:.1f} s")
    t, (_, single) = c.timed(lambda: c.genome_run(clr, feats, dev), sync)
    print(f"one card (stream): {t:.3f} s")
    n_snips = c.engine_snips(single)
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    for devs in ([cards[0]], cards[:2], cards, [cards[0]] * 4):
        mesh = LociMesh(devs)
        for rep in range(2):
            t, (pu, table) = c.timed(
                lambda: c.genome_run(clr, feats, dev, mesh=mesh), sync)
            err = c.compare_tables(table, single, rtol=1e-4, atol=1e-7,
                                   what=str(devs))
            c.mesh_line(f"genome on {[str(d) for d in devs]} run {rep}", t,
                        pu, n_snips, card)
            print("  max_abs_err", err, "current device",
                  torch.cuda.current_device())


if __name__ == "__main__":
    main()
