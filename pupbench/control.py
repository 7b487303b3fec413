"""The readings that the limits of ``correct`` are set from, at a cell's
own size: for each seed, one job of the program (the timed path's call,
at the configuration's precision) against the reference (the lower
reading), and on the first ``--control`` seeds the reference computed
through bfloat16 in the program's place (the control, the upper reading).

    python3 pupbench/control.py --workload <name> --seeds 1,2,3 \\
        --control 3

Prints one JSON line a seed and a summary line: the largest of each number
over the program's seeds and the smallest over the control's. Needs a
card, as a run does; the benchmark's own runs never run this."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(name, seed, control, device, config=None, cell=None, job=0):
    """(program numbers, control numbers or None) of job ``job`` of a run
    of ``name`` with ``seed``."""
    from pupbench import compare, harness
    from pupbench.gen import features
    from pupbench.reference.pileup import reference_pileup

    c = harness.Cell(name, seed, device, config, cell)
    table = c.run(c.pool[job], features.job_seed(seed, job))
    got = compare.program_rows(table, c.parts)
    c.free_program()
    ref = reference_pileup(c.cmap, c.pool[job], c.job_kw(job), device,
                           c.parts, expected=c.expected)
    prog = compare.compare(got, ref)
    ctrl = None
    if control:
        low = reference_pileup(c.cmap, c.pool[job], c.job_kw(job), device,
                               c.parts, expected=c.expected,
                               precision=c.config["precision"]["control"])
        ctrl = compare.compare(low, ref)
    return prog, ctrl


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    args = p.parse_args(argv)
    import torch

    from pupbench import compare

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    progs, ctrls = [], []
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        prog, ctrl = readings(args.workload, seed, i < args.control, "cuda:0")
        progs.append(prog)
        if ctrl is not None:
            ctrls.append(ctrl)
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl,
                          "s": time.perf_counter() - t}), flush=True)
    summary = {"workload": args.workload, "seeds": len(progs),
               "program_max": compare.worst(progs)}
    if ctrls:
        summary["control_min"] = {k: min(c[k] for c in ctrls)
                                  for k in compare.NUMBERS}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
