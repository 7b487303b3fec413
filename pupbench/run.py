"""Run one cell of the benchmark:

    python3 pupbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints the result as one JSON line, the last
of standard output, and each number compared beside its limit as the last
lines of standard error. Exits non-zero, printing no result, without an
NVIDIA card, without the program, or when JAX or the JAX package was
imported."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    if args.seed < 0:
        print("pupbench: --seed must be a whole number >= 0", file=sys.stderr)
        return 2
    import torch

    from pupbench import harness, spec

    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"pupbench: the cell needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}: no run on the CPU",
              file=sys.stderr)
        return 3
    try:
        import coolpuppy_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"pupbench: the program does not import: {e}", file=sys.stderr)
        return 4
    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda:0", T0)
    except harness.ForbiddenImport as e:
        print(f"pupbench: imported in the measured process: {e}",
              file=sys.stderr)
        return 5
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
