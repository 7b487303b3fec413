"""What the benchmark loads and opens: no JAX, no JAX package (whole
top-level names: ``coolpuppy_tpu_torch`` passes), none of the old
benchmark's files."""

import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "coolpuppy_tpu"}
OLD = ("bench.py", "chip_smoke.py")

SPY = r"""
import builtins, io, os, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, os.path.join({root!r}, "pupbench", "tests"))
opened = []
real_open = builtins.open
def spy(file, *a, **k):
    opened.append(str(file))
    return real_open(file, *a, **k)
builtins.open = io.open = spy
import runpy
runpy.run_path(os.path.join({root!r}, "pupbench", "run.py"), run_name="x")
import pupbench.reference.pileup, pupbench.control, pupbench.harness
from conftest import tiny, BIG_SEED
from pupbench import harness
for name in ("ctcf_sites_10kb.pairs_by_strand", "tads_10kb.local_rescale"):
    cfg, cell = tiny(name)
    harness.run(name, BIG_SEED, 0.2, True, "cpu", time.perf_counter(),
                config=cfg, cell=cell)
print("MODULES", " ".join(sorted(sys.modules)))
print("OPENED", "\t".join(opened))
"""


def test_no_jax_and_no_old_benchmark_files():
    p = subprocess.run([sys.executable, "-c", SPY.format(root=ROOT)],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = dict(ln.split(" ", 1) for ln in p.stdout.splitlines()
                 if ln.startswith(("MODULES", "OPENED")))
    tops = {m.split(".")[0] for m in lines["MODULES"].split()}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert "coolpuppy_tpu_torch" in tops and "pupbench" in tops
    for path in lines.get("OPENED", "").split("\t"):
        base = path.rsplit("/", 1)[-1]
        assert base not in OLD and not base.startswith("BENCH_"), path
