"""Fixtures of the benchmark's CPU tests: a tiny copy of each cell (three
chromosomes of 700 bins, tens of features), run with the program's plain
PyTorch version on the CPU."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pupbench import spec  # noqa: E402

TINY_MAP = dict(kind="cis_zipf", chromosomes=3, bins_per_chromosome=700, binsize=10_000,
                contacts_per_chromosome=150_000, distance_zipf_a=1.35,
                count_poisson_lam=3.0, weight_low=0.5, weight_high=1.5,
                bad_bin_fraction=0.03)
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
BIG_SEED = 2**31 + 987_654


def tiny(name):
    """(config, cell) of workload ``name`` cut to the tiny map."""
    cfg = spec.config(spec.workload(name)["config"])
    cfg["map"] = dict(TINY_MAP)
    f = dict(cfg["features"])
    if f["kind"] == "sites":
        f["per_chromosome"] = 40
    else:
        f.update(count=37, max_width_bp=600_000, first_bin=60,
                 last_margin_bins=120)
    cfg["features"] = f
    cell = spec.cell(name)
    cell["pool_jobs"] = 3
    return cfg, cell


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda:0"
