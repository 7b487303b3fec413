"""Find what ``BENCHMARK.json`` names: the workload, its configuration and
cell files, and the per-layer metrics' readers."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def workload(name, bench=None):
    """The ``workloads`` entry called ``name``."""
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    known = ", ".join(w["name"] for w in bench["workloads"])
    raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")


def config(name):
    return load_json(HERE / "configs" / f"{name}.json")


def cell(name):
    return load_json(HERE / "cells" / f"{name}.json")


def metrics_for(name, section, bench=None):
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    the workload ``name`` reports: those without a ``workloads`` key, and
    those that list it."""
    bench = bench or benchmark()
    return [m for m in bench[section]
            if name in m.get("workloads", [name])]


def reader(metric):
    """The ``read(ctx)`` function of ``metrics/<metric>/reader.py``."""
    mod = importlib.import_module(f"pupbench.metrics.{metric}.reader")
    return mod.read


def kernel_names(metric):
    """The kernel names a roofline divides by: one a line, in every file
    under ``metrics/<metric>/kernels/``."""
    names = []
    for path in sorted((HERE / "metrics" / metric / "kernels").glob("*.txt")):
        names += [ln.strip() for ln in path.read_text().splitlines()
                  if ln.strip() and not ln.startswith("#")]
    return names
