"""Feature sets: one general generator driven by the configuration's
``features`` block and the cell's ``features`` block.

Job ``j`` of a run with seed ``s`` draws its features from
``SeedSequence([s, 0, j])`` and passes ``seed=`` the first word of
``SeedSequence([s, 1, j])`` to ``pileup`` (the shifted controls); the
warm-up job uses stream 2. Every job of a run has the same sizes: the same
number of features a chromosome, drawn at other bins.

A chromosome holds ``per_chromosome`` features, or its share of ``count``
(the first ``count % chromosomes`` chromosomes one more), starting at
distinct bins in [``first_bin``, ``bins_per_chromosome -
last_margin_bins``). What a feature is, is the configuration's ``kind``:
``kinds/<kind>.py`` draws its ends and columns. What a cell hands to
``pileup``, is the cell's ``features.as``: ``forms/<form>.py`` makes it
from the features. A new kind or form is a module of its own.
"""

from __future__ import annotations

import importlib

import numpy as np
import pandas as pd

FEATURES, CONTROLS, WARMUP = 0, 1, 2


def job_rng(seed, job, stream=FEATURES):
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream,
                                                         int(job)]))


def job_seed(seed, job):
    """The ``seed`` keyword of job ``job``'s pileup."""
    return int(np.random.SeedSequence([int(seed), CONTROLS, int(job)])
               .generate_state(1)[0])


def warmup_seed(seed):
    return int(np.random.SeedSequence([int(seed), WARMUP, 0])
               .generate_state(1)[0])


def counts(feat_cfg, chromosomes):
    """The number of features of each chromosome."""
    if "count" in feat_cfg:
        q, r = divmod(int(feat_cfg["count"]), chromosomes)
        return [q + (k < r) for k in range(chromosomes)]
    return [int(feat_cfg["per_chromosome"])] * chromosomes


def base_features(feat_cfg, map_cfg, rng):
    n = int(map_cfg["bins_per_chromosome"])
    res = int(map_cfg["binsize"])
    lo, hi = int(feat_cfg["first_bin"]), n - int(feat_cfg["last_margin_bins"])
    kind = importlib.import_module(f"pupbench.gen.kinds.{feat_cfg['kind']}")
    per = counts(feat_cfg, int(map_cfg["chromosomes"]))
    cols = {"start": [], "end": []}
    for n_k in per:
        start = np.sort(rng.choice(np.arange(lo, hi), n_k,
                                   replace=False)) * res
        end, extra = kind.draw(feat_cfg, start, res, rng)
        for name, col in {"start": start, "end": end, **extra}.items():
            cols.setdefault(name, []).append(np.broadcast_to(col, n_k))
    chrom = np.repeat([f"chr{k + 1}" for k in range(len(per))], per)
    return pd.DataFrame({"chrom": chrom, **{
        name: np.concatenate(parts) for name, parts in cols.items()}})


def cell_form(frame, form, binsize):
    return importlib.import_module(f"pupbench.gen.forms.{form}").form(
        frame, binsize)


def job_features(config, cell, seed, job, stream=FEATURES):
    rng = job_rng(seed, job, stream)
    frame = base_features(config["features"], config["map"], rng)
    return cell_form(frame, cell["features"]["as"],
                     int(config["map"]["binsize"]))


class Pool:
    """The feature sets of a run's jobs, drawn ahead for the first
    ``size`` jobs; a job past them draws its own."""

    def __init__(self, config, cell, seed, size):
        self.config, self.cell, self.seed = config, cell, int(seed)
        self.sets = []
        self.draw(size)

    def draw(self, size):
        """Draw the sets of the jobs up to ``size`` that are not drawn."""
        self.sets += [job_features(self.config, self.cell, self.seed, j)
                      for j in range(len(self.sets), size)]

    def __getitem__(self, job):
        if job < len(self.sets):
            return self.sets[job]
        return job_features(self.config, self.cell, self.seed, job)

    def warmup(self):
        return job_features(self.config, self.cell, self.seed, 0, WARMUP)
