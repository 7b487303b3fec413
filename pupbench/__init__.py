"""pupbench: the benchmark of ``coolpuppy_tpu_torch`` on one NVIDIA card.

Run one cell with ``python3 pupbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. What is measured
is listed in ``BENCHMARK.json``; each configuration, cell and per-layer
metric is a file of its own under this folder, found by its name:

- ``configs/<config>.json``: the map, the features, the precision; the
  map's and the features' ``kind`` name their generators,
  ``gen/maps/<kind>.py`` and ``gen/kinds/<kind>.py``;
- ``cells/<workload>.json``: the pileup keywords, the feature pool and its
  form (``gen/forms/<form>.py``), the parts of the reference
  (``reference/<role>/<name>.py``), the limits of the comparison that
  decides ``correct``;
- ``metrics/<metric>/reader.py``: the reader of one per-layer metric (the
  rooflines also read the kernel names in ``metrics/<metric>/kernels/``);
- ``reference/``: the plain reference that ``correct`` compares with.

A new configuration, traffic mix, reference mode or metric adds files and
edits none.

Nothing here imports JAX or the JAX package.
"""
