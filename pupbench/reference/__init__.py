"""The plain reference of a pileup job: numpy for the coordinates, plain
torch (float64) for the windows, on whichever device it is given. It
imports nothing of the program and takes nothing the program made: it reads
the benchmark's own map arrays, features and expected table and works out
again every derived quantity.

A cell names its reference's parts in its ``reference`` block, one module
a role, found by name as ``reference/<role>/<name>.py``:

- ``source``: the windows of the features, as blocks of one pair of
  chromosomes (``blocks(job, features)``);
- ``groups``: the group key of each window (``keys(job, left, right)``);
- ``values``: a block's window values (``make(cmap, block, kw, expected,
  precision, device)``);
- ``windows``: the accumulation of a block's windows (``size(job)``,
  ``accumulate(values, snips, cid, size, kw, acc)``);
- ``table``: the output rows (``finalize(acc, n, labels, kw)``), the
  program's table read as rows of the same keys (``program_rows(table)``)
  and a job's snips (``snips(table)``).

A cell with another mode adds a module of a role and edits none.
"""

import importlib
from types import SimpleNamespace

ROLES = ("source", "groups", "values", "windows", "table")


def parts(names):
    """The modules that ``names`` ({role: name}) choose."""
    return SimpleNamespace(**{
        role: importlib.import_module(f"pupbench.reference.{role}."
                                      f"{names[role]}")
        for role in ROLES})
