"""The reference's module alias ``coolpup`` (``from coolpuppy import
coolpup`` in the reference notebooks; counterpart of ``coolpuppy/coolpup.py``):
``CoordCreator``, ``PileUpper``, ``pileup`` and the free helpers."""

from .coords import (  # noqa: F401
    CoordCreator,
    assign_groups,
    bin_distance_intervals,
    flip_mark_intervals,
)
from .engine import PileUpper, pileup  # noqa: F401
