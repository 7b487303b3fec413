"""The port's pile-up engine: PileUpper and pileup()."""

from .pileup import PileUpper, pileup  # noqa: F401
