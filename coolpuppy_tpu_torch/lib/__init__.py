"""Pup algebra of the port (host side, numpy), and the reference's
``lib.io`` and ``lib.util`` names."""

from . import io, numutils, puputils, util  # noqa: F401
