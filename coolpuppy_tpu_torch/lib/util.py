"""The reference's ``lib.util`` name (counterpart of
``coolpuppy/lib/util.py``)."""

from ..io.bedio import validate_csv  # noqa: F401
