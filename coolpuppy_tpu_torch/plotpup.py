"""The reference's module alias ``plotpup`` (counterpart of
``coolpuppy/plotpup.py``): the names of ``plotting``. Importing it imports
matplotlib."""

from .plotting import *  # noqa: F401,F403
from .plotting import plot, plot_stripes  # noqa: F401
