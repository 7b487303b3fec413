"""Matrix input of the port: an in-memory cooler."""

from .cool import Cooler, PixelSlab  # noqa: F401
