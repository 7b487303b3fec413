"""Genomic interval helpers of the port (host side, pandas/numpy;
counterpart of ``coolpuppy_tpu/genomics``)."""

from .intervals import (  # noqa: F401
    natsort_key,
    natsorted,
    expand_intervals,
    expand_intervals_2d,
    make_viewframe,
    make_cooler_view,
    sort_bedframe,
    is_compatible_viewframe,
    is_valid_expected,
)
