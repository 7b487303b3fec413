"""Genomic interval helpers of the port (host side, pandas/numpy)."""
