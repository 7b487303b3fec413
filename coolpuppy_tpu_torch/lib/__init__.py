"""Pup algebra of the port (host side, numpy)."""
