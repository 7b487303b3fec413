"""Tensor operations of the port: tile stacks, normalization, the quad
gather-accumulate and the flip-bank merge."""
