"""coolpuppy-tpu-torch: the PyTorch/CUDA port of coolpuppy-tpu.

The pile-up of ``coolpuppy_tpu`` (the JAX package, which stays the
reference) re-built on PyTorch tensors: ``pileup()`` and ``PileUpper`` over
an in-memory ``Cooler`` for BED and BEDPE features, cis and trans, by
strand, distance or window, with stripes, with the quad gather-accumulate
written by hand in CUDA C++ for Hopper (``csrc/``). Rescaled pileups and
the extension hooks are not ported yet.

Importing the package has no side effects: no allocator or thread tuning,
no kernel build. The kernel is compiled at its first launch on a CUDA
tensor (``kernels/build.py``).
"""

__version__ = "0.2.0"

from .coords import CoordCreator  # noqa: E402,F401
from .engine import PileUpper, pileup  # noqa: E402,F401
from .io import Cooler  # noqa: E402,F401
from .ops.gather import merge_flip_banks  # noqa: E402,F401
from .ops.quad_gather import (  # noqa: E402,F401
    QuadPileupSession,
    quad_accumulate,
    quad_accumulate_plain,
    run_quad_pileup,
)
from .ops.tiles import (  # noqa: E402,F401
    SymTileStack,
    TileStack,
    build_tile_stack,
    build_tile_stack_sym,
    from_reference,
)
