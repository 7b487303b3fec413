"""coolpuppy-tpu-torch: the PyTorch/CUDA port of coolpuppy-tpu.

The pile-up of ``coolpuppy_tpu`` (the JAX package, which stays the
reference) re-built on PyTorch tensors: ``pileup()`` and ``PileUpper`` over
a ``Cooler`` (a ``.cool`` file read one row span a fetch, or arrays in
memory) for BED and BEDPE features, cis and trans, by
strand, distance or window, with stripes, rescaling and the reference's
extension hooks, with the quad gather-accumulate written by hand in CUDA
C++ for Hopper (``csrc/``). What a hook author needs is in ``lib``:
``lib.puputils.accumulate_values`` and ``group_by_region_frame``,
``lib.numutils.get_domain_score``. Around it, as in the JAX package: the
file formats in ``io`` (BED/BEDPE/expected tables, ``.clpy`` pileups,
``.txt`` arrays, ``write_cool``), ``plotting`` and the three command line
tools in ``cli`` (``coolpup-torch``, ``plotpup-torch``, ``dividepups-torch``).
``.cool`` and ``.clpy`` files are read and written through h5py, imported
inside those functions; matplotlib is imported by ``plotting`` and
``cli.plotpup_cli`` alone. The pileup itself needs neither. The reference
notebooks' import lines work against the aliases ``coolpup``, ``plotpup``
(which imports matplotlib) and ``lib.io``/``numutils``/``puputils``/``util``.

Importing the package has no side effects: no allocator or thread tuning,
no kernel build. The kernel is compiled at its first launch on a CUDA
tensor (``kernels/build.py``).
"""

from ._version import __version__  # noqa: F401

from .coords import (  # noqa: F401
    CoordCreator,
    assign_groups,
    bin_distance_intervals,
)
from .engine import PileUpper, pileup  # noqa: F401
from .io import Cooler, write_cool  # noqa: F401
from .ops.gather import merge_flip_banks  # noqa: F401
from .ops.quad_gather import (  # noqa: F401
    QuadPileupSession,
    quad_accumulate,
    quad_accumulate_plain,
    run_quad_pileup,
)
from .ops.tiles import (  # noqa: F401
    SymTileStack,
    TileStack,
    build_tile_stack,
    build_tile_stack_sym,
    from_reference,
)
