"""Multi-device and multi-process pile-ups (counterpart of
``coolpuppy_tpu/parallel``): the loci mesh (``mesh``), row-banded stacks
with halo copies (``rowshard``), the quad kernel per mesh device
(``quad_mesh``) and the region split across processes
(``distributed``)."""

from .mesh import (  # noqa: F401
    LociMesh,
    make_loci_mesh,
    make_mesh,
    sharded_generic_step,
    sharded_pileup_demo_inputs,
    sharded_pileup_step,
    sharded_rescale_step,
)
from .rowshard import (  # noqa: F401
    build_row_partition,
    route_snips,
    row_sharded_step,
)
from .quad_mesh import QuadMeshSession, sharded_normalize_halo  # noqa: F401
from .distributed import (  # noqa: F401
    init_distributed,
    local_region_pairs,
    allreduce_region_maps,
)
