"""Multi-process runs: process-group set-up, region-pair work split across
processes, and the exchange of per-region outputs (counterpart of
``coolpuppy_tpu/parallel/distributed.py``).

The reference's only scale-out axis is a process pool over region pairs on
one node with a driver-side reduce (reference coolpup.py:1502–1531). Across
processes the same axis becomes: each process ingests and piles up its
share of region pairs on its own device, then the per-region outputs are
all-gathered and reduced by the same ``sum_pups`` monoid.

The collective runs on ``torch.distributed`` with the gloo backend: the
payload is host dicts of numpy accumulators (the JAX package, too, ships
them as host bytes), and NCCL refuses two ranks on one card.
"""

from __future__ import annotations

import datetime
import os

# how long a collective of this module waits for the other processes
TIMEOUT = datetime.timedelta(minutes=5)


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def _initialized():
    dist = _dist()
    return dist is not None and dist.is_initialized()


def init_distributed(backend="gloo", timeout=TIMEOUT, **kwargs):
    """Initialize the default process group for a multi-process run and
    return ``(rank, world_size)``.

    With no ``init_method`` the group reads ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), as
    ``jax.distributed.initialize`` reads the pod's environment. A no-op when
    the group is already initialized, and when the run is single-process
    (no ``init_method`` given and ``WORLD_SIZE`` unset or 1): then it
    returns ``(0, 1)``. ``kwargs`` go to ``init_process_group``
    (``init_method``, ``world_size``, ``rank``)."""
    dist = _dist()
    if dist is None:
        return 0, 1
    if not dist.is_initialized():
        if "init_method" not in kwargs and int(
            os.environ.get("WORLD_SIZE", "1")
        ) <= 1:
            return 0, 1
        dist.init_process_group(backend=backend, timeout=timeout, **kwargs)
    return dist.get_rank(), dist.get_world_size()


def rank():
    """This process's rank (0 outside a process group)."""
    return _dist().get_rank() if _initialized() else 0


def world_size():
    """The processes of the run (1 outside a process group)."""
    return _dist().get_world_size() if _initialized() else 1


def local_device_index():
    """This process's rank among the processes of its host:
    ``LOCAL_RANK`` where the launcher sets it, else the global rank."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def local_region_pairs(pairs, process_index=None, process_count=None):
    """This process's share of the region-pair work list (round-robin, so
    large chromosomes spread across processes)."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    return [p for i, p in enumerate(pairs) if i % pc == pi]


def allreduce_region_maps(region_outputs):
    """Exchange per-region pileup outputs across processes so every process
    holds the full list, the lists of the ranks concatenated in rank order
    (the counterpart of the reference's driver-side gather before
    ``reduce(sum_pups, …)``). Single-process: identity. The outputs are
    python dicts of numpy accumulators and travel pickled
    (``all_gather_object``)."""
    if world_size() == 1:
        return region_outputs
    dist = _dist()
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, region_outputs)
    merged = []
    for part in gathered:
        merged.extend(part)
    return merged
