"""Which torch device an entry point runs on.

Every entry point of the port that takes ``device`` defaults to ``"cuda"``
and resolves it here: a CUDA device must exist, and the CPU (the plain
PyTorch versions of the kernels) is taken only when the caller asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device):
    """The torch device to run on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} but torch sees no CUDA device; pass "
                "device='cpu' to run the plain PyTorch version"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
