"""The two CUDA quad gather-accumulate kernels against the plain PyTorch
version, on the card: chip_smoke.py's phase-3 inputs (W = 11, 21, 65, 120,
the largest staged W and the first direct W; a 900-snip quad; group ids
above 512; +inf poison; an empty stream; by-window runs of 1-3 snips; quads
cut exactly at ITEM_MAX; an item longer than the kernel's chunk; missing
tiles) through every variant that takes the W, the direct kernel, the
staged kernel on split and on whole quads, and the routed wrapper, with its
tolerances: ``num`` exact, poison planes equal,
finite ``sum`` within rtol/atol 1e-5.

Needs a CUDA device and nvcc; skipped elsewhere. On a machine with a card:

    python -m pytest tests/test_torch_kernel_cuda.py -q
"""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_quad_accumulate_kernel_matches_plain(cuda_device):
    sys.path.insert(0, str(REPO))
    try:
        from chip_smoke import check_case, kernel_cases
    finally:
        sys.path.remove(str(REPO))
    from coolpuppy_tpu_torch.ops import quad_gather as qg

    for name, stiles, quads, W, C in kernel_cases():
        before = qg.LAUNCHES
        held, _, _ = check_case(name, stiles, quads, W, C, cuda_device,
                                torch.cuda.synchronize)
        assert "direct" in held and "routed" in held
        assert ("staged" in held) == qg.corner_layout(W).staged
        assert qg.LAUNCHES == before + (len(held) if len(quads[2]) else 0)
