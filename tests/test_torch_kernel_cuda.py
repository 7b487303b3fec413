"""The CUDA quad gather-accumulate against its plain PyTorch version, on the
card: chip_smoke.py's phase-3 inputs (W = 11, 21, 65, 120; a 900-snip quad;
group ids above 512; +inf poison; an empty stream) with its tolerances:
``num`` exact, poison planes equal, finite ``sum`` within rtol/atol 1e-5.

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
        from chip_smoke import SMALL_TOL, compare, kernel_cases
    finally:
        sys.path.remove(str(REPO))
    from coolpuppy_tpu_torch.ops import quad_gather as qg

    for name, args in kernel_cases(cuda_device):
        before = qg.LAUNCHES
        got = qg.quad_accumulate(*args)
        torch.cuda.synchronize()
        assert qg.LAUNCHES == before + (1 if args[1].shape[0] else 0)
        want = qg.quad_accumulate_plain(*args)
        compare(got, want, what=name, **SMALL_TOL)
