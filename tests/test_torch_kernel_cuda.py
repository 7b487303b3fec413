"""The staged CUDA quad gather-accumulate kernel against the plain PyTorch
version, on the card: ``torch_cases.kernel_cases`` (W = 11, 21, 65, 115,
120, the largest one-band W and the first banded W; a 900-snip quad; group
ids above 512; +inf poison; an empty stream; by-window runs of 1-3 snips;
quads cut exactly at ITEM_MAX; an item longer than the kernel's chunk;
missing tiles) through the staged kernel on split and on whole quads and
the routed wrapper, with its tolerances: ``num`` exact, poison planes
equal, finite ``sum`` within rtol/atol 1e-5. The banded cases (W = 111,
115, 120: two blocks an item) are parameters of their own, where the
staged kernel is also held against the plain banded accumulate.

Needs a CUDA device and nvcc; skipped elsewhere. On a machine with a card:

    python -m pytest tests/test_torch_kernel_cuda.py -q
"""

import pytest
import torch

from torch_cases import check_case, kernel_cases, variant_args


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("only_w", [None, 111, 115, 120],
                         ids=["every case", "W111", "W115", "W120"])
def test_quad_accumulate_kernel_matches_plain(cuda_device, only_w):
    from coolpuppy_tpu_torch.ops import quad_gather as qg

    cases = [c for c in kernel_cases() if only_w in (None, c[3])]
    assert cases
    for name, stiles, quads, W, C in cases:
        before = qg.LAUNCHES
        held, _, _ = check_case(name, stiles, quads, W, C, cuda_device)
        assert held == ["staged", "staged, whole quads", "routed"]
        assert qg.LAUNCHES == before + (len(held) if len(quads[2]) else 0)
        if only_w is not None:
            assert qg.corner_layout(W).bands == 2
            st = torch.from_numpy(stiles).to(cuda_device)
            args = variant_args(quads, "staged", cuda_device)
            got = qg.quad_accumulate_staged(st, *args, W, C)
            want = qg.quad_accumulate_banded_plain(st, *args, W, C)
            assert torch.equal(got[1].double(), want[1])
            torch.testing.assert_close(got[0].double(), want[0], rtol=1e-5,
                                       atol=1e-5)
