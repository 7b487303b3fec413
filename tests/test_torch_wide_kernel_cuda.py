"""The wide CUDA kernel against the plain PyTorch version, on the card:
``torch_cases.wide_kernel_cases`` (missing tiles, +inf poison, NaN-masked
pixels, several groups in one tile, a run cut at ``ITEM_MAX``, stripes) at
W = 121, 201 and 401 through the routed ``generic_accumulate`` (one launch
each) with its tolerances: ``num`` and ``poison`` exact, ``sum`` within
rtol 1e-5, stripe planes equal; the library's band count equal to the
wrapper's; and the kernel on the case's first 60 snips against the
kernel-order plain version on the same items.

Needs a CUDA device and nvcc; skipped elsewhere. On a machine with a card:

    python -m pytest tests/test_torch_wide_kernel_cuda.py -q
"""

import pytest
import torch

from torch_cases import check_wide_case, wide_kernel_cases


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [121, 201, 401])
def test_wide_kernel_matches_plain(cuda_device, W):
    import coolpuppy_tpu_torch.ops.gather as ga
    from coolpuppy_tpu_torch.kernels.build import load_kernels

    assert load_kernels().wide_accumulate_bands(W) == ga.wide_bands(W)
    name, W, C, case = next(c for c in wide_kernel_cases() if c[1] == W)
    before = ga.LAUNCHES
    err, launches, want = check_wide_case(name, W, C, case, cuda_device)
    assert launches == 1 and ga.LAUNCHES == before + 1
    assert want["num"].sum() > 0 and want["poison"].sum() > 0

    args = [x.to(cuda_device) for x in case[:2]] + [
        x[:60].to(cuda_device) for x in case[2:]]
    got = ga.wide_accumulate(*args, W, C)
    order = ga.wide_accumulate_banded_plain(
        args[0], *ga.wide_items(*args[1:], W, C), W, C)
    for k in ("num", "poison"):
        assert torch.equal(got[k].double(), order[k]), k
    torch.testing.assert_close(got["sum"].double(), order["sum"], rtol=1e-5,
                               atol=1e-6)
