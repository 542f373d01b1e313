"""Kernel tests that need the CUDA card: each hand-written kernel against its
plain PyTorch version, bf16 on the card. They skip on a machine without a
card; on one, run `python -m pytest tests/test_torch_cuda.py -m cuda`.
Tolerances: bf16 outputs, about one bf16 ulp of the output's magnitude."""

import pytest
import torch

from cflearn_torch.ops import attention as A
from cflearn_torch.ops import conv as C

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 1024, 1024, 40), (1, 2, 300, 777, 80), (1, 1, 512, 512, 512), (1, 2, 256, 256, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernel_matches_plain(cuda, causal, shape, dtype) -> None:
    b, h, lq, lk, d = shape
    q = torch.randn((b, h, lq, d), generator=cuda, device="cuda").to(dtype)
    k = torch.randn((b, h, lk, d), generator=cuda, device="cuda").to(dtype)
    v = torch.randn((b, h, lk, d), generator=cuda, device="cuda").to(dtype)
    before = A.flash_attention.launches
    out = A.flash_attention(q, k, v, causal=causal)
    assert A.flash_attention.launches == before + 1
    ref = A.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)


@pytest.mark.parametrize("shape", [(1, 64, 64, 512, 512), (2, 33, 47, 64, 136), (1, 128, 128, 256, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_conv_kernel_matches_plain(cuda, shape, dtype) -> None:
    b, h, w, c, co = shape
    x = torch.randn((b, h, w, c), generator=cuda, device="cuda").to(dtype)
    wt = (torch.randn((co, 3, 3, c), generator=cuda, device="cuda") * (9 * c) ** -0.5).to(dtype)
    bias = (torch.randn((co,), generator=cuda, device="cuda") * 0.1).to(dtype)
    out = C.conv3x3(x, wt, bias)
    ref = C.conv3x3_plain(x, wt, bias)
    torch.testing.assert_close(out.float(), ref.float(), atol=6.25e-2, rtol=0)


def test_kernels_reject_f32(cuda) -> None:
    q = torch.randn((1, 1, 256, 64), device="cuda")
    with pytest.raises(TypeError):
        A.flash_attention(q, q, q)
