"""Kernel tests that need the CUDA card: each hand-written kernel against its
plain PyTorch version on the card. They skip on a machine without a card; on
one, run `python -m pytest tests/test_torch_cuda.py -m cuda`.
Tolerances: 16-bit outputs, about two ulps of the output's largest value
(2^-6 of max|ref| covers bf16 and fp16); f32 inputs go through TF32 products
(2^-8 of max|ref|). `chip_smoke.py` runs the same checks at the main paths'
shapes."""

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


def test_kernels_reject_f64_and_take_f32(cuda) -> None:
    q = torch.randn((1, 1, 256, 64), device="cuda")
    out = A.flash_attention(q, q, q)
    ref = A.flash_attention_plain(q, q, q)
    assert (out - ref).abs().max() <= 2.0**-8 * ref.abs().max()
    with pytest.raises(TypeError):
        A.flash_attention(q.double(), q.double(), q.double())


def _rel(dtype) -> float:
    return 2.0**-8 if dtype == torch.float32 else 2.0**-6


def _close(got, ref, rel) -> None:
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= rel * ref.float().abs().max().item(), err


TRAIN_SHAPES = [(2, 8, 1024, 1024, 40), (1, 2, 300, 777, 80), (1, 2, 256, 256, 160), (1, 1, 200, 330, 640)]


def _train_inputs(gen, shape, dtype):
    b, h, lq, lk, d = shape
    q = torch.randn((b, h, lq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, h, lk, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, h, lk, d), generator=gen, device="cuda").to(dtype)
    # dO as autograd hands it over: (B, L, H, D) storage, transposed view
    do = torch.randn((b, lq, h, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    return q, k, v, do


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_flash_fwd_lse_kernel_matches_plain(cuda, causal, shape, dtype) -> None:
    q, k, v, _ = _train_inputs(cuda, shape, dtype)
    before = A.flash_fwd_lse.launches
    o, lse = A.flash_fwd_lse(q, k, v, causal=causal)
    assert A.flash_fwd_lse.launches == before + 1
    ref_o, ref_lse = A.flash_fwd_with_lse_plain(q, k, v, causal=causal)
    _close(o, ref_o, _rel(dtype))
    assert lse.dtype == torch.float32 and lse.shape == ref_lse.shape
    assert (lse - ref_lse).abs().max() <= (4e-3 if dtype == torch.float32 else 1e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_flash_bwd_kernels_match_plain(cuda, causal, shape, dtype) -> None:
    q, k, v, do = _train_inputs(cuda, shape, dtype)
    o, lse = A.flash_fwd_with_lse_plain(q, k, v, causal=causal)
    ref = A.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
    counts = [fn.launches for fn in (A.flash_bwd_fused, A.flash_bwd_dq, A.flash_bwd_dkv)]
    fused = A.flash_bwd_fused(q, k, v, o, lse, do, causal=causal)
    split = (A.flash_bwd_dq(q, k, v, o, lse, do, causal=causal), *A.flash_bwd_dkv(q, k, v, o, lse, do, causal=causal))
    assert [fn.launches for fn in (A.flash_bwd_fused, A.flash_bwd_dq, A.flash_bwd_dkv)] == [c + 1 for c in counts]
    for got_f, got_s, r in zip(fused, split, ref):
        _close(got_f, r, _rel(dtype))
        _close(got_s, r, _rel(dtype))
    # the split pair sums in a fixed order: bit-identical on a second launch
    assert torch.equal(split[0], A.flash_bwd_dq(q, k, v, o, lse, do, causal=causal))
    again = A.flash_bwd_dkv(q, k, v, o, lse, do, causal=causal)
    assert torch.equal(split[1], again[0]) and torch.equal(split[2], again[1])


@pytest.mark.parametrize("deterministic", [False, True])
def test_trainable_function_on_the_card(cuda, deterministic) -> None:
    q, k, v, do = _train_inputs(cuda, (2, 4, 512, 512, 64), torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    with torch.no_grad():
        assert A.sdp_attn(q, k, v).grad_fn is None
    saved, A.FUSED_BWD = A.FUSED_BWD, not deterministic
    try:
        out = A.sdp_attn(q, k, v)
        assert out.grad_fn is not None
        grads = torch.autograd.grad(out, (q, k, v), do)
    finally:
        A.FUSED_BWD = saved
    o, lse = A.flash_fwd_with_lse_plain(q.detach(), k.detach(), v.detach())
    for got, r in zip(grads, A.flash_bwd_plain(q.detach(), k.detach(), v.detach(), o, lse, do)):
        _close(got, r, _rel(torch.bfloat16))


def test_conv_kernel_refuses_gradients_on_the_card(cuda) -> None:
    x = torch.randn((1, 8, 8, 64), device="cuda").bfloat16()
    w = torch.randn((64, 3, 3, 64), device="cuda").bfloat16()
    with pytest.raises(RuntimeError, match="conv VJP"):
        C.conv3x3(x.requires_grad_(), w)
    with torch.no_grad():
        assert C.conv3x3(x, w).grad_fn is None
