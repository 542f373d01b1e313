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
from cflearn_torch.ops import group_norm as G

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


# the UNet's d = 40 at L = 1024 and ToMe's L = 2048, d = 80 and 160 with a ragged kv, d = 40 with a ragged kv
# (the kv tail that TMA zero-fills is masked) and with ragged q and kv on three consumer warpgroups, d = 512 (the
# mma.sync kernel) and d = 256
FWD_SHAPES = [
    (2, 8, 1024, 1024, 40), (2, 8, 2048, 2048, 40), (1, 2, 300, 777, 40), (8, 8, 1000, 777, 40), (1, 2, 300, 777, 80),
    (2, 8, 256, 256, 160), (1, 3, 200, 333, 160), (1, 1, 512, 512, 512), (1, 2, 256, 256, 256),
]


def _fwd_inputs(gen, shape, dtype, layout):
    """q, k, v of `shape` (B, H, Lq, Lk, D): (B, H, L, D) tensors, or transposed views of (B, L, H, D)
    storage as the UNet hands them over."""
    b, h, lq, lk, d = shape
    out = []
    for length in (lq, lk, lk):
        if layout == "bhld":
            out.append(torch.randn((b, h, length, d), generator=gen, device="cuda").to(dtype))
        else:
            out.append(torch.randn((b, length, h, d), generator=gen, device="cuda").to(dtype).transpose(1, 2))
    return out


def _expected_kernel(shape, dtype) -> str:
    """The planner's choice: wgmma + TMA for 16-bit d <= 256, mma.sync for d = 512, the chunked kernel beyond
    and for f32."""
    d = shape[-1]
    if dtype == torch.float32 or d > 512:
        return "mma_sync_chunked"
    return "sm90" if d <= 256 else "mma_sync"


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", FWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernel_matches_plain(cuda, layout, causal, shape, dtype) -> None:
    q, k, v = _fwd_inputs(cuda, shape, dtype, layout)
    b, h, lq, lk, d = shape
    plan = A.flash_plan(b, h, lq, lk, d, dtype, torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.kernel == _expected_kernel(shape, dtype)
    before = A.flash_attention.launches
    out = A.flash_attention(q, k, v, causal=causal)
    assert A.flash_attention.launches == before + 1
    ref = A.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    _close(out, ref, _rel(dtype))
    # the mma.sync kernel, on request: the same function
    _close(A.flash_attention(q, k, v, causal=causal, kernel="mma_sync"), ref, _rel(dtype))
    assert torch.equal(out, A.flash_attention(q, k, v, causal=causal))  # no atomics: the same bits again


def test_flash_kernel_routes_a_non_positive_scale_to_mma_sync(cuda) -> None:
    """The wgmma kernel takes the row max of the raw scores, which needs a positive scale: the wrapper sends
    any other scale to the mma.sync kernel, and the wgmma entry refuses one."""
    q, k, v = _fwd_inputs(cuda, (1, 2, 300, 777, 40), torch.bfloat16, "bhld")
    for scale in (-0.3, 0.0):
        out = A.flash_attention(q, k, v, sm_scale=scale)
        _close(out, A.flash_attention_plain(q, k, v, sm_scale=scale), _rel(torch.bfloat16))
        with pytest.raises(RuntimeError):
            A.flash_attention(q, k, v, sm_scale=scale, kernel="sm90")


# C = 24 and 72 (below and not a multiple of the kernels' 64-channel box), W = 131 and H != W (boxes past
# the image's edge), batch 3, and (2, 128, 128, 64, 264) for 256 output channels per tile with a ragged last one
CONV_SHAPES = [
    (1, 64, 64, 512, 512), (2, 33, 47, 64, 136), (1, 128, 128, 256, 128), (3, 20, 131, 24, 72),
    (2, 9, 40, 72, 24), (2, 128, 128, 64, 264),
]


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_conv_kernel_matches_plain(cuda, shape, dtype) -> None:
    b, h, w, c, co = shape
    x = torch.randn((b, h, w, c), generator=cuda, device="cuda").to(dtype)
    wt = (torch.randn((co, 3, 3, c), generator=cuda, device="cuda") * (9 * c) ** -0.5).to(dtype)
    bias = (torch.randn((co,), generator=cuda, device="cuda") * 0.1).to(dtype)
    before = C.conv3x3.launches
    out = C.conv3x3(x, wt, bias)
    assert C.conv3x3.launches == before + 1
    ref = C.conv3x3_plain(x, wt, bias)
    torch.testing.assert_close(out.float(), ref.float(), atol=6.25e-2, rtol=0)
    assert torch.equal(out, C.conv3x3(x, wt, bias))  # no atomics: the same bits again


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


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "shape", TRAIN_SHAPES + [(2, 8, 2048, 2048, 40), (1, 2, 300, 777, 40), (8, 8, 1000, 777, 40), (2, 8, 256, 256, 160)]
)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_flash_fwd_lse_kernel_matches_plain(cuda, layout, causal, shape, dtype) -> None:
    q, k, v = _fwd_inputs(cuda, shape, dtype, layout)
    b, h, lq, lk, d = shape
    plan = A.flash_plan(b, h, lq, lk, d, dtype, torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.kernel == _expected_kernel(shape, dtype)
    before = A.flash_fwd_lse.launches
    o, lse = A.flash_fwd_lse(q, k, v, causal=causal)
    assert A.flash_fwd_lse.launches == before + 1
    ref_o, ref_lse = A.flash_fwd_with_lse_plain(q, k, v, causal=causal)
    tol = 4e-3 if dtype == torch.float32 else 1e-4
    for got_o, got_lse in ((o, lse), A.flash_fwd_lse(q, k, v, causal=causal, kernel="mma_sync")):
        _close(got_o, ref_o, _rel(dtype))
        assert got_lse.dtype == torch.float32 and got_lse.shape == ref_lse.shape
        assert (got_lse - ref_lse).abs().max() <= tol


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


def test_conv_kernel_carries_gradients_on_the_card(cuda) -> None:
    """`conv3x3` on CUDA tensors that need a gradient goes through the conv
    VJP: dx from the forward kernel with flipped weights, dw from the
    weight-gradient kernel, db; each within two bf16 ulps of its largest value
    of the plain version's autograd."""
    x = torch.randn((2, 33, 47, 64), generator=cuda, device="cuda").bfloat16().requires_grad_()
    w = (torch.randn((136, 3, 3, 64), generator=cuda, device="cuda") / 24).bfloat16().requires_grad_()
    b = (torch.randn((136,), generator=cuda, device="cuda") * 0.1).bfloat16().requires_grad_()
    dy = torch.randn((2, 33, 47, 136), generator=cuda, device="cuda").bfloat16()
    counts = C.conv3x3.launches, C.conv3x3_wgrad.launches
    y = C.conv3x3(x, w, b)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, (x, w, b), dy)
    assert (C.conv3x3.launches, C.conv3x3_wgrad.launches) == (counts[0] + 2, counts[1] + 1)
    ref = torch.autograd.grad(C.conv3x3_plain(x, w, b), (x, w, b), dy)
    for g, r in zip(got, ref):
        _close(g, r, 2.0**-6)
    with torch.no_grad():
        assert C.conv3x3(x, w).grad_fn is None


@pytest.mark.parametrize(
    "shape",
    [(8, 64, 64, 128, 128), (3, 33, 47, 64, 136), (2, 5, 7, 96, 64), (1, 128, 128, 256, 128), (3, 20, 131, 24, 72),
     (2, 9, 40, 72, 24), (1, 7, 131, 72, 264)],
)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wgrad_kernel_matches_plain(cuda, shape, dtype) -> None:
    b, h, w, c, co = shape
    x = torch.randn((b, h, w, c), generator=cuda, device="cuda").to(dtype)
    dy = (torch.randn((b, h, w, co), generator=cuda, device="cuda") * (b * h * w) ** -0.5).to(dtype)
    before = C.conv3x3_wgrad.launches
    out = C.conv3x3_wgrad(x, dy)
    assert C.conv3x3_wgrad.launches == before + 1
    _close(out, C.conv3x3_wgrad_plain(x, dy), 2.0**-6)
    assert torch.equal(out, C.conv3x3_wgrad(x, dy))  # a fixed summation order: bit-identical again
    with pytest.raises(TypeError):
        C.conv3x3_wgrad(x.float(), dy.float())


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize(
    "shape,groups", [((8, 64, 64, 128), 32), ((2, 16, 16, 320), 32), ((1, 9, 7, 36), 4), ((2, 3, 5, 1280), 32),
                     ((2, 5, 3, 6152), 2), ((1, 4, 4, 777), 3)]
)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_group_norm_kernel_matches_plain(cuda, silu, shape, groups, dtype) -> None:
    x = (torch.randn(shape, generator=cuda, device="cuda") * 2 + 0.5).to(dtype)
    w = 1 + 0.2 * torch.randn((shape[-1],), generator=cuda, device="cuda")
    b = 0.2 * torch.randn((shape[-1],), generator=cuda, device="cuda")
    for params in ((w, b), (w.to(dtype), b.to(dtype))):
        before = G.group_norm_silu.launches
        out = G.group_norm_silu(x, *params, num_groups=groups, apply_silu=silu)
        assert G.group_norm_silu.launches == before + 1
        ref = G.group_norm_silu_plain(x, *params, num_groups=groups, apply_silu=silu)
        _close(out, ref, 2.0**-16 if dtype == torch.float32 else 2.0**-6)
        assert torch.equal(out, G.group_norm_silu(x, *params, num_groups=groups, apply_silu=silu))
    with pytest.raises(TypeError):
        G.group_norm_silu(x.double(), w, b, num_groups=groups)


def test_fused_group_norm_on_the_card(cuda) -> None:
    """The modules' dispatcher launches the kernel on CUDA tensors with and
    without a gradient; the backward recomputes the plain version."""
    x = torch.randn((2, 16, 16, 64), generator=cuda, device="cuda").bfloat16().requires_grad_()
    w = torch.ones(64, device="cuda", requires_grad=True)
    b = torch.zeros(64, device="cuda", requires_grad=True)
    before = G.group_norm_silu.launches
    y = G.module_call(x, w, b, num_groups=32, eps=1e-6, apply_silu=True)
    assert y.dtype == torch.float32 and isinstance(y.grad_fn, G.FusedGroupNorm._backward_cls)
    got = torch.autograd.grad(y, (x, w, b), torch.ones_like(y))
    with torch.no_grad():
        assert G.module_call(x, w, b, num_groups=32, eps=1e-6).grad_fn is None
    assert G.group_norm_silu.launches == before + 2
    ref = torch.autograd.grad(
        G.group_norm_silu_plain(x.float(), w, b, num_groups=32, apply_silu=True), (x, w, b), torch.ones_like(y)
    )
    for g, r in zip(got, ref):
        _close(g, r.to(g.dtype), 2.0**-6)


W8A8_SHAPES = [(1, 64, 64, 512, 512), (2, 33, 47, 64, 136), (1, 128, 128, 256, 128), (1, 9, 7, 16, 8)]


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("shape", W8A8_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_w8a8_kernel_matches_plain_bit_for_bit(cuda, with_bias, shape, dtype) -> None:
    """The int32 sums are exact and the epilogue rounds as PyTorch does: the
    kernel and its plain version (f64 sums on the card) agree bit for bit."""
    b, h, w, c, co = shape
    x = torch.randn((b, h, w, c), generator=cuda, device="cuda").to(dtype)
    wt = (torch.randn((co, 3, 3, c), generator=cuda, device="cuda") * (9 * c) ** -0.5).to(dtype)
    bias = (torch.randn((co,), generator=cuda, device="cuda") * 0.1).to(dtype) if with_bias else None
    before = C.conv3x3_w8a8.launches
    out = C.conv3x3_w8a8(x, wt, bias)
    assert C.conv3x3_w8a8.launches == before + 1
    ref = C.conv3x3_w8a8_plain(x, wt, bias)
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(out, ref)
    # and close to the unquantised conv: a few per cent of its largest output
    exact = C.conv3x3_plain(x, wt, bias).float()
    assert (out.float() - exact).abs().max() <= 0.05 * exact.abs().max()


def test_w8a8_kernel_refuses_what_it_cannot_take(cuda) -> None:
    x = torch.randn((1, 8, 8, 72), generator=cuda, device="cuda").bfloat16()
    w = torch.randn((64, 3, 3, 72), generator=cuda, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="% 16"):
        C.conv3x3_w8a8(x, w)
    x8, w8, scale = C.w8a8_operands(x[..., :64], w[..., :64])
    with pytest.raises(TypeError):
        C.conv3x3_int8(x8, w8, scale, None, torch.float32)
    with pytest.raises(RuntimeError, match="gradient"):
        C.conv3x3_w8a8(x[..., :64], w[..., :64].clone().requires_grad_())


@pytest.mark.parametrize("shape", [(1, 64, 64, 512, 512), (2, 33, 47, 64, 136), (1, 128, 128, 256, 128), (2, 9, 7, 40, 24)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fold_kernel_matches_plain(cuda, shape, dtype) -> None:
    b, h, w, c, co = shape
    x = torch.randn((b, h, w, c), generator=cuda, device="cuda").to(dtype)
    wt = (torch.randn((co, 3, 3, c), generator=cuda, device="cuda") * (9 * c) ** -0.5).to(dtype)
    bias = (torch.randn((co,), generator=cuda, device="cuda") * 0.1).to(dtype)
    counts = C.conv3x3_fold.launches, C.conv3x3.launches
    out = C.conv3x3(x, wt, bias, fold=True)
    assert (C.conv3x3_fold.launches, C.conv3x3.launches) == (counts[0] + 1, counts[1])
    _close(out, C.conv3x3_fold_plain(x, wt, bias), 2.0**-6)
    _close(out, C.conv3x3(x, wt, bias), 2.0**-6)
