"""Kernel tests that need the CUDA card: each hand-written kernel against its
plain PyTorch version on the card. They skip on a machine without a card; on
one, run `python -m pytest tests/test_torch_cuda.py -m cuda`.
Tolerances: 16-bit outputs, about two ulps of the output's largest value
(2^-6 of max|ref| covers bf16 and fp16); f32 inputs, 2^-8 of max|ref| (the
limit from when the f32 products ran in TF32; they run 3xTF32 now, and
`test_f32_flash_rows_compute_in_f32` holds them to f32 level). `chip_smoke.py` runs the same checks at the main paths'
shapes."""

import pytest
import torch

from cflearn_torch.ops import attention as A
from cflearn_torch.ops import conv as C
from cflearn_torch.ops import group_norm as G

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="session")
def built_kernels() -> None:
    """Every kernel library built once, before the first test touches the card. A wrapper builds its library
    at first use, from the calling process; in a test process that built libraries on the way,
    `torch.profiler` sessions then lost their kernel records most of the time (`_kernel_names` counts kernels
    through them): a fresh checkout's `-m cuda` run failed 13 profiled tests that way, and passed all 508 with
    the libraries built here first."""
    if torch.cuda.is_available():
        from cflearn_torch.ops import _native

        _native.build()


@pytest.fixture
def cuda(built_kernels):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


# the UNet's d = 40 at L = 1024 and ToMe's L = 2048, d = 80 and 160 with a ragged kv, d = 40 with a ragged kv
# (the kv tail that TMA zero-fills is masked) and with ragged q and kv on three consumer warpgroups, d = 512 and
# d = 320 (the wide-head kernel; a ragged kv split into parts) and d = 256
FWD_SHAPES = [
    (2, 8, 1024, 1024, 40), (2, 8, 2048, 2048, 40), (1, 2, 300, 777, 40), (8, 8, 1000, 777, 40), (1, 2, 300, 777, 80),
    (2, 8, 256, 256, 160), (1, 3, 200, 333, 160), (1, 1, 512, 512, 512), (1, 2, 256, 256, 256),
    (1, 2, 1000, 777, 512), (1, 2, 300, 333, 320),
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
    """The planner's choice: wgmma + TMA for 16-bit d <= 256, the wide-head wgmma + TMA kernel for
    256 < d <= 512, the chunked mma.sync kernel beyond and for f32."""
    d = shape[-1]
    if dtype == torch.float32 or d > 512:
        return "mma_sync_chunked"
    return "sm90" if d <= 256 else "sm90_wide"


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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 1, 4096, 4096, 512), (1, 2, 1000, 777, 512), (1, 2, 1000, 1000, 320)])
def test_flash_wide_split_kv_matches_plain(cuda, shape, causal) -> None:
    """The wide-head kernel with its kv range split into parts and combined by a second launch (one counted
    call): o and lse against the plain forward and against the parts' arithmetic in plain PyTorch
    (`flash_fwd_split_plain`), the same bits again. With `causal`, some tiles' parts hold no kv block."""
    q, k, v = _fwd_inputs(cuda, shape, torch.bfloat16, "bhld")
    b, h, lq, lk, d = shape
    plan = A.flash_plan(b, h, lq, lk, d, torch.bfloat16, torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.kernel == "sm90_wide" and plan.splits > 1
    before = A.flash_fwd_lse.launches
    o, lse = A.flash_fwd_lse(q, k, v, causal=causal)
    assert A.flash_fwd_lse.launches == before + 1
    ref_o, ref_lse = A.flash_fwd_with_lse_plain(q, k, v, causal=causal)
    _close(o, ref_o, _rel(torch.bfloat16))
    assert (lse - ref_lse).abs().max() <= 1e-4
    mirror_o, mirror_lse = A.flash_fwd_split_plain(q, k, v, plan.splits, causal=causal)
    _close(o, mirror_o, _rel(torch.bfloat16))
    assert (lse - mirror_lse).abs().max() <= 1e-4
    o2, lse2 = A.flash_fwd_lse(q, k, v, causal=causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2) and torch.equal(o, A.flash_attention(q, k, v, causal=causal))


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


def _tf32_defeating(gen, shape, positive=False):
    """f32 values 1 + a 2^-12 + b 2^-20 (a in 1..7, b in 0..255), random signs unless `positive`: TF32 keeps 10
    mantissa bits, so it rounds every one of them to 1 (or 1 + 2^-10), where f32 holds them exactly."""
    a = torch.randint(1, 8, shape, generator=gen, device="cuda").float()
    b = torch.randint(0, 256, shape, generator=gen, device="cuda").float()
    x = 1.0 + a * 2.0**-12 + b * 2.0**-20
    if positive:
        return x
    return x * (torch.randint(0, 2, shape, generator=gen, device="cuda").float() * 2 - 1)


def _attention_f64(q, k, v, do):
    """o, lse and (dq, dk, dv) in float64 by autograd."""
    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    o = torch.softmax(s, dim=-1) @ v
    o.backward(do.double())
    return o.detach(), torch.logsumexp(s, dim=-1).detach(), (q.grad, k.grad, v.grad)


def _tf32_round(t):
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


# f32 level: 2^-16 of max|ref| (f32's own rounding through a 64-long product, the softmax and the exponent's
# ex2.approx is ~1e-6); the TF32 products these kernels once ran are ~1e-3 off on these inputs
F32_LEVEL = 2.0**-16


def test_f32_flash_rows_compute_in_f32(cuda) -> None:
    """Rows 1, 3, 4 and 5 in f32 at d = 64 (DPT-Large's heads) on operands that TF32 cannot hold: the 3xTF32
    products keep the error at f32 level against a float64 reference, where TF32-rounded operands miss it."""
    b, h, lq, lk, d = 1, 4, 300, 333, 64
    q, k = _tf32_defeating(cuda, (b, h, lq, d)), _tf32_defeating(cuda, (b, h, lk, d))
    v = _tf32_defeating(cuda, (b, h, lk, d), positive=True)
    do = _tf32_defeating(cuda, (b, h, lq, d))
    o64, lse64, grads64 = _attention_f64(q, k, v, do)
    assert A.flash_plan(b, h, lq, lk, d, torch.float32, torch.cuda.get_device_properties(0).multi_processor_count
                        ).kernel == "mma_sync_chunked"

    def err(got, ref):
        return (got.double() - ref).abs().max().item() / ref.abs().max().item()

    o = A.flash_attention(q, k, v)
    assert err(o, o64) <= F32_LEVEL, err(o, o64)
    # the same inputs rounded to TF32, multiplied exactly: what a TF32 product computes is far off
    o_tf32 = _attention_f64(_tf32_round(q), _tf32_round(k), _tf32_round(v), do)[0]
    assert err(o_tf32, o64) > 4 * F32_LEVEL
    o2, lse = A.flash_fwd_lse(q, k, v)
    assert err(o2, o64) <= F32_LEVEL and (lse.double() - lse64).abs().max().item() <= 1e-5
    # the backward on a v of random signs (an all-positive v makes dp - delta cancel to its 2^-12 parts, which no
    # f32 computation keeps relative to the result)
    v = _tf32_defeating(cuda, (b, h, lk, d))
    o64, _, grads64 = _attention_f64(q, k, v, do)
    o2, lse = A.flash_fwd_lse(q, k, v)
    for name, grads in (("fused", A.flash_bwd_fused(q, k, v, o2, lse, do)),
                        ("split", (A.flash_bwd_dq(q, k, v, o2, lse, do), *A.flash_bwd_dkv(q, k, v, o2, lse, do)))):
        for g, g64, which in zip(grads, grads64, ("dq", "dk", "dv")):
            assert g.dtype == torch.float32 and err(g, g64) <= F32_LEVEL, (name, which, err(g, g64))


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
    "shape", TRAIN_SHAPES + [(2, 8, 2048, 2048, 40), (1, 2, 300, 777, 40), (8, 8, 1000, 777, 40), (2, 8, 256, 256, 160),
                             (1, 2, 300, 777, 512)]
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


# the backward's shapes: TRAIN_SHAPES, the UNet's d = 40 / 80 / 160 at its L (batch cut to 2; d = 160 keeps the
# fused and dk.dv kernels on mma.sync), and d = 40 with a ragged kv
BWD_SHAPES = TRAIN_SHAPES + [(2, 8, 4096, 4096, 40), (2, 8, 1024, 1024, 80), (2, 8, 256, 256, 160), (1, 2, 300, 777, 40),
                             (2, 8, 1024, 1024, 96), (2, 8, 1024, 1024, 128)]


def _expected_bwd_kernel(shape, dtype, mode) -> str:
    """The planner's choice: wgmma + TMA for 16-bit d <= 128 (d <= 192 for dq), mma.sync beyond and for f32."""
    limit = 192 if mode == "dq" else 128
    return "sm90" if dtype != torch.float32 and shape[-1] <= limit else "mma_sync"


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_flash_bwd_kernels_match_plain(cuda, layout, causal, shape, dtype) -> None:
    """The three backward kernels the planner picks, and the mma.sync kernel on the same inputs, against the
    plain backward; q, k, v as (B, H, L, D) tensors or transposed views, dO always a transposed view."""
    q, k, v = _fwd_inputs(cuda, shape, dtype, layout)
    _, _, _, do = _train_inputs(cuda, shape, dtype)
    b, h, lq, lk, d = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for mode in A.BWD_MODES:
        assert A.flash_bwd_plan(b, h, lq, lk, d, dtype, sms, mode=mode).kernel == _expected_bwd_kernel(shape, dtype, mode)
    o, lse = A.flash_fwd_with_lse_plain(q, k, v, causal=causal)
    ref = A.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
    counts = [fn.launches for fn in (A.flash_bwd_fused, A.flash_bwd_dq, A.flash_bwd_dkv)]
    fused = A.flash_bwd_fused(q, k, v, o, lse, do, causal=causal)
    split = (A.flash_bwd_dq(q, k, v, o, lse, do, causal=causal), *A.flash_bwd_dkv(q, k, v, o, lse, do, causal=causal))
    assert [fn.launches for fn in (A.flash_bwd_fused, A.flash_bwd_dq, A.flash_bwd_dkv)] == [c + 1 for c in counts]
    kw = dict(causal=causal, kernel="mma_sync")
    old_fused = A.flash_bwd_fused(q, k, v, o, lse, do, **kw)
    old_split = (A.flash_bwd_dq(q, k, v, o, lse, do, **kw), *A.flash_bwd_dkv(q, k, v, o, lse, do, **kw))
    for got in (fused, split, old_fused, old_split):
        for g, r in zip(got, ref):
            _close(g, r, _rel(dtype))
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


# the VAE decoder's shape classes (64^2 x 512, 128^2 x 512, 256^2 x 256, 512^2 x 256 -> 128 and 512^2 x 128: each
# tile shape of `conv3x3_w8a8_plan`), H != W with C != Co, C = 144 (a 128-channel slice zero-filled past C), and
# narrow ones
W8A8_SHAPES = [
    (1, 64, 64, 512, 512), (1, 128, 128, 512, 512), (1, 256, 256, 256, 256), (1, 512, 512, 256, 128),
    (1, 512, 512, 128, 128), (2, 33, 47, 64, 136), (3, 33, 47, 144, 136), (1, 128, 128, 256, 128), (1, 9, 7, 16, 8),
]


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("shape", W8A8_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_w8a8_kernel_matches_plain_bit_for_bit(cuda, with_bias, shape, dtype) -> None:
    """The int32 sums are exact and the epilogue rounds as PyTorch does: the
    route (quantiser and s8 wgmma kernel) and its plain version (f64 sums on
    the card) agree bit for bit; so does the mma.sync yardstick."""
    b, h, w, c, co = shape
    x = torch.randn((b, h, w, c), generator=cuda, device="cuda").to(dtype)
    wt = (torch.randn((co, 3, 3, c), generator=cuda, device="cuda") * (9 * c) ** -0.5).to(dtype)
    bias = (torch.randn((co,), generator=cuda, device="cuda") * 0.1).to(dtype) if with_bias else None
    before = C.conv3x3_w8a8.launches, C.quantize_w8a8.launches
    out = C.conv3x3_w8a8(x, wt, bias)
    assert (C.conv3x3_w8a8.launches, C.quantize_w8a8.launches) == (before[0] + 1, before[1] + 1)
    ref = C.conv3x3_w8a8_plain(x, wt, bias)
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(out, ref)
    assert torch.equal(C.conv3x3_w8a8(x, wt, bias, kernel="mma_sync"), ref)
    x8, w8, scale = C.w8a8_operands(x, wt)
    assert torch.equal(C.conv3x3_int8(x8, w8, scale, bias, dtype), C.conv3x3_int8_plain(x8, w8, scale, bias, dtype))
    # and close to the unquantised conv: a few per cent of its largest output
    exact = C.conv3x3_plain(x, wt, bias).float()
    assert (out.float() - exact).abs().max() <= 0.05 * exact.abs().max()


def _quant_cases(gen):
    """(name, x, w) edge cases of the quantiser, bf16 unless named fp16."""
    dev = "cuda"
    ties = torch.cat([torch.arange(-127, 127, device=dev) + 0.5, torch.tensor([127.0], device=dev)])
    ties = ties[torch.randperm(ties.numel(), generator=gen, device=dev)].repeat(16 * 3)[: 2 * 5 * 8 * 48]
    w = (torch.randn((24, 3, 3, 48), generator=gen, device=dev) * 0.1).bfloat16()
    last = torch.randn((1, 9, 10, 64), generator=gen, device=dev).bfloat16()
    last_neg = last.clone()
    last.view(-1)[-1], last_neg.view(-1)[-1] = 50.0, -50.0  # +-amax in the last element
    negzero = torch.randn((2, 8, 8, 32), generator=gen, device=dev).bfloat16()
    negzero.view(-1)[::3] = -0.0
    wz = torch.zeros((16, 3, 3, 32), device=dev).bfloat16()
    wz[1:, 0, 0, 0] = -0.0
    wz[3, 1, 1, 5] = 0.75  # one weight row with a value, the others all (negative) zero
    fp16 = (torch.randn((1, 64, 64, 128), generator=gen, device=dev) * 3).half()
    return [
        ("ties", ties.reshape(2, 5, 8, 48).bfloat16(), w),
        ("ties_fp16", ties.reshape(2, 5, 8, 48).half(), w.half()),
        ("zero_x", torch.zeros((1, 16, 16, 64), device=dev).bfloat16(), w[..., :8].repeat(1, 1, 1, 8)),
        ("amax_last", last, w[:, :, :, :1].repeat(1, 1, 1, 64)),
        ("neg_amax_last", last_neg, w[:, :, :, :1].repeat(1, 1, 1, 64)),
        ("negative_zero", negzero, wz),
        ("fp16", fp16, (torch.randn((128, 3, 3, 128), generator=gen, device=dev) * 0.05).half()),
        ("decoder_64x64_512", torch.randn((1, 64, 64, 512), generator=gen, device=dev).bfloat16(),
         (torch.randn((512, 3, 3, 512), generator=gen, device=dev) * 0.02).bfloat16()),
    ]


@pytest.mark.parametrize("case", range(8))
def test_quantize_w8a8_bit_for_bit(cuda, case) -> None:
    """The one-launch quantiser gives `w8a8_operands`' x8, w8 and combined
    scale bit for bit: exact ties (half to even), an all-zero x, +-amax in the
    last element, negative zeros, fp16."""
    name, x, w = _quant_cases(cuda)[case]
    before = C.quantize_w8a8.launches
    got = C.quantize_w8a8(x, w)
    assert C.quantize_w8a8.launches == before + 1
    want = C.w8a8_operands(x, w)
    for g, r, what in zip(got, want, ("x8", "w8", "scale")):
        assert g.dtype == r.dtype and g.shape == r.shape, (name, what)
        assert torch.equal(g, r), (name, what, (g.float() - r.float()).abs().max().item())
    assert torch.equal(C.quantize_w8a8(x, w)[0], got[0])  # no atomics: the same bits again


def test_w8a8_route_is_two_launches(cuda) -> None:
    """On the card `conv3x3_w8a8` runs the quantiser's launch and the conv's,
    and no other kernel (no PyTorch quantisation op), counted on both
    wrappers and by `torch.profiler`."""
    x = torch.randn((1, 64, 64, 512), generator=cuda, device="cuda").bfloat16()
    wt = (torch.randn((512, 3, 3, 512), generator=cuda, device="cuda") * 0.02).bfloat16()
    bias = torch.randn((512,), generator=cuda, device="cuda").bfloat16()
    with torch.no_grad():
        route = lambda: C.conv3x3_w8a8(x, wt, bias)  # noqa: E731
        before = C.conv3x3_w8a8.launches, C.quantize_w8a8.launches
        route()
        assert (C.conv3x3_w8a8.launches, C.quantize_w8a8.launches) == (before[0] + 1, before[1] + 1)
        names = _kernel_names(route)
        assert len(names) == 2, names
        assert sum("quantize_w8a8_kernel" in n for n in names) == 1, names
        assert sum("conv3x3_w8a8_kernel" in n for n in names) == 1, names


def test_w8a8_kernel_refuses_what_it_cannot_take(cuda) -> None:
    x = torch.randn((1, 8, 8, 72), generator=cuda, device="cuda").bfloat16()
    w = torch.randn((64, 3, 3, 72), generator=cuda, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="% 16"):
        C.conv3x3_w8a8(x, w)  # the quantiser takes C % 8 == 0, the s8 wgmma's TMA boxes C % 16 == 0
    with pytest.raises(ValueError, match="% 8"):
        C.quantize_w8a8(x[..., :68], w[..., :68])
    with pytest.raises(TypeError):
        C.quantize_w8a8(x.float(), w.float())
    x8, w8, scale = C.w8a8_operands(x[..., :64], w[..., :64])
    with pytest.raises(TypeError):
        C.conv3x3_int8(x8, w8, scale, None, torch.float32)
    with pytest.raises(ValueError, match="kernel"):
        C.conv3x3_int8(x8, w8, scale, None, torch.bfloat16, kernel="nope")
    big = C.W8A8_MAX_C + 16 - C.W8A8_MAX_C % 16  # the first C % 16 == 0 past the exact-sum limit
    with pytest.raises(ValueError, match="exact"):
        C.conv3x3_int8(torch.zeros((1, 2, 2, big), dtype=torch.int8, device="cuda"),
                       torch.zeros((8, 3, 3, big), dtype=torch.int8, device="cuda"),
                       torch.ones(8, device="cuda"), None, torch.bfloat16)
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


MARKER = "spin_kernel"  # `torch.cuda._sleep`'s kernel


def _kernel_names(fn, sessions: int = 5) -> list:
    """The names of the kernels that one call of `fn` launches on the card (torch.profiler), in order. The call
    runs between two marker kernels, each followed by a synchronize, and the kernels between the markers are
    its own. `torch.profiler` now and then loses the first kernel records of a session, or all of them (about
    one session in 300, with or without a CUDA graph in the process and with CUPTI's teardown off alike:
    `scripts/profiler_event_probe.py`); a session that lost a marker lost records, and the call is profiled
    again in a new session."""
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        marks = [i for i, name in enumerate(names) if MARKER in name]
        if len(marks) == 2:
            return names[marks[0] + 1 : marks[1]]
    raise AssertionError(f"torch.profiler lost the marker kernels in {sessions} sessions")


def _kernels_launched(fn, key: str) -> int:
    """How many kernels whose name holds `key` one call of `fn` launches on the card (torch.profiler)."""
    return sum(key in name for name in _kernel_names(fn))


# (shape, groups, dtype, route): the UNet's 64^2 x 960 at batch 2 and its 16^2 x 2560 (on chip), f32 and fp16 on
# chip, an unvectorised width, and the VAE decoder's 512^2 x 128 and the ae step's 256^2 x 128 (streamed)
GN_ROUTES = [
    ((2, 64, 64, 960), 32, torch.bfloat16, "on_chip"), ((2, 16, 16, 2560), 32, torch.bfloat16, "on_chip"),
    ((2, 32, 32, 320), 32, torch.float16, "on_chip"), ((2, 17, 13, 96), 32, torch.float32, "on_chip"),
    ((2, 9, 7, 36), 4, torch.float16, "on_chip"), ((1, 512, 512, 128), 32, torch.bfloat16, "streamed"),
    ((8, 256, 256, 128), 32, torch.bfloat16, "streamed"),
]


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,groups,dtype,route", GN_ROUTES)
def test_group_norm_one_launch_on_both_routes(cuda, silu, shape, groups, dtype, route) -> None:
    """One kernel launch per call on either route, within the limit of the plain version,
    the same bits on a second launch and from a CUDA-graph replay."""
    x = (torch.randn(shape, generator=cuda, device="cuda") * 2 + 0.5).to(dtype)
    w = (1 + 0.2 * torch.randn((shape[-1],), generator=cuda, device="cuda")).to(dtype)
    b = (0.2 * torch.randn((shape[-1],), generator=cuda, device="cuda")).to(dtype)
    kw = dict(num_groups=groups, apply_silu=silu)
    spatial = x.numel() // (shape[0] * shape[-1])
    assert G.gn_plan(shape[0], spatial, shape[-1], groups, x.element_size()).route == route
    before = G.group_norm_silu.launches
    out = G.group_norm_silu(x, w, b, **kw)
    assert G.group_norm_silu.launches == before + 1
    _close(out, G.group_norm_silu_plain(x, w, b, **kw), 2.0**-16 if dtype == torch.float32 else 2.0**-6)
    assert torch.equal(out, G.group_norm_silu(x, w, b, **kw))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = G.group_norm_silu(x, w, b, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, out)
    assert _kernels_launched(lambda: G.group_norm_silu(x, w, b, **kw), "gn_") == 1


def test_group_norm_slabs_yardstick_is_reachable(cuda) -> None:
    """`kernel="slabs"`: the previous design, three launches, the same function."""
    x = torch.randn((2, 32, 32, 640), generator=cuda, device="cuda").bfloat16()
    w, b = torch.ones(640, device="cuda"), torch.zeros(640, device="cuda")
    before = G.group_norm_silu.launches
    out = G.group_norm_silu(x, w, b, num_groups=32, apply_silu=True, kernel="slabs")
    assert G.group_norm_silu.launches == before + 1
    _close(out, G.group_norm_silu_plain(x, w, b, num_groups=32, apply_silu=True), 2.0**-6)
    slabs = lambda: G.group_norm_silu(x, w, b, num_groups=32, apply_silu=True, kernel="slabs")  # noqa: E731
    assert _kernels_launched(slabs, "gn_") == 3
    with pytest.raises(ValueError):
        G.group_norm_silu(x, w, b, num_groups=32, kernel="nope")


# the VAE decoder's conv shapes at 512px (batch 1), and C % 64 != 0 (40 and 72 channels: each dj tap padded to a
# 64-channel slice on its own) on both x-box layouts (2 x 64 and 1 x 128 pixels)
FOLD_SHAPES = [
    (1, 64, 64, 512, 512), (1, 128, 128, 512, 512), (1, 256, 256, 512, 512), (1, 256, 256, 512, 256),
    (1, 256, 256, 256, 256), (1, 512, 512, 256, 256), (1, 512, 512, 256, 128), (1, 512, 512, 128, 128),
    (2, 33, 47, 40, 24), (1, 130, 260, 72, 136),
]


@pytest.mark.parametrize("shape", FOLD_SHAPES)
def test_fold_wgmma_kernel_and_its_yardstick_match_plain(cuda, shape) -> None:
    b, h, w, c, co = shape
    x = torch.randn((b, h, w, c), generator=cuda, device="cuda").bfloat16()
    wt = (torch.randn((co, 3, 3, c), generator=cuda, device="cuda") * (9 * c) ** -0.5).bfloat16()
    bias = (torch.randn((co,), generator=cuda, device="cuda") * 0.1).bfloat16()
    assert C.conv3x3_fold_plan(b, h, w, c, co).kernel == "sm90"
    ref = C.conv3x3_fold_plain(x, wt, bias)
    before = C.conv3x3_fold.launches
    out = C.conv3x3_fold(x, wt, bias)
    old = C.conv3x3_fold(x, wt, bias, kernel="mma_sync")
    assert C.conv3x3_fold.launches == before + 2
    _close(out, ref, 2.0**-6)
    _close(old, ref, 2.0**-6)
    assert torch.equal(out, C.conv3x3_fold(x, wt, bias))  # no atomics: the same bits again
    assert _kernels_launched(lambda: C.conv3x3_fold(x, wt, bias), "conv3x3_fold_kernel") == 1
    with pytest.raises(ValueError):
        C.conv3x3_fold(x, wt, bias, kernel="nope")


# the VQ latent-diffusion family's new kernel shapes (batch 1): flash at d = 32, 64, 96 and 128 from the
# multi-head attention's strided (per-head interleaved) q / k / v, the conv at C = 224, 448 and 672 (not all
# multiples of the 64-channel box), GroupNorm at 7 and 21 channels a group
VQ_FLASH = [(1, 14, 4096, 32), (1, 8, 1024, 64), (1, 8, 256, 96), (1, 8, 1024, 128)]


@pytest.mark.parametrize("shape", VQ_FLASH)
def test_flash_kernel_on_interleaved_qkv(cuda, shape) -> None:
    b, h, l, d = shape
    qkv = torch.randn((b, l, h, 3 * d), generator=cuda, device="cuda").bfloat16().transpose(1, 2)
    q, k, v = qkv.chunk(3, dim=-1)
    assert A.flash_plan(b, h, l, l, d, torch.bfloat16).kernel == "sm90"
    before = A.flash_attention.launches
    out = A.flash_attention(q, k, v)
    assert A.flash_attention.launches == before + 1
    ref = A.flash_attention_plain(q, k, v)
    _close(out, ref, 2.0**-6)


@pytest.mark.parametrize("shape", [(1, 128, 128, 224, 224), (1, 128, 128, 672, 224), (1, 128, 128, 448, 448),
                                   (1, 128, 128, 640, 128)])
def test_conv_kernel_at_the_sr_unet_widths(cuda, shape) -> None:
    b, h, w, c, co = shape
    x = torch.randn((b, h, w, c), generator=cuda, device="cuda").bfloat16()
    wt = (torch.randn((co, 3, 3, c), generator=cuda, device="cuda") * (9 * c) ** -0.5).bfloat16()
    bias = (torch.randn((co,), generator=cuda, device="cuda") * 0.1).bfloat16()
    out = C.conv3x3(x, wt, bias)
    _close(out, C.conv3x3_plain(x, wt, bias), 2.0**-6)
    assert torch.equal(out, C.conv3x3(x, wt, bias))


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", [(1, 128, 128, 224), (1, 16, 16, 672), (1, 32, 32, 1568)])
def test_group_norm_kernel_at_odd_group_widths(cuda, silu, shape) -> None:
    x = (torch.randn(shape, generator=cuda, device="cuda") * 2 + 0.5).bfloat16()
    w = (1 + 0.2 * torch.randn((shape[-1],), generator=cuda, device="cuda")).bfloat16()
    b = (0.2 * torch.randn((shape[-1],), generator=cuda, device="cuda")).bfloat16()
    out = G.group_norm_silu(x, w, b, num_groups=32, apply_silu=silu)
    _close(out, G.group_norm_silu_plain(x, w, b, num_groups=32, apply_silu=silu), 2.0**-6)


def test_multi_head_spatial_attention_on_the_card(cuda) -> None:
    """The module on the card (GroupNorm and flash kernels, strided q / k / v) against the same module on the CPU
    (the plain versions), both in f32 parameters with bf16 activations on the card."""
    from cflearn_torch.modules.common import init_parameters
    from cflearn_torch.modules.core.attentions import MultiHeadSpatialAttention

    cpu = init_parameters(MultiHeadSpatialAttention(256, num_heads=8), seed=0)
    for p in cpu.to_out.parameters():
        p.data.normal_(0, 0.05, generator=torch.Generator().manual_seed(1))
    card = MultiHeadSpatialAttention(256, num_heads=8).cuda()
    card.load_state_dict(cpu.state_dict())
    card.bfloat16()
    x = torch.randn((1, 32, 32, 256), generator=torch.Generator().manual_seed(2)).bfloat16()
    with torch.no_grad():
        before = A.flash_attention.launches
        out = card(x.cuda())
        assert A.flash_attention.launches == before + 1
        ref = cpu.bfloat16()(x)
    _close(out.cpu(), ref, 2.0**-5)


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_at_the_clip_tower_shapes(cuda, d, dtype) -> None:
    """CLIP's /14 vision towers at 224px: 257 tokens (a ragged q and kv tail of one row), 16 heads of 64
    (ViT-L/14) and 80 (ViT-H/14), q / k / v as transposed views of the projections' (B, L, H, D) storage. f32
    (the APIs' images) takes the chunked mma.sync kernel, bf16 the wgmma kernel."""
    shape = (4, 16, 257, 257, d)
    q, k, v = _fwd_inputs(cuda, shape, dtype, "blhd")
    plan = A.flash_plan(*shape, dtype, torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.kernel == _expected_kernel(shape, dtype)
    before = A.flash_attention.launches
    out = A.flash_attention(q, k, v)
    assert A.flash_attention.launches == before + 1
    _close(out, A.flash_attention_plain(q, k, v), _rel(dtype))
    assert torch.equal(out, A.flash_attention(q, k, v))


@pytest.mark.parametrize("shape", [(2, 8, 4096, 8192, 40), (2, 8, 1024, 2048, 80), (2, 8, 256, 512, 160)])
def test_flash_kernel_at_the_style_reference_shapes(cuda, shape) -> None:
    """Style reference's READ pass at SD-1.5 512px (CFG batch 2, 8 heads): the self-attention's keys are
    [self, reference], kv = 2 q, as transposed views of the projections' (B, L, H, D) storage."""
    q, k, v = _fwd_inputs(cuda, shape, torch.bfloat16, "blhd")
    before = A.flash_attention.launches
    out = A.flash_attention(q, k, v)
    assert A.flash_attention.launches == before + 1
    _close(out, A.flash_attention_plain(q, k, v), _rel(torch.bfloat16))


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable", "everything_saveable"])
def test_kernel_ops_under_selective_checkpointing(cuda, policy) -> None:
    """The kernels' forwards as operations of the dispatcher (`flash_fwd_lse_op`, `group_norm_silu_op`):
    forward and backward against the plain versions, and launched again in the backward unless the
    policy keeps their outputs (`everything_saveable`)."""
    from torch.utils.checkpoint import checkpoint

    from cflearn_torch.toolkit.misc import checkpoint_context_fn

    q, k, v, do = _train_inputs(cuda, (2, 4, 512, 512, 64), torch.bfloat16)
    x = torch.randn((2, 16, 16, 256), generator=cuda, device="cuda").bfloat16()
    w = torch.linspace(0.5, 1.5, 256, device="cuda")
    b = torch.linspace(-0.2, 0.2, 256, device="cuda")
    leaves = [t.detach().requires_grad_() for t in (q, k, v, x, w, b)]

    def block(q_, k_, v_, x_, w_, b_):
        y = G.FusedGroupNorm.apply(x_, w_, b_, 32, 1e-6, True)
        return A.sdp_attn(q_, k_, v_), y

    counts = (A.flash_fwd_lse.launches, G.group_norm_silu.launches)
    o, y = checkpoint(block, *leaves, use_reentrant=False, context_fn=checkpoint_context_fn(policy))
    grads = torch.autograd.grad((o, y), leaves, (do, torch.ones_like(y)))
    again = 1 if policy == "everything_saveable" else 2
    assert (A.flash_fwd_lse.launches - counts[0], G.group_norm_silu.launches - counts[1]) == (again, again)
    # the operations alone, against the plain versions
    o_op, lse_op = A.flash_fwd_lse_op(q, k, v, False, None)
    o_ref, lse_ref = A.flash_fwd_with_lse_plain(q, k, v)
    _close(o_op, o_ref, _rel(torch.bfloat16))
    torch.testing.assert_close(lse_op, lse_ref, atol=1e-3, rtol=0)
    _close(G.group_norm_silu_op(x, w, b, 32, 1e-6, True), G.group_norm_silu_plain(x, w, b, num_groups=32,
                                                                                  apply_silu=True), 2.0**-6)
    _close(o, o_ref, _rel(torch.bfloat16))
    for got, r in zip(grads[:3], A.flash_bwd_plain(q, k, v, o_ref, lse_ref, do)):
        _close(got, r, _rel(torch.bfloat16))
    xr, wr, br = (t.detach().float().requires_grad_() for t in (x, w, b))
    ref = torch.autograd.grad(G.group_norm_silu_plain(xr, wr, br, num_groups=32, apply_silu=True), (xr, wr, br),
                              torch.ones_like(y).float())
    for got, r in zip(grads[3:], ref):
        _close(got.float(), r, 2.0**-6)


def test_fit_array_on_the_card(cuda, tmp_path, monkeypatch) -> None:
    """A 2-step `fit_array` of a small ViT on the card (64 px in patches of 4: 257 tokens, so that its attention
    takes the kernels): one `flash_fwd_lse` and one `flash_bwd_fused` a layer a step, one `flash_attention` a layer
    a validation batch, counted from the run's steps and batches; finite losses; the saved pipeline loaded on the
    card predicts bit for bit what the trained one predicts."""
    import numpy as np

    import cflearn_torch
    from cflearn_torch.inference import DLInference

    batches = []
    run_eval = DLInference._eval
    monkeypatch.setattr(DLInference, "_eval", lambda self, *a, **k: batches.append(1) or run_eval(self, *a, **k))
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (24, 64, 64, 3)).astype(np.float32)
    y = rs.randint(0, 5, (24, 1))
    config = cflearn_torch.DLConfig(
        model="common", module_name="clf", loss_name="cross_entropy", module_config=dict(
            img_size=64, in_channels=3, num_classes=5, encoder="vit", latent_dim=32,
            encoder_config=dict(patch_size=4, num_layers=2, num_heads=2)),
        workspace=str(tmp_path), fixed_steps=2, min_num_sample=0, metric_names="acc", callback_names=[],
    )
    data = cflearn_torch.DataConfig()
    data.batch_size = data.valid_batch_size = 8
    names = ("flash_attention", "flash_fwd_lse", "flash_bwd_fused")
    for name in names:
        getattr(A, name).launches = 0
    p = cflearn_torch.fit_array(x[:16], y[:16], x[16:], y[16:], config=config, data_config=data)
    torch.cuda.synchronize()
    steps = p.trainer.state.step
    assert steps == 2 and next(p.model.parameters()).is_cuda
    assert {n: getattr(A, n).launches for n in names} == {
        "flash_attention": 2 * len(batches), "flash_fwd_lse": 2 * steps, "flash_bwd_fused": 2 * steps}
    assert batches and all(np.isfinite(v) for v in p.trainer.final_results.metric_values.values())
    loaded = cflearn_torch.load_inference(cflearn_torch.save(p, str(tmp_path / "saved")))
    assert np.array_equal(loaded.predict(x[16:])["predictions"], p.predict(x[16:])["predictions"])


# the tabular transformer at its defaults: 8 heads of 16 in f32 over the feature tokens and the head token (MNIST's
# 784 columns: 785 tokens), and a ragged 300 x 257 case
TAB_SHAPES = [(8, 8, 785, 785, 16), (2, 8, 300, 257, 16)]


@pytest.mark.parametrize("row", ["flash_attention", "flash_fwd_lse", "flash_bwd_fused"])
@pytest.mark.parametrize("shape", TAB_SHAPES)
def test_flash_kernels_at_the_tabular_head_dim(cuda, row, shape) -> None:
    """Rows 1, 3 and 4 at d = 16 in f32 (the chunked mma.sync kernels: one chunk, its columns past 16 zero),
    q / k / v as transposed views of the projection's (B, L, H, D) storage, against the plain versions, one
    launch a call."""
    q, k, v = _fwd_inputs(cuda, shape, torch.float32, "blhd")
    b, h, lq, lk, d = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert A.flash_plan(b, h, lq, lk, d, torch.float32, sms).kernel == "mma_sync_chunked"
    fn = getattr(A, row)
    before = fn.launches
    if row == "flash_attention":
        _close(A.flash_attention(q, k, v), A.flash_attention_plain(q, k, v), _rel(torch.float32))
    elif row == "flash_fwd_lse":
        o, lse = A.flash_fwd_lse(q, k, v)
        ref_o, ref_lse = A.flash_fwd_with_lse_plain(q, k, v)
        _close(o, ref_o, _rel(torch.float32))
        assert (lse - ref_lse).abs().max() <= 4e-3
    else:
        _, _, _, do = _train_inputs(cuda, shape, torch.float32)
        o, lse = A.flash_fwd_with_lse_plain(q, k, v)
        for got, ref in zip(A.flash_bwd_fused(q, k, v, o, lse, do), A.flash_bwd_plain(q, k, v, o, lse, do)):
            _close(got, ref, _rel(torch.float32))
    assert fn.launches == before + 1


def test_fit_ml_transformer_on_the_card(cuda, tmp_path, monkeypatch) -> None:
    """A 2-step `fit_ml` of a one-layer tabular transformer on a 300-column table (301 tokens with the head
    token, so its attention takes the kernels at d = 16): one `flash_fwd_lse` and one `flash_bwd_fused` a step,
    one `flash_attention` a validation or predict batch; finite losses; the saved pipeline loaded on the card
    predicts bit for bit what the trained one predicts."""
    import numpy as np

    import cflearn_torch
    from cflearn_torch.inference import DLInference

    batches = []
    run_eval = DLInference._eval
    monkeypatch.setattr(DLInference, "_eval", lambda self, *a, **k: batches.append(1) or run_eval(self, *a, **k))
    rs = np.random.RandomState(0)
    x = rs.randn(64, 300).astype(np.float32)
    y = (x[:, :3].sum(1) > 0).astype(np.int64)[:, None]
    config = cflearn_torch.MLConfig(module_name="transformer", module_config={"num_layers": 1},
                                    workspace=str(tmp_path), fixed_steps=2, min_num_sample=0, callback_names=[])
    data = cflearn_torch.DataConfig()
    data.batch_size = data.valid_batch_size = 16
    names = ("flash_attention", "flash_fwd_lse", "flash_bwd_fused")
    for name in names:
        getattr(A, name).launches = 0
    p = cflearn_torch.fit_ml(x, y, config=config, data_config=data)
    torch.cuda.synchronize()
    steps = p.trainer.state.step
    assert steps == 2 and next(p.model.parameters()).is_cuda
    assert {n: getattr(A, n).launches for n in names} == {
        "flash_attention": len(batches), "flash_fwd_lse": steps, "flash_bwd_fused": steps}
    assert all(np.isfinite(v) for v in p.trainer.final_results.metric_values.values())
    loaded = cflearn_torch.load_inference(cflearn_torch.save(p, str(tmp_path / "saved")))
    assert np.array_equal(loaded.predict(x[:20])["predictions"], p.predict(x[:20])["predictions"])


def _small_vit(cuda_device: str = "cuda"):
    import cflearn_torch

    return cflearn_torch.IDLModel.from_config(cflearn_torch.DLConfig(
        model="common", module_name="clf", loss_name="cross_entropy", module_config=dict(
            img_size=64, in_channels=3, num_classes=5, encoder="vit", latent_dim=32,
            encoder_config=dict(patch_size=4, num_layers=2, num_heads=2))), device=cuda_device)


def _launches():
    from cflearn_torch.ops import launch_counts

    return launch_counts()


def _moved(before):
    return {k: v - before[k] for k, v in _launches().items() if v != before[k]}


@pytest.mark.parametrize("model", ["vit", "ae_kl"])
def test_export_carries_the_kernel_operations(cuda, tmp_path, model) -> None:
    """`export_model` -> `load_exported` on the card: a small ViT (257 tokens: the flash operation) and a small
    `ae_kl` in bf16 at 128 px (64 channels at 128^2: the conv; GroupNorm; the 32^2 mid-block attention), its
    posterior's mode. The program holds one kernel operation node for each launch of the eager forward, one
    call of it launches the same kernels, and its outputs are the eager forward's bit for bit."""
    import cflearn_torch
    from cflearn_torch.pipeline.export import KERNEL_OPS

    if model == "vit":
        m, kwargs = _small_vit(), {}
        batch = {"input": torch.rand((4, 64, 64, 3), generator=cuda, device="cuda") * 2 - 1}
    else:
        m = cflearn_torch.build_ae(dict(img_size=128, inner_channels=64, channel_multipliers=[1, 2, 2],
                                        num_res_blocks=1, use_perceptual=False), device="cuda", dtype=torch.bfloat16)
        kwargs = {"sample": False}
        batch = {"input": (torch.rand((2, 128, 128, 3), generator=cuda, device="cuda") * 2 - 1).bfloat16()}
    before = _launches()
    with torch.no_grad():
        eager = m.run(batch, training=False, **kwargs)["predictions"]
    torch.cuda.synchronize()
    eager_launches = _moved(before)
    exported = cflearn_torch.load_exported(
        cflearn_torch.export_model(m, batch, str(tmp_path), forward_kwargs=kwargs), device="cuda")
    before = _launches()
    out = exported(batch)["predictions"]
    torch.cuda.synchronize()
    assert _moved(before) == eager_launches
    assert {KERNEL_OPS[k]: v for k, v in exported.op_counts().items()} == eager_launches
    want = {"flash_attention"} if model == "vit" else {"flash_attention", "conv3x3", "group_norm"}
    assert set(eager_launches) == want
    assert torch.equal(out, eager)


def test_aot_compile_replays_the_forward(cuda) -> None:
    """`aot_compile` of a small ViT on the card: the capture launches what the eager forward launches, a replay
    moves no counter (launches = captures x replays), and every replay gives the eager forward bit for bit, on
    new inputs too."""
    import cflearn_torch

    m = _small_vit()
    x1 = torch.rand((4, 64, 64, 3), generator=cuda, device="cuda")
    x2 = torch.rand((4, 64, 64, 3), generator=cuda, device="cuda")
    before = _launches()
    with torch.no_grad():
        eager = [m.run({"input": x}, training=False)["predictions"] for x in (x1, x2)]
    torch.cuda.synchronize()
    per_forward = {k: v // 2 for k, v in _moved(before).items()}
    compiled = cflearn_torch.aot_compile(m, {"input": x1})
    assert compiled.graph is not None and compiled.launches_per_replay == per_forward == {"flash_attention": 2}
    before = _launches()
    for _ in range(2):
        for x, ref in zip((x1, x2), eager):
            assert torch.equal(compiled({"input": x})["predictions"], ref)
    torch.cuda.synchronize()
    assert _moved(before) == {} and compiled.replays == 4


def test_aot_compile_refuses_another_batch(cuda) -> None:
    """A capture at batch 4 refuses a batch of 1, and f16 in place of f32, with a `TypeError` before anything is
    copied: the graph does not replay and its static input keeps the captured batch (a plain `copy_` would
    broadcast the one sample over four rows, or cast)."""
    import cflearn_torch

    m = _small_vit()
    x = torch.rand((4, 64, 64, 3), generator=cuda, device="cuda")
    compiled = cflearn_torch.aot_compile(m, {"input": x})
    kept = compiled.static_inputs["input"].clone()
    for bad in (x[:1], x.half()):
        with pytest.raises(TypeError, match="captured for shape"):
            compiled({"input": bad})
    torch.cuda.synchronize()
    assert compiled.replays == 0 and torch.equal(compiled.static_inputs["input"], kept)
    assert compiled({"input": x})["predictions"].shape == (4, 5) and compiled.replays == 1


@pytest.mark.parametrize("sampler,deepcache", [("ddim", 2), ("plms", None)])
def test_diffusion_compile_replays_bit_for_bit(cuda, sampler, deepcache) -> None:
    """`DiffusionAPI.compile` on a small LDM on the card (`__graft_entry__.py`'s widths, 64 px images): the
    compiled txt2img is the eager one bit for bit, a replay moves no counter, and the counters plus the graphs'
    launches per replay x replays equal the eager run's launches (with DeepCache, a full and a shallow graph)."""
    import numpy as np

    import cflearn_torch
    from cflearn_torch.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel

    m = cflearn_torch.build(
        cflearn_torch.LDM, device="cuda", img_size=8, in_channels=4, out_channels=4, num_timesteps=50,
        condition_model=CLIPTextConditionModel(latent_dim=32, num_layers=2, num_heads=2),
        unet_config=dict(start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2),
                         attention_downsample_rates=(1,), num_heads=4, context_dim=32),
        first_stage_config=dict(img_size=64, inner_channels=32, z_channels=4, embedding_channels=4,
                                channel_multipliers=[1, 2, 2, 2], num_res_blocks=1),
    )
    api = cflearn_torch.DiffusionAPI(m, device="cuda")
    api.switch_sampler(sampler)
    api.set_deepcache(deepcache, cut=1)
    kw = dict(size=(64, 64), num_steps=4, guidance_scale=5.0, seed=3)
    api.txt2img("a red cube", **kw)
    before = _launches()
    eager = api.txt2img("a red cube", **kw)
    torch.cuda.synchronize()
    eager_launches = _moved(before)
    api.compile(num_samples=1, size=(64, 64), num_steps=4)
    assert len(api._graphs) == (2 if deepcache else 1)
    graphs_before, before = api.graph_launches(), _launches()
    compiled = api.txt2img("a red cube", **kw)
    torch.cuda.synchronize()
    counted = _moved(before)
    replayed = {k: n - graphs_before.get(k, 0) for k, n in api.graph_launches().items()}
    total = {k: counted.get(k, 0) + replayed.get(k, 0) for k in set(counted) | set(replayed)}
    assert np.array_equal(compiled, eager)
    assert {k: v for k, v in total.items() if v} == eager_launches and replayed
