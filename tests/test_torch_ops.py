"""The port's ops (`cflearn_torch.ops`) against the JAX package's.

The JAX Pallas kernels run in interpret mode on the CPU (the module
attribute is patched, as the JAX kernel tests do); the port's CPU path is
each kernel's plain PyTorch version. Everything runs in f32, so the
tolerances only cover a different summation order (online softmax over
kv blocks vs one pass; 9 tap matmuls in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from cflearn_torch.ops import attention as TA
from cflearn_torch.ops import conv as TC
from cflearn_torch.ops.group_norm import group_norm
from cflearn_tpu.ops import attention as A
from cflearn_tpu.ops import conv as C


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(A, "_INTERPRET", True)
    monkeypatch.setattr(C, "_INTERPRET", True)


def _qkv(shape, kv_len=None, seed=0):
    rng = np.random.RandomState(seed)
    b, h, l, d = shape
    kv = kv_len or l
    return (
        rng.randn(b, h, l, d).astype(np.float32),
        rng.randn(b, h, kv, d).astype(np.float32),
        rng.randn(b, h, kv, d).astype(np.float32),
    )


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [256, 300])
@pytest.mark.parametrize("d", [16, 40])
def test_flash_plain_matches_pallas(interpret, causal, seq, d) -> None:
    q, k, v = _qkv((1, 2, seq, d))
    ref = A.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, block_q=128, block_k=128)
    got = TA.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_flash_plain_ragged_kv_matches_pallas(interpret) -> None:
    q, k, v = _qkv((2, 2, 256, 16), kv_len=300, seed=1)
    ref = A.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128)
    got = TA.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_xla_attention_matches() -> None:
    """The library branch (short kv: SD cross-attention at kv = 77)."""
    q, k, v = _qkv((2, 4, 64, 16), kv_len=77, seed=2)
    ref = A.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=0.3)
    got = TA.xla_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("q_len,kv_len", [(64, 128), (128, 64)])
def test_xla_attention_causal_is_top_left_when_lengths_differ(q_len, kv_len) -> None:
    """Causal with Lq != Lk: query i sees keys 0..i, as `jax.nn.dot_product_attention` aligns the mask. With
    Lq > Lk a bottom-right mask (FlashAttention-2's) would leave the first Lq - Lk rows no key at all."""
    q, k, v = _qkv((1, 2, q_len, 16), kv_len=kv_len, seed=3)
    ref = A.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = TA.xla_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


# (q shape, kv length, causal, dtype, whether FlashAttention-2 by name computes what SDPA does): SD's
# cross-attentions and CLIP's square causal self-attention go to it; a causal call with Lq != Lk, f32, a head
# dim it does not take, a head count that differs and a strided head dim stay with SDPA
LIBRARY_FLASH_CASES = [
    ((2, 8, 64, 40), 77, False, torch.bfloat16, True),
    ((2, 8, 64, 80), 77, False, torch.float16, True),
    ((2, 8, 64, 160), 77, False, torch.bfloat16, True),
    ((1, 12, 77, 64), 77, True, torch.bfloat16, True),
    ((1, 2, 64, 64), 128, True, torch.bfloat16, False),
    ((1, 2, 128, 64), 64, True, torch.bfloat16, False),
    ((1, 2, 128, 64), 64, False, torch.bfloat16, True),
    ((2, 8, 64, 40), 77, False, torch.float32, False),
    ((1, 2, 64, 12), 77, False, torch.bfloat16, False),
    ((1, 2, 64, 264), 77, False, torch.bfloat16, False),
]


@pytest.mark.parametrize("shape,kv_len,causal,dtype,takes", LIBRARY_FLASH_CASES)
def test_library_flash_route_only_where_it_matches_sdpa(shape, kv_len, causal, dtype, takes) -> None:
    b, h, lq, d = shape
    q = torch.zeros((b, h, lq, d), dtype=dtype)
    k, v = (torch.zeros((b, h, kv_len, d), dtype=dtype) for _ in range(2))
    assert TA.library_flash_takes(q, k, v, causal) is takes
    if takes:
        assert not TA.library_flash_takes(q, k[:, :1], v[:, :1], causal)  # another head count
        strided = torch.zeros((b, h, kv_len, 2 * d), dtype=dtype)[..., ::2]
        assert not TA.library_flash_takes(q, strided, v, causal)


ATTN_SHAPES = [
    # (q_len, kv_len, head dim): SD self-attn at 64/32/16/8 latents, cross-attn,
    # the VAE mid-block, and each edge of the predicate
    (4096, 4096, 40), (1024, 1024, 80), (256, 256, 160), (64, 64, 160), (4096, 77, 40),
    (4096, 4096, 512), (128, 256, 64), (127, 256, 64), (128, 255, 64), (77, 77, 64),
    (256, 256, 1024), (256, 256, 1025),
]


@pytest.mark.parametrize("q_len,kv_len,d", ATTN_SHAPES)
def test_sdp_attn_routing_matches(interpret, q_len, kv_len, d) -> None:
    q = jax.ShapeDtypeStruct((2, 8, q_len, d), jnp.bfloat16)
    k = jax.ShapeDtypeStruct((2, 8, kv_len, d), jnp.bfloat16)
    tq = torch.empty((2, 8, q_len, d), dtype=torch.bfloat16, device="meta")
    tk = torch.empty((2, 8, kv_len, d), dtype=torch.bfloat16, device="meta")
    assert TA.use_kernel(tq, tk) == A._use_pallas(q, k)


@pytest.mark.parametrize(
    "shape,co",
    [((2, 8, 8, 128), 128), ((1, 16, 16, 256), 512), ((1, 12, 20, 64), 192)],
)
def test_conv3x3_plain_matches_pallas(interpret, shape, co) -> None:
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[-1], co) * 0.05).astype(np.float32)
    b = (rng.randn(co) * 0.1).astype(np.float32)
    ref = C.conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = TC.conv3x3(torch.from_numpy(x), TC.kernel_weight(w_oihw), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)


CONV_CASES = [
    # (h, w, c, co, kernel, stride, padding): SD VAE decoder, SD UNet, edges
    (64, 64, 512, 512, 3, 1, "SAME"),
    (128, 128, 512, 512, 3, 1, "SAME"),
    (256, 256, 512, 256, 3, 1, "SAME"),
    (256, 256, 256, 256, 3, 1, "SAME"),
    (512, 512, 256, 128, 3, 1, "SAME"),
    (512, 512, 128, 128, 3, 1, "SAME"),
    (512, 512, 128, 3, 3, 1, "SAME"),
    (64, 64, 4, 512, 3, 1, "SAME"),
    (64, 64, 512, 256, 3, 1, "SAME"),
    (64, 64, 320, 320, 3, 1, "SAME"),
    (32, 32, 640, 640, 3, 1, "SAME"),
    (16, 16, 1280, 1280, 3, 1, "SAME"),
    (64, 64, 960, 320, 3, 1, "SAME"),
    (64, 64, 320, 320, 3, 2, ((1, 1), (1, 1))),
    (128, 128, 256, 256, 3, 1, ((1, 1), (1, 1))),
    (128, 128, 256, 256, 3, 1, "VALID"),
    (128, 128, 512, 256, 1, 1, "SAME"),
    (128, 128, 32, 256, 3, 1, "SAME"),
]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("h,w,c,co,ks,stride,padding", CONV_CASES)
def test_conv_routing_matches(interpret, dtype, h, w, c, co, ks, stride, padding) -> None:
    x = jax.ShapeDtypeStruct((1, h, w, c), jnp.dtype(dtype))
    kern = jax.ShapeDtypeStruct((ks, ks, c, co), jnp.dtype(dtype))
    tdt = getattr(torch, dtype)
    tx = torch.empty((1, h, w, c), dtype=tdt, device="meta")
    tw = torch.empty((co, c, ks, ks), dtype=tdt, device="meta")
    expected = C.use_pallas_conv(x, kern, (stride, stride), padding)
    assert TC.use_kernel_conv(tx, tw, (stride, stride), padding) == expected


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_matches_nnx(silu) -> None:
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 8, 8, 64) * 3 + 1).astype(np.float32)
    gn = nnx.GroupNorm(64, num_groups=32, epsilon=1e-6, rngs=nnx.Rngs(0))
    scale = rng.randn(64).astype(np.float32)
    bias = rng.randn(64).astype(np.float32)
    gn.scale[...] = jnp.asarray(scale)
    gn.bias[...] = jnp.asarray(bias)
    ref = gn(jnp.asarray(x))
    if silu:
        ref = jax.nn.silu(ref)
    got = group_norm(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), num_groups=32, eps=1e-6, apply_silu=silu
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("l,d", [(4096, 40), (1024, 80), (256, 160), (4096, 512)])
def test_flash_tolerance_catches_faults(l, d) -> None:
    """`chip_smoke.py` holds the flash kernel to FLASH_REL * max|ref| in bf16.
    At each main-path (L, d), with its N(0, 1) inputs, a kernel that skipped
    the first or last kv block (64 keys) or rescaled its output by 3% must
    exceed that limit."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 1, l, d), generator=g).bfloat16() for _ in range(3))
    ref = TA.flash_attention_plain(q, k, v).float()
    tol = smoke.FLASH_REL * ref.abs().max().item()
    faults = {
        "skip_last_kv_block": TA.flash_attention_plain(q, k[:, :, :-64], v[:, :, :-64]),
        "skip_first_kv_block": TA.flash_attention_plain(q, k[:, :, 64:], v[:, :, 64:]),
        "rescale_3pct": (ref * 1.03).bfloat16(),
    }
    for name, out in faults.items():
        err = (out.float() - ref).abs().max().item()
        assert err > tol, f"{name}: err {err} within tolerance {tol}"
