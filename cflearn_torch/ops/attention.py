"""Attention ops: the flash-attention CUDA kernel and the dispatcher.

Counterpart of `cflearn_tpu/ops/attention.py`:

* `flash_attention` — wrapper of the hand-written Hopper kernel
  (`csrc/flash_attention.cu`), which replaces the TPU's `_flash_kernel`. On
  a CPU tensor it runs `flash_attention_plain`, the same arithmetic in plain
  PyTorch; on a CUDA tensor it launches the kernel or raises.
* `xla_attention` — what the JAX package leaves to XLA (masks, biases, short
  kv such as SD cross-attention at kv = 77); here
  `F.scaled_dot_product_attention`.
* `sdp_attn` — the dispatcher, with the JAX package's `_use_pallas` shape
  predicate.

Layout is (B, H, L, D) throughout. The ring-attention branch and the
trainable (custom-VJP) kernels belong to later slices.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _native

_NEG_INF = -1.0e30
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}
MAX_HEAD_DIM = 512


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 scores, masked entries at
    -1e30 (causal: k > q), P cast to the value dtype before P.V with f32
    accumulation, output acc / max(l, 1e-30)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        q_pos = torch.arange(q.shape[-2], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[-2], device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """A (B, H, L, D) view the kernel can read: contiguous D, B/H/L strides
    and base address 16-byte aligned; otherwise a contiguous copy."""
    ok = (
        t.stride(-1) == 1
        and all(s % 8 == 0 for s in t.stride()[:-1])
        and t.data_ptr() % 16 == 0
    )
    return t if ok else t.contiguous()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention forward. q: (B, H, Lq, D), k/v: (B, H, Lk, D) ->
    (B, H, Lq, D). CPU tensors take the plain version; CUDA tensors launch
    the kernel (bf16 / fp16, D % 8 == 0, D <= 512) or raise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    b, h, q_len, d = q.shape
    kv_len = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes bf16/fp16 q, k, v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, h, kv_len, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if d % 8 != 0 or d > MAX_HEAD_DIM or q_len == 0 or kv_len == 0:
        raise ValueError(f"flash_attention kernel takes 8 | D <= {MAX_HEAD_DIM} and non-empty L; got {tuple(q.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    # (B, Lq, H, D) storage: merging heads afterwards is a free view
    out = torch.empty((b, q_len, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    fn = _native.library("flash_attention")
    err = fn(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, h, q_len, kv_len, d, int(causal), scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _native.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused library attention for the shapes the JAX package leaves to XLA.
    `mask` is boolean (True = keep), `bias` an additive logits bias, both
    broadcastable to (B, H, Lq, Lk)."""
    attn_mask = None
    if mask is not None or bias is not None:
        if causal:
            lq, lk = q.shape[-2], k.shape[-2]
            tri = torch.ones((lq, lk), dtype=torch.bool, device=q.device).tril()
            mask = tri if mask is None else torch.logical_and(mask, tri)
            causal = False
        if bias is None:
            attn_mask = mask
        else:
            attn_mask = bias.to(q.dtype)
            if mask is not None:
                attn_mask = attn_mask.masked_fill(~mask, float("-inf"))
    return F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, is_causal=causal, scale=sm_scale
    )


def use_kernel(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Shape predicate of the JAX package's `_use_pallas`: K/V stream block
    by block, so only the q block and head dim bound the kernel; short kv
    (SD cross-attention, kv = 77) stays on the library path."""
    return q.shape[2] >= 128 and k.shape[2] >= 256 and _round_up(q.shape[3], 128) <= 1024


def sdp_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled-dot-product attention dispatcher. (B, H, L, D) in and out."""
    if mask is None and bias is None and use_kernel(q, k):
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    return xla_attention(q, k, v, causal=causal, sm_scale=sm_scale, mask=mask, bias=bias)
