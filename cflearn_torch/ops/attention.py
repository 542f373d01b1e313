"""Attention ops: the flash-attention CUDA kernels and the dispatcher.

Counterpart of `cflearn_tpu/ops/attention.py`:

* `flash_attention` — wrapper of the hand-written Hopper forward kernel
  (`csrc/flash_attention.cu`), which replaces the TPU's `_flash_kernel`.
* `flash_fwd_lse` — the same forward that also returns the per-row
  logsumexp (`csrc/flash_fwd_lse.cu`, the TPU's `_flash_fwd_kernel`).
* `flash_bwd_fused`, `flash_bwd_dq`, `flash_bwd_dkv` — the backward kernels
  (`csrc/flash_bwd_*.cu`; the TPU's `_flash_bwd_fused_kernel`,
  `_flash_bwd_dq_kernel`, `_flash_bwd_dkv_kernel`).
* `flash_attention_trainable` — the `torch.autograd.Function` over them
  (the JAX package's custom VJP of the same name).
* `xla_attention` — what the JAX package leaves to XLA (masks, biases, short
  kv such as SD cross-attention at kv = 77); here
  `F.scaled_dot_product_attention`.
* `sdp_attn` — the dispatcher, with the JAX package's `_use_pallas` shape
  predicate.

Every kernel wrapper runs its plain PyTorch version (`*_plain`, the same
arithmetic) on a CPU tensor; on a CUDA tensor it launches the kernel or
raises, and counts the launch in its `launches` attribute. The kernels take
bf16, fp16 and f32 (f32 products round their operands to TF32 in the tensor
cores; sums are f32), D % 8 == 0 and D <= 1024.

Layout is (B, H, L, D) throughout. The ring-attention branch belongs to a
later slice.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _native

_NEG_INF = -1.0e30
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
MAX_HEAD_DIM = 1024
# mirrors the JAX package's `_FUSED_BWD`: False selects the split dq / dk.dv
# kernels, as `torch.use_deterministic_algorithms(True)` does
FUSED_BWD = True


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


def _keep_mask(q_len: int, kv_len: int, device: torch.device) -> torch.Tensor:
    q_pos = torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return k_pos <= q_pos


def flash_fwd_with_lse_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels' function in plain PyTorch: f32 scores, masked
    entries at -1e30 (causal: k > q), P cast to the value dtype before P.V
    with f32 accumulation, o = acc / max(l, 1e-30) and
    lse = m + log(max(l, 1e-30)) as (B, H, Lq) f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(q.shape[-1], sm_scale)
    if causal:
        s = torch.where(_keep_mask(q.shape[-2], k.shape[-2], q.device), s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """`flash_fwd_with_lse_plain` without the logsumexp."""
    return flash_fwd_with_lse_plain(q, k, v, causal=causal, sm_scale=sm_scale)[0]


def flash_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch, written out from
    their formulas (not autograd of the forward): p = exp(s - lse) with
    masked entries 0, dv = cast(p)^T dO, dp = dO v^T, ds = p (dp - delta)
    with delta = rowsum(dO * O) in f32, dk = scale * cast(ds)^T q and
    dq = scale * cast(ds) k; p is cast to dO's dtype and ds to q's before
    their products, and every sum is f32."""
    scale = _scale(q.shape[-1], sm_scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    if causal:
        p = torch.where(_keep_mask(q.shape[-2], k.shape[-2], q.device), p, torch.zeros_like(p))
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)).to(q.dtype).float()
    dk = scale * torch.matmul(ds.transpose(-1, -2), qf)
    dq = scale * torch.matmul(ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """A (B, H, L, D) view the kernels can read: contiguous D, B/H/L strides
    and base address 16-byte aligned; otherwise a contiguous copy."""
    ok = (
        t.stride(-1) == 1
        and all(s % 8 == 0 for s in t.stride()[:-1])
        and t.data_ptr() % 16 == 0
    )
    return t if ok else t.contiguous()


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernels do not take."""
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {q.device}")
    b, h, q_len, d = q.shape
    kv_len = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} kernel takes bf16/fp16/f32 q, k, v of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, h, kv_len, d) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if d % 8 != 0 or d > MAX_HEAD_DIM or q_len == 0 or kv_len == 0:
        raise ValueError(f"{name} kernel takes 8 | D <= {MAX_HEAD_DIM} and non-empty L; got {tuple(q.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on different devices")


def _count_launch(name: str) -> None:
    """One more launch of kernel `name`, on its wrapper's `launches`. The
    wrapper is looked up in `_WRAPPERS`, not by its global name, which a
    caller may have pointed elsewhere."""
    _WRAPPERS[name].launches += 1


def _launch_fwd(
    name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, sm_scale: Optional[float], with_lse: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    _check_qkv(name, q, k, v)
    b, h, q_len, d = q.shape
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    # (B, Lq, H, D) storage: merging heads afterwards is a free view
    out = torch.empty((b, q_len, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, q_len), dtype=torch.float32, device=q.device) if with_lse else None
    err = _native.library(name)(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, h, q_len, k.shape[2], d, int(causal), _scale(d, sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _native.check(err, name)
    _count_launch(name)
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention forward, no graph. q: (B, H, Lq, D), k/v:
    (B, H, Lk, D) -> (B, H, Lq, D). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise. The result carries no `grad_fn`:
    differentiable callers go through `flash_attention_trainable`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    out, _ = _launch_fwd("flash_attention", q, k, v, causal, sm_scale, False)
    return out


flash_attention.launches = 0


def flash_fwd_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward with its residual: (o (B, H, Lq, D),
    lse (B, H, Lq) f32). No padded rows are stored."""
    if q.device.type == "cpu":
        return flash_fwd_with_lse_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    out, lse = _launch_fwd("flash_fwd_lse", q, k, v, causal, sm_scale, True)
    return out, lse


flash_fwd_lse.launches = 0


def bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B, H, Lq): a bandwidth pass that the
    JAX package also leaves outside its kernels."""
    return (do.float() * o.float()).sum(dim=-1)


def _launch_bwd(
    name: str,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool,
    sm_scale: Optional[float],
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    _check_qkv(name, q, k, v)
    b, h, q_len, d = q.shape
    kv_len = k.shape[2]
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"{name}: dO {tuple(do.shape)} {do.dtype} does not match q {tuple(q.shape)} {q.dtype}")
    if tuple(lse.shape) != (b, h, q_len) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be f32 {(b, h, q_len)}; got {lse.dtype} {tuple(lse.shape)}")
    delta = bwd_delta(o, do).contiguous()
    lse = lse.contiguous()
    # dO comes with whatever strides autograd gave it: a copy only if the
    # kernel cannot read them
    q, k, v, do = _kernel_view(q), _kernel_view(k), _kernel_view(v), _kernel_view(do)
    dq = dk = dv = None
    if name == "flash_bwd_fused":
        # the kv tiles' CTAs add their shares of dq into this f32 buffer
        dq = torch.zeros((b, h, q_len, d), dtype=torch.float32, device=q.device)
    elif name == "flash_bwd_dq":
        dq = torch.empty((b, h, q_len, d), dtype=q.dtype, device=q.device)
    if name != "flash_bwd_dq":
        dk = torch.empty((b, h, kv_len, d), dtype=q.dtype, device=q.device)
        dv = torch.empty((b, h, kv_len, d), dtype=q.dtype, device=q.device)
    err = _native.library(name)(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if dq is None else dq.data_ptr(),
        None if dk is None else dk.data_ptr(),
        None if dv is None else dv.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        b, h, q_len, kv_len, d, int(causal), _scale(d, sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _native.check(err, name)
    _count_launch(name)
    if name == "flash_bwd_fused":
        dq = dq.to(q.dtype)
    return dq, dk, dv


def flash_bwd_fused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from one kernel. dq is summed across kv tiles by f32
    atomics (not bit-reproducible) and cast to q's dtype afterwards."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)
    grads = _launch_bwd("flash_bwd_fused", q, k, v, o, lse, do, causal, sm_scale)
    return grads


flash_bwd_fused.launches = 0


def flash_bwd_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """dq of the split (bit-reproducible) backward."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)[0]
    dq, _, _ = _launch_bwd("flash_bwd_dq", q, k, v, o, lse, do, causal, sm_scale)
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the split (bit-reproducible) backward."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)[1:]
    _, dk, dv = _launch_bwd("flash_bwd_dkv", q, k, v, o, lse, do, causal, sm_scale)
    return dk, dv


flash_bwd_dkv.launches = 0


_WRAPPERS = {
    fn.__name__: fn for fn in (flash_attention, flash_fwd_lse, flash_bwd_fused, flash_bwd_dq, flash_bwd_dkv)
}


class FlashAttentionTrainable(torch.autograd.Function):
    """Differentiable flash attention: the kernels' forward and backward.
    When no input needs a gradient the forward is the inference kernel, as
    the JAX custom VJP's primal is. Otherwise it
    runs `flash_fwd_lse` and saves q, k, v, o, lse; the backward runs the
    fused kernel, or the split pair when `FUSED_BWD` is false or
    `torch.are_deterministic_algorithms_enabled()`."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False, sm_scale=None):  # type: ignore[override]
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
        o, lse = flash_fwd_lse(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):  # type: ignore[override]
        q, k, v, o, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale)
        if FUSED_BWD and not torch.are_deterministic_algorithms_enabled():
            dq, dk, dv = flash_bwd_fused(q, k, v, o, lse, do, **kw)
        else:
            dq = flash_bwd_dq(q, k, v, o, lse, do, **kw)
            dk, dv = flash_bwd_dkv(q, k, v, o, lse, do, **kw)
        return dq, dk, dv, None, None


def flash_attention_trainable(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """`FlashAttentionTrainable.apply` with the JAX function's signature.
    Under `torch.no_grad()` no graph is wanted whatever the inputs say (the
    function's forward cannot see the grad mode), so the inference kernel
    runs directly."""
    if not torch.is_grad_enabled():
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    return FlashAttentionTrainable.apply(q, k, v, causal, sm_scale)


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
        # always the differentiable entry: without a gradient to carry it is
        # the inference kernel
        return flash_attention_trainable(q, k, v, causal, sm_scale)
    return xla_attention(q, k, v, causal=causal, sm_scale=sm_scale, mask=mask, bias=bias)
