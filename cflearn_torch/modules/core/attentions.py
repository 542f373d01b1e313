"""Attention modules (counterpart of `cflearn_tpu/modules/core/attentions.py`):
`Attention` (registered "basic"), `CrossAttention` ("cross"),
`DecayedAttention` ("decayed"), `SpatialAttention`,
`MultiHeadSpatialAttention`, `LinearDepthWiseAttention`, and the
`register_attention` / `make_attention` registry. Channel-last; scores go
through `cflearn_torch.ops.attention.sdp_attn`. Dropout, where a module
takes it, acts in training mode only."""

import math
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import sdp_attn
from ..common import PrefixModules, zero_module
from ..layers import GroupNorm, Linear

attentions = PrefixModules("attention")


def register_attention(name: str, **kwargs: Any) -> Callable[[type], type]:
    return attentions.register(name, **kwargs)


def make_attention(name: str, *args: Any, **kwargs: Any) -> nn.Module:
    return attentions.build(name, *args, **kwargs)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


@register_attention("basic")
class Attention(nn.Module):
    """Multi-head attention with q / k / v projections (one `in_proj` of
    3 x `embed_dim` with `is_self_attention`)."""

    def __init__(
        self,
        input_dim: int,
        num_heads: int = 1,
        *,
        bias: bool = True,
        dropout: float = 0.0,
        qk_scale: Optional[float] = None,
        embed_dim: Optional[int] = None,
        kv_dim: Optional[int] = None,
        out_dim: Optional[int] = None,
        is_self_attention: bool = False,
    ) -> None:
        super().__init__()
        self.input_dim = input_dim
        self.num_heads = num_heads
        embed_dim = embed_dim or input_dim
        kv_dim = kv_dim or input_dim
        self.embed_dim = embed_dim
        if embed_dim % num_heads != 0:
            raise ValueError("`embed_dim` should be divisible by `num_heads`")
        self.head_dim = embed_dim // num_heads
        self.scale = qk_scale or 1.0 / math.sqrt(self.head_dim)
        self.is_self_attention = is_self_attention
        if is_self_attention:
            self.in_proj = Linear(input_dim, 3 * embed_dim, bias=bias)
        else:
            self.q_proj = Linear(input_dim, embed_dim, bias=bias)
            self.k_proj = Linear(kv_dim, embed_dim, bias=bias)
            self.v_proj = Linear(kv_dim, embed_dim, bias=bias)
        self.out_proj = Linear(embed_dim, out_dim or input_dim, bias=bias)
        self.dropout = dropout

    def forward(
        self,
        q: torch.Tensor,
        k: Optional[torch.Tensor] = None,
        v: Optional[torch.Tensor] = None,
        *,
        mask: Optional[torch.Tensor] = None,
        bias: Optional[torch.Tensor] = None,
        causal: bool = False,
    ) -> torch.Tensor:
        """`mask` marks slots to be masked OUT (True = drop; inverted before
        the scores, which keep True); `bias` is an additive logits bias."""
        if self.is_self_attention:
            q_, k_, v_ = self.in_proj(q).chunk(3, dim=-1)
        else:
            k = q if k is None else k
            v = q if v is None else v
            q_, k_, v_ = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        keep = None if mask is None else torch.logical_not(mask)
        out = sdp_attn(
            _split_heads(q_, self.num_heads), _split_heads(k_, self.num_heads), _split_heads(v_, self.num_heads),
            sm_scale=self.scale, mask=keep, bias=bias, causal=causal,
        )
        out = F.dropout(_merge_heads(out), self.dropout, self.training)
        return self.out_proj(out)


@register_attention("cross")
class CrossAttention(nn.Module):
    """SD-style attention: no bias on q/k/v, context supplies k/v."""

    def __init__(
        self,
        *,
        query_dim: int,
        context_dim: Optional[int] = None,
        heads: int = 8,
        dim_head: int = 64,
        dropout: float = 0.0,
    ) -> None:
        super().__init__()
        inner_dim = dim_head * heads
        self.dropout = dropout
        context_dim = context_dim or query_dim
        self.heads = heads
        self.scale = 1.0 / math.sqrt(dim_head)
        self.to_q = Linear(query_dim, inner_dim, bias=False)
        self.to_k = Linear(context_dim, inner_dim, bias=False)
        self.to_v = Linear(context_dim, inner_dim, bias=False)
        self.to_out = Linear(inner_dim, query_dim, bias=True)

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        *,
        mask: Optional[torch.Tensor] = None,
        hooks: Optional[Any] = None,
    ) -> torch.Tensor:
        """`mask` marks slots to be masked OUT (True = drop). `hooks`
        (a `SpatialTransformerHooks`) may transform q, k and v before the
        heads are split (`process_qkv`)."""
        context = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        if hooks is not None:
            q, k, v = hooks.process_qkv(self, q, k, v)
        qh, kh, vh = _split_heads(q, self.heads), _split_heads(k, self.heads), _split_heads(v, self.heads)
        keep = None if mask is None else torch.logical_not(mask)
        out = sdp_attn(qh, kh, vh, sm_scale=self.scale, mask=keep)
        return F.dropout(self.to_out(_merge_heads(out)), self.dropout, self.training)


class SpatialAttention(nn.Module):
    """Single-head attention over NHWC feature maps (the VAE mid-block)."""

    def __init__(self, in_channels: int, *, num_groups: int = 32, eps: float = 1e-6) -> None:
        super().__init__()
        self.norm = GroupNorm(in_channels, num_groups=num_groups, eps=eps)
        self.to_q = Linear(in_channels, in_channels)
        self.to_k = Linear(in_channels, in_channels)
        self.to_v = Linear(in_channels, in_channels)
        self.to_out = Linear(in_channels, in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        net = self.norm(x).reshape(b, h * w, c)
        q, k, v = self.to_q(net), self.to_k(net), self.to_v(net)
        out = sdp_attn(q[:, None], k[:, None], v[:, None], sm_scale=1.0 / math.sqrt(c))[:, 0]
        return x + self.to_out(out).reshape(b, h, w, c)


class MultiHeadSpatialAttention(nn.Module):
    """Multi-head attention over NHWC feature maps (the attention blocks of
    the LDM UNets): GroupNorm, one qkv projection, a zero-initialised output
    projection and a skip. The qkv channels are interleaved per head,
    [h0: (q, k, v), h1: (q, k, v), ...], not [Q | K | V]: the split gives
    strided q / k / v views, which the flash kernel's wrapper copies where
    its tensor maps need it."""

    def __init__(
        self,
        in_channels: int,
        *,
        num_heads: Optional[int] = 1,
        num_head_channels: Optional[int] = None,
        num_groups: int = 32,
    ) -> None:
        super().__init__()
        if num_head_channels is not None:
            num_heads = in_channels // num_head_channels
        if not num_heads or in_channels % num_heads != 0:
            raise ValueError(f"{in_channels} channels do not split into {num_heads} heads")
        self.num_heads = num_heads
        self.norm = GroupNorm(in_channels, num_groups=num_groups, eps=1e-5)
        self.to_qkv = Linear(in_channels, 3 * in_channels)
        self.to_out = zero_module(Linear(in_channels, in_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        qkv = self.to_qkv(self.norm(x).reshape(b, h * w, c))
        qkv = qkv.reshape(b, h * w, self.num_heads, -1).transpose(1, 2)
        q, k, v = qkv.chunk(3, dim=-1)  # each (b, heads, n, dh)
        out = _merge_heads(sdp_attn(q, k, v))
        return x + self.to_out(out).reshape(b, h, w, c)


class LinearDepthWiseAttention(nn.Module):
    """Linear attention: softmax on k over the tokens, then q (k^T v); no
    softmax on q."""

    def __init__(self, in_channels: int, *, num_heads: int = 4, head_dim: int = 32) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        inner = num_heads * head_dim
        self.to_qkv = Linear(in_channels, 3 * inner, bias=False)
        self.to_out = Linear(inner, in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        q, k, v = (_split_heads(t, self.num_heads) for t in self.to_qkv(x.reshape(b, h * w, c)).chunk(3, dim=-1))
        ctx = torch.einsum("bhnd,bhne->bhde", torch.softmax(k, dim=-2), v)
        out = _merge_heads(torch.einsum("bhnd,bhde->bhne", q, ctx))
        return self.to_out(out).reshape(b, h, w, c)


def np_decay_log_bias(seq_len: int, num_heads: int) -> np.ndarray:
    """bias[h, i, j] = -(0.1^(h + 3)) (i - j)^2 for j <= i, 0 above the
    diagonal (f32): the log of a post-softmax decay, added to the logits."""
    i = np.arange(seq_len)[:, None]
    j = np.arange(seq_len)[None, :]
    sq = np.where(j <= i, (i - j).astype(np.float32) ** 2, 0.0)
    rates = np.asarray([0.1 ** (h + 3) for h in range(num_heads)], dtype=np.float32)
    return -rates[:, None, None] * sq[None]


@register_attention("decayed")
class DecayedAttention(Attention):
    """`Attention` with a fixed per-head, per-position decay as an additive
    logits bias (`np_decay_log_bias`, a buffer)."""

    def __init__(self, input_dim: int, num_heads: int = 1, *, seq_len: int, dropout: float = 0.0, **kwargs: Any) -> None:
        super().__init__(input_dim, num_heads, dropout=dropout, **kwargs)
        self.seq_len = seq_len
        self.register_buffer("decay_bias", torch.from_numpy(np_decay_log_bias(seq_len, num_heads)), persistent=False)

    def reset_buffers(self) -> None:
        """The bias again, on the buffer's device (`build_module` materialises a module from "meta")."""
        if self.decay_bias.device.type != "meta":
            self.decay_bias.copy_(torch.from_numpy(np_decay_log_bias(self.seq_len, self.num_heads)))

    def forward(
        self, q: torch.Tensor, k: Optional[torch.Tensor] = None, v: Optional[torch.Tensor] = None, **kwargs: Any
    ) -> torch.Tensor:
        kwargs["bias"] = self.decay_bias[None]
        return super().forward(q, k, v, **kwargs)
