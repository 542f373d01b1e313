"""Attention modules on the SD path (counterpart of
`cflearn_tpu/modules/core/attentions.py`). Channel-last; scores go through
`cflearn_torch.ops.attention.sdp_attn`."""

import math
from typing import Optional

import torch
import torch.nn as nn

from ...ops.attention import sdp_attn
from ..layers import GroupNorm, Linear


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


class CrossAttention(nn.Module):
    """SD-style attention: no bias on q/k/v, context supplies k/v."""

    def __init__(
        self, *, query_dim: int, context_dim: Optional[int] = None, heads: int = 8, dim_head: int = 64
    ) -> None:
        super().__init__()
        inner_dim = dim_head * heads
        context_dim = context_dim or query_dim
        self.heads = heads
        self.scale = 1.0 / math.sqrt(dim_head)
        self.to_q = Linear(query_dim, inner_dim, bias=False)
        self.to_k = Linear(context_dim, inner_dim, bias=False)
        self.to_v = Linear(context_dim, inner_dim, bias=False)
        self.to_out = Linear(inner_dim, query_dim, bias=True)

    def forward(
        self, x: torch.Tensor, context: Optional[torch.Tensor] = None, *, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """`mask` marks slots to be masked OUT (True = drop)."""
        context = x if context is None else context
        qh = _split_heads(self.to_q(x), self.heads)
        kh = _split_heads(self.to_k(context), self.heads)
        vh = _split_heads(self.to_v(context), self.heads)
        keep = None if mask is None else torch.logical_not(mask)
        out = sdp_attn(qh, kh, vh, sm_scale=self.scale, mask=keep)
        return self.to_out(_merge_heads(out))


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
