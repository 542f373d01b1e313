"""The SD UNet's transformer stack (counterpart of
`cflearn_tpu/modules/core/mixed_stacks.py`: the plain branch and ToMe; the
style-reference hooks are not ported). `dropout` acts in training mode
only."""

from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.group_norm import gn_call
from ..layers import Conv, GroupNorm, LayerNorm, Linear
from .activations import GEGLU
from .attentions import CrossAttention
from .tome import compute_merge


class FeedForward(nn.Module):
    """GEGLU feed-forward (the `activation="geglu"` branch), dropout after
    each layer."""

    def __init__(self, in_dim: int, latent_dim: int, dropout: float = 0.0) -> None:
        super().__init__()
        self.net1 = GEGLU(in_dim=in_dim, out_dim=latent_dim)
        self.linear2 = Linear(latent_dim, in_dim)
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.linear2(F.dropout(self.net1(x), self.dropout, self.training))
        return F.dropout(net, self.dropout, self.training)


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> GEGLU FF, all pre-norm residual. The
    LayerNorms keep flax's default epsilon 1e-6."""

    def __init__(
        self, query_dim: int, num_heads: int, head_dim: int, *, context_dim: Optional[int] = None, dropout: float = 0.0
    ) -> None:
        super().__init__()
        self.norm1 = LayerNorm(query_dim)
        self.attn1 = CrossAttention(query_dim=query_dim, heads=num_heads, dim_head=head_dim, dropout=dropout)
        self.norm2 = LayerNorm(query_dim)
        self.attn2 = CrossAttention(
            query_dim=query_dim, context_dim=context_dim, heads=num_heads, dim_head=head_dim, dropout=dropout
        )
        self.norm3 = LayerNorm(query_dim)
        self.ff = FeedForward(query_dim, query_dim * 4, dropout)

    def forward(
        self, x: torch.Tensor, context: Optional[torch.Tensor] = None, *, tome_info: Optional[Any] = None
    ) -> torch.Tensor:
        """`tome_info` = (h, w, ratio, merge_mlp): ToMe merges the tokens for
        the self-attention (and, with merge_mlp, for the FF, with the same
        matching), the block's input `x` being the similarity metric."""
        if tome_info is not None:
            h, w, ratio, merge_mlp = tome_info
            merge, unmerge, _ = compute_merge(x, h, w, ratio=ratio)
            x = x + unmerge(self.attn1(merge(self.norm1(x))))
            x = x + self.attn2(self.norm2(x), context=context)
            if merge_mlp:
                return x + unmerge(self.ff(merge(self.norm3(x))))
            return x + self.ff(self.norm3(x))
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm -> proj-in -> transformer blocks -> proj-out + skip."""

    def __init__(
        self,
        in_channels: int,
        num_heads: int,
        head_dim: int,
        *,
        num_layers: int = 1,
        context_dim: Optional[int] = None,
        dropout: float = 0.0,
        use_linear: bool = False,
    ) -> None:
        super().__init__()
        inner_dim = num_heads * head_dim
        self.norm = GroupNorm(in_channels, num_groups=32, eps=1e-6)
        self.use_linear = use_linear
        if use_linear:
            self.proj_in = Linear(in_channels, inner_dim)
            self.proj_out = Linear(inner_dim, in_channels)
        else:
            self.proj_in = Conv(in_channels, inner_dim, (1, 1))
            self.proj_out = Conv(inner_dim, in_channels, (1, 1))
        self.blocks = nn.ModuleList(
            BasicTransformerBlock(inner_dim, num_heads, head_dim, context_dim=context_dim, dropout=dropout)
            for _ in range(num_layers)
        )
        # ToMe ratio (0 = off), set through `set_tome_ratio`
        self.tome_ratio = 0.0
        self.tome_merge_mlp = False

    def set_tome_ratio(self, ratio: float, *, merge_mlp: bool = False) -> None:
        self.tome_ratio = float(ratio)
        self.tome_merge_mlp = bool(merge_mlp)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        net = gn_call(self.norm, x)
        if self.use_linear:
            net = self.proj_in(net.reshape(b, h * w, c))
        else:
            net = self.proj_in(net).reshape(b, h * w, -1)
        tome_info = (h, w, self.tome_ratio, self.tome_merge_mlp) if self.tome_ratio > 0 else None
        for block in self.blocks:
            net = block(net, context=context, tome_info=tome_info)
        if self.use_linear:
            net = self.proj_out(net).reshape(b, h, w, c)
        else:
            net = self.proj_out(net.reshape(b, h, w, -1))
        return x + net
