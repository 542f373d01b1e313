"""Conv blocks on the SD path (counterpart of `cflearn_tpu/modules/core/convs.py`).
Channel-last NHWC; 3x3 convs go through `cflearn_torch.ops.conv.conv_call`."""

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.conv import conv_call
from ...ops.group_norm import gn_call
from ..common import zero_module
from ..layers import Conv, GroupNorm, Linear


class Conv2d(nn.Module):
    """Plain-padding 2-D conv wrapper (the gain / circular / kernel-transform
    options of the JAX module are not on this slice's path)."""

    def __init__(
        self, in_channels: int, out_channels: int, *, kernel_size: int = 3, stride: int = 1, bias: bool = True
    ) -> None:
        super().__init__()
        self.conv = Conv(
            in_channels, out_channels, (kernel_size, kernel_size), strides=(stride, stride), use_bias=bias
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_call(self.conv, x)


def interpolate(
    x: torch.Tensor, *, factor: Optional[float] = None, size: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    """Nearest resize of NHWC `x` with half-pixel centres (`jax.image.resize`
    "nearest")."""
    b, h, w, c = x.shape
    if size is None:
        assert factor is not None
        size = (int(round(h * factor)), int(round(w * factor)))
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="nearest-exact")
    return y.permute(0, 2, 3, 1)


class UpsampleConv2d(nn.Module):
    """Nearest-upsample + conv."""

    def __init__(self, in_channels: int, out_channels: int, *, kernel_size: int = 3, factor: float = 2.0) -> None:
        super().__init__()
        self.factor = factor
        self.conv = Conv2d(in_channels, out_channels, kernel_size=kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.factor != 1.0:
            x = interpolate(x, factor=self.factor)
        return self.conv(x)


class Downsample(nn.Module):
    """Stride-2 3x3 conv. The VAE convention pads (0, 1); the UNet passes
    `symmetric=True` for (1, 1)."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None, *, symmetric: bool = False) -> None:
        super().__init__()
        pad = (1, 1) if symmetric else (0, 1)
        self.conv = Conv(in_channels, out_channels or in_channels, (3, 3), strides=(2, 2), padding=[pad, pad])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ResidualBlock(nn.Module):
    """GroupNorm -> SiLU -> conv, twice, with a skip (the VAE resblock)."""

    def __init__(
        self, in_channels: int, out_channels: Optional[int] = None, *, num_groups: int = 32, eps: float = 1e-6
    ) -> None:
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = GroupNorm(in_channels, num_groups=num_groups, eps=eps)
        self.conv1 = Conv(in_channels, out_channels)
        self.norm2 = GroupNorm(out_channels, num_groups=num_groups, eps=eps)
        self.conv2 = Conv(out_channels, out_channels)
        self.shortcut = Conv(in_channels, out_channels, (1, 1)) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = conv_call(self.conv1, gn_call(self.norm1, x, silu=True))
        net = conv_call(self.conv2, gn_call(self.norm2, net, silu=True))
        skip = x if self.shortcut is None else self.shortcut(x)
        return skip + net


class ResidualBlockWithTimeEmbedding(nn.Module):
    """Diffusion-UNet resblock: the time embedding is added between the convs.
    `conv2` starts at zero, as in the JAX package."""

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        *,
        time_embed_dim: int,
        num_groups: int = 32,
        eps: float = 1e-5,
        use_scale_shift_norm: bool = False,
    ) -> None:
        super().__init__()
        out_channels = out_channels or in_channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.norm1 = GroupNorm(in_channels, num_groups=num_groups, eps=eps)
        self.conv1 = Conv(in_channels, out_channels)
        self.time_proj = Linear(time_embed_dim, 2 * out_channels if use_scale_shift_norm else out_channels)
        self.norm2 = GroupNorm(out_channels, num_groups=num_groups, eps=eps)
        self.conv2 = zero_module(Conv(out_channels, out_channels))
        self.shortcut = Conv(in_channels, out_channels, (1, 1)) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor, time_embed: torch.Tensor) -> torch.Tensor:
        net = conv_call(self.conv1, gn_call(self.norm1, x, silu=True))
        emb = self.time_proj(F.silu(time_embed))[:, None, None, :]
        if self.use_scale_shift_norm:
            scale, shift = emb.chunk(2, dim=-1)
            net = F.silu(gn_call(self.norm2, net) * (1.0 + scale) + shift)
        else:
            net = gn_call(self.norm2, net + emb, silu=True)
        net = conv_call(self.conv2, net)
        skip = x if self.shortcut is None else self.shortcut(x)
        return skip + net
