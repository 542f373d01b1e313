"""Conv blocks on the SD path (counterpart of `cflearn_tpu/modules/core/convs.py`).
Channel-last NHWC; 3x3 convs go through `cflearn_torch.ops.conv.conv_call`."""

from typing import Any, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.conv import conv_call
from ...ops.group_norm import gn_call
from ..common import zero_module
from ..layers import Conv, GroupNorm, Linear


def _norm_padding(padding: Union[str, int, Tuple[int, int]]) -> Any:
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return (tuple(padding), tuple(padding))


class Conv2d(nn.Module):
    """2-D conv with the options of the JAX module: `padding` ("same",
    "valid", an int or a (lo, hi) pair for both axes), `dilation`, `groups`,
    `gain` (an init gain only: xavier-normal weights, set by
    `init_constants`), `weight_scale` (a multiplier of the output),
    `transform_kernel` (the kernel smoothed by [1, 2, 1] / 4: four shifted
    copies of it padded by one, averaged, one wider) and circular padding
    (`set_circular`, the tiling mode of the diffusion API). A plain call goes
    through `conv_call` (the 3x3 kernel where it routes); with circular
    padding or `transform_kernel` the JAX module runs XLA's conv on the
    wrapped input with VALID padding, and this one `F.conv2d`."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        *,
        kernel_size: int = 3,
        stride: int = 1,
        padding: Union[str, int, Tuple[int, int]] = "same",
        dilation: int = 1,
        groups: int = 1,
        bias: bool = True,
        gain: float = 1.0,
        weight_scale: Optional[float] = None,
        transform_kernel: bool = False,
    ) -> None:
        super().__init__()
        self.padding_mode = "zeros"
        self.conv = Conv(
            in_channels, out_channels, (kernel_size, kernel_size), strides=(stride, stride),
            padding=_norm_padding(padding), use_bias=bias, dilation=(dilation, dilation), groups=groups,
        )
        self.gain = gain
        self.weight_scale = weight_scale
        self.transform_kernel = transform_kernel

    def init_constants(self) -> None:
        """With a `gain`: the weight drawn N(0, 1 / fan_in) by
        `init_parameters` rescaled to xavier-normal, std gain x sqrt(2 /
        (fan_in + fan_out))."""
        if self.gain == 1.0:
            return
        w = self.conv.weight
        fan_in = w[0].numel()
        std = self.gain * (2.0 / (fan_in + w.shape[0] * w[0, 0].numel())) ** 0.5
        with torch.no_grad():
            w.mul_(std * fan_in**0.5)

    def set_circular(self, circular: bool) -> None:
        self.padding_mode = "circular" if circular else "zeros"

    def _kernel(self) -> torch.Tensor:
        w = self.conv.weight
        if self.transform_kernel:
            w = F.pad(w, (1, 1, 1, 1))
            w = (w[..., 1:, 1:] + w[..., :-1, 1:] + w[..., 1:, :-1] + w[..., :-1, :-1]) / 4.0
        return w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.transform_kernel or self.padding_mode == "circular":
            kernel = self._kernel()
            padding = self.conv.padding
            if self.padding_mode == "circular":
                ph, pw = kernel.shape[2] // 2, kernel.shape[3] // 2
                x = F.pad(x.permute(0, 3, 1, 2), (pw, pw, ph, ph), mode="circular").permute(0, 2, 3, 1)
                padding = "VALID"
            out = self.conv.conv_with(x, kernel, padding)
        else:
            out = conv_call(self.conv, x)
        if self.weight_scale is not None:
            out = out * self.weight_scale
        return out


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
    """Stride-2 3x3 conv, or with `use_conv=False` a 2x2 average pool. The
    VAE convention pads (0, 1); the UNet passes `symmetric=True` for (1, 1)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        *,
        use_conv: bool = True,
        symmetric: bool = False,
    ) -> None:
        super().__init__()
        self.use_conv = use_conv
        self.conv = None
        if use_conv:
            pad = (1, 1) if symmetric else (0, 1)
            self.conv = Conv(in_channels, out_channels or in_channels, (3, 3), strides=(2, 2), padding=[pad, pad])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) if self.conv is not None else avg_pool2(x)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 window mean at stride 2 of NHWC `x` (odd trailing rows and columns
    dropped), in x's dtype: the window sum times 0.25."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class ResidualBlock(nn.Module):
    """GroupNorm -> SiLU -> conv, twice, with a skip (the VAE resblock);
    `dropout` before the second conv, in training mode."""

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        *,
        dropout: float = 0.0,
        num_groups: int = 32,
        eps: float = 1e-6,
    ) -> None:
        super().__init__()
        out_channels = out_channels or in_channels
        self.dropout = dropout
        self.norm1 = GroupNorm(in_channels, num_groups=num_groups, eps=eps)
        self.conv1 = Conv(in_channels, out_channels)
        self.norm2 = GroupNorm(out_channels, num_groups=num_groups, eps=eps)
        self.conv2 = Conv(out_channels, out_channels)
        self.shortcut = Conv(in_channels, out_channels, (1, 1)) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = conv_call(self.conv1, gn_call(self.norm1, x, silu=True))
        net = F.dropout(gn_call(self.norm2, net, silu=True), self.dropout, self.training)
        net = conv_call(self.conv2, net)
        skip = x if self.shortcut is None else self.shortcut(x)
        return skip + net


class ResidualBlockWithTimeEmbedding(nn.Module):
    """Diffusion-UNet resblock: the time embedding is added between the convs.
    `conv2` starts at zero, as in the JAX package. `down` / `up` resample
    both the branch (after the first norm and SiLU) and the skip, without a
    conv: a 2x2 average pool or a nearest 2x resize. `dropout` before the
    second conv, in training mode."""

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        *,
        time_embed_dim: int,
        dropout: float = 0.0,
        num_groups: int = 32,
        eps: float = 1e-5,
        use_scale_shift_norm: bool = False,
        up: bool = False,
        down: bool = False,
    ) -> None:
        super().__init__()
        out_channels = out_channels or in_channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up = up
        self.down = down
        self.dropout = dropout
        self.norm1 = GroupNorm(in_channels, num_groups=num_groups, eps=eps)
        self.conv1 = Conv(in_channels, out_channels)
        self.time_proj = Linear(time_embed_dim, 2 * out_channels if use_scale_shift_norm else out_channels)
        self.norm2 = GroupNorm(out_channels, num_groups=num_groups, eps=eps)
        self.conv2 = zero_module(Conv(out_channels, out_channels))
        self.shortcut = Conv(in_channels, out_channels, (1, 1)) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor, time_embed: torch.Tensor) -> torch.Tensor:
        net = gn_call(self.norm1, x, silu=True)
        if self.down:
            net, x = avg_pool2(net), avg_pool2(x)
        elif self.up:
            net, x = interpolate(net, factor=2.0), interpolate(x, factor=2.0)
        net = conv_call(self.conv1, net)
        emb = self.time_proj(F.silu(time_embed))[:, None, None, :]
        if self.use_scale_shift_norm:
            scale, shift = emb.chunk(2, dim=-1)
            net = F.silu(gn_call(self.norm2, net) * (1.0 + scale) + shift)
        else:
            net = gn_call(self.norm2, net + emb, silu=True)
        net = conv_call(self.conv2, F.dropout(net, self.dropout, self.training))
        skip = x if self.shortcut is None else self.shortcut(x)
        return skip + net
