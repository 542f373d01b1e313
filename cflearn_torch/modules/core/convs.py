"""Conv blocks (counterpart of `cflearn_tpu/modules/core/convs.py`):
`Conv2d`, `DepthWiseConv2d`, `Interpolate` / `interpolate`,
`UpsampleConv2d`, `Downsample`, the channel attentions `SEBlock`,
`ECABlock` and `CABlock` (coordinate attention), the residual blocks
(`ResidualBlock`, `ResidualBlockWithTimeEmbedding`, `ResidualBlockV2`,
`ResDownsample`, `ResUpsample`), `GaussianBlur3`, `conv_nd`,
`get_conv_blocks`, `max_pool2d_with_indices` and `MaxUnpool2d`.
Channel-last NHWC; 3x3 convs go through `cflearn_torch.ops.conv.conv_call`
where the JAX package routes them through its kernel."""

from typing import Any, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.conv import conv_call
from ...ops.group_norm import gn_call
from ..common import zero_module
from ..layers import BatchNorm, Conv, ConvN, GroupNorm, Linear, resize
from .activations import build_activation


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


class DepthWiseConv2d(nn.Module):
    """A depthwise conv (one group a channel, SAME padding), no pointwise stage."""

    def __init__(self, dim: int, *, kernel_size: int = 3) -> None:
        super().__init__()
        self.depth_wise = Conv(dim, dim, (kernel_size, kernel_size), groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.depth_wise(x)


def interpolate(
    x: torch.Tensor, *, factor: Optional[float] = None, size: Optional[Tuple[int, int]] = None, mode: str = "nearest"
) -> torch.Tensor:
    """`jax.image.resize` of NHWC `x` to `size` (or by `factor`, rounded),
    half-pixel centres: "nearest" by `F.interpolate`'s "nearest-exact", the
    other methods by `layers.resize`."""
    b, h, w, c = x.shape
    if size is None:
        assert factor is not None
        size = (int(round(h * factor)), int(round(w * factor)))
    if mode != "nearest":
        return resize(x, size, mode)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="nearest-exact")
    return y.permute(0, 2, 3, 1)


class Interpolate(nn.Module):
    """Resize by `factor` (`interpolate`)."""

    def __init__(self, factor: float = 2.0, mode: str = "nearest") -> None:
        super().__init__()
        self.factor = factor
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return interpolate(x, factor=self.factor, mode=self.mode)


class UpsampleConv2d(nn.Module):
    """Upsample (nearest by default) + conv."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        *,
        kernel_size: int = 3,
        factor: float = 2.0,
        mode: str = "nearest",
        bias: bool = True,
    ) -> None:
        super().__init__()
        self.factor = factor
        self.mode = mode
        self.conv = Conv2d(in_channels, out_channels, kernel_size=kernel_size, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.factor != 1.0:
            x = interpolate(x, factor=self.factor, mode=self.mode)
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


class SEBlock(nn.Module):
    """Squeeze-excite: the channels' spatial means through down -> ReLU -> up
    -> sigmoid scale the input."""

    def __init__(self, in_channels: int, latent_channels: int) -> None:
        super().__init__()
        self.down = Linear(in_channels, latent_channels)
        self.up = Linear(latent_channels, in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.sigmoid(self.up(F.relu(self.down(x.mean(dim=(1, 2))))))
        return x * w[:, None, None, :]


class ECABlock(nn.Module):
    """Efficient channel attention: a bias-free 1-D conv (SAME) along the
    channels' spatial means, then sigmoid gates."""

    def __init__(self, kernel_size: int = 3) -> None:
        super().__init__()
        self.conv = ConvN(1, 1, (kernel_size,), use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.sigmoid(self.conv(x.mean(dim=(1, 2))[:, :, None])[:, :, 0])
        return x * w[:, None, None, :]


def _h_swish(x: torch.Tensor) -> torch.Tensor:
    return x * F.relu6(x + 3.0) / 6.0


class CABlock(nn.Module):
    """Coordinate attention: the rows' and the columns' means through one
    shared 1x1 conv, BatchNorm and h-swish, then a sigmoid gate for each row
    (`conv_h`) and each column (`conv_w`)."""

    def __init__(self, num_channels: int, reduction: int = 32) -> None:
        super().__init__()
        latent = max(8, num_channels // reduction)
        self.conv_in = Conv(num_channels, latent, (1, 1))
        self.norm = BatchNorm(latent)
        self.conv_h = Conv(latent, num_channels, (1, 1))
        self.conv_w = Conv(latent, num_channels, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.shape[1]
        net_h = x.mean(dim=2, keepdim=True)  # (b, h, 1, c)
        net_w = x.mean(dim=1, keepdim=True).transpose(1, 2)  # (b, w, 1, c)
        net = _h_swish(self.norm(self.conv_in(torch.cat([net_h, net_w], dim=1))))
        gate_h = torch.sigmoid(self.conv_h(net[:, :h]))
        gate_w = torch.sigmoid(self.conv_w(net[:, h:])).transpose(1, 2)
        return x * gate_h * gate_w


class GaussianBlur3(nn.Module):
    """A fixed depthwise [1, 2, 1] x [1, 2, 1] / 16 blur, SAME padding. The
    kernel is a buffer in the JAX variable's HWIO layout (3, 3, 1, C)."""

    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.in_channels = in_channels
        self.register_buffer("kernel", torch.empty(3, 3, 1, in_channels))
        self.reset_buffers()

    def reset_buffers(self) -> None:
        if self.kernel.device.type == "meta":
            return
        base = torch.tensor([1.0, 2.0, 1.0], device=self.kernel.device)
        kernel = base[:, None] * base[None, :] / 16.0
        self.kernel.copy_(kernel[:, :, None, None].expand_as(self.kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.kernel.to(x.dtype).permute(3, 2, 0, 1)
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=1, groups=self.in_channels)
        return y.permute(0, 2, 3, 1)


def conv_nd(
    n: int, in_channels: int, out_channels: int, kernel_size: int, *, stride: int = 1,
    padding: Union[int, str] = 0, use_bias: bool = True, feature_group_count: int = 1,
) -> nn.Module:
    """A rank-`n` channel-last conv (`nnx.Conv`'s keywords): `Conv` for
    n = 2, `ConvN` otherwise. An int `padding` pads every axis by it."""
    pad: Any = padding.upper() if isinstance(padding, str) else [(padding, padding)] * n
    if n == 2:
        return Conv(in_channels, out_channels, (kernel_size,) * 2, strides=(stride,) * 2, padding=pad,
                    use_bias=use_bias, groups=feature_group_count)
    return ConvN(in_channels, out_channels, (kernel_size,) * n, strides=(stride,) * n, padding=pad,
                 use_bias=use_bias, groups=feature_group_count)


def get_conv_blocks(
    in_channels: int,
    out_channels: int,
    kernel_size: int,
    stride: int,
    *,
    bias: bool = True,
    norm_type: Optional[str] = None,
    norm_kwargs: Optional[Any] = None,
    activation: Optional[Any] = None,
    pre_activate: bool = False,
    **conv2d_kwargs: Any,
) -> List[nn.Module]:
    """[conv, norm, activation], or [norm, activation, conv] with
    `pre_activate`; the norm (over the conv's output channels, or its input
    channels when pre-activated) and the activation (a name or a module)
    where given."""
    from .norms import NormFactory

    conv = Conv2d(in_channels, out_channels, kernel_size=kernel_size, stride=stride, bias=bias, **conv2d_kwargs)
    blocks: List[nn.Module] = [] if pre_activate else [conv]
    if norm_type is not None and norm_type != "none":
        blocks.append(NormFactory(norm_type).make(in_channels if pre_activate else out_channels, **(norm_kwargs or {})))
    if activation is not None:
        blocks.append(build_activation(activation) if isinstance(activation, str) else activation)
    if pre_activate:
        blocks.append(conv)
    return blocks


class ResDownsample(nn.Module):
    """`Downsample` with the UNet's signature: a stride-2 3x3 conv, padded
    (1, 1) when `padding` is 1 and (0, 1) otherwise, or a 2x2 average pool."""

    def __init__(self, in_channels: int, use_conv: bool, *, out_channels: Optional[int] = None, padding: int = 1) -> None:
        super().__init__()
        out_channels = out_channels or in_channels
        if not use_conv and in_channels != out_channels:
            raise ValueError("`in_channels` must equal `out_channels` when `use_conv=False`")
        self.net = Downsample(in_channels, out_channels, use_conv=use_conv, symmetric=padding == 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class ResUpsample(nn.Module):
    """A nearest 2x upsample, then a 3x3 conv padded by `padding` when `use_conv`."""

    def __init__(self, in_channels: int, use_conv: bool, *, out_channels: Optional[int] = None, padding: int = 1) -> None:
        super().__init__()
        out_channels = out_channels or in_channels
        self.conv = Conv(in_channels, out_channels, (3, 3), padding=[(padding, padding)] * 2) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = interpolate(x, factor=2.0)
        return x if self.conv is None else self.conv(x)


class ResidualBlockV2(nn.Module):
    """Pre-activation residual block: norm -> leaky ReLU 0.2 -> conv ->
    dropout (in training mode, 0 < dropout < 1) -> norm -> conv, plus the
    input. No activation before the second conv, as in the JAX module."""

    def __init__(
        self, dim: int, dropout: float, kernel_size: int = 3, stride: int = 1, *,
        norm_type: Optional[str] = "batch_norm", **kwargs: Any,
    ) -> None:
        super().__init__()
        from .norms import NormFactory

        factory = NormFactory(norm_type)
        self.norm1 = factory.make(dim)
        self.conv1 = Conv2d(dim, dim, kernel_size=kernel_size, stride=stride)
        self.dropout = dropout if 0.0 < dropout < 1.0 else 0.0
        self.norm2 = factory.make(dim)
        self.conv2 = Conv2d(dim, dim, kernel_size=kernel_size, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.conv1(F.leaky_relu(self.norm1(x), 0.2))
        net = F.dropout(net, self.dropout, self.training)
        return x + self.conv2(self.norm2(net))


def max_pool2d_with_indices(
    x: torch.Tensor, kernel_size: int, stride: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC max pool (VALID windows) with each maximum's flat h * w index in
    its channel (int32), for `MaxUnpool2d`. Of equal values in a window the
    first in row-major order wins, as the JAX reducer's strict `>` keeps it."""
    stride = stride or kernel_size
    b, h, w, c = x.shape
    win = x.unfold(1, kernel_size, stride).unfold(2, kernel_size, stride)  # (b, oh, ow, c, k, k)
    oh, ow = win.shape[1], win.shape[2]
    vals, local = win.reshape(b, oh, ow, c, kernel_size * kernel_size).max(dim=-1)
    rows = torch.arange(oh, device=x.device)[:, None, None] * stride + local // kernel_size
    cols = torch.arange(ow, device=x.device)[None, :, None] * stride + local % kernel_size
    return vals, (rows * w + cols).to(torch.int32)


class MaxUnpool2d(nn.Module):
    """Scatter pooled values back to their argmax positions (indices from
    `max_pool2d_with_indices`) in a zero map of `output_size`."""

    def __init__(self, kernel_size: int, stride: Optional[int] = None) -> None:
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride or kernel_size

    def forward(self, x: torch.Tensor, indices: torch.Tensor, output_size: Tuple[int, int]) -> torch.Tensor:
        b, h, w, c = x.shape
        oh, ow = output_size
        flat = torch.zeros((b, oh * ow, c), dtype=x.dtype, device=x.device)
        flat = flat.scatter(1, indices.reshape(b, h * w, c).long(), x.reshape(b, h * w, c))
        return flat.reshape(b, oh, ow, c)
