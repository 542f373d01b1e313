"""Channel-last layers with flax `nnx` semantics.

The port's counterparts of `nnx.Linear`, `nnx.Conv`, `nnx.LayerNorm`,
`nnx.GroupNorm`, `nnx.BatchNorm` and `nnx.Embed`. Parameters carry PyTorch's names and
layouts (`weight` (out, in) for Linear, OIHW for Conv); `cflearn_torch.bridge`
maps the JAX package's parameters onto them. Like flax, each layer computes
in the promoted dtype of its input and parameters (an f32 input meets bf16
weights in f32), and the norms take their statistics in f32.
"""

from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import kernel_weight
from ..ops.group_norm import module_call as group_norm_call

_Padding = Union[str, Sequence[Tuple[int, int]]]


def _promote(x: torch.Tensor, *params: Optional[torch.Tensor]) -> torch.dtype:
    dtype = x.dtype
    for p in params:
        if p is not None:
            dtype = torch.promote_types(dtype, p.dtype)
    return dtype


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _promote(x, self.weight)
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class Conv(nn.Module):
    """NHWC 2-D conv, OIHW weight. `padding` is "SAME" or JAX-style
    ((top, bottom), (left, right))."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Tuple[int, int] = (3, 3),
        *,
        strides: Tuple[int, int] = (1, 1),
        padding: _Padding = "SAME",
        use_bias: bool = True,
    ) -> None:
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.strides = tuple(strides)
        self.padding = padding.upper() if isinstance(padding, str) else tuple(map(tuple, padding))
        self.dilation = (1, 1)
        self.groups = 1
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None
        self._kernel_cache: Optional[Tuple[Any, torch.Tensor]] = None

    def _pads(self) -> List[Tuple[int, int]]:
        if self.padding == "SAME":
            pads = []
            for k, s in zip(self.weight.shape[2:], self.strides):
                total = max(k - s, 0)  # XLA "SAME" for input sizes divisible by the stride
                pads.append((total // 2, total - total // 2))
            return pads
        if self.padding == "VALID":
            return [(0, 0), (0, 0)]
        return [tuple(p) for p in self.padding]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _promote(x, self.weight)
        (pt, pb), (pl, pr) = self._pads()
        xc = x.to(dtype).permute(0, 3, 1, 2)
        if pt == pb and pl == pr:
            pad: Any = (pt, pl)
        else:
            xc = F.pad(xc, (pl, pr, pt, pb))
            pad = 0
        bias = None if self.bias is None else self.bias.to(dtype)
        y = F.conv2d(xc, self.weight.to(dtype), bias, stride=self.strides, padding=pad)
        return y.permute(0, 2, 3, 1)

    def kernel_weight(self) -> torch.Tensor:
        """The weight in the conv kernel's (Co, 3, 3, C) layout, rearranged
        once and cached until the parameter changes. Where the weight carries
        a gradient the rearrangement stays on the graph and is not cached."""
        if torch.is_grad_enabled() and self.weight.requires_grad:
            return kernel_weight(self.weight)
        key = (self.weight.data_ptr(), self.weight._version, self.weight.dtype, self.weight.device)
        if self._kernel_cache is None or self._kernel_cache[0] != key:
            self._kernel_cache = (key, kernel_weight(self.weight.detach()))
        return self._kernel_cache[1]


class LayerNorm(nn.Module):
    def __init__(self, dim: int, *, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _promote(x, self.weight, self.bias)
        y = F.layer_norm(
            x.float(), x.shape[-1:], self.weight.float(), self.bias.float(), self.eps
        )
        return y.to(dtype)


class GroupNorm(nn.Module):
    def __init__(self, num_channels: int, *, num_groups: int = 32, eps: float = 1e-6) -> None:
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_call(x, self.weight, self.bias, num_groups=self.num_groups, eps=self.eps)


class BatchNorm(nn.Module):
    """`nnx.BatchNorm` over the last axis of a channel-last input.

    It differs from `torch.nn.BatchNorm2d` where flax does: the running
    statistics move by `momentum` = 0.99 as ra = momentum * ra + (1 -
    momentum) * batch (PyTorch: 0.1, weighted the other way round), the
    running variance averages the **biased** batch variance (PyTorch: the
    unbiased one), eps is 1e-5 and the variance is E[x^2] - E[x]^2 clipped at
    0. Statistics are taken in at least f32. Like flax, the layer computes in
    the promoted dtype of the input, the running statistics and the
    parameters: with f32 running statistics a bf16 input leaves as f32.
    `mean` and `var` are buffers (flax `BatchStat`), updated in place in
    training mode."""

    def __init__(self, num_features: int, *, momentum: float = 0.99, eps: float = 1e-5) -> None:
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _promote(x, self.mean, self.var, self.weight, self.bias)
        x = x.to(dtype)
        if self.training:
            xs = x.to(torch.promote_types(dtype, torch.float32))
            axes = tuple(range(x.ndim - 1))
            mean = xs.mean(dim=axes)
            var = (xs.square().mean(dim=axes) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(mean.to(self.mean.dtype), alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(var.to(self.var.dtype), alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean.to(dtype), self.var.to(dtype)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(dtype)
        return (x - mean.to(dtype)) * mul.to(dtype) + self.bias.to(dtype)


class Embed(nn.Embedding):
    """`nnx.Embed`: a lookup in the table's dtype."""
