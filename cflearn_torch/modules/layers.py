"""Channel-last layers with flax `nnx` semantics.

The port's counterparts of `nnx.Linear`, `nnx.Conv`, `nnx.LayerNorm`,
`nnx.GroupNorm` and `nnx.Embed`. Parameters carry PyTorch's names and
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
from ..ops.group_norm import group_norm

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
        once and cached until the parameter changes."""
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
        return group_norm(x, self.weight, self.bias, num_groups=self.num_groups, eps=self.eps)


class Embed(nn.Embedding):
    """`nnx.Embed`: a lookup in the table's dtype."""
