"""Channel-last layers with flax `nnx` semantics.

The port's counterparts of `nnx.Linear`, `nnx.Conv` (`Conv` at rank 2,
`ConvN` at ranks 1 and 3), `nnx.LayerNorm`,
`nnx.GroupNorm`, `nnx.BatchNorm` and `nnx.Embed`, and of `jax.image.resize`
(`resize`: its nearest, linear and cubic methods). Parameters carry PyTorch's names and
layouts (`weight` (out, in) for Linear, OIHW for Conv); `cflearn_torch.bridge`
maps the JAX package's parameters onto them. Like flax, each layer computes
in the promoted dtype of its input and parameters (an f32 input meets bf16
weights in f32), and the norms take their statistics in f32.
"""

from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
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
    """NHWC 2-D conv, OIHW weight ((out, in / groups, kh, kw)). `padding` is
    "SAME", "VALID" or JAX-style ((top, bottom), (left, right));
    `dilation` is the kernel's (`kernel_dilation`), `groups` flax's
    `feature_group_count`."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Tuple[int, int] = (3, 3),
        *,
        strides: Tuple[int, int] = (1, 1),
        padding: _Padding = "SAME",
        use_bias: bool = True,
        dilation: Tuple[int, int] = (1, 1),
        groups: int = 1,
    ) -> None:
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.strides = tuple(strides)
        self.padding = padding.upper() if isinstance(padding, str) else tuple(map(tuple, padding))
        self.dilation = tuple(dilation)
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, *kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None
        self._kernel_cache: Optional[Tuple[Any, torch.Tensor]] = None

    def _pads(self, size: Tuple[int, int], kernel: Tuple[int, int], padding: Any) -> List[Tuple[int, int]]:
        if padding == "SAME":
            return same_pads(size, kernel, self.strides, self.dilation)
        if padding == "VALID":
            return [(0, 0), (0, 0)]
        return [tuple(p) for p in padding]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_with(x, self.weight, self.padding)

    def conv_with(self, x: torch.Tensor, weight: torch.Tensor, padding: Any) -> torch.Tensor:
        """This conv's strides, dilation, groups and bias with another OIHW
        `weight` and `padding` (`Conv2d`'s transformed kernel and wrapped
        input)."""
        dtype = _promote(x, weight)
        (pt, pb), (pl, pr) = self._pads(x.shape[1:3], weight.shape[2:], padding)
        xc = x.to(dtype).permute(0, 3, 1, 2)
        if pt == pb and pl == pr:
            pad: Any = (pt, pl)
        else:
            xc = F.pad(xc, (pl, pr, pt, pb))
            pad = 0
        bias = None if self.bias is None else self.bias.to(dtype)
        y = F.conv2d(xc, weight.to(dtype), bias, stride=self.strides, padding=pad, dilation=self.dilation,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)

    def kernel_weight(self) -> torch.Tensor:
        """The weight in the conv kernel's (Co, 3, 3, C) layout, rearranged
        once and cached until the parameter changes. Where the weight carries
        a gradient the rearrangement stays on the graph and is not cached, nor
        under tracing."""
        # a traced weight (`torch.export`'s fake tensors) has no storage to key the cache by
        if (torch.is_grad_enabled() and self.weight.requires_grad) or torch.compiler.is_compiling():
            return kernel_weight(self.weight)
        key = (self.weight.data_ptr(), self.weight._version, self.weight.dtype, self.weight.device)
        if self._kernel_cache is None or self._kernel_cache[0] != key:
            self._kernel_cache = (key, kernel_weight(self.weight.detach()))
        return self._kernel_cache[1]


def same_pads(size: Sequence[int], kernel: Sequence[int], strides: Sequence[int], dilation: Sequence[int]) -> List[Tuple[int, int]]:
    """XLA's "SAME" along each axis: ceil(n / s) outputs, the padding they need split with the odd pixel at
    the end: a 4x4 stride-2 conv pads 28 px by (1, 1), 7 px by (1, 2)."""
    pads = []
    for n, k, s, d in zip(size, kernel, strides, dilation):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


class ConvN(nn.Module):
    """`nnx.Conv` of rank 1 or 3 on a channel-last input (B, *spatial, C):
    weight (out, in / groups, *kernel), `padding` "SAME", "VALID" or one
    (lo, hi) pair per spatial axis. The rank-2 conv is `Conv`."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Tuple[int, ...],
        *,
        strides: Optional[Tuple[int, ...]] = None,
        padding: _Padding = "SAME",
        use_bias: bool = True,
        groups: int = 1,
    ) -> None:
        super().__init__()
        self.rank = len(kernel_size)
        if self.rank not in (1, 3):
            raise ValueError(f"ConvN takes rank 1 or 3, not {self.rank} (rank 2 is `Conv`)")
        self.strides = tuple(strides or (1,) * self.rank)
        self.padding = padding.upper() if isinstance(padding, str) else tuple(map(tuple, padding))
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, *kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _promote(x, self.weight)
        n = self.rank
        if self.padding == "SAME":
            pads = same_pads(x.shape[1:1 + n], self.weight.shape[2:], self.strides, (1,) * n)
        elif self.padding == "VALID":
            pads = [(0, 0)] * n
        else:
            pads = list(self.padding)
        xc = x.to(dtype).movedim(-1, 1)
        xc = F.pad(xc, [p for lo_hi in reversed(pads) for p in lo_hi])
        conv = F.conv1d if n == 1 else F.conv3d
        bias = None if self.bias is None else self.bias.to(dtype)
        return conv(xc, self.weight.to(dtype), bias, stride=self.strides, groups=self.groups).movedim(1, -1)


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
    training mode. Inside a train step on a mesh the batch statistics are
    those of the global batch (`parallel.mesh.global_mean`), as the JAX
    step computes them."""

    def __init__(self, num_features: int, *, momentum: float = 0.99, eps: float = 1e-5) -> None:
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def reset_buffers(self) -> None:
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _promote(x, self.mean, self.var, self.weight, self.bias)
        x = x.to(dtype)
        if self.training:
            from ..parallel.mesh import global_mean

            xs = x.to(torch.promote_types(dtype, torch.float32))
            axes = tuple(range(x.ndim - 1))
            # over the global batch where it is sharded over a mesh's data x fsdp (one rank: the plain mean)
            mean = global_mean(xs, axes)
            var = (global_mean(xs.square(), axes) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(mean.to(self.mean.dtype), alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(var.to(self.var.dtype), alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean.to(dtype), self.var.to(dtype)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(dtype)
        return (x - mean.to(dtype)) * mul.to(dtype) + self.bias.to(dtype)


class Embed(nn.Embedding):
    """`nnx.Embed`: a lookup in the table's dtype."""


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5."""
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


_RESIZE_KERNELS = {"linear": _triangle, "bilinear": _triangle, "trilinear": _triangle, "triangle": _triangle,
                   "cubic": _keys_cubic, "bicubic": _keys_cubic, "tricubic": _keys_cubic}


def resize_weights(in_size: int, out_size: int, method: str, antialias: bool = True) -> np.ndarray:
    """(in_size, out_size) f32 weights of one axis of `jax.image.resize`
    (`compute_weight_mat` of `jax._src.image.scale`, in f32 as there): the
    kernel at the half-pixel sample positions, widened by 1 / scale where
    the axis shrinks (`antialias`), each column normalised over the taps
    inside the input, and zero where a sample falls outside it."""
    kernel = _RESIZE_KERNELS[method]
    inv_scale = np.float32(1.0) / np.float32(out_size / in_size)
    kernel_scale = max(inv_scale, np.float32(1.0)) if antialias else np.float32(1.0)
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = kernel(x.astype(np.float32))
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    weights = np.where(ok, weights / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= np.float32(in_size) - np.float32(0.5))
    return np.where(inside[None, :], weights, np.float32(0.0)).astype(np.float32)


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """`jax.image.resize`'s nearest sample of each output pixel:
    floor((i + 0.5) * in / out), in f32."""
    offsets = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(in_size) / np.float32(out_size)
    return np.floor(offsets).astype(np.int64)


def resize(x: torch.Tensor, size: Tuple[int, int], method: str = "bilinear", *, antialias: bool = True) -> torch.Tensor:
    """`jax.image.resize(x, (b, h, w, c), method)` on NHWC `x`: "nearest"
    gathers each output pixel's sample (`nearest_indices`); the linear and
    cubic methods (Keys, a = -0.5) apply each changed axis's weights
    (`resize_weights`, built on the host) as a product in x's floating
    dtype (f32 for an integer x). Half-pixel centres throughout."""
    out = x if x.is_floating_point() or method == "nearest" else x.float()
    for axis, n in ((1, int(size[0])), (2, int(size[1]))):
        m = out.shape[axis]
        if m == n:
            continue
        if method == "nearest":
            out = out.index_select(axis, torch.as_tensor(nearest_indices(m, n), device=x.device))
            continue
        if method not in _RESIZE_KERNELS:
            raise ValueError(f"resize: unknown method '{method}'")
        w = torch.as_tensor(resize_weights(m, n, method, antialias), device=x.device).to(out.dtype)
        out = torch.einsum("bhwc,hH->bHwc" if axis == 1 else "bhwc,wW->bhWc", out, w)
    return out


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`jax.image.resize(x, (b, h, w, c), "bilinear")` on NHWC: half-pixel
    centres, and a triangle kernel widened by the scale where it shrinks
    (antialiased), computed in f32 and returned in x's dtype."""
    return resize(x.float(), (h, w), "bilinear").to(x.dtype)
