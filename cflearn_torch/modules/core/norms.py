"""Norm layers and `NormFactory` (counterpart of
`cflearn_tpu/modules/core/norms.py`). Channel-last (NHWC) throughout; the
layers keep flax's defaults and compute like the port's other norms (`layers`):
statistics in f32, the result in the promoted dtype of input and parameters."""

from typing import Any, Optional

import torch
import torch.nn as nn

from ..layers import BatchNorm, GroupNorm, LayerNorm, _promote


class PixelNorm(nn.Module):
    """x / sqrt(mean(x^2 over channels) + 1e-8)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x / torch.sqrt(x.square().mean(dim=-1, keepdim=True) + 1e-8)


class AdaptiveInstanceNorm2d(nn.Module):
    """AdaIN: each sample's channels normalised over H and W, then scaled and
    shifted by the (B, C) `scale` and `bias` given at call time."""

    def __init__(self, dim: int, *, eps: float = 1e-5) -> None:
        super().__init__()
        self.dim = dim
        self.eps = eps

    def forward(self, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
        normed = (x - mean) * torch.rsqrt(var + self.eps)
        return normed * scale[:, None, None, :] + bias[:, None, None, :]


class RMSNorm(nn.Module):
    """`nnx.RMSNorm` over the last axis: x / sqrt(mean(x^2) + eps) x scale,
    the mean in f32."""

    def __init__(self, dim: int, *, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _promote(x, self.weight)
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps) * self.weight.float()
        return y.to(dtype)


def _eps(kwargs: dict) -> dict:
    """flax's `epsilon` keyword under the port layers' name."""
    if "epsilon" in kwargs:
        kwargs["eps"] = kwargs.pop("epsilon")
    return kwargs


class NormFactory:
    """Build norms by type name: None / "none" (identity), "batch_norm" /
    "batch", "layer_norm" / "layer", "rms_norm", "group_norm" (`num_groups`,
    32 by default: through `GroupNorm`, so the kernel on the card),
    "pixel_norm" and "instance_norm" (a GroupNorm of one channel a group).
    Keywords go to the layer, flax's `epsilon` as `eps`."""

    def __init__(self, norm_type: Optional[str]) -> None:
        self.norm_type = norm_type

    def make(self, dim: int, **kwargs: Any) -> nn.Module:
        nt = self.norm_type
        kwargs = _eps(dict(kwargs))
        if nt is None or nt == "none":
            return nn.Identity()
        if nt in ("batch_norm", "batch"):
            return BatchNorm(dim, **kwargs)
        if nt in ("layer_norm", "layer"):
            return LayerNorm(dim, **kwargs)
        if nt == "rms_norm":
            return RMSNorm(dim, **kwargs)
        if nt == "group_norm":
            return GroupNorm(dim, num_groups=kwargs.pop("num_groups", 32), **kwargs)
        if nt == "pixel_norm":
            return PixelNorm()
        if nt == "instance_norm":
            return GroupNorm(dim, num_groups=dim, **kwargs)
        raise ValueError(f"unrecognized norm type '{nt}'")


# the JAX package's aliases: NHWC BatchNorm / LayerNorm
BN = BatchNorm
LN = LayerNorm
