"""GroupNorm (+ optional SiLU) over channel-last input.

Counterpart of `cflearn_tpu/ops/group_norm.py`'s default path (`gn_call`
without `CFLEARN_TPU_FUSED_GN`): the JAX package leaves GroupNorm to XLA by
default, so this slice has no kernel for it. The arithmetic follows flax's
GroupNorm: statistics in f32 with var = E[x^2] - E[x]^2 clipped at 0, the
affine in f32, the result cast to the promoted input/parameter dtype.
"""

from typing import Any, Optional

import torch
import torch.nn.functional as F


def group_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    *,
    num_groups: int = 32,
    eps: float = 1e-6,
    apply_silu: bool = False,
) -> torch.Tensor:
    """x: (B, ..., C). Statistics per sample and group over all other axes."""
    out_dtype = x.dtype
    for p in (weight, bias):
        if p is not None:
            out_dtype = torch.promote_types(out_dtype, p.dtype)
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    mean2 = xf.square().mean(dim=(1, 3), keepdim=True)
    var = (mean2 - mean.square()).clamp_min(0.0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    y = y.to(out_dtype)
    return F.silu(y) if apply_silu else y


def gn_call(gn: Any, x: torch.Tensor, *, silu: bool = False) -> torch.Tensor:
    """Run a port `GroupNorm` module, then SiLU in the output dtype."""
    out = gn(x)
    return F.silu(out) if silu else out
