"""Small numerical helpers (counterpart of part of `cflearn_tpu/toolkit/misc.py`)."""

from typing import Optional, Union

import torch


def slerp(
    x1: torch.Tensor,
    x2: torch.Tensor,
    r1: Union[float, torch.Tensor],
    r2: Optional[Union[float, torch.Tensor]] = None,
    *,
    dot_threshold: float = 0.9995,
) -> torch.Tensor:
    """Spherical interpolation per sample (the leading axis): r1 of `x1`
    and r2 (default 1 - r1) of `x2`; nearly parallel samples are lerped."""
    if r2 is None:
        r2 = 1.0 - r1
    b = x1.shape[0]
    x1f, x2f = x1.reshape(b, -1), x2.reshape(b, -1)
    low_norm = x1f / torch.linalg.norm(x1f, dim=1, keepdim=True)
    high_norm = x2f / torch.linalg.norm(x2f, dim=1, keepdim=True)
    dot = (low_norm * high_norm).sum(dim=1, keepdim=True)
    omega = torch.arccos(dot.clamp(-1.0, 1.0))
    so = torch.sin(omega)
    lerped = r1 * x1f + r2 * x2f
    slerped = (torch.sin(r1 * omega) / so) * x1f + (torch.sin(r2 * omega) / so) * x2f
    return torch.where(dot.abs() > dot_threshold, lerped, slerped).reshape(x1.shape)
