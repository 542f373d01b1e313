"""Activations on the SD path (counterpart of
`cflearn_tpu/modules/core/activations.py`). `jax.nn.gelu` defaults to the
tanh approximation, so GELU here is `approximate="tanh"`."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Linear


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class GEGLU(nn.Module):
    """GEGLU with its projection."""

    def __init__(self, *, in_dim: int, out_dim: int) -> None:
        super().__init__()
        self.net = Linear(in_dim, out_dim * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.net(x).chunk(2, dim=-1)
        return x * gelu(gate)
