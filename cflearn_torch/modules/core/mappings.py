"""Mapping blocks (counterpart of `cflearn_tpu/modules/core/mappings.py`):
Linear -> norm -> activation -> dropout stacks behind the "mapping."
registry, which FCNN and its relatives build by name: "basic", "highway"
(a sigmoid gate between a linear and a non-linear mapping) and "res" (two
mappings and a skip). The norms come from `NormFactory` (flax's BatchNorm:
momentum 0.99, the biased variance, eps 1e-5); dropout acts in training
mode only."""

from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import PrefixModules
from ..layers import Linear
from .activations import build_activation
from .norms import NormFactory

mappings = PrefixModules("mapping")


@mappings.register("basic")
class MappingBlock(nn.Module):
    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        *,
        bias: bool = True,
        norm_type: Optional[str] = "batch_norm",
        activation: Optional[str] = "relu",
        dropout: float = 0.0,
    ) -> None:
        super().__init__()
        self.linear = Linear(in_dim, out_dim, bias=bias)
        self.norm = NormFactory(norm_type).make(out_dim)
        self.activation = build_activation(activation)
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.activation(self.norm(self.linear(x)))
        return F.dropout(x, self.dropout, self.training) if self.dropout > 0.0 else x


@mappings.register("highway")
class HighwayBlock(nn.Module):
    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        *,
        bias: bool = True,
        norm_type: Optional[str] = "batch_norm",
        activation: Optional[str] = "relu",
        dropout: float = 0.0,
    ) -> None:
        super().__init__()
        self.linear_mapping = MappingBlock(in_dim, out_dim, bias=bias, norm_type=norm_type, activation=None)
        self.nonlinear_mapping = MappingBlock(
            in_dim, out_dim, bias=bias, norm_type=norm_type, activation=activation, dropout=dropout
        )
        self.gate_linear = Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.gate_linear(x))
        return gate * self.nonlinear_mapping(x) + (1.0 - gate) * self.linear_mapping(x)


@mappings.register("res")
class ResBlock(nn.Module):
    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        *,
        bias: bool = True,
        norm_type: Optional[str] = "batch_norm",
        activation: Optional[str] = "relu",
        dropout: float = 0.0,
    ) -> None:
        super().__init__()
        self.to_out = Linear(in_dim, out_dim, bias=bias) if in_dim != out_dim else None
        self.block1 = MappingBlock(
            out_dim, out_dim, bias=bias, norm_type=norm_type, activation=activation, dropout=dropout
        )
        self.block2 = MappingBlock(out_dim, out_dim, bias=bias, norm_type=norm_type, activation=None)
        self.activation = build_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.to_out is not None:
            x = self.to_out(x)
        return self.activation(x + self.block2(self.block1(x)))


def build_mapping(name: str, *args: Any, **kwargs: Any) -> nn.Module:
    return mappings.build(name, *args, **kwargs)


register_mapping = mappings.register
