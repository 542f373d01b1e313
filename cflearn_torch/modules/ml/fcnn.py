"""The fully-connected net (counterpart of `cflearn_tpu/modules/ml/fcnn.py`):
a mapping block a hidden width ([64, 64] by default; "basic": Linear ->
BatchNorm -> ReLU), then a linear head."""

from typing import List, Optional

import torch
import torch.nn as nn

from ..common import register_module
from ..core.mappings import build_mapping
from ..layers import Linear


@register_module("fcnn")
class FCNN(nn.Module):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        hidden_units: Optional[List[int]] = None,
        *,
        mapping_type: str = "basic",
        bias: bool = True,
        norm_type: Optional[str] = "batch_norm",
        activation: Optional[str] = "relu",
        dropout: float = 0.0,
    ) -> None:
        super().__init__()
        if hidden_units is None:
            hidden_units = [64, 64]
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.hidden_units = hidden_units
        blocks = []
        in_dim = input_dim
        for hidden in hidden_units:
            blocks.append(build_mapping(
                mapping_type, in_dim, hidden, bias=bias, norm_type=norm_type, activation=activation, dropout=dropout
            ))
            in_dim = hidden
        self.blocks = nn.ModuleList(blocks)
        self.head = Linear(in_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return self.head(x)
