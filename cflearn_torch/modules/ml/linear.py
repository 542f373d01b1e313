"""The linear model (counterpart of `cflearn_tpu/modules/ml/linear.py`)."""

import torch
import torch.nn as nn

from ..common import register_module
from ..layers import Linear


@register_module("linear")
class LinearModule(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, *, bias: bool = True) -> None:
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.net = Linear(input_dim, output_dim, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)
