"""Activations (counterpart of `cflearn_tpu/modules/core/activations.py`):
the registry (`register_activation`, `build_activation`), the simple
activations registered by name, `Sine` (SIREN's sin(w x)), `GEGLU` with its
projection and `DiffReLU`. `jax.nn.gelu` defaults to the tanh
approximation, so GELU here is `approximate="tanh"`."""

from typing import Any, Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import PrefixModules
from ..layers import Linear

activations = PrefixModules("activation")


def register_activation(name: str, **kwargs: Any) -> Callable[[type], type]:
    return activations.register(name, **kwargs)


def build_activation(name: Optional[str], **kwargs: Any) -> nn.Module:
    """The activation registered as `name` ("identity" for None), built
    with `kwargs` (GEGLU's `in_dim` / `out_dim`, Sine's `w`)."""
    return activations.build("identity" if name is None else name, **kwargs)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _Fn(nn.Module):
    fn: Callable[[torch.Tensor], torch.Tensor]

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return type(self).fn(x)


def _simple(name: str, fn: Callable[[torch.Tensor], torch.Tensor]) -> type:
    cls = type(name.capitalize(), (_Fn,), {"fn": staticmethod(fn)})
    return activations.register(name)(cls)


def _glu(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


_simple("identity", lambda x: x)
_simple("relu", F.relu)
_simple("relu6", F.relu6)
_simple("leaky_relu", lambda x: F.leaky_relu(x, 0.01))
_simple("leaky_relu_0.2", lambda x: F.leaky_relu(x, 0.2))
_simple("gelu", gelu)
_simple("quick_gelu", quick_gelu)
_simple("silu", F.silu)
_simple("swish", F.silu)
_simple("sigmoid", torch.sigmoid)
_simple("tanh", torch.tanh)
_simple("softmax", lambda x: torch.softmax(x, dim=-1))
_simple("mish", lambda x: x * torch.tanh(F.softplus(x)))
_simple("h_swish", lambda x: x * (F.relu6(x + 3.0) / 6.0))
_simple("glu", _glu)
_simple("atanh", lambda x: torch.atanh(x.clamp(-1.0 + 1e-6, 1.0 - 1e-6)))
_simple("isoftplus", lambda x: torch.log(torch.expm1(x).clamp_min(1e-12)))


@register_activation("sine")
class Sine(nn.Module):
    """SIREN's activation, sin(w x)."""

    def __init__(self, *, w: float = 1.0) -> None:
        super().__init__()
        self.w = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sin(self.w * x)


@register_activation("geglu")
class GEGLU(nn.Module):
    """GEGLU with its projection."""

    def __init__(self, *, in_dim: int, out_dim: int) -> None:
        super().__init__()
        self.net = Linear(in_dim, out_dim * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.net(x).chunk(2, dim=-1)
        return x * gelu(gate)


@register_activation("diff_relu")
class DiffReLU(nn.Module):
    """relu(x) - relu(x - 1): x clipped to [0, 1]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x) - F.relu(x - 1.0)
