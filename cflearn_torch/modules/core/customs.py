"""Custom blocks (counterpart of `cflearn_tpu/modules/core/customs.py`):
`Linear` with an optional soft `Pruner`, `DNDF` (a differentiable neural
decision forest), `DropPath` (stochastic depth) and the functional
`leaf_aggregation` and `route`. Autograd differentiates every expression as
written."""

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..layers import Linear as _Linear


class Linear(nn.Module):
    """A linear layer whose kernel goes through `Pruner` first when a
    `pruner_config` is given."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        *,
        bias: bool = True,
        pruner_config: Optional[dict] = None,
        init_method: Optional[str] = None,
    ) -> None:
        super().__init__()
        self.linear = _Linear(in_dim, out_dim, bias=bias)
        self.pruner = Pruner(pruner_config) if pruner_config is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pruner is None:
            return self.linear(x)
        # the kernel in the JAX (in, out) layout, as the pruner's mean sees it
        out = x @ self.pruner(self.linear.weight.t())
        return out if self.linear.bias is None else out + self.linear.bias


class Pruner(nn.Module):
    """w * sigmoid(beta (|w| / (mean |w| + eps) - gamma softplus(alpha)))."""

    def __init__(self, config: Optional[dict] = None) -> None:
        super().__init__()
        config = config or {}
        self.eps = config.get("eps", 1e-12)
        self.beta = config.get("beta", 1.0)
        self.gamma = config.get("gamma", 1.0)
        self.alpha_init = float(config.get("alpha", 1e-4))
        self.alpha = nn.Parameter(torch.tensor(self.alpha_init))

    def init_constants(self) -> None:
        with torch.no_grad():
            self.alpha.fill_(self.alpha_init)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        abs_w = w.abs()
        gate = torch.sigmoid(
            self.beta * (abs_w / (abs_w.mean() + self.eps) - self.gamma * nn.functional.softplus(self.alpha))
        )
        return w * gate


def tree_masks(tree_depth: int) -> np.ndarray:
    """(2, leaves, internals) f32: for each leaf, the internal nodes on its
    path (1) and the direction taken at each (1 = right)."""
    num_leaves, num_internals = 2**tree_depth, 2**tree_depth - 1
    masks = np.zeros((2, num_leaves, num_internals), dtype=np.float32)
    for leaf in range(num_leaves):
        node = 0
        for depth in range(tree_depth):
            bit = (leaf >> (tree_depth - 1 - depth)) & 1
            masks[0, leaf, node] = 1.0
            masks[1, leaf, node] = float(bit)
            node = 2 * node + 1 + bit
    return masks


class DNDF(nn.Module):
    """`num_tree` soft trees of `tree_depth`: the input's planes (sigmoid)
    route to the leaves (each leaf the product of its path's probabilities,
    taken as a sum of clipped logs), whose class distributions (softmax of
    `leaves`, uniform [0, 1) at init, unless a regression) average over the
    trees. Without `out_dim` it returns the routes. `_path` and `_sign` are
    the fixed tree masks (buffers, the JAX package's `nnx.Variable`s)."""

    def __init__(
        self,
        in_dim: int,
        out_dim: Optional[int] = None,
        *,
        num_tree: int = 10,
        tree_depth: int = 4,
        is_regression: Optional[bool] = None,
        output_probabilities: bool = True,
    ) -> None:
        super().__init__()
        self.num_tree = num_tree
        self.tree_depth = tree_depth
        self.num_internals = 2**tree_depth - 1
        self.num_leaves = 2**tree_depth
        self.out_dim = out_dim
        self.output_probabilities = output_probabilities
        self.is_regression = is_regression if is_regression is not None else (out_dim == 1)
        self.to_planes = _Linear(in_dim, num_tree * self.num_internals)
        self.leaves = nn.Parameter(torch.empty(num_tree, self.num_leaves, out_dim)) if out_dim is not None else None
        masks = torch.from_numpy(tree_masks(tree_depth))
        self.register_buffer("_path", masks[0].clone())
        self.register_buffer("_sign", masks[1].clone())

    def reset_buffers(self) -> None:
        masks = torch.from_numpy(tree_masks(self.tree_depth))
        self._path.copy_(masks[0])
        self._sign.copy_(masks[1])

    def init_constants(self) -> None:
        """The leaves ~ U[0, 1): `init_parameters`' N(0, 1 / fan_in) draw
        through the normal CDF."""
        if self.leaves is not None and self.leaves.device.type != "meta":
            with torch.no_grad():
                fan = self.leaves[0].numel()
                self.leaves.copy_(0.5 * (1.0 + torch.erf(self.leaves * math.sqrt(fan / 2.0))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        planes = torch.sigmoid(self.to_planes(x)).reshape(b, self.num_tree, self.num_internals)
        sign, path = self._sign, self._path
        log_p = torch.log(planes.clamp(1e-8, 1.0))
        log_not = torch.log((1.0 - planes).clamp(1e-8, 1.0))
        leaf_log = torch.einsum("bti,li->btl", log_p, path * sign) + torch.einsum(
            "bti,li->btl", log_not, path * (1.0 - sign)
        )
        routes = torch.exp(leaf_log)
        if self.leaves is None:
            return routes.reshape(b, -1)
        leaves = self.leaves
        if not self.is_regression and self.output_probabilities:
            leaves = torch.softmax(leaves, dim=-1)
        return torch.einsum("btl,tlo->bo", routes, leaves) / self.num_tree


class DropPath(nn.Module):
    """Stochastic depth: in training mode each sample is kept with 1 - rate
    (and scaled by 1 / (1 - rate)), drawn from `generator` where one is set."""

    def __init__(self, rate: float = 0.0) -> None:
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def leaf_aggregation(net: torch.Tensor, leaves: torch.Tensor) -> torch.Tensor:
    """net @ softmax(leaves, axis 1)."""
    return net @ torch.softmax(leaves, dim=1)


def route(planes: torch.Tensor, path_mask: torch.Tensor, sign_mask: torch.Tensor) -> torch.Tensor:
    """Each leaf's routing probability from the internal nodes' plane
    logits: `planes` (B, T, I), the (L, I) path and sign masks; (B, T, L)."""
    p_left = torch.sigmoid(planes)[:, :, None, :]
    p = torch.where(sign_mask[None, None] > 0.5, 1.0 - p_left, p_left)
    log_p = torch.where(path_mask[None, None] > 0.5, torch.log(p.clamp_min(1e-12)), torch.zeros_like(p))
    return torch.exp(log_p.sum(dim=-1))


LeafAggregation = leaf_aggregation
Route = route
