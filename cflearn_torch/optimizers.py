"""Optimizer registry (counterpart of `cflearn_tpu/optimizers.py`).

`sgd`, `adam` and `adamw` with optax's update rules, written out on
`torch._foreach_*` so that one step of a large parameter list is a few
launches: weight decay of `sgd` / `adam` is added to the gradient
(`optax.add_decayed_weights` ahead of the transform), `adamw` decays the
parameter inside the update, and Adam's step is
mu_hat / (sqrt(nu_hat) + eps) with both moments bias-corrected. Moments are
kept in the parameters' dtype (f32 masters -> f32 moments).
`clip_by_global_norm` is `optax.clip_by_global_norm`. `rmsprop`, `nadam`,
`adamp` and `OptimizerPack` are not ported yet.
"""

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

optimizer_dict: Dict[str, Callable[..., "Optimizer"]] = {}


def register_optimizer(name: str) -> Callable:
    def _core(fn: Callable[..., "Optimizer"]) -> Callable:
        optimizer_dict[name] = fn
        return fn

    return _core


def build_optimizer(name: str, lr: float, **kwargs: Any) -> "Optimizer":
    if name not in optimizer_dict:
        raise ValueError(f"optimizer '{name}' is not registered (available: {sorted(optimizer_dict)})")
    return optimizer_dict[name](lr, **kwargs)


class Optimizer:
    """`step(params, grads)` updates `params` in place; state is allocated at
    the first step, one slot list per moment, in the order of `params`."""

    def __init__(self, lr: float) -> None:
        self.lr = lr
        self.count = 0
        self.state: Dict[str, List[torch.Tensor]] = {}

    def _slot(self, name: str, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if name not in self.state:
            self.state[name] = [torch.zeros_like(p) for p in params]
        return self.state[name]

    def updates(self, params: Sequence[torch.Tensor], grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The step direction u (the update is p -= lr * u). May overwrite `grads`."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
        self.count += 1
        u = self.updates(params, [g.to(p.dtype) for g, p in zip(grads, params)])
        torch._foreach_add_(list(params), u, alpha=-self.lr)


class SGD(Optimizer):
    def __init__(self, lr: float, *, momentum: float = 0.0, nesterov: bool = False, weight_decay: float = 0.0) -> None:
        super().__init__(lr)
        self.momentum, self.nesterov, self.weight_decay = momentum, nesterov, weight_decay

    def updates(self, params: Sequence[torch.Tensor], grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.weight_decay > 0:
            grads = torch._foreach_add(grads, list(params), alpha=self.weight_decay)
        if not self.momentum:
            return grads
        trace = self._slot("trace", params)
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)  # t = g + momentum * t
        if self.nesterov:
            return torch._foreach_add(grads, trace, alpha=self.momentum)
        return trace


class Adam(Optimizer):
    """`decoupled=False`: weight decay joins the gradient (optax `adam` behind
    `add_decayed_weights`); True: it joins the update (`optax.adamw`)."""

    def __init__(
        self, lr: float, *, betas: Any = (0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
        decoupled: bool = False,
    ) -> None:
        super().__init__(lr)
        self.b1, self.b2 = betas
        self.eps, self.weight_decay, self.decoupled = eps, weight_decay, decoupled

    def updates(self, params: Sequence[torch.Tensor], grads: List[torch.Tensor]) -> List[torch.Tensor]:
        params = list(params)
        if self.weight_decay > 0 and not self.decoupled:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        mu, nu = self._slot("mu", params), self._slot("nu", params)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_div(nu, 1 - self.b2**self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu, 1 - self.b1**self.count)
        torch._foreach_div_(u, denom)
        if self.weight_decay > 0 and self.decoupled:
            torch._foreach_add_(u, params, alpha=self.weight_decay)
        return u


@register_optimizer("sgd")
def _sgd(lr: float, *, momentum: float = 0.0, nesterov: bool = False, weight_decay: float = 0.0, **_: Any) -> Optimizer:
    return SGD(lr, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)


@register_optimizer("adam")
def _adam(lr: float, *, betas: Any = (0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0, **_: Any) -> Optimizer:
    return Adam(lr, betas=betas, eps=eps, weight_decay=weight_decay)


@register_optimizer("adamw")
def _adamw(lr: float, *, betas: Any = (0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-2, **_: Any) -> Optimizer:
    return Adam(lr, betas=betas, eps=eps, weight_decay=weight_decay, decoupled=True)


@torch.no_grad()
def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in f32."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float, norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """Scale `grads` so that their global norm is at most `max_norm`:
    unchanged below it, g / norm * max_norm above."""
    norm = global_norm(grads) if norm is None else norm
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return [g * factor.to(g.dtype) for g in grads]
