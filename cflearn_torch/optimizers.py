"""Optimizer registry (counterpart of `cflearn_tpu/optimizers.py`).

`sgd`, `adam`, `adamw`, `rmsprop`, `nadam` and `adamp` with optax's update
rules, written out on `torch._foreach_*` so that one step of a large
parameter list is a few launches. As in optax, the learning rate is a float or
a schedule (a function of the update count, 0 at the first update; see
`schedulers.py`) and is applied where optax's chain applies it: after the
transform, except `rmsprop`, whose momentum trace accumulates lr-scaled
updates. Weight decay of `sgd` / `adam` / `rmsprop` is added to the gradient
(`optax.add_decayed_weights` ahead of the transform), `adamw` decays the
parameter inside the update. Adam's step is mu_hat / (sqrt(nu_hat) + eps)
with both moments bias-corrected; `nadam` takes optax's Nesterov mu_hat.
Moments are kept in the parameters' dtype (f32 masters -> f32 moments).
`clip_by_global_norm` is `optax.clip_by_global_norm`.

`adamp` is the JAX package's AdamP transform (Adam, then per row of the
parameter's leading axis the radial component removed where the update is
nearly orthogonal to the weight) followed by a descent step of lr. The JAX
registry chains the transform, which already negates its step, with
`optax.scale_by_learning_rate`, which negates it again: the JAX `adamp`
climbs the loss. The port descends by the same distance.
"""

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Union

import torch

from .schedulers import Schedule

ScalarOrSchedule = Union[float, Schedule]

optimizer_dict: Dict[str, Callable[..., "Optimizer"]] = {}


def register_optimizer(name: str) -> Callable:
    def _core(fn: Callable[..., "Optimizer"]) -> Callable:
        optimizer_dict[name] = fn
        return fn

    return _core


def build_optimizer(name: str, lr: ScalarOrSchedule, **kwargs: Any) -> "Optimizer":
    if name not in optimizer_dict:
        raise ValueError(f"optimizer '{name}' is not registered (available: {sorted(optimizer_dict)})")
    return optimizer_dict[name](lr, **kwargs)


class Optimizer:
    """`step(params, grads)` updates `params` in place; state is allocated at
    the first step, one slot list per moment, in the order of `params`.
    `lr` is a float or a schedule of the update count; `last_lr` is the
    rate of the last step. `lr_scale` multiplies the whole update (the
    trainer's plateau scale, 1 by default)."""

    def __init__(self, lr: ScalarOrSchedule) -> None:
        self.lr = lr
        self.lr_scale = 1.0
        self.count = 0
        self.last_lr: Optional[float] = None
        self.state: Dict[str, List[torch.Tensor]] = {}

    def lr_at(self, count: int) -> float:
        """The learning rate of the update after `count` updates."""
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def _slot(self, name: str, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if name not in self.state:
            self.state[name] = [torch.zeros_like(p) for p in params]
        return self.state[name]

    def updates(self, params: List[torch.Tensor], grads: List[torch.Tensor], lr: float) -> List[torch.Tensor]:
        """What the step adds to the parameters at learning rate `lr`. May
        overwrite `grads`."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
        lr = self.last_lr = self.lr_at(self.count)
        self.count += 1
        params = list(params)
        u = self.updates(params, [g.to(p.dtype) for g, p in zip(grads, params)], lr)
        torch._foreach_add_(params, u, alpha=self.lr_scale)


def _decayed(grads: List[torch.Tensor], params: List[torch.Tensor], weight_decay: float) -> List[torch.Tensor]:
    """`optax.add_decayed_weights`: g + weight_decay * p."""
    return torch._foreach_add(grads, params, alpha=weight_decay) if weight_decay > 0 else grads


def _trace(trace: List[torch.Tensor], u: List[torch.Tensor], decay: float, nesterov: bool) -> List[torch.Tensor]:
    """`optax.trace`: t = u + decay * t in place; returns t, or u + decay * t
    (Nesterov)."""
    torch._foreach_mul_(trace, decay)
    torch._foreach_add_(trace, u)
    return torch._foreach_add(u, trace, alpha=decay) if nesterov else trace


class SGD(Optimizer):
    def __init__(
        self, lr: ScalarOrSchedule, *, momentum: float = 0.0, nesterov: bool = False, weight_decay: float = 0.0
    ) -> None:
        super().__init__(lr)
        self.momentum, self.nesterov, self.weight_decay = momentum, nesterov, weight_decay

    def updates(self, params: List[torch.Tensor], grads: List[torch.Tensor], lr: float) -> List[torch.Tensor]:
        grads = _decayed(grads, params, self.weight_decay)
        if self.momentum:
            grads = _trace(self._slot("trace", params), grads, self.momentum, self.nesterov)
        return torch._foreach_mul(grads, -lr)


class Adam(Optimizer):
    """`decoupled=False`: weight decay joins the gradient (optax `adam` behind
    `add_decayed_weights`); True: it joins the update (`optax.adamw`).
    `nesterov=True` is optax's `nadam`."""

    def __init__(
        self, lr: ScalarOrSchedule, *, betas: Any = (0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
        decoupled: bool = False, nesterov: bool = False,
    ) -> None:
        super().__init__(lr)
        self.b1, self.b2 = betas
        self.eps, self.weight_decay, self.decoupled, self.nesterov = eps, weight_decay, decoupled, nesterov

    def updates(self, params: List[torch.Tensor], grads: List[torch.Tensor], lr: float) -> List[torch.Tensor]:
        if not self.decoupled:
            grads = _decayed(grads, params, self.weight_decay)
        b1, b2, t = self.b1, self.b2, self.count
        mu, nu = self._slot("mu", params), self._slot("nu", params)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        denom = torch._foreach_div(nu, 1 - b2**t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        # -lr folded into the bias correction: one pass fewer over the parameters
        if self.nesterov:  # mu_hat = b1 mu / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t)
            u = torch._foreach_mul(mu, -lr * b1 / (1 - b1 ** (t + 1)))
            torch._foreach_add_(u, grads, alpha=-lr * (1 - b1) / (1 - b1**t))
        else:
            u = torch._foreach_mul(mu, -lr / (1 - b1**t))
        torch._foreach_div_(u, denom)
        if self.weight_decay > 0 and self.decoupled:
            torch._foreach_add_(u, params, alpha=-lr * self.weight_decay)
        return u


class RMSProp(Optimizer):
    """optax's `rmsprop` (eps inside the square root, no centring, no bias
    correction): g / sqrt(nu + eps) scaled by -lr, then the momentum trace."""

    def __init__(
        self, lr: ScalarOrSchedule, *, decay: float = 0.99, eps: float = 1e-8, momentum: float = 0.0,
        weight_decay: float = 0.0,
    ) -> None:
        super().__init__(lr)
        self.decay, self.eps, self.momentum, self.weight_decay = decay, eps, momentum, weight_decay

    def updates(self, params: List[torch.Tensor], grads: List[torch.Tensor], lr: float) -> List[torch.Tensor]:
        grads = _decayed(grads, params, self.weight_decay)
        nu = self._slot("nu", params)
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.decay)
        denom = torch._foreach_add(nu, self.eps)
        torch._foreach_sqrt_(denom)
        u = torch._foreach_div(grads, denom)
        torch._foreach_mul_(u, -lr)
        if self.momentum:
            u = _trace(self._slot("trace", params), u, self.momentum, False)
        return u


class AdamP(Optimizer):
    """The JAX package's AdamP: Adam's step, then for parameters of rank >= 2
    the radial component of the step removed in the rows (the leading axis)
    where |cos(p, step)| < delta / sqrt(row width), weight decay scaled by
    `wd_ratio` where any row was projected."""

    def __init__(
        self, lr: ScalarOrSchedule, *, betas: Any = (0.9, 0.999), eps: float = 1e-8, delta: float = 0.1,
        wd_ratio: float = 0.1, weight_decay: float = 0.0,
    ) -> None:
        super().__init__(lr)
        self.b1, self.b2 = betas
        self.eps, self.delta, self.wd_ratio, self.weight_decay = eps, delta, wd_ratio, weight_decay

    def _project(self, p: torch.Tensor, step: torch.Tensor) -> Any:
        if p.ndim < 2:
            return step, 1.0
        view, u_view = p.reshape(p.shape[0], -1), step.reshape(p.shape[0], -1)
        p_norm = torch.linalg.vector_norm(view, dim=1) + self.eps
        cos = (view * u_view).sum(dim=1).abs() / (p_norm * (torch.linalg.vector_norm(u_view, dim=1) + self.eps))
        unit = view / p_norm[:, None]
        projected = (u_view - (u_view * unit).sum(dim=1, keepdim=True) * unit).reshape(step.shape)
        cond = cos < self.delta / math.sqrt(view.shape[1])
        step = torch.where(cond.reshape((-1,) + (1,) * (step.ndim - 1)), projected, step)
        return step, torch.where(cond.any(), self.wd_ratio, 1.0)

    def updates(self, params: List[torch.Tensor], grads: List[torch.Tensor], lr: float) -> List[torch.Tensor]:
        b1, b2, t = self.b1, self.b2, self.count
        mu, nu = self._slot("mu", params), self._slot("nu", params)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        denom = torch._foreach_div(nu, 1 - b2**t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        steps = torch._foreach_div(mu, 1 - b1**t)
        torch._foreach_div_(steps, denom)
        out = []
        for p, step in zip(params, steps):
            step, wd = self._project(p, step)
            if self.weight_decay > 0:
                step = step + self.weight_decay * wd * p
            out.append(step * -lr)
        return out


@register_optimizer("sgd")
def _sgd(lr: ScalarOrSchedule, *, momentum: float = 0.0, nesterov: bool = False, weight_decay: float = 0.0, **_: Any) -> Optimizer:
    return SGD(lr, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)


@register_optimizer("adam")
def _adam(lr: ScalarOrSchedule, *, betas: Any = (0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0, **_: Any) -> Optimizer:
    return Adam(lr, betas=betas, eps=eps, weight_decay=weight_decay)


@register_optimizer("adamw")
def _adamw(lr: ScalarOrSchedule, *, betas: Any = (0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-2, **_: Any) -> Optimizer:
    return Adam(lr, betas=betas, eps=eps, weight_decay=weight_decay, decoupled=True)


@register_optimizer("rmsprop")
def _rmsprop(
    lr: ScalarOrSchedule, *, alpha: float = 0.99, eps: float = 1e-8, momentum: float = 0.0, weight_decay: float = 0.0,
    **_: Any,
) -> Optimizer:
    return RMSProp(lr, decay=alpha, eps=eps, momentum=momentum, weight_decay=weight_decay)


@register_optimizer("nadam")
def _nadam(lr: ScalarOrSchedule, *, betas: Any = (0.9, 0.999), eps: float = 1e-8, **_: Any) -> Optimizer:
    return Adam(lr, betas=betas, eps=eps, nesterov=True)


@register_optimizer("adamp")
def _adamp(lr: ScalarOrSchedule, **kwargs: Any) -> Optimizer:
    return AdamP(lr, **kwargs)


class OptimizerPack(NamedTuple):
    """Per-scope optimizer / scheduler declaration: a value of the
    `optimizer_settings` dict, or an entry of the list-form packs."""

    scope: str
    optimizer_name: str
    scheduler_name: Optional[str] = None
    optimizer_config: Optional[Dict[str, Any]] = None
    scheduler_config: Optional[Dict[str, Any]] = None


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
