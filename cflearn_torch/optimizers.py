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
`clip_by_global_norm` is `optax.clip_by_global_norm`; `GradAccumulation` is
`optax.MultiSteps`. An optimizer's `state_dict()` / `load_state_dict()` carry
its update count and slots as numpy arrays (a checkpoint's optimizer file).

`adamp` is the JAX package's AdamP transform (Adam, then per row of the
leading axis of the JAX layout, which the bridge transposes to another
dimension here (`Rows`), the radial component removed where the update is
nearly orthogonal to the weight) followed by a descent step of lr. The JAX
registry chains the transform, which already negates its step, with
`optax.scale_by_learning_rate`, which negates it again: the JAX `adamp`
climbs the loss. The port descends by the same distance.
"""

import math
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
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

    def state_dict(self) -> Dict[str, np.ndarray]:
        """The update count and every slot, as {"count", "<slot>/<index>"}
        numpy arrays (what a checkpoint of the optimizer holds)."""
        npd = {"count": np.asarray(self.count, dtype=np.int64)}
        for name, slots in self.state.items():
            npd.update({f"{name}/{i}": t.detach().float().cpu().numpy() for i, t in enumerate(slots)})
        return npd

    def load_state_dict(self, npd: Mapping[str, np.ndarray], params: Sequence[torch.Tensor]) -> None:
        """What `state_dict` gave, for the optimizer of `params`; raises
        `KeyError` where the slots do not match the parameters."""
        params = list(params)
        state: Dict[str, List[torch.Tensor]] = {}
        for key in npd:
            if key != "count":
                state.setdefault(key.split("/")[0], [])
        for name in state:
            for i, p in enumerate(params):
                value = npd.get(f"{name}/{i}")
                if value is None or tuple(value.shape) != tuple(p.shape):
                    raise KeyError(f"slot {name}/{i} does not match the parameter of shape {tuple(p.shape)}")
                state[name].append(torch.from_numpy(np.array(value)).to(device=p.device, dtype=p.dtype))
        if len(npd) != 1 + len(state) * len(params):
            raise KeyError("the slots hold more entries than there are parameters")
        self.count = int(npd["count"])
        self.state = state


class GradAccumulation:
    """optax's `MultiSteps` around `inner`: the gradients of `every_k` calls
    averaged (acc += (g - acc) / (n + 1)), clipped by their global norm where
    `clip_norm` > 0 (the clip chained inside, as the JAX trainer chains it),
    and one step of `inner` on the k-th call; the other calls change nothing.
    `norm` takes that norm (`global_norm`; on a mesh, the trainer's norm of
    the whole gradient, of which this rank holds parts). The learning rate,
    its scale and the update count are the inner optimizer's."""

    def __init__(self, inner: Optimizer, every_k: int, *, clip_norm: float = 0.0) -> None:
        self.inner = inner
        self.every_k = every_k
        self.clip_norm = clip_norm
        self.mini_step = 0
        self.acc: List[torch.Tensor] = []
        self.norm: Callable[[List[torch.Tensor]], torch.Tensor] = global_norm

    def __getattr__(self, name: str) -> Any:
        # lr, count, last_lr, lr_at, state: the inner optimizer's
        return getattr(self.__dict__["inner"], name)

    @property
    def lr_scale(self) -> float:
        return self.inner.lr_scale

    @lr_scale.setter
    def lr_scale(self, value: float) -> None:
        self.inner.lr_scale = value

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
        params = list(params)
        if not self.acc:
            self.acc = [torch.zeros_like(p) for p in params]
        grads = [g.to(p.dtype) for g, p in zip(grads, params)]
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        if self.mini_step == self.every_k - 1:
            acc = clip_by_global_norm(self.acc, self.clip_norm, self.norm(self.acc)) if self.clip_norm > 0.0 else self.acc
            self.inner.step(params, acc)
            torch._foreach_zero_(self.acc)
        self.mini_step = (self.mini_step + 1) % self.every_k

    def state_dict(self) -> Dict[str, np.ndarray]:
        npd = {f"inner/{k}": v for k, v in self.inner.state_dict().items()}
        npd["mini_step"] = np.asarray(self.mini_step, dtype=np.int64)
        npd.update({f"acc/{i}": t.detach().float().cpu().numpy() for i, t in enumerate(self.acc)})
        return npd

    def load_state_dict(self, npd: Mapping[str, np.ndarray], params: Sequence[torch.Tensor]) -> None:
        params = list(params)
        self.inner.load_state_dict({k[len("inner/"):]: v for k, v in npd.items() if k.startswith("inner/")}, params)
        acc = [npd.get(f"acc/{i}") for i in range(len(params))]
        if any(a is None for a in acc) and any(a is not None for a in acc):
            raise KeyError("the accumulated gradients do not match the parameters")
        self.acc = [] if acc and acc[0] is None else [
            torch.from_numpy(np.array(a)).to(device=p.device, dtype=p.dtype) for a, p in zip(acc, params)]
        self.mini_step = int(npd["mini_step"])


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


class Rows(NamedTuple):
    """Where AdamP finds a parameter's rows in the tensor `step` hands it:
    `dim` holds them (the JAX layout's leading axis, `bridge.jax_row_dims`).
    On a mesh the tensor may be this rank's part of the parameter: each row
    is cut into `parts` parts that lie on the ranks of `width_axes` (its
    sums are all-reduced over them), and the rows lie on the ranks of
    `row_axes` (whether any row was projected is reduced over them)."""

    dim: int = 0
    width_axes: Tuple[str, ...] = ()
    row_axes: Tuple[str, ...] = ()
    parts: int = 1


class AdamP(Optimizer):
    """The JAX package's AdamP: Adam's step, then for parameters of rank >= 2
    the radial component of the step removed in the rows where |cos(p,
    step)| < delta / sqrt(row width), weight decay scaled by `wd_ratio`
    where any row was projected. The rows are the leading axis of the JAX
    layout: `rows` (one `Rows` a parameter, in the order of `step`'s) says
    which dimension holds them here; without it, dimension 0. Where a
    parameter is split over a mesh, `all_reduce(tensors, axes)` sums the
    tensors in place over each of the mesh axes: one call for every set of
    axes, for all the parameters split over it."""

    def __init__(
        self, lr: ScalarOrSchedule, *, betas: Any = (0.9, 0.999), eps: float = 1e-8, delta: float = 0.1,
        wd_ratio: float = 0.1, weight_decay: float = 0.0,
    ) -> None:
        super().__init__(lr)
        self.b1, self.b2 = betas
        self.eps, self.delta, self.wd_ratio, self.weight_decay = eps, delta, wd_ratio, weight_decay
        self.rows: Optional[List[Rows]] = None
        self.all_reduce: Optional[Callable[[List[torch.Tensor], Tuple[str, ...]], None]] = None

    def _reduce(self, tensors: List[torch.Tensor], axes: List[Tuple[str, ...]]) -> None:
        by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for t, a in zip(tensors, axes):
            if a:
                by_axes.setdefault(a, []).append(t)
        for a, ts in by_axes.items():
            if self.all_reduce is None:
                raise RuntimeError(f"rows split over the mesh axes {a} need `all_reduce`")
            self.all_reduce(ts, a)

    def _project(self, params: List[torch.Tensor], steps: List[torch.Tensor]) -> List[Any]:
        """(step, weight-decay factor) of each parameter."""
        rows = self.rows or [Rows()] * len(params)
        idx = [i for i, p in enumerate(params) if p.ndim >= 2]
        views = {}
        for i in idx:
            dim = rows[i].dim
            n = params[i].shape[dim]
            views[i] = (params[i].movedim(dim, 0).reshape(n, -1), steps[i].movedim(dim, 0).reshape(n, -1))
        # per row: <p, u>, |p|^2, |u|^2, summed over the row's parts
        sums = {i: torch.stack([(pv * uv).sum(1), pv.square().sum(1), uv.square().sum(1)]) for i, (pv, uv) in views.items()}
        self._reduce([sums[i] for i in idx], [rows[i].width_axes for i in idx])
        norms, conds, anys = {}, {}, {}
        for i in idx:
            dot, p_sq, u_sq = sums[i]
            norms[i] = p_sq.sqrt() + self.eps
            cos = dot.abs() / (norms[i] * (u_sq.sqrt() + self.eps))
            width = views[i][0].shape[1] * rows[i].parts
            conds[i] = cos < self.delta / math.sqrt(width)
            anys[i] = conds[i].any().to(p_sq.dtype).reshape(1)
        self._reduce([anys[i] for i in idx], [rows[i].row_axes for i in idx])
        out: List[Any] = [(step, 1.0) for step in steps]
        for i in idx:
            (pv, uv), dot, p_norm = views[i], sums[i][0], norms[i][:, None]
            projected = uv - (dot[:, None] / p_norm) * (pv / p_norm)
            step = torch.where(conds[i][:, None], projected, uv)
            moved = params[i].movedim(rows[i].dim, 0).shape
            out[i] = (step.reshape(moved).movedim(0, rows[i].dim), torch.where(anys[i][0] > 0, self.wd_ratio, 1.0))
        return out

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
        for p, (step, wd) in zip(params, self._project(params, steps)):
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
