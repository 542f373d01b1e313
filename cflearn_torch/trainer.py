"""The core of one train step (counterpart of `_build_step_fn` in
`cflearn_tpu/trainer.py`).

`TrainStepFn` is one scope's part of it and keeps f32 master parameters. It
casts every floating parameter to the compute dtype inside the loss
(`torch.func.functional_call` on the cast copies, so the gradients flow
through the cast back to the masters; parameters outside the scope are cast
for compute too and stay untouched f32 masters), runs the model's forward on
the batch with its input cast to the compute dtype, takes the loss of the
scope's train step on the original batch, clips by the global norm where
asked and runs the optimizer on the scope's masters. Buffers (the noise
schedule, BatchNorm's running statistics) stay f32.

`MultiScopeStep` runs a model's scopes in order, each with its own forward,
loss, gradient and optimizer, tells every train step which scopes are live
(`step_actives`), prefixes the loss items with the scope and calls
`post_step_update` once at the end.

`Trainer.fit`, callbacks, monitors, schedulers, gradient accumulation,
freezing masks, `steps_per_dispatch` and the mesh are not ported yet.
"""

from typing import Any, Dict, List, Mapping, Optional

import torch
from torch.func import functional_call

from .optimizers import Optimizer, build_optimizer, clip_by_global_norm, global_norm

INPUT_KEY = "input"
LOSS_KEY = "loss"


class TrainStepFn:
    """One scope's step over `model` (a module with `train_steps`,
    `params_filter`, `run` and `post_step_update`).

    After `step()`, `grads` holds the (unclipped) gradients by parameter name
    and `grad_norm` their global norm."""

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: Optimizer,
        *,
        compute_dtype: Optional[torch.dtype] = None,
        clip_norm: float = 0.0,
        scope: str = "all",
    ) -> None:
        steps = [ts for ts in model.train_steps if ts.scope == scope]
        if len(steps) != 1:
            raise ValueError(f"expected one train step of scope '{scope}', found {len(steps)}")
        self.model = model
        self.scope = scope
        self.train_step = steps[0]
        self.optimizer = optimizer
        self.compute_dtype = None if compute_dtype in (None, torch.float32) else compute_dtype
        self.clip_norm = clip_norm
        named = model.params_filter(scope)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.grads: Dict[str, torch.Tensor] = {}
        self.grad_norm: Optional[torch.Tensor] = None

    def _forward(self, batch: Dict[str, Any], forward_kwargs: Mapping[str, Any]) -> Any:
        """`model.run(batch, training=True)` with the input in the compute
        dtype; without a gradient where the train step asks for none (the
        discriminator's view of the reconstruction)."""
        x_in = batch.get(INPUT_KEY)
        if self.compute_dtype is not None and torch.is_tensor(x_in) and x_in.is_floating_point():
            batch = dict(batch)
            batch[INPUT_KEY] = x_in.to(self.compute_dtype)
        with torch.set_grad_enabled(getattr(self.train_step, "requires_grad_in_forward", True)):
            return self.model.run(batch, training=True, **forward_kwargs)

    def loss_and_grads(
        self, batch: Dict[str, Any], *, forward_kwargs: Optional[Mapping[str, Any]] = None, **loss_kwargs: Any
    ) -> Dict[str, torch.Tensor]:
        """Loss items (f32, detached) of one forward + backward; fills `grads`."""

        def run(b: Dict[str, Any]) -> Dict[str, torch.Tensor]:
            with torch.enable_grad():
                fwd = self._forward(b, forward_kwargs or {})
                # the loss sees the original (f32) batch, as in the JAX trainer
                losses = self.train_step.loss_fn(self.model, b, fwd, **loss_kwargs)
                grads = torch.autograd.grad(losses[LOSS_KEY].float(), self.params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
            self.grads = dict(zip(self.names, grads))
            return {k: v.detach().float() for k, v in losses.items()}

        if self.compute_dtype is None:
            return run(batch)
        # every floating parameter is computed with in the compute dtype,
        # in this scope or not; buffers stay f32, and so do the masters, which
        # remain the leaves of the graph. The backward runs inside the swap
        # too: a checkpointed block is computed again there and must meet the
        # same cast parameters.
        cast = {
            f"module.{name}": p.to(self.compute_dtype)
            for name, p in self.model.named_parameters()
            if p.is_floating_point()
        }
        return functional_call(_Call(self.model, run), cast, (batch,))

    def update(self) -> None:
        """Clip `grads` where asked and run the optimizer on the masters."""
        grads: List[torch.Tensor] = list(self.grads.values())
        self.grad_norm = global_norm(grads)
        if self.clip_norm > 0.0:
            grads = clip_by_global_norm(grads, self.clip_norm, self.grad_norm)
        self.optimizer.step(self.params, grads)

    def step(
        self, batch: Dict[str, Any], *, forward_kwargs: Optional[Mapping[str, Any]] = None, **loss_kwargs: Any
    ) -> Dict[str, torch.Tensor]:
        """One optimisation step; returns the loss items."""
        losses = self.loss_and_grads(batch, forward_kwargs=forward_kwargs, **loss_kwargs)
        self.update()
        self.model.post_step_update()
        return losses


class StepState:
    """What `should_skip` reads: the count of finished train steps."""

    def __init__(self) -> None:
        self.step = 0


class MultiScopeStep:
    """One train step over all of `model.train_steps`, in their order.
    `optimizers` maps each scope to its optimizer. `steps[scope]` holds that
    scope's `TrainStepFn` with its last gradients."""

    def __init__(
        self,
        model: torch.nn.Module,
        optimizers: Mapping[str, Optimizer],
        *,
        compute_dtype: Optional[torch.dtype] = None,
        clip_norm: float = 0.0,
    ) -> None:
        self.model = model
        self.state = StepState()
        self.steps: Dict[str, TrainStepFn] = {
            ts.scope: TrainStepFn(
                model, optimizers[ts.scope], compute_dtype=compute_dtype, clip_norm=clip_norm, scope=ts.scope
            )
            for ts in model.train_steps
        }

    def step(
        self, batch: Dict[str, Any], *, forward_kwargs: Optional[Mapping[str, Mapping[str, Any]]] = None
    ) -> Dict[str, torch.Tensor]:
        """`forward_kwargs` maps a scope to the keyword arguments of its
        forward (`model.run`). Returns the loss items, each prefixed with its
        scope when there is more than one."""
        train_steps = [fn.train_step for fn in self.steps.values()]
        actives = {ts.scope: not ts.should_skip(self.model, self.state) for ts in train_steps}
        for ts in train_steps:
            ts.step_actives = actives
        loss_items: Dict[str, torch.Tensor] = {}
        for scope, fn in self.steps.items():
            if not actives[scope]:
                continue
            losses = fn.loss_and_grads(batch, forward_kwargs=(forward_kwargs or {}).get(scope))
            fn.update()
            prefix = "" if len(self.steps) == 1 else f"{scope}_"
            loss_items.update({prefix + k: v for k, v in losses.items()})
        self.model.post_step_update()
        self.state.step += 1
        return loss_items


class _Call(torch.nn.Module):
    """Lets `functional_call` swap the parameters of `module` around any
    function of it, not only its `forward`."""

    def __init__(self, module: torch.nn.Module, fn: Any) -> None:
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *args: Any) -> Any:
        return self.fn(*args)


def make_train_step(
    model: torch.nn.Module,
    *,
    optimizer: str = "adamw",
    lr: float = 1e-5,
    compute_dtype: Optional[torch.dtype] = None,
    clip_norm: float = 0.0,
) -> TrainStepFn:
    opt = build_optimizer(optimizer, lr)
    return TrainStepFn(model, opt, compute_dtype=compute_dtype, clip_norm=clip_norm)
