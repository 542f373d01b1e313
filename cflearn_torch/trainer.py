"""The core of one train step (counterpart of `_build_step_fn` in
`cflearn_tpu/trainer.py`, for one scope).

`TrainStepFn` keeps f32 master parameters. A step casts the parameters to
the compute dtype inside the loss (`torch.func.functional_call` on the cast
copies, so the gradients flow through the cast back to the masters), takes
the loss of the model's train step, clips by the global norm where asked,
runs the optimizer on the masters and calls `post_step_update`.

`Trainer.fit`, callbacks, monitors, schedulers, gradient accumulation,
freezing masks, `steps_per_dispatch` and the mesh are not ported yet.
"""

from typing import Any, Dict, List, Optional

import torch
from torch.func import functional_call

from .optimizers import Optimizer, build_optimizer, clip_by_global_norm, global_norm

LOSS_KEY = "loss"


class TrainStepFn:
    """One scope's step over `model` (a `DDPMModel`-like module with
    `train_steps`, `params_filter` and `post_step_update`).

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
        self.train_step = steps[0]
        self.optimizer = optimizer
        self.compute_dtype = None if compute_dtype in (None, torch.float32) else compute_dtype
        self.clip_norm = clip_norm
        named = model.params_filter(scope)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.grads: Dict[str, torch.Tensor] = {}
        self.grad_norm: Optional[torch.Tensor] = None

    def loss_and_grads(self, batch: Dict[str, Any], **loss_kwargs: Any) -> Dict[str, torch.Tensor]:
        """Loss items (f32, detached) of one forward + backward; fills `grads`."""

        def run(b: Dict[str, Any]) -> Dict[str, torch.Tensor]:
            with torch.enable_grad():
                losses = self.train_step.loss_fn(self.model, b, None, **loss_kwargs)
                grads = torch.autograd.grad(losses[LOSS_KEY].float(), self.params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
            self.grads = dict(zip(self.names, grads))
            return {k: v.detach().float() for k, v in losses.items()}

        if self.compute_dtype is None:
            return run(batch)
        # every floating parameter is computed with in the compute dtype,
        # trained or not; buffers (the noise schedule) stay f32, and so do the
        # masters, which remain the leaves of the graph. The backward runs
        # inside the swap too: a checkpointed block is computed again there
        # and must meet the same cast parameters.
        cast = {
            f"module.{name}": p.to(self.compute_dtype)
            for name, p in self.model.named_parameters()
            if p.is_floating_point()
        }
        # the loss sees the original (f32) batch, as in the JAX trainer, which
        # casts the input of the monitoring forward only; the UNet casts its
        # input to its parameters' dtype itself
        return functional_call(_Call(self.model, run), cast, (batch,))

    def step(self, batch: Dict[str, Any], **loss_kwargs: Any) -> Dict[str, torch.Tensor]:
        """One optimisation step; returns the loss items."""
        losses = self.loss_and_grads(batch, **loss_kwargs)
        grads: List[torch.Tensor] = list(self.grads.values())
        self.grad_norm = global_norm(grads)
        if self.clip_norm > 0.0:
            grads = clip_by_global_norm(grads, self.clip_norm, self.grad_norm)
        self.optimizer.step(self.params, grads)
        self.model.post_step_update()
        return losses


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
