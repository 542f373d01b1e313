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

A train step whose loss reads no forward results (`uses_forward_results =
False`: the p-loss draws its own t and noise) gets none: in the JAX trainer
XLA drops that unused forward from the compiled step.

`default_optimizer_settings` and `build_optimizers` are the JAX `Trainer`'s
`_default_optimizer_settings` and `_build_optimizers` as plain functions: the
per-scope optimizer, its config, scheduler and scheduler config, from the
trainer-wide defaults (Adam at 1e-3, behind a `warmup` x3 that hands off to
`plateau`, starting at a third of the lr), then the dict settings, then the
list packs; `"none"` turns a scheduler off. Clipping by the global norm is the
step's `clip_norm`, applied ahead of the optimizer as optax's
`clip_by_global_norm` is chained ahead of it.

`Trainer.fit`, callbacks, monitors, gradient accumulation, per-epoch
scheduler updates, freezing masks, `steps_per_dispatch` and the mesh are not
ported yet.
"""

import copy
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import torch
from torch.func import functional_call

from .optimizers import Optimizer, build_optimizer, clip_by_global_norm, global_norm
from .schedulers import PlateauState, build_scheduler, scheduler_requires_metric

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
        discriminator's view of the reconstruction); nothing where its loss
        reads no forward results."""
        if not getattr(self.train_step, "uses_forward_results", True):
            return {}
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


DEFAULT_LR = 1.0e-3


def default_optimizer_settings(
    *,
    lr: Optional[float] = None,
    optimizer_name: Optional[str] = None,
    optimizer_config: Optional[Dict[str, Any]] = None,
    scheduler_name: Optional[str] = None,
    scheduler_config: Optional[Dict[str, Any]] = None,
    optimizer_settings: Optional[Mapping[str, Any]] = None,
    optimizer_packs: Optional[Iterable[Any]] = None,
    batch_size: Optional[int] = None,
    num_step_per_epoch: Optional[int] = None,
) -> Dict[str, Dict[str, Any]]:
    """{scope: {"optimizer", "optimizer_config" (with its "lr"), "scheduler",
    "scheduler_config"}}, "all" for every scope not named, as the JAX
    `Trainer._default_optimizer_settings` builds it from its config (the
    keyword arguments carry the `TrainerConfig` fields of the same names).
    With no `scheduler_name`: `warmup` with multiplier 3 over min(round(3e5 /
    batch_size), 10 * num_step_per_epoch) updates (1000 without the two
    counts) handing off to `plateau`, from lr / 3. `"none"`: no scheduler.
    `optimizer_settings` ({scope: dict or `OptimizerPack`}) and then
    `optimizer_packs` (a list of them, each naming its scope) override it."""
    lr = lr if lr is not None else DEFAULT_LR
    scheduler = scheduler_name
    scheduler_config = dict(scheduler_config or {})
    if scheduler is None:
        scheduler = "warmup"
        multiplier = scheduler_config.setdefault("multiplier", 3)
        if batch_size is not None and num_step_per_epoch is not None:
            warmup = min(int(round(3.0e5 / max(1, batch_size))), 10 * num_step_per_epoch)
            scheduler_config.setdefault("warmup_step", warmup)
        else:
            scheduler_config.setdefault("warmup_step", 1000)
        scheduler_config.setdefault("afterwards", "plateau")
        lr = lr / multiplier
    elif scheduler == "none":
        scheduler = None
    settings = {
        "all": {
            "optimizer": optimizer_name or "adam",
            "optimizer_config": dict(optimizer_config or {}, lr=lr),
            "scheduler": scheduler,
            "scheduler_config": scheduler_config,
        }
    }

    def merge(scope: str, sub: Any) -> None:
        if sub is None:
            return
        if hasattr(sub, "_asdict"):  # an OptimizerPack
            sub = sub._asdict()
        sub = {k: v for k, v in dict(sub).items() if k != "scope" and v is not None}
        if "optimizer_name" in sub:
            sub["optimizer"] = sub.pop("optimizer_name")
        if "scheduler_name" in sub:
            sub["scheduler"] = sub.pop("scheduler_name")
        merged = copy.deepcopy(settings.get(scope, settings["all"]))
        merged.update(sub)
        if "lr" in sub:
            merged.setdefault("optimizer_config", {})
            merged["optimizer_config"]["lr"] = sub["lr"]
        if sub.get("scheduler") == "none":
            merged["scheduler"] = None
        settings[scope] = merged

    for scope, sub in (optimizer_settings or {}).items():
        merge(scope, sub)
    # list-form packs after the dict settings: an explicit pack wins for its scope
    for pack in optimizer_packs or ():
        pack = pack._asdict() if hasattr(pack, "_asdict") else dict(pack)
        merge(pack.get("scope", "all"), pack)
    return settings


def build_optimizers(
    scopes: Iterable[str], settings: Mapping[str, Mapping[str, Any]], *, lr: Optional[float] = None
) -> Tuple[Dict[str, Optimizer], Dict[str, PlateauState]]:
    """One optimizer per scope from `settings` (`default_optimizer_settings`),
    its learning rate a schedule where a scheduler is named; and a
    `PlateauState` for each scope whose scheduler is metric-driven (`plateau`,
    also behind `warmup`), whose scale the caller moves into the optimizer's
    `lr_scale`. `lr` is the rate of a scope whose optimizer config names none
    (default 1e-3)."""
    optimizers: Dict[str, Optimizer] = {}
    lr_scales: Dict[str, PlateauState] = {}
    for scope in sorted(set(scopes)):
        sub = settings.get(scope, settings["all"])
        opt_config = dict(sub.get("optimizer_config") or {})
        scope_lr = opt_config.pop("lr", lr or DEFAULT_LR)
        name = sub.get("scheduler")
        scheduler_config = dict(sub.get("scheduler_config") or {})
        schedule: Any = scope_lr
        if name is not None:
            schedule = build_scheduler(name, scope_lr, **scheduler_config)
            if name in scheduler_requires_metric or scheduler_config.get("afterwards") in scheduler_requires_metric:
                allowed = {"mode", "factor", "patience", "threshold", "min_scale"}
                plateau = scheduler_config.get("afterwards_config") or {}
                lr_scales[scope] = PlateauState(**{k: v for k, v in plateau.items() if k in allowed})
        optimizers[scope] = build_optimizer(sub.get("optimizer", "adam"), schedule, **opt_config)
    return optimizers, lr_scales
