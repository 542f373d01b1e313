"""The Trainer (counterpart of `cflearn_tpu/trainer.py`) and the core of
its step.

`TrainStepFn` is one scope's part of a step and keeps f32 master parameters.
It casts every floating parameter to the compute dtype inside the loss
(`torch.func.functional_call` on the cast copies, so the gradients flow
through the cast back to the masters; parameters outside the scope are cast
for compute too and stay untouched f32 masters), runs the model's forward on
the batch with its input cast to the compute dtype, takes the loss of the
scope's train step on the original batch, clips by the global norm where
asked and runs the optimizer on the scope's masters, less the frozen ones.
Buffers (the noise schedule, BatchNorm's running statistics) stay f32.

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

`Trainer.fit(data, model)` is the JAX `Trainer`'s loop around one
`MultiScopeStep`: epochs of the data's train loader, its numpy batches moved
to the model's device by a `DeviceBatcher`; the loss window and its logs;
monitors at the snapshot cadence, scoring the validation loader's metrics
(or the losses) through `DLInference`; the plateau scales; top-k
checkpoints by score with `scores.json`; the rollback to the best one and
the final evaluation; callbacks at every hook. Its options:

- `grad_accumulate` (or a train step's own): `GradAccumulation`, optax's
  `MultiSteps`, with the clip inside it; `update_scheduler_per_epoch`: the
  schedule fed the epoch, not the update count;
- `finetune_config`: `pretrained_ckpt` (a model file of either package; the
  JAX one through the bridge) and `freeze` / `freeze_except`, regexes over
  the JAX package's parameter paths (`bridge.jax_param_names`), so that one
  config freezes the same parameters in both;
- `save_on_preemption` / `resume_from_preemption`: SIGTERM finishes the step
  in flight and dumps the model, the optimizers and the counters to
  `<workspace root>/preemption/`; the next fit against that root resumes
  from the dump, and a fit that ends normally removes it;
- `async_checkpointing`: checkpoint files written on one background thread
  from a copy of the states; `fit` waits for them and shuts the thread
  down before it returns or raises;
- `profile_steps`: a `torch.profiler` trace of each of those steps in
  `<workspace>/traces`;
- `debug_nans`: every step's loss items and gradients checked finite,
  `FloatingPointError` where not;
- `mixed_precision` "bf16" / "fp16": bf16 compute on f32 masters.

- `mesh` ({axis: size} of a `MeshConfig`) over the processes of
  `torch.distributed` (`parallel.mesh`; `maybe_initialize_distributed`
  forms the group from the launcher's environment): the parameters placed
  by `parallel.tp.place_params` (tensor, expert and pipeline parallelism);
  each rank trains on its slice of every global batch (`shard_batch`, the
  same shuffle on every rank from one seed), inside
  `parallel.mesh.batch_shard_context`, so that the step's global-batch
  quantities are those of the whole batch (DDPM's draws, BatchNorm's
  statistics, the MoE router's capacity); the gradients are averaged over
  `data` x `fsdp`, the losses too; the evaluation runs the whole validation
  set on every rank; checkpoints hold whole tensors (gathered from every
  rank) and rank 0 writes them; after the fit the parameters are whole on
  every rank again (`unplace_params`);
- `shard_optimizer_states` / `use_zero`: the optimizer's states and update
  of a parameter split over `fsdp` (its largest divisible axis) live on
  that rank's part only, and the updated parts are gathered (ZeRO's first
  stage: the gradients are averaged whole, the parameters stay whole for
  compute);
- what an optimizer computes over a whole parameter or gradient spans the
  splits: the clip's global norm (inside gradient accumulation too) sums
  its squares over the `model`, `pipe` and ZeRO's `fsdp` parts, and AdamP
  all-reduces each row's sums over the axes that cut the row and whether
  any row was projected over those that hold other rows (`MeshStep.rows`;
  a step makes one small all-reduce per axis of each such set of axes, for
  every parameter split over it at once);
- `remat` True or a policy name (`toolkit.misc.CHECKPOINT_POLICY_NAMES`):
  `torch.utils.checkpoint.checkpoint(..., use_reentrant=False)` around the
  forward and the loss, as the JAX trainer's `jax.checkpoint` around its
  loss: the forward keeps only the step's inputs (a name: also the
  operations `checkpoint_context_fn` keeps), and the backward first runs
  the whole forward again, keeping every activation, so the step's peak
  memory does not fall (one segment around the whole loss saves nothing)
  and the step pays a second forward. A saving comes from the modules'
  own per-block `use_checkpoint`. The model's generators are rewound
  before the recomputation, so that it draws what the forward drew.

The JAX package's other placement options mean nothing here and are
accepted as they are: `steps_per_dispatch` (the JAX trainer fuses up to k
steps into one `lax.scan` dispatch; the port launches each step's kernels
as they come, so k steps run as k steps at k = 1 would, until the steps are
captured in a CUDA graph), `donate_buffers` (PyTorch updates the parameters
in place, so no buffer is copied to donate) and `transfer_guard` (no
implicit transfer happens: batches move once, by the batcher).
"""

import copy
import json
import os
import re
import shutil
import time
from typing import Any, Collection, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from .constants import CHECKPOINTS_FOLDER, CKPT_PREFIX, INPUT_KEY, LOSS_KEY, SCORES_FILE
from .data.utils import DeviceBatcher, to_numpy
from .inference import DLInference
from .optimizers import AdamP, GradAccumulation, Optimizer, Rows, build_optimizer, clip_by_global_norm, global_norm
from .schedulers import PlateauState, build_scheduler, scheduler_requires_metric
from .schema.config import TrainerConfig
from .schema.data import IData
from .schema.metrics_schema import IMetric, MetricsOutputs, weighted_loss_score
from .schema.model import IDLModel, StepOutputs
from .schema.train_schema import ITrainer, MonitorResults, TrainerCallback, TrainerMonitor, TrainerState
from .parallel import comm
from .parallel.mesh import (
    Mesh,
    batch_shard_context,
    get_ambient_mesh,
    make_mesh,
    maybe_initialize_distributed,
    run_timestamp,
    set_mesh,
    shard_batch,
)
from .parallel.tp import ParamPlacement, gather_state_dict, is_placed, local_state_dict, place_params, unplace_params
from .toolkit.misc import checkpoint_context_fn, is_local_rank_0, sort_dict_by_value


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
        frozen: Collection[str] = (),
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
        # the optimizer's share: the parameters not frozen (a frozen one keeps its gradient, which is not used)
        frozen = set(frozen)
        self.trained = [i for i, n in enumerate(self.names) if n not in frozen]
        self.grads: Dict[str, torch.Tensor] = {}
        self.grad_norm: Optional[torch.Tensor] = None
        # set by the Trainer: the step's collectives on a mesh, and `remat` (False, True or a policy name)
        self.mesh_step: Optional["MeshStep"] = None
        self.remat: Any = False
        self._bound = False

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
                losses = self._losses(b, forward_kwargs or {}, loss_kwargs)
                grads = torch.autograd.grad(losses[LOSS_KEY].float(), self.params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
            if self.mesh_step is not None:
                self.mesh_step.reduce_grads(grads)
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

    def _losses(self, b: Dict[str, Any], forward_kwargs: Mapping[str, Any], loss_kwargs: Dict[str, Any]) -> Any:
        """The forward and the loss; under `remat`, checkpointed as one
        segment: only the inputs are kept, and the backward computes the
        whole forward again (so the peak does not fall), from the model's
        generators rewound to where the forward found them."""

        def forward_loss(b: Dict[str, Any]) -> Any:
            fwd = self._forward(b, forward_kwargs)
            # the loss sees the original (f32) batch, as in the JAX trainer
            return self.train_step.loss_fn(self.model, b, fwd, **loss_kwargs)

        if not self.remat:
            return forward_loss(b)
        from torch.utils.checkpoint import checkpoint

        gens = [g for g in getattr(self.model, "rngs", {}).values() if isinstance(g, torch.Generator)]
        device = next(self.model.parameters()).device
        if device.type == "cuda":
            gens.append(torch.cuda.default_generators[device.index or 0])
        states = [g.get_state() for g in gens]

        def replayed(b: Dict[str, Any]) -> Any:
            for g, state in zip(gens, states):
                g.set_state(state)
            return forward_loss(b)

        kwargs = {} if self.remat is True else {"context_fn": checkpoint_context_fn(self.remat)}
        return checkpoint(replayed, b, use_reentrant=False, **kwargs)

    def update(self) -> None:
        """Clip `grads` where asked and run the optimizer on the masters (the
        ones not frozen: a frozen parameter's gradient counts as zero in the
        norm, and its update is none, as the JAX trainer's masks make them).
        On a mesh the norm is that of the whole gradient, and under ZeRO
        the optimizer updates this rank's part of each split parameter."""
        grads: List[torch.Tensor] = list(self.grads.values())
        names, params = self.names, self.params
        if len(self.trained) < len(grads):
            grads = [grads[i] for i in self.trained]
            names = [names[i] for i in self.trained]
        params = [self.params[i] for i in self.trained]
        ms = self.mesh_step
        if not self._bound:
            self._bind(names)
        self.grad_norm = global_norm(grads) if ms is None else ms.global_norm(names, grads)
        if self.clip_norm > 0.0:
            grads = clip_by_global_norm(grads, self.clip_norm, self.grad_norm)
        if ms is not None and ms.zero:
            ms.zero_step(self.optimizer, names, params, grads)
        else:
            self.optimizer.step(params, grads)

    def _bind(self, names: List[str]) -> None:
        """Hand the optimizer what it needs of the parameters besides their
        values, once: AdamP the dimension of each one's rows (the JAX
        layout's leading axis, `bridge.jax_row_dims`) and, on a mesh, the
        axes its rows lie on and their all-reduce; an accumulated clip the
        norm of the whole gradient (`MeshStep.global_norm` over what this
        rank holds)."""
        from .bridge import jax_row_dims

        opt, ms = self.optimizer, self.mesh_step
        inner = getattr(opt, "inner", opt)
        if isinstance(inner, AdamP):
            dims = jax_row_dims(self.model)
            inner.rows = [Rows(dims[n]) for n in names] if ms is None else ms.rows(names, dims)
            inner.all_reduce = None if ms is None else ms.all_reduce_over
        if isinstance(opt, GradAccumulation) and ms is not None:
            opt.norm = lambda acc: ms.global_norm(names, acc, parts=ms.zero)
        self._bound = True

    def step(
        self, batch: Dict[str, Any], *, forward_kwargs: Optional[Mapping[str, Any]] = None, **loss_kwargs: Any
    ) -> Dict[str, torch.Tensor]:
        """One optimisation step; returns the loss items."""
        losses = self.loss_and_grads(batch, forward_kwargs=forward_kwargs, **loss_kwargs)
        self.update()
        self.model.post_step_update()
        return losses


class StepState:
    """What `should_skip` reads: the number of the step being run (1 at the
    first), as the JAX `Trainer`'s state counts it."""

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
        frozen: Collection[str] = (),
    ) -> None:
        self.model = model
        self.state = StepState()
        self.steps: Dict[str, TrainStepFn] = {
            ts.scope: TrainStepFn(
                model, optimizers[ts.scope], compute_dtype=compute_dtype, clip_norm=clip_norm, scope=ts.scope,
                frozen=frozen,
            )
            for ts in model.train_steps
        }

    def step(
        self,
        batch: Dict[str, Any],
        *,
        forward_kwargs: Optional[Mapping[str, Mapping[str, Any]]] = None,
        loss_kwargs: Optional[Mapping[str, Any]] = None,
        state: Any = None,
    ) -> Dict[str, torch.Tensor]:
        """`forward_kwargs` maps a scope to the keyword arguments of its
        forward (`model.run`); `loss_kwargs` go to every scope's loss.
        `should_skip` reads `state` where it is given (the `Trainer`'s
        `TrainerState`, whose `step` counts this step already), else this
        object's own count, which this step moves first. Returns the loss
        items, each prefixed with its scope when there is more than one."""
        train_steps = [fn.train_step for fn in self.steps.values()]
        if state is None:
            self.state.step += 1
            state = self.state
        actives = {ts.scope: not ts.should_skip(self.model, state) for ts in train_steps}
        for ts in train_steps:
            ts.step_actives = actives
        loss_items: Dict[str, torch.Tensor] = {}
        for scope, fn in self.steps.items():
            if not actives[scope]:
                continue
            losses = fn.loss_and_grads(batch, forward_kwargs=(forward_kwargs or {}).get(scope), **(loss_kwargs or {}))
            fn.update()
            prefix = "" if len(self.steps) == 1 else f"{scope}_"
            loss_items.update({prefix + k: v for k, v in losses.items()})
        self.model.post_step_update()
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


class MeshStep:
    """What a train step does on a mesh besides its forward and backward:
    the batch cut to this rank's slice, the gradients and the losses
    averaged over `data` x `fsdp`, the global norm of the whole gradient
    (the squares of a parameter split over `model` or `pipe`, and of a ZeRO
    part over `fsdp`, summed over that group), AdamP's `rows` on this
    rank's shards and parts, and ZeRO's update (`zero_step`): each
    parameter that the placement splits over `fsdp` is updated on this
    rank's part only (so that the optimizer's states are that part's), then
    the parts are gathered back into the whole parameter."""

    def __init__(self, mesh: Mesh, placement: Optional[Dict[str, ParamPlacement]], *, zero: bool) -> None:
        self.mesh = mesh
        self.placement = placement or {}
        self.zero = zero
        self.batch_group = mesh.group("data", "fsdp")

    def shard(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return shard_batch(batch, self.mesh)

    def reduce_grads(self, grads: List[torch.Tensor]) -> None:
        comm.all_reduce_(grads, self.batch_group, average=True)

    def reduce_losses(self, items: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        keys = sorted(items)
        values = [items[k].detach().float().reshape(()).clone() for k in keys]
        comm.all_reduce_(values, self.batch_group, average=True)
        return dict(zip(keys, values))

    def _axes(self, name: str, parts: bool = False) -> Tuple[str, ...]:
        """The mesh axes whose ranks hold parts of `name`: `model` and
        `pipe`, and with `parts` (what `zero_step` hands the optimizer)
        `fsdp` too."""
        pl = self.placement.get(name)
        kept = ("model", "pipe", "fsdp") if parts else ("model", "pipe")
        return () if pl is None else tuple(a for a in kept if a in pl.spec)

    def all_reduce_over(self, tensors: List[torch.Tensor], axes: Tuple[str, ...]) -> None:
        """Sum `tensors` in place over the ranks of each of `axes` (one
        collective an axis for all of them)."""
        for axis in axes:
            comm.all_reduce_(tensors, self.mesh.group(axis))

    @torch.no_grad()
    def global_norm(self, names: List[str], grads: List[torch.Tensor], *, parts: bool = False) -> torch.Tensor:
        """The norm of the whole gradient, of which `grads` are this rank's
        shards (with `parts`: its ZeRO parts)."""
        by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
        for name, g in zip(names, grads):
            axes = self._axes(name, parts)
            sq = g.float().square().sum()
            by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
        total = torch.zeros((), dtype=torch.float32, device=grads[0].device if grads else None)
        for axes, sq in by_axes.items():
            sq = sq.clone()
            self.all_reduce_over([sq], axes)
            total = total + sq
        return total.sqrt()

    def rows(self, names: List[str], dims: Mapping[str, int]) -> List[Rows]:
        """AdamP's `Rows` of each parameter as this rank holds it (its ZeRO
        part under ZeRO): the rows in `dims[name]`, the mesh axes that cut
        each row into parts and those that hold other rows."""
        out = []
        for name in names:
            pl = self.placement.get(name)
            kept = self._axes(name, self.zero)
            split = {} if pl is None else {d: a for d, a in enumerate(pl.spec) if a in kept}
            dim = dims[name]
            width = tuple(a for d, a in split.items() if d != dim)
            out.append(Rows(dim, width_axes=width, row_axes=tuple(a for d, a in split.items() if d == dim),
                            parts=self.mesh.axis_size(*width)))
        return out

    def _fsdp_dim(self, name: str) -> Optional[int]:
        pl = self.placement.get(name)
        return pl.spec.index("fsdp") if pl is not None and "fsdp" in pl.spec else None

    @torch.no_grad()
    def zero_step(self, optimizer: Any, names: List[str], params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        parts, index = self.mesh.shape["fsdp"], self.mesh.coord["fsdp"]
        views, gviews, split = [], [], []
        for name, p, g in zip(names, params, grads):
            dim = self._fsdp_dim(name)
            if dim is None:
                views.append(p)
                gviews.append(g)
            else:
                step = p.shape[dim] // parts
                views.append(p.data.narrow(dim, index * step, step))
                gviews.append(g.narrow(dim, index * step, step))
                split.append((p, dim, views[-1]))
        optimizer.step(views, gviews)
        group = self.mesh.group("fsdp")
        for p, dim, view in split:
            p.data.copy_(comm.all_gather_along(view.contiguous(), dim, group))


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


# --------------------------------------------------------------------------
# the Trainer
# --------------------------------------------------------------------------


def get_scores(checkpoint_folder: str) -> Dict[str, float]:
    scores_path = os.path.join(checkpoint_folder, SCORES_FILE)
    if not os.path.isfile(scores_path):
        return {}
    with open(scores_path, "r") as f:
        return json.load(f)


def get_sorted_checkpoints(checkpoint_folder: str) -> List[str]:
    """The checkpoint files of `scores.json`, best first."""
    return list(sort_dict_by_value(get_scores(checkpoint_folder), reverse=True).keys())


def read_states(path: str) -> Dict[str, np.ndarray]:
    """The states of a model file (`IDLModel.save`'s npz, of either package)."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


class Trainer(ITrainer):
    model: IDLModel

    def __init__(
        self,
        config: TrainerConfig,
        *,
        metrics: Optional[IMetric] = None,
        monitors: Optional[List[TrainerMonitor]] = None,
        callbacks: Optional[List[TrainerCallback]] = None,
        inference: Optional[DLInference] = None,
    ) -> None:
        self.config = config
        self.metrics = metrics
        self.monitors = monitors or []
        if callbacks is None and config.callback_names:
            # a bare Trainer honours `callback_names` as the pipeline's BuildCallbacksBlock does
            names = [config.callback_names] if isinstance(config.callback_names, str) else config.callback_names
            callbacks = [
                TrainerCallback.make(n, (config.callback_configs or {}).get(n, {}))
                for n in names
                if TrainerCallback.has(n)
            ]
        self.callbacks = callbacks or []
        self.inference = inference or DLInference()
        self.state: Optional[TrainerState] = None
        self.intermediate: Optional[MetricsOutputs] = None
        self.final_results: Optional[MetricsOutputs] = None
        self.checkpoint_scores: Dict[str, float] = {}
        self.optimizers: Dict[str, Any] = {}
        self.lr_scales: Dict[str, PlateauState] = {}
        self.step_fn: Optional[MultiScopeStep] = None
        self.frozen: set = set()
        self._workspace: Optional[str] = None
        self._preloaded_opt_npd: Optional[Dict[str, Any]] = None
        self._loss_window: Dict[str, List[torch.Tensor]] = {}
        self._ckpt_futures: List[Any] = []
        self._ckpt_executor: Optional[Any] = None
        self._preempted = False
        self._preemption_dumped = False
        self.mesh: Optional[Mesh] = None
        self.mesh_step: Optional[MeshStep] = None

    # setup

    @property
    def workspace(self) -> str:
        assert self._workspace is not None, "`fit` should be called first"
        return self._workspace

    @property
    def checkpoint_folder(self) -> str:
        return os.path.join(self.workspace, CHECKPOINTS_FOLDER)

    @property
    def preemption_folder(self) -> str:
        # the workspace root, not the timestamped sub-workspace: a fit against the same root finds the dump
        return os.path.join(self.config.workspace, "preemption")

    @property
    def metrics_log_path(self) -> str:
        return os.path.join(self.workspace, "metrics.txt")

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _prepare_workspace(self) -> None:
        workspace = self.config.workspace
        if self.config.create_sub_workspace:
            # one sub-workspace for every rank
            workspace = os.path.join(workspace, run_timestamp())
        self._workspace = workspace
        if is_local_rank_0():
            os.makedirs(self.checkpoint_folder, exist_ok=True)
            with open(os.path.join(workspace, "trainer_config.json"), "w") as f:
                json.dump(self.config.to_info(), f, indent=2)

    def _check_options(self) -> None:
        remat = self.config.remat
        if isinstance(remat, str):
            checkpoint_context_fn(remat)  # an unknown policy name raises here, not at the first backward
        elif remat not in (True, False):
            raise ValueError(f"`remat` should be a bool or a checkpoint policy name, not {remat!r}")

    def _setup_mesh(self, model: IDLModel) -> None:
        """The mesh of the config over the process group (formed from the
        launcher's environment where none is), the placement of the model's
        parameters, and the step's collectives."""
        c = self.config
        use_fsdp = bool(c.shard_optimizer_states or c.use_zero)
        mesh = self.mesh
        assert mesh is not None
        placement = None
        if mesh.shape["model"] > 1 or mesh.shape["pipe"] > 1 or (use_fsdp and mesh.shape["fsdp"] > 1):
            placement = place_params(model, mesh, use_fsdp=use_fsdp)
        self.mesh_step = MeshStep(mesh, placement, zero=use_fsdp) if mesh.device_mesh is not None else None

    def _build_optimizers(self, model: IDLModel) -> None:
        """One optimizer per scope from the config (the JAX `Trainer`'s
        `_build_optimizers`): the schedule fed the epoch under
        `update_scheduler_per_epoch`, `GradAccumulation` where a scope
        accumulates (with the clip inside it)."""
        c, state = self.config, self.state
        assert state is not None
        settings = default_optimizer_settings(
            lr=c.lr, optimizer_name=c.optimizer_name, optimizer_config=c.optimizer_config,
            scheduler_name=c.scheduler_name, scheduler_config=c.scheduler_config,
            optimizer_settings=c.optimizer_settings, optimizer_packs=c.optimizer_packs,
            batch_size=state.batch_size, num_step_per_epoch=state.num_step_per_epoch,
        )
        scopes = [ts.scope for ts in model.train_steps]
        optimizers, self.lr_scales = build_optimizers(scopes, settings, lr=c.lr)
        accumulating = set()
        for scope, opt in optimizers.items():
            if c.update_scheduler_per_epoch and callable(opt.lr):
                opt.lr = lambda count, _b=opt.lr, _n=max(1, state.num_step_per_epoch): _b(count // _n)
            accumulate = c.grad_accumulate
            for ts in model.train_steps:
                if ts.scope == scope and ts.grad_accumulate is not None:
                    accumulate = ts.grad_accumulate
            if accumulate and accumulate > 1:
                optimizers[scope] = GradAccumulation(opt, accumulate, clip_norm=c.clip_norm)
                accumulating.add(scope)
        self.optimizers = optimizers
        compute_dtype = torch.bfloat16 if c.compute_dtype == "bfloat16" else None
        self.step_fn = MultiScopeStep(
            model, optimizers, compute_dtype=compute_dtype, clip_norm=c.clip_norm, frozen=self.frozen
        )
        for scope in accumulating:
            self.step_fn.steps[scope].clip_norm = 0.0
        for fn in self.step_fn.steps.values():
            fn.mesh_step, fn.remat = self.mesh_step, c.remat
        if self._preloaded_opt_npd:
            # a resume: the optimizers' states as the dump (or the pipeline folder) holds them; a structure
            # that does not match starts them afresh, as in the JAX package
            for scope, opt in optimizers.items():
                sub = {k[len(scope) + 2:]: v for k, v in self._preloaded_opt_npd.items() if k.startswith(scope + "::")}
                if sub:
                    fn = self.step_fn.steps[scope]
                    try:
                        opt.load_state_dict(sub, [fn.params[i] for i in fn.trained])
                    except KeyError:
                        pass

    def optimizer_states(self) -> Dict[str, np.ndarray]:
        """Every scope's optimizer state as {"<scope>::<key>": array}."""
        npd: Dict[str, np.ndarray] = {}
        for scope, opt in self.optimizers.items():
            npd.update({f"{scope}::{k}": v for k, v in opt.state_dict().items()})
        return npd

    # fit

    def fit(
        self,
        data: IData,
        model: IDLModel,
        *,
        config_export_file: Optional[str] = None,
        skip_final_evaluation: bool = False,
        cuda: Any = None,
    ) -> "Trainer":
        """Train `model` (on its device) on `data`. The checkpoint writer's
        thread is shut down before this returns or raises, and the ambient
        mesh (which the fit sets to its own) is restored."""
        ambient = get_ambient_mesh()
        try:
            return self._fit_impl(data, model, skip_final_evaluation=skip_final_evaluation)
        finally:
            set_mesh(ambient)
            executor, self._ckpt_executor = self._ckpt_executor, None
            if executor is not None:
                executor.shutdown(wait=True)

    def _fit_impl(self, data: IData, model: IDLModel, *, skip_final_evaluation: bool = False) -> "Trainer":
        self._check_options()
        self.model = model
        maybe_initialize_distributed(force_cpu=self.device.type == "cpu")
        self.mesh = make_mesh(self.config.get_mesh_config())
        set_mesh(self.mesh)
        self._prepare_workspace()

        # a resume from a preemption dump: meta.json is written last, so a dump without it is incomplete
        self._resume_meta: Optional[Dict[str, Any]] = None
        pre_folder = self.preemption_folder
        if (
            self.config.resume_from_preemption
            and os.path.isfile(os.path.join(pre_folder, "model.npz"))
            and os.path.isfile(os.path.join(pre_folder, "meta.json"))
        ):
            model.load_state_dict(read_states(os.path.join(pre_folder, "model.npz")))
            opt_path = os.path.join(pre_folder, "optimizers.npz")
            if self._preloaded_opt_npd is None and os.path.isfile(opt_path):
                self._preloaded_opt_npd = dict(np.load(opt_path, allow_pickle=False))
            with open(os.path.join(pre_folder, "meta.json"), "r") as f:
                self._resume_meta = json.load(f)
            print(f"> resuming from preemption dump at step {self._resume_meta['step']}")

        v_split = self.config.validation_split
        if v_split and getattr(data, "bundle", None) is not None and data.bundle.x_valid is None:
            data.split_validation(v_split, seed=getattr(self.config, "seed", None) or 0)

        train_loader, valid_loader = data.get_loaders()
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        state = TrainerState.from_config(
            self.config, num_step_per_epoch=len(train_loader), batch_size=train_loader.batch_size
        )
        if self._resume_meta is not None:
            state.step = int(self._resume_meta.get("step", 0))
            state.epoch = int(self._resume_meta.get("epoch", 0))
        self.state = state

        self.frozen = set()
        if self.config.finetune_config:
            self._init_finetune(model)
        self._setup_mesh(model)
        self._build_optimizers(model)
        self.inference.bind(self)

        if is_local_rank_0():
            try:
                from .toolkit.init_summary import summary

                with open(os.path.join(self.workspace, "summary.txt"), "w") as f:
                    f.write(summary(model, return_only=True))
                with open(os.path.join(self.workspace, "model.txt"), "w") as f:
                    f.write(repr(model))
            except Exception:  # noqa: BLE001 — the summary files must not break a fit
                pass

        for callback in self.callbacks:
            callback.initialize()
        for callback in self.callbacks:
            callback.before_loop(self)

        batcher = DeviceBatcher(train_loader, device=self.device)
        terminate = False
        has_ckpt = self._has_ckpt = False
        start_t = time.time()

        # SIGTERM (preemption) finishes the step in flight, dumps a resumable snapshot and stops
        self._preempted = False
        self._preemption_dumped = False
        prev_sigterm: Any = None
        if self.config.save_on_preemption:
            import signal
            import threading

            if threading.current_thread() is threading.main_thread():

                def _on_sigterm(signum: int, frame: Any) -> None:
                    self._preempted = True

                prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
        try:
            terminate, has_ckpt = self._loop(state, batcher, model, terminate, has_ckpt)
        except KeyboardInterrupt:
            print("> keyboard interrupt — terminating gracefully")
            has_ckpt = self._has_ckpt
        finally:
            if prev_sigterm is not None:
                import signal

                signal.signal(signal.SIGTERM, prev_sigterm)

        # a SIGTERM outside the loop's check (during the last monitor, or after the last step) still dumps
        if self._preempted and not self._preemption_dumped:
            self.dump_preemption()
            print(f"> SIGTERM — preemption dump written at step {state.step}")
        if has_ckpt and not self._preempted:
            self.restore_checkpoint()
        if not skip_final_evaluation and not self._preempted:
            with state.disable_logging:
                self.final_results = self._get_metrics(portion=self.config.valid_portion)
        if self.final_results is not None:
            self._log_metrics_msg(self.final_results)
        if not has_ckpt and not self._preempted:
            score = self.final_results.final_score if self.final_results is not None else 0.0
            self.save_checkpoint(score)
        self._drain_checkpoints()
        if is_placed(model):
            unplace_params(model)
        if not self._preempted and is_local_rank_0():
            # a fit that ended normally invalidates a preemption dump
            shutil.rmtree(self.preemption_folder, ignore_errors=True)
        for callback in self.callbacks:
            callback.finalize(self)
        self._fit_wall_time = time.time() - start_t
        return self

    def _train_step(self, batch: Dict[str, Any], state: TrainerState) -> Dict[str, torch.Tensor]:
        assert self.step_fn is not None
        for scope, plateau in self.lr_scales.items():
            self.optimizers[scope].lr_scale = plateau.scale
        forward_kwargs: Dict[str, Any] = {}
        loss_kwargs: Dict[str, Any] = {}
        for callback in self.callbacks:
            callback.mutate_train_forward_kwargs(forward_kwargs, self)
            callback.mutate_train_loss_kwargs(loss_kwargs, self)
        ms = self.mesh_step
        if ms is not None:
            batch = ms.shard(batch)
        with batch_shard_context(self.mesh):
            loss_items = self.step_fn.step(
                batch, forward_kwargs=dict.fromkeys(self.step_fn.steps, forward_kwargs), loss_kwargs=loss_kwargs,
                state=state,
            )
        if ms is not None:
            loss_items = ms.reduce_losses(loss_items)
        if self.config.debug_nans:
            bad = [k for k, v in loss_items.items() if not bool(torch.isfinite(v).all())]
            for scope, fn in self.step_fn.steps.items():
                bad += [f"{scope} gradient {n}" for n, g in fn.grads.items() if not bool(torch.isfinite(g).all())]
            if bad:
                raise FloatingPointError(f"non-finite values at step {state.step}: {bad[:10]}")
        return loss_items

    def _loop(
        self, state: TrainerState, batcher: DeviceBatcher, model: IDLModel, terminate: bool, has_ckpt: bool
    ) -> Tuple[bool, bool]:
        while state.should_train and not terminate:
            state.epoch += 1
            for batch in batcher:
                if not state.should_train:
                    break
                profiler = None
                if self.config.profile_steps and state.step + 1 in self.config.profile_steps:
                    profiler = self._start_profile()
                state.step += 1
                loss_items = self._train_step(batch, state)
                if profiler is not None:
                    self._stop_profile(profiler, state.step)
                if self._preempted:
                    # the step in flight when SIGTERM came has finished: dump and stop
                    self.dump_preemption()
                    print(f"> SIGTERM — preemption dump written at step {state.step}")
                    return True, has_ckpt
                for k, v in loss_items.items():
                    window = self._loss_window.setdefault(k, [])
                    window.append(v)
                    if len(window) > 64:
                        del window[:-64]

                # monitor before the log drains the window: a train-loss score peeks it
                if state.should_monitor:
                    monitor_results = self._monitor_step(state)
                    if monitor_results.save_checkpoint:
                        assert monitor_results.metric_outputs is not None
                        self.save_checkpoint(monitor_results.metric_outputs.final_score)
                        has_ckpt = self._has_ckpt = True
                    for callback in self.callbacks:
                        callback.after_monitor(monitor_results, state)
                    if monitor_results.terminate:
                        terminate = True
                if state.should_log_losses:
                    host_losses = self._drain_loss_window()
                    for callback in self.callbacks:
                        callback.after_step(StepOutputs(None, host_losses), state)
                if state.should_log_artifacts:
                    for callback in self.callbacks:
                        callback.log_artifacts(self)
                if terminate:
                    break
        return terminate, has_ckpt

    def _start_profile(self) -> Any:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()
        return profiler

    def _stop_profile(self, profiler: Any, step: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.__exit__(None, None, None)
        folder = os.path.join(self.workspace, "traces")
        os.makedirs(folder, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(folder, f"step_{step}.json"))

    def _init_finetune(self, model: IDLModel) -> None:
        """`pretrained_ckpt` loaded (not strictly), and `freeze` /
        `freeze_except` matched against the JAX parameter paths."""
        from .bridge import jax_param_names

        cfg = dict(self.config.finetune_config or {})
        ckpt = cfg.get("pretrained_ckpt")
        if ckpt:
            model.load_state_dict(read_states(ckpt if str(ckpt).endswith(".npz") else f"{ckpt}.npz"), strict=False)
        freeze = cfg.get("freeze", "")
        freeze_except = cfg.get("freeze_except", "")
        if freeze and freeze_except:
            raise ValueError("`freeze` & `freeze_except` should not be provided together")
        if freeze or freeze_except:
            pattern = re.compile(freeze or freeze_except)
            for name, key in jax_param_names(model).items():
                hit = bool(pattern.search(key))
                if (freeze and hit) or (freeze_except and not hit):
                    self.frozen.add(name)

    # monitoring

    def _drain_loss_window(self) -> Dict[str, float]:
        out = self._peek_loss_window()
        self._loss_window = {}
        return out

    def _peek_loss_window(self) -> Dict[str, float]:
        return {k: float(np.mean([to_numpy(v) for v in vs[-8:]])) for k, vs in self._loss_window.items() if vs}

    def _get_metrics(self, *, portion: float = 1.0) -> MetricsOutputs:
        loader = self.valid_loader if self.valid_loader is not None else self.train_loader
        outputs = self.inference.get_outputs(
            loader,
            portion=portion,
            metrics=self.metrics,
            use_losses_as_metrics=self._use_losses_as_metrics,
            return_outputs=False,
        )
        metric_outputs = outputs.metric_outputs
        if metric_outputs is None:
            score = weighted_loss_score(outputs.loss_items or {}, self.config.loss_metrics_weights)
            metric_outputs = MetricsOutputs(score, dict(outputs.loss_items or {}), {})
        self.intermediate = metric_outputs
        return metric_outputs

    @property
    def _use_losses_as_metrics(self) -> bool:
        if self.config.use_losses_as_metrics is not None:
            return self.config.use_losses_as_metrics
        return self.metrics is None

    def _monitor_step(self, state: TrainerState) -> MonitorResults:
        terminate = False
        save_checkpoint = False
        if self.valid_loader is None and self._use_losses_as_metrics:
            # no validation set: the score of the running train loss, or of a pass where the window is drained
            host_losses = self._peek_loss_window()
            if not host_losses:
                metric_outputs = self._get_metrics(portion=self.config.valid_portion)
            else:
                score = weighted_loss_score(host_losses, self.config.loss_metrics_weights)
                metric_outputs = MetricsOutputs(score, host_losses, {})
            self.intermediate = metric_outputs
        else:
            metric_outputs = self._get_metrics(portion=self.config.valid_portion)
        score = metric_outputs.final_score
        for plateau in self.lr_scales.values():
            plateau.update(score)
        if state.should_start_snapshot:
            for monitor in self.monitors:
                monitor.handle_extension(state)
                if monitor.should_snapshot(score) and state.can_snapshot:
                    state.update_snapshot_epoch()
                    save_checkpoint = True
                if monitor.should_terminate(score):
                    terminate = True
        if state.reached_max_epoch:
            terminate = True
        if state.should_log_metrics_msg:
            self._log_metrics_msg(metric_outputs)
        return MonitorResults(terminate, save_checkpoint, metric_outputs)

    def _log_metrics_msg(self, metric_outputs: MetricsOutputs) -> None:
        for callback in self.callbacks:
            callback.log_metrics(metric_outputs, self.state)
            callback.log_metrics_msg(metric_outputs, self.metrics_log_path, self.state)

    # checkpoints

    def save_checkpoint(self, score: float, folder: Optional[str] = None, *, no_history: bool = False) -> None:
        """`model_<step>.npz` and its score in `scores.json`, keeping the best
        `max_snapshot_file`. Under `async_checkpointing` the file is written
        on a background thread from a copy of the states taken now. On a
        mesh every rank calls it: a placed model's whole tensors are gathered
        from every rank, and rank 0 writes."""
        if folder is None:
            folder = self.checkpoint_folder
        gathered = gather_state_dict(self.model) if is_placed(self.model) else None
        if not is_local_rank_0():
            return
        os.makedirs(folder, exist_ok=True)
        step = self.state.step if self.state is not None else 0
        file = f"{CKPT_PREFIX}{step}.npz"
        path = os.path.join(folder, file)
        if self.config.async_checkpointing:
            from concurrent.futures import ThreadPoolExecutor

            if self._ckpt_executor is None:
                self._ckpt_executor = ThreadPoolExecutor(max_workers=1)
            states = gathered or {k: v.detach().clone() for k, v in self.model.state_dict().items()}
            self._ckpt_futures.append(self._ckpt_executor.submit(self.model.save, path, states=states))
        else:
            self.model.save(path, states=gathered)
        scores = {} if no_history else get_scores(folder)
        scores[file] = score
        for stale in list(sort_dict_by_value(scores, reverse=True))[self.config.max_snapshot_file:]:
            self._drain_checkpoints()
            stale_path = os.path.join(folder, stale)
            if os.path.isfile(stale_path):
                os.remove(stale_path)
            scores.pop(stale, None)
        with open(os.path.join(folder, SCORES_FILE), "w") as f:
            json.dump(scores, f, indent=2)
        self.checkpoint_scores = scores

    def dump_preemption(self) -> str:
        """The model, the optimizers and the step / epoch counters, written
        now to the workspace root's `preemption/`; `meta.json` last, by a
        rename, so that its presence marks a complete dump."""
        folder = self.preemption_folder
        self._drain_checkpoints()
        gathered = gather_state_dict(self.model) if is_placed(self.model) else None
        if is_local_rank_0():
            os.makedirs(folder, exist_ok=True)
            self.model.save(os.path.join(folder, "model.npz"), states=gathered)
            np.savez(os.path.join(folder, "optimizers.npz"), **self.optimizer_states())
            meta_path = os.path.join(folder, "meta.json")
            with open(meta_path + ".tmp", "w") as f:
                json.dump({"step": self.state.step if self.state else 0, "epoch": self.state.epoch if self.state else 0}, f)
            os.replace(meta_path + ".tmp", meta_path)
        self._preemption_dumped = True
        return folder

    def _drain_checkpoints(self) -> None:
        """Wait for the checkpoint files in flight (their errors raise here)."""
        futures, self._ckpt_futures = self._ckpt_futures, []
        for fut in futures:
            fut.result()

    def restore_checkpoint(self, folder: Optional[str] = None) -> bool:
        """Roll the model back to the best checkpoint of `scores.json` (on a
        mesh every rank reads rank 0's file, once written, and keeps its shards)."""
        self._drain_checkpoints()
        if self.mesh is not None and self.mesh.size > 1:
            torch.distributed.barrier()
        folder = folder or self.checkpoint_folder
        best = get_sorted_checkpoints(folder)
        if not best or not os.path.isfile(os.path.join(folder, best[0])):
            return False
        states: Dict[str, Any] = read_states(os.path.join(folder, best[0]))
        if is_placed(self.model):
            states = local_state_dict(
                {k: torch.from_numpy(v) for k, v in states.items()}, self.model._placement, self.model._mesh
            )
        self.model.load_state_dict(states)
        return True


def get_input_sample(loader: Any) -> Dict[str, Any]:
    """The loader's first batch cut to one sample: each array or tensor (and
    each one inside a list) keeps its first row."""
    sample = dict(next(iter(loader)))
    for k, v in sample.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            sample[k] = v[:1]
        elif isinstance(v, list):
            sample[k] = [vv[:1] if isinstance(vv, (np.ndarray, torch.Tensor)) else vv for vv in v]
    return sample


def get_update_fn(trainer: Trainer) -> Any:
    """The callable that `trainer` runs for one step: `fn(batch, state)` ->
    the step's loss items (forward, loss, backward and the optimizers'
    update of every scope, on the mesh when there is one)."""
    return trainer._train_step
