"""The model wrapper and its train steps (counterpart of
`cflearn_tpu/schema/model.py`).

`TrainStep` is one optimisation unit: a `scope` naming the parameters it
updates (`IDLModel.params_filter`), its `loss_fn`, and its flags.
`step_actives` tells its loss which scopes run in the current step (the
autoencoder's generator adds its adversarial term only once the
discriminator's step runs). The port's step core, `TrainStepFn` /
`MultiScopeStep` (`cflearn_torch/trainer.py`), drives them.

`IDLModel` is an `nn.Module` that owns the net (`m`) and its loss, built by
name: `IDLModel.from_config(DLConfig(model="ddpm", ...))` builds the
registered model's modules on a device (the CUDA card unless the caller
asks for another) with parameters drawn from seeded `torch.Generator`s
(`make_rngs`: params, dropout and default, from `config.seed`, 0 when not
set). `set_mode` is `train()` / `eval()` of `all_modules`;
`params_filter(scope)` returns the (name, parameter) pairs a scope trains.

An auxiliary objective: a submodule sets an attribute to an
`AuxLossVariable` in its forward, and `run(training=True)` sums every one
of them under `AUX_LOSS_KEY`, which `CommonTrainStep` adds to the loss.

`state_dict` is PyTorch's; `load_state_dict` also takes numpy arrays, and
the JAX model's `state_dict()` ("/"-joined paths of its `nnx.state`), which
goes through the bridge (`bridge.state_dict_from_jax`). `save` / `load`
keep the config and the states in one npz file. `save_sharded(directory)`
writes, from every rank of a mesh, only the tensors this rank owns (its
shards of the split parameters: over `model`, `pipe` and, under ZeRO,
`fsdp`; a whole tensor from rank 0), one `rank<r>.npz` each, beside a
`meta.json` (the config, the mesh and each split tensor's spec): no gather.
`load_sharded(directory)` puts the pieces together into a whole model on
one device, in any process, on any world size.
"""

import json
import os
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple, Type, TypeVar

import numpy as np
import torch
import torch.nn as nn

from ..bridge import state_dict_from_jax
from ..constants import AUX_LOSS_KEY, INPUT_KEY, PREDICTIONS_KEY
from ..device import resolve_device
from ..modules.common import EMA, cast_parameters
from ..toolkit.registry import WithRegister
from ..toolkit.tree import convert_pp_layout, npd_to_tree, tree_num_params, tree_to_npd
from .config import DLConfig, config_registry
from .losses_schema import loss_dict_type

TDLModel = TypeVar("TDLModel", bound="IDLModel")
forward_results_type = Dict[str, Any]


class AuxLossVariable:
    """An auxiliary objective a submodule records in its forward, as an
    attribute: `self.aux_loss = AuxLossVariable(value)`."""

    def __init__(self, value: torch.Tensor) -> None:
        self.value = value


def aux_losses(module: nn.Module) -> List[torch.Tensor]:
    """The values of every `AuxLossVariable` held by `module` or its submodules."""
    return [v.value for sub in module.modules() for v in vars(sub).values() if isinstance(v, AuxLossVariable)]


class TrainStep:
    """One optimisation unit. `uses_forward_results = False` marks a loss
    that reads no forward results (the p-loss draws its own t and noise):
    the step core then runs no forward for it."""

    uses_forward_results = True

    def __init__(
        self,
        scope: str = "all",
        *,
        num_forward: int = 1,
        grad_accumulate: Optional[int] = None,
        requires_new_forward: bool = False,
        requires_grad_in_forward: bool = True,
        requires_scheduler_step: bool = False,
        enable_toggle_optimizer: bool = True,
    ) -> None:
        self.scope = scope
        self.num_forward = num_forward
        self.grad_accumulate = grad_accumulate
        self.requires_new_forward = requires_new_forward
        self.requires_grad_in_forward = requires_grad_in_forward
        self.requires_scheduler_step = requires_scheduler_step
        self.enable_toggle_optimizer = enable_toggle_optimizer
        # scope -> whether that scope's step runs in this train step; set by
        # the step core before every step
        self.step_actives: Dict[str, bool] = {}

    def loss_fn(
        self, m: "IDLModel", batch: Dict[str, Any], forward_results: Dict[str, Any], **kwargs: Any
    ) -> loss_dict_type:
        raise NotImplementedError

    def should_skip(self, m: "IDLModel", state: Any) -> bool:
        return False

    def callback(self, m: "IDLModel", trainer: Any, batch: Dict[str, Any], forward_results: Any) -> None:
        pass


class IDLModel(nn.Module, WithRegister):
    d: Dict[str, type] = {}

    def __init__(self, config: Optional[DLConfig] = None) -> None:
        super().__init__()
        if config is None:
            config = DLConfig(model=getattr(type(self), "__identifier__", "common"))
        self.config = config
        self.loss: Optional[nn.Module] = None
        # the device `build` builds on, and the generators a model keeps for its train steps' draws
        self.build_device = torch.device("cpu")
        self.rngs: Dict[str, torch.Generator] = {}

    @classmethod
    def from_config(
        cls: Type[TDLModel], config: DLConfig, *, device: Any = None, dtype: torch.dtype = torch.float32
    ) -> TDLModel:
        """The model registered as `config.model`, built from `config` on
        `device` (CUDA unless the caller asks for another; "meta" allocates
        and draws nothing), its parameters cast to `dtype`."""
        model = IDLModel.get(config.model)(config)
        model.build_device = resolve_device(device)
        with torch.device(model.build_device):
            model.build(config)
        return cast_parameters(model, dtype)

    def build(self, config: DLConfig) -> None:
        raise NotImplementedError

    def make_rngs(self, seed: Optional[int] = None) -> Dict[str, torch.Generator]:
        """Seeded generators on the build device: params (seed), dropout
        (seed + 1), default (seed + 2: the train steps' draws)."""
        if seed is None:
            seed = self.config.seed if self.config.seed is not None else 0
        device = self.build_device if self.build_device.type != "meta" else torch.device("cpu")
        return {
            name: torch.Generator(device=device).manual_seed(seed + offset)
            for name, offset in (("params", 0), ("dropout", 1), ("default", 2))
        }

    # training semantics

    @property
    def train_steps(self) -> List[TrainStep]:
        raise NotImplementedError

    @property
    def all_modules(self) -> List[nn.Module]:
        mods: List[nn.Module] = [self.m]
        if self.loss is not None:
            mods.append(self.loss)
        return mods

    def params_filter(self, scope: str) -> List[Tuple[str, nn.Parameter]]:
        """(name, parameter) of what `scope` trains: "all" and "core" the
        net's (a path through `m`), any other scope the parameters with that
        name in their path."""
        key = "m" if scope in ("all", "core") else scope
        return [(n, p) for n, p in self.named_parameters() if key in n.split(".")]

    def post_step_update(self) -> None:
        """Run once per optimisation step after every train step (DDPM's EMA)."""

    # forward

    def get_forward_args(self, batch: Dict[str, Any], **kwargs: Any) -> Tuple[Any, ...]:
        return (batch[INPUT_KEY],)

    def postprocess(self, outputs: Any, batch: Dict[str, Any], **kwargs: Any) -> Dict[str, Any]:
        if isinstance(outputs, dict):
            return outputs
        return {PREDICTIONS_KEY: outputs}

    def forward(self, batch: Dict[str, Any], **kwargs: Any) -> Any:
        return self.m(*self.get_forward_args(batch, **kwargs))

    def run(self, batch: Dict[str, Any], *, training: bool = False, **kwargs: Any) -> Dict[str, Any]:
        self.set_mode(training)
        outputs = self.forward(batch, **kwargs)
        results = self.postprocess(outputs, batch, **kwargs)
        if training:
            aux = aux_losses(self.m)
            if aux:
                total = aux[0].sum()
                for value in aux[1:]:
                    total = total + value.sum()
                results[AUX_LOSS_KEY] = total
        return results

    def set_mode(self, training: bool) -> None:
        for mod in self.all_modules:
            mod.train(training)

    # serialisation

    def load_state_dict(self, state_dict: Mapping[str, Any], strict: bool = True, assign: bool = False) -> Any:
        """PyTorch's, which also takes numpy arrays, and the JAX model's
        `state_dict()` (its keys are "/"-joined) through the bridge."""
        state_dict = dict(state_dict)
        if any("/" in k for k in state_dict):
            state_dict = state_dict_from_jax(state_dict, self)
        # a pipelined encoder's stacked blocks <-> the block list
        state_dict = convert_pp_layout(state_dict, self.state_dict().keys())
        arrays = npd_to_tree({k: v for k, v in state_dict.items() if isinstance(v, np.ndarray)})
        return super().load_state_dict(dict(state_dict, **arrays), strict=strict, assign=assign)

    def save(self, path: str, *, states: Optional[Mapping[str, torch.Tensor]] = None) -> None:
        """The config, the model's name, its parameters' dtype and its
        states (`states`, a copy taken earlier, where given) in one npz file,
        uncompressed: float weights gain little from zlib, whose compression
        would run on the host at every checkpoint write, and `np.load` reads
        either kind, so both packages read it."""
        folder = os.path.dirname(os.path.abspath(path))
        os.makedirs(folder, exist_ok=True)
        dtypes = {p.dtype for p in self.parameters() if p.is_floating_point()}
        meta = json.dumps(dict(
            self._meta(), dtype=str(dtypes.pop()).split(".")[-1] if len(dtypes) == 1 else "float32"
        ))
        npd = tree_to_npd(self.state_dict() if states is None else states)
        np.savez(path, __meta__=np.frombuffer(meta.encode(), dtype=np.uint8), **npd)

    def _meta(self) -> Dict[str, Any]:
        config_type = "dl"
        for name, cls in config_registry.items():
            if type(self.config) is cls:
                config_type = name
        return {"config": self.config.to_info(), "config_type": config_type,
                "type": getattr(self, "__identifier__", "common")}

    def save_sharded(self, directory: str) -> None:
        """Every rank writes the tensors it owns (see the module's
        docstring); a model off a mesh, or not placed, writes from rank 0."""
        import torch.distributed as dist

        from ..parallel.mesh import AXES

        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        placement = getattr(self, "_placement", None) or {}
        mesh = getattr(self, "_mesh", None)
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        coord = mesh.coord if mesh is not None else dict.fromkeys(AXES, 0)
        own: Dict[str, torch.Tensor] = {}
        specs: Dict[str, Any] = {}
        for name, t in self.state_dict().items():
            pl = placement.get(name)
            spec = list(pl.spec) if pl is not None else [None] * t.ndim
            if any(a is not None for a in spec):
                specs[name] = {"spec": spec, "parts": pl.parts, "shape": list(t.shape)}
            # the owner: coordinate 0 along every axis the tensor is not split over
            if all(coord[a] == 0 for a in AXES if a not in spec):
                if "fsdp" in spec:  # ZeRO keeps the parameter whole: write this rank's part
                    dim = spec.index("fsdp")
                    step = t.shape[dim] // mesh.shape["fsdp"]
                    t = t.narrow(dim, coord["fsdp"] * step, step)
                own[name] = t.detach()
        np.savez(os.path.join(directory, f"rank{rank}.npz"), **tree_to_npd(own))
        if rank == 0:
            meta = self._meta()
            meta.update(
                world=(mesh.size if mesh is not None else 1),
                mesh=(mesh.shape if mesh is not None else dict.fromkeys(AXES, 1)),
                specs=specs,
            )
            with open(os.path.join(directory, "meta.json"), "w") as f:
                json.dump(meta, f)
        if dist.is_available() and dist.is_initialized() and mesh is not None and mesh.size > 1:
            dist.barrier()

    @classmethod
    def load_sharded(cls, directory: str, *, device: Any = None) -> "IDLModel":
        """A whole model on `device` from `save_sharded`'s files."""
        from ..parallel.mesh import AXES

        directory = os.path.abspath(directory)
        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        config_cls = config_registry.get(meta.get("config_type", "dl"), DLConfig)
        config = config_cls()
        config.from_info(meta["config"])
        shape = meta["mesh"]
        layout = np.arange(int(meta["world"])).reshape([shape[a] for a in AXES])
        full: Dict[str, np.ndarray] = {}
        for rank in range(int(meta["world"])):
            coord = dict(zip(AXES, (int(i) for i in np.argwhere(layout == rank)[0])))
            with np.load(os.path.join(directory, f"rank{rank}.npz"), allow_pickle=False) as z:
                for name in z.files:
                    piece = z[name]
                    info = meta["specs"].get(name)
                    if info is None:
                        full[name] = piece
                        continue
                    out = full.setdefault(name, np.zeros(_whole_shape(info, shape), piece.dtype))
                    _put(out, piece, info, shape, coord)
        model = IDLModel.get(meta["type"]).from_config(config, device=device)
        model.load_state_dict(full)
        return model

    @classmethod
    def load(cls, path: str, *, device: Any = None) -> "IDLModel":
        """The model `save` wrote, built from its config on `device` and
        given its states."""
        with np.load(path if str(path).endswith(".npz") else f"{path}.npz", allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            npd = {k: z[k] for k in z.files if k != "__meta__"}
        config = config_registry.get(meta.get("config_type", "dl"), DLConfig)()
        config.from_info(meta["config"])
        config.model = meta["type"]
        model = IDLModel.from_config(config, device=device, dtype=getattr(torch, meta.get("dtype", "float32")))
        model.load_state_dict(npd)
        return model

    @property
    def num_params(self) -> int:
        """The parameters of `all_modules`; an EMA's shadows count too, as in
        the JAX package, where they are copies of the `nnx.Param`s."""
        return sum(
            tree_num_params(mod.shadow().values() if isinstance(mod, EMA) else mod.parameters())
            for mod in self.all_modules
        )


class StepOutputs:
    """The host's view of one train step's results."""

    def __init__(self, forward_results: Any, loss_items: Dict[str, float]) -> None:
        self.forward_results = forward_results
        self.loss_items = loss_items


class TrainStepLoss(NamedTuple):
    """A loss and its items; `loss_fn` returns the dict form."""

    loss: Any
    losses: Dict[str, Any]


def _whole_shape(info: Dict[str, Any], mesh_shape: Dict[str, int]) -> List[int]:
    """The whole shape of a tensor `save_sharded` split by `info["spec"]`
    (`info["shape"]` is its shape on a rank: whole along `fsdp`, which
    ZeRO keeps whole there)."""
    return [n * (mesh_shape[a] if a in ("model", "pipe") else 1) for n, a in zip(info["shape"], info["spec"])]


def _put(out: np.ndarray, piece: np.ndarray, info: Dict[str, Any], mesh_shape: Dict[str, int], coord: Dict[str, int]) -> None:
    """Write a rank's piece into the whole tensor: each split dimension at
    its rank's offset (a `model` split of a fused projection in each of its
    parts)."""
    index: List[Any] = []
    for dim, axis in enumerate(info["spec"]):
        if axis is None:
            index.append([slice(None)])
            continue
        size = out.shape[dim]
        parts = int(info["parts"]) if axis == "model" else 1
        part, step = size // parts, size // parts // mesh_shape[axis]
        index.append([slice(p * part + coord[axis] * step, p * part + (coord[axis] + 1) * step) for p in range(parts)])
    # the piece is the concatenation of its parts along the split dims
    import itertools

    for combo in itertools.product(*[range(len(ix)) for ix in index]):
        src = []
        for dim, k in enumerate(combo):
            n = len(index[dim])
            step = piece.shape[dim] // n
            src.append(slice(k * step, (k + 1) * step))
        out[tuple(ix[k] for ix, k in zip(index, combo))] = piece[tuple(src)]
