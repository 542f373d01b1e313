"""The device mesh over `torch.distributed` (counterpart of
`cflearn_tpu/parallel/mesh.py`).

The JAX package is one program over every device, and GSPMD places the work;
the port runs one process per rank, and each rank sees only what it holds.
`Mesh` is the five named axes of `MeshConfig` (data, fsdp, model, context,
pipe) laid row-major over the ranks, in that order, as `jax.sharding.Mesh`
lays the devices: a `torch.distributed.device_mesh.DeviceMesh` gives each
axis its process group, and the batch's group (`data` x `fsdp`) is made
beside it. A mesh of one rank needs no process group: its groups are
`None`, and every collective of `parallel.comm` is then the identity.

`get_mesh` / `set_mesh` / `get_ambient_mesh` / `mesh_context` hold the
ambient mesh; `get_active_context_mesh` (a `context` axis > 1) is the
switch of `ops.attention.sdp_attn`'s context route, and
`get_active_pipe_mesh` (a `pipe` axis > 1) that of
`MixedStackedEncoder(pipeline_parallel=True)`.

`shard_batch` gives this rank its slice of a global batch over `data` x
`fsdp`; `batch_shard_context` tells the code inside a step that the batch
is sharded, so that what the JAX step computes over the global batch is
computed over it here too: `global_randn` / `global_randint` draw for the
whole batch and keep this rank's rows (DDPM's t and noise, the samplers'
noise), `global_mean` reduces a batch statistic over the group
(BatchNorm), and `batch_group()` names the group (the MoE router).

`maybe_initialize_distributed` forms the process group from `MASTER_ADDR`,
`MASTER_PORT`, `RANK`, `WORLD_SIZE` and `LOCAL_RANK` (what `dist.launch.
run_distributed` and `torchrun` set): NCCL on the card, gloo only where the
caller asks for the CPU. It then gives every rank rank 0's seed unless the
process seeded already."""

import os
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..schema.config import MeshConfig
from . import comm

AXES = ("data", "fsdp", "model", "context", "pipe")
BATCH_AXES = ("data", "fsdp")


class Mesh:
    """The five axes over the ranks of the default process group (or over
    one process where there is none). `shape` maps each axis to its size,
    `coord` to this rank's index along it; `group(*axes)` is the process
    group of the ranks that share this rank's other coordinates (`None`
    for a group of one)."""

    def __init__(self, sizes: Sequence[int], *, device_type: str = "cpu") -> None:
        self.sizes = tuple(int(s) for s in sizes)
        self.shape: Dict[str, int] = dict(zip(AXES, self.sizes))
        self.size = int(np.prod(self.sizes))
        self.device_type = device_type
        initialized = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if initialized else 1
        if world != self.size:
            raise ValueError(f"a mesh of {self.size} ranks {self.shape} over a group of {world} processes")
        self.rank = dist.get_rank() if initialized else 0
        self.layout = np.arange(self.size).reshape(self.sizes)
        idx = np.argwhere(self.layout == self.rank)[0]
        self.coord: Dict[str, int] = dict(zip(AXES, (int(i) for i in idx)))
        self.device_mesh: Optional[Any] = None
        self._groups: Dict[Tuple[str, ...], Any] = {}
        if initialized:
            from torch.distributed.device_mesh import init_device_mesh

            self.device_mesh = init_device_mesh(device_type, self.sizes, mesh_dim_names=AXES)
            for axis in AXES:
                self._groups[(axis,)] = self.device_mesh.get_group(axis) if self.shape[axis] > 1 else None
            self._make_group(BATCH_AXES)

    def _make_group(self, axes: Tuple[str, ...]) -> None:
        """One process group per value of the other axes (every rank makes
        every group, in the same order, as `new_group` asks)."""
        if int(np.prod([self.shape[a] for a in axes])) == 1:
            self._groups[axes] = None
            return
        keep = [AXES.index(a) for a in axes]
        rest = [i for i in range(len(AXES)) if i not in keep]
        grid = np.transpose(self.layout, rest + keep).reshape(-1, int(np.prod([self.sizes[i] for i in keep])))
        for ranks in grid:
            group = dist.new_group([int(r) for r in ranks])
            if self.rank in ranks:
                self._groups[axes] = group

    def group(self, *axes: str) -> Optional[Any]:
        return self._groups.get(tuple(axes)) if self.size > 1 else None

    def axis_size(self, *axes: str) -> int:
        return int(np.prod([self.shape[a] for a in axes]))

    def axis_index(self, *axes: str) -> int:
        """This rank's row-major index over `axes` (its rank in `group(*axes)`)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coord[a]
        return idx

    def ranks(self, axis: str) -> List[int]:
        """The global ranks along `axis` through this rank, by index."""
        sl = tuple(slice(None) if a == axis else self.coord[a] for a in AXES)
        return [int(r) for r in self.layout[sl]]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


_current_mesh: Optional[Mesh] = None


def _device_type() -> str:
    if dist.is_available() and dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def make_mesh(config: Optional[MeshConfig] = None, *, device_type: Optional[str] = None) -> Mesh:
    """The mesh of `config` (default: every rank on `data`) over the
    default process group, or over this one process where none is formed."""
    config = config or MeshConfig()
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return Mesh(config.axis_sizes(world), device_type=device_type or _device_type())


def get_mesh() -> Mesh:
    global _current_mesh
    if _current_mesh is None:
        _current_mesh = make_mesh()
    return _current_mesh


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _current_mesh
    _current_mesh = mesh


def get_ambient_mesh() -> Optional[Mesh]:
    """The ambient mesh as set (None if never set): to save and restore around a scope that sets its own."""
    return _current_mesh


def get_active_context_mesh() -> Optional[Mesh]:
    """The ambient mesh where its `context` axis is > 1, else None."""
    if _current_mesh is None or _current_mesh.shape.get("context", 1) <= 1:
        return None
    return _current_mesh


def get_active_pipe_mesh() -> Optional[Mesh]:
    """The ambient mesh where its `pipe` axis is > 1, else None."""
    if _current_mesh is None or _current_mesh.shape.get("pipe", 1) <= 1:
        return None
    return _current_mesh


@contextmanager
def mesh_context(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    global _current_mesh
    backup = _current_mesh
    _current_mesh = mesh
    try:
        yield mesh
    finally:
        _current_mesh = backup


class Sharding(NamedTuple):
    """Where a tensor lives on a mesh: one entry per dimension, the axis
    (or axes) it is split over, or None (replicated along it)."""

    mesh: Mesh
    spec: Tuple[Any, ...]


def data_sharding(mesh: Optional[Mesh] = None, *, ndim: int = 0) -> Sharding:
    """The batch axis split over ("data", "fsdp"), the rest replicated."""
    return Sharding(mesh or get_mesh(), (BATCH_AXES,) + (None,) * max(0, ndim - 1))


def replicated_sharding(mesh: Optional[Mesh] = None) -> Sharding:
    return Sharding(mesh or get_mesh(), ())


def batch_slice(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of `n` over `data` x `fsdp`."""
    parts = mesh.axis_size(*BATCH_AXES)
    if n % parts:
        raise ValueError(f"a batch of {n} does not divide over data x fsdp = {parts} ranks")
    step = n // parts
    lo = mesh.axis_index(*BATCH_AXES) * step
    return slice(lo, lo + step)


def shard_batch(batch: Dict[str, Any], mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """This rank's slice of every value of `batch` with a batch axis (all of
    one length), over `data` x `fsdp`; other values as they are."""
    mesh = mesh or get_mesh()
    if mesh.axis_size(*BATCH_AXES) == 1:
        return dict(batch)
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) >= 1:
            out[k] = v[batch_slice(len(v), mesh)]
        else:
            out[k] = v
    return out


def fsdp_param_sharding(mesh: Any, shape: Sequence[int], order: Optional[Sequence[int]] = None) -> Tuple[Any, ...]:
    """The spec that splits the largest axis of `shape` that divides over
    `fsdp` (the first of equals, in `order`, by default the axes' own), or
    an all-None spec where none does. `mesh` is a `Mesh` or {axis: size}."""
    shape_of = mesh.shape if isinstance(mesh, Mesh) else dict(mesh)
    fsdp = shape_of.get("fsdp", 1)
    spec: List[Any] = [None] * len(shape)
    if fsdp <= 1:
        return tuple(spec)
    best_axis, best = -1, 0
    for i in order if order is not None else range(len(shape)):
        if shape[i] % fsdp == 0 and shape[i] > best:
            best, best_axis = shape[i], i
    if best_axis >= 0:
        spec[best_axis] = "fsdp"
    return tuple(spec)


def shard_params_fsdp(params: Dict[str, torch.Tensor], mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """This rank's shard of every parameter by `fsdp_param_sharding` (a
    view; a parameter with no divisible axis whole)."""
    mesh = mesh or get_mesh()
    out = {}
    for name, p in params.items():
        spec = fsdp_param_sharding(mesh, tuple(p.shape))
        out[name] = p
        for dim, axis in enumerate(spec):
            if axis == "fsdp":
                step = p.shape[dim] // mesh.shape["fsdp"]
                out[name] = p.narrow(dim, mesh.coord["fsdp"] * step, step)
    return out


# the batch shard of the step being run


class BatchShard(NamedTuple):
    group: Optional[Any]
    index: int
    parts: int


_batch_shard: Optional[BatchShard] = None


@contextmanager
def batch_shard_context(mesh: Optional[Mesh]) -> Iterator[Optional[BatchShard]]:
    """Inside: the batch each module sees is this rank's slice over `data`
    x `fsdp` of `mesh` (nothing changes for a mesh without those axes)."""
    global _batch_shard
    backup = _batch_shard
    if mesh is not None and mesh.axis_size(*BATCH_AXES) > 1:
        _batch_shard = BatchShard(mesh.group(*BATCH_AXES), mesh.axis_index(*BATCH_AXES), mesh.axis_size(*BATCH_AXES))
    else:
        _batch_shard = None
    try:
        yield _batch_shard
    finally:
        _batch_shard = backup


def batch_group() -> Optional[BatchShard]:
    return _batch_shard


def _global_draw(draw: Any, shape: Sequence[int]) -> torch.Tensor:
    shard = _batch_shard
    if shard is None:
        return draw(tuple(shape))
    n = shape[0]
    full = draw((n * shard.parts,) + tuple(shape[1:]))
    return full[shard.index * n:(shard.index + 1) * n]


def global_randn(shape: Sequence[int], **kwargs: Any) -> torch.Tensor:
    """`torch.randn(shape, **kwargs)` for this rank's rows: drawn for the
    whole batch and sliced where the batch is sharded."""
    return _global_draw(lambda s: torch.randn(s, **kwargs), shape)


def global_randint(low: int, high: int, shape: Sequence[int], **kwargs: Any) -> torch.Tensor:
    return _global_draw(lambda s: torch.randint(low, high, s, **kwargs), shape)


def global_mean(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """The mean over `dims` (the batch axis among them) of the global batch."""
    shard = _batch_shard
    if shard is None:
        return x.mean(dim=tuple(dims))
    count = int(np.prod([x.shape[d] for d in dims])) * shard.parts
    return comm.all_reduce_sum(x.sum(dim=tuple(dims)), shard.group) / count


# processes


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_local_rank_0() -> bool:
    return process_index() == 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def maybe_initialize_distributed(*, force_cpu: Optional[bool] = None) -> bool:
    """Form the default process group from the launcher's environment
    (`MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE`, `LOCAL_RANK`);
    False where it names none or a group is formed already. NCCL on
    `cuda:LOCAL_RANK` unless `force_cpu` (default: the launcher's
    `CFLEARN_TORCH_FORCE_CPU=1`) asks for gloo; without a card NCCL raises.
    Then, unless this process seeded already (`toolkit.misc.seed_everything`),
    every rank takes rank 0's seed: the data's shuffles and splits run on
    numpy's global generator and must agree across ranks."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    if force_cpu is None:
        force_cpu = os.environ.get("CFLEARN_TORCH_FORCE_CPU") == "1"
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT", "29500")
    device = torch.device("cpu")
    if not force_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("a NCCL group needs a CUDA card; pass force_cpu=True for gloo on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo" if force_cpu else "nccl", init_method=f"tcp://{addr}:{port}", world_size=world, rank=rank,
        **({} if force_cpu else {"device_id": device}),
    )
    from ..toolkit import misc

    if world > 1 and misc._seed is None:
        seed = torch.tensor([np.random.randint(0, 2**31 - 1)], dtype=torch.int64, device=device)
        dist.broadcast(seed, src=0)
        misc.seed_everything(int(seed.item()))
    return True


RUN_TS_ENV = "CFLEARN_TORCH_RUN_TS"


def run_timestamp() -> str:
    """The timestamp of a run's sub-workspace, one for every rank: the
    launcher's `CFLEARN_TORCH_RUN_TS`, else rank 0's broadcast over the
    process group, else this process's own (microseconds included)."""
    from ..toolkit.misc import timestamp

    env_ts = os.environ.get(RUN_TS_ENV)
    if env_ts:
        return env_ts
    if get_world_size() > 1:
        box = [timestamp(ensure_different=True) if process_index() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return str(box[0])
    return timestamp(ensure_different=True)
