"""Parallelism on a device mesh over `torch.distributed`, one process per
rank (counterpart of `cflearn_tpu/parallel/`): the mesh and the batch's
sharding (`mesh`), the collectives as differentiable functions (`comm`),
tensor / expert / pipeline placement and its execution (`tp`), and the
GPipe pipeline (`pp`)."""

from .mesh import (
    MeshConfig,
    Mesh,
    data_sharding,
    get_active_context_mesh,
    get_active_pipe_mesh,
    get_ambient_mesh,
    get_mesh,
    get_world_size,
    is_local_rank_0,
    make_mesh,
    maybe_initialize_distributed,
    mesh_context,
    replicated_sharding,
    set_mesh,
    shard_batch,
    shard_params_fsdp,
)
from .pp import pipeline_apply, stack_module_states
from .tp import describe_placement, gather_state_dict, place_params, plan_placement, unplace_params

__all__ = [
    "Mesh", "MeshConfig", "data_sharding", "describe_placement", "gather_state_dict", "get_active_context_mesh",
    "get_active_pipe_mesh", "get_ambient_mesh", "get_mesh", "get_world_size", "is_local_rank_0", "make_mesh",
    "maybe_initialize_distributed", "mesh_context", "pipeline_apply", "place_params", "plan_placement",
    "replicated_sharding", "set_mesh", "shard_batch", "shard_params_fsdp", "stack_module_states", "unplace_params",
]
