"""The toolkit (counterpart of `cflearn_tpu/toolkit/__init__.py`): the same
names, with the JAX-only ones under their PyTorch names — `new_generator`
for `new_rng_key`, `np_batch_to_tensor` / `tensor_batch_to_np` for
`np_batch_to_jax` / `jax_batch_to_np`, `to_device_dtype` for
`to_jax_dtype`."""

from .registry import Registry, WithRegister
from .serialization import DataClassBase, ISerializable, Serializer
from .block_pipeline import IBlock, IPipeline
from .misc import (
    ScalarEMA,
    WeightsStrategy,
    adain_with_params,
    adain_with_tgt,
    check_is_ci,
    check_sha_with,
    download,
    download_checkpoint,
    download_json,
    fix_denormal_states,
    get_file_info,
    get_latest_workspace,
    get_num_params,
    get_seed,
    get_tensors,
    has_batch_norms,
    hash_code,
    inject_parameters,
    make_indices_visualization_map,
    mean_std,
    new_generator,
    np_batch_to_tensor,
    np_dict_type,
    prod,
    random_hash,
    seed_everything,
    show_or_return,
    slerp,
    sort_dict_by_value,
    sorted_param_diffs,
    tensor_batch_to_np,
    tensor_dict_type,
    timestamp,
    to_2d,
    to_device_dtype,
    truncate_string_to_length,
)
from .init_summary import Initializer, summary
from .contexts import auto_num_layers, eval_context, gradient_checkpoint, no_grad_context, train_context
from ..ops.attention import sdp_attn
