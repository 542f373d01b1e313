"""Small helpers (counterpart of part of `cflearn_tpu/toolkit/misc.py`):
`slerp`, the `jax.checkpoint_policies` names as selective-checkpoint
policies (`resolve_checkpoint_policy`, `checkpoint_context_fn`), and the
framework's `check_is_ci`, `timestamp`, `sort_dict_by_value` and
`truncate_string_to_length`."""

import functools
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

np_dict_type = Dict[str, Union[np.ndarray, Any]]


def check_is_ci() -> bool:
    """The `CI` environment flag, which turns a fit into a one-step debug run."""
    return bool(int(os.environ.get("CI", "0")))


def timestamp(*, simplify: bool = False, ensure_different: bool = False) -> str:
    """The local time as "%Y-%m-%d_%H-%M-%S"; with `ensure_different`, and a
    microsecond suffix."""
    s = time.strftime("%Y-%m-%d_%H-%M-%S", time.localtime())
    if not simplify and ensure_different:
        s = f"{s}-{int((time.time() % 1) * 1e6):06d}"
    return s


def sort_dict_by_value(d: Dict[Any, Any], *, reverse: bool = False) -> Dict[Any, Any]:
    return dict(sorted(d.items(), key=lambda kv: kv[1], reverse=reverse))


def truncate_string_to_length(string: str, length: int) -> str:
    if len(string) <= length:
        return string
    half = (length - 3) // 2
    return string[:half] + "..." + string[-half:]


def slerp(
    x1: torch.Tensor,
    x2: torch.Tensor,
    r1: Union[float, torch.Tensor],
    r2: Optional[Union[float, torch.Tensor]] = None,
    *,
    dot_threshold: float = 0.9995,
) -> torch.Tensor:
    """Spherical interpolation per sample (the leading axis): r1 of `x1`
    and r2 (default 1 - r1) of `x2`; nearly parallel samples are lerped."""
    if r2 is None:
        r2 = 1.0 - r1
    b = x1.shape[0]
    x1f, x2f = x1.reshape(b, -1), x2.reshape(b, -1)
    low_norm = x1f / torch.linalg.norm(x1f, dim=1, keepdim=True)
    high_norm = x2f / torch.linalg.norm(x2f, dim=1, keepdim=True)
    dot = (low_norm * high_norm).sum(dim=1, keepdim=True)
    omega = torch.arccos(dot.clamp(-1.0, 1.0))
    so = torch.sin(omega)
    lerped = r1 * x1f + r2 * x2f
    slerped = (torch.sin(r1 * omega) / so) * x1f + (torch.sin(r2 * omega) / so) * x2f
    return torch.where(dot.abs() > dot_threshold, lerped, slerped).reshape(x1.shape)


# --------------------------------------------------------------------------
# selective activation checkpointing: the `jax.checkpoint_policies` names
# --------------------------------------------------------------------------

# JAX's `dot_general` as PyTorch's dispatcher sees it: the 2-D products of a
# `Linear` (`mm`, `addmm`: no batch dimension) and the batched ones (`bmm`,
# `baddbmm`, and the library attention of the short-kv calls, whose JAX
# counterpart is a pair of batched `dot_general`s). A conv is no dot in
# either package.
_NO_BATCH_DOTS = ("mm.default", "addmm.default")
_BATCH_DOTS = (
    "bmm.default", "baddbmm.default", "_scaled_dot_product_flash_attention_for_cpu.default",
    "_scaled_dot_product_efficient_attention.default", "_scaled_dot_product_flash_attention.default",
    "_scaled_dot_product_cudnn_attention.default",
)
# policy factories: a name of one of them, given where a policy is expected,
# is called with the operation's arguments and fails
_POLICY_FACTORIES = (
    "offload_dot_with_no_batch_dims", "save_and_offload_only_these_names", "save_any_names_but_these",
    "save_anything_except_these_names", "save_from_both_policies", "save_only_these_names",
)


def _aten_ops(names: Any) -> frozenset:
    """The aten overloads named "op.overload" that this PyTorch build has."""
    ops = []
    for name in names:
        packet, overload = name.rsplit(".", 1)
        packet = getattr(torch.ops.aten, packet, None)
        if packet is not None and overload in packet.overloads():
            ops.append(getattr(packet, overload))
    return frozenset(ops)


def _save_ops(names: Any) -> Callable:
    """A policy that keeps the outputs of the aten ops `names` (None: of
    every op) and recomputes the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    saved = None if names is None else _aten_ops(names)

    def policy(ctx: Any, op: Any, *args: Any, **kwargs: Any) -> Any:
        return CheckpointPolicy.MUST_SAVE if saved is None or op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _factory(name: str) -> Callable:
    def policy(ctx: Any, op: Any, *args: Any, **kwargs: Any) -> Any:
        raise TypeError(
            f"{name}() is a policy factory, not a policy: it takes the names to save and returns the "
            f"policy (called here with the operation {op})"
        )

    return policy


# the direct names: the aten ops whose outputs each keeps (None: every op's)
_SAVED_OPS: Dict[str, Optional[Tuple[str, ...]]] = {
    "everything_saveable": None,
    "nothing_saveable": (),
    "dots_saveable": _NO_BATCH_DOTS + _BATCH_DOTS,
    "checkpoint_dots": _NO_BATCH_DOTS + _BATCH_DOTS,
    "dots_with_no_batch_dims_saveable": _NO_BATCH_DOTS,
    "checkpoint_dots_with_no_batch_dims": _NO_BATCH_DOTS,
}
CHECKPOINT_POLICY_NAMES = tuple(sorted(list(_SAVED_OPS) + list(_POLICY_FACTORIES)))


def resolve_checkpoint_policy(name: str) -> Callable:
    """The selective-checkpoint policy of a `jax.checkpoint_policies` name,
    for `torch.utils.checkpoint.create_selective_checkpoint_contexts`: a
    function (ctx, op, *args, **kwargs) -> `CheckpointPolicy`.

    - `everything_saveable` keeps every output, `nothing_saveable` none
      (what `use_checkpoint=True` does);
    - `dots_saveable` (alias `checkpoint_dots`) keeps the products: `mm`,
      `addmm`, `bmm`, `baddbmm` and the library attention;
    - `dots_with_no_batch_dims_saveable` (alias
      `checkpoint_dots_with_no_batch_dims`) keeps only `mm` and `addmm`, the
      2-D products of a `Linear`;
    - the six factory names resolve, as in JAX, to a policy that fails when
      it is first applied (at the first step with a gradient): in JAX the
      factory itself is called with the primitive's parameters.

    The hand-written kernels' forwards are operations of their own
    (`ops.attention`, `ops.group_norm`): no name keeps them but
    `everything_saveable`, as no JAX name but it keeps a `pallas_call`'s
    outputs. An unknown name raises `ValueError` with the valid names."""
    if name in _SAVED_OPS:
        return _save_ops(_SAVED_OPS[name])
    if name in _POLICY_FACTORIES:
        return _factory(name)
    raise ValueError(
        f"unknown remat policy {name!r}; valid jax.checkpoint_policies names: {list(CHECKPOINT_POLICY_NAMES)}"
    )


def checkpoint_context_fn(name: str) -> Callable:
    """`context_fn` for `torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`
    under the policy of `name`."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return functools.partial(create_selective_checkpoint_contexts, resolve_checkpoint_policy(name))


def is_local_rank_0() -> bool:
    """True in a single process, and in the process of rank 0 of an
    initialised `torch.distributed` group."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def random_hash() -> str:
    """A short unique id (for temporary registrations)."""
    import uuid

    return uuid.uuid4().hex


def make_indices_visualization_map(indices: Any) -> np.ndarray:
    """Each index rendered as a 28 x 28 white tile with its number drawn in
    the centre (a VQ-VAE codebook's visualisation), as float NHWC in
    [-1, 1]. Needs PIL."""
    from PIL import Image, ImageDraw

    tiles = []
    for idx in np.asarray(indices).reshape(-1):
        img = Image.new("L", (28, 28), 255)
        draw = ImageDraw.Draw(img)
        text = str(int(idx))
        bbox = draw.textbbox((0, 0), text)
        tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
        draw.text(((28 - tw) / 2 - bbox[0], (28 - th) / 2 - bbox[1]), text, fill=0)
        tiles.append(np.asarray(img, np.float32) / 127.5 - 1.0)
    return np.stack(tiles)[..., None]
