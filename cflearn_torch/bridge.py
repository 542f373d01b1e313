"""Parameter bridge: the JAX package's `nnx.Param` leaves -> the port's
`state_dict`.

Input is a flat dict from dotted path ("unet.input_blocks.0.mods.0.conv1.kernel")
to a numpy array, i.e. `nnx.state(model, nnx.Param)` flattened. The port
mirrors the JAX attribute names, so the path maps one to one; only the leaf
name and layout change (the rules of `cflearn_tpu/zoo/convert.py`, run the
other way):

* Linear `kernel` (in, out) -> `weight` (out, in);
* Conv `kernel` HWIO -> `weight` OIHW;
* norm `scale` -> `weight`;
* `Embed.embedding` -> `weight`;
* `bias` and bare parameters (the positional table, the VQ codebook's
  `embedding`, which the port keeps under its JAX name) are copied.

`nnx.List`s (the LPIPS tower's `convs`, a multi-scale discriminator's
`nets`) are `nn.ModuleList`s of the same name: the list index is a path
component on both sides.

The bridge is strict: every JAX leaf maps to exactly one port tensor of the
same shape, and every port parameter is covered. The noise-schedule buffers
are not parameters: the port recomputes them from the schedule spec.

`nnx.BatchStat` leaves (BatchNorm's running `mean` and `var`) go across as
buffers of the same name: `load_nnx_batch_stats` is strict in the same way
over the module's BatchNorm layers. Other `nnx.Variable` leaves (LPIPS's
`shift` and `scale`) go across by `load_nnx_buffers`, strict over the
leaves it is given. An `AEModel` needs no mapping of its own:
the port keeps the JAX model's attribute names (`m.*`, `discriminator.*`,
`log_var`), so its paths map like any other.

Any tree shaped like the parameters goes the same way: `tree_from_nnx`
carries the JAX gradients or updated parameters (flattened to the same
dotted paths) into the port's names and layouts, in f32, so that a test can
compare them leaf by leaf. `names` restricts the port side to the parameters
that tree covers (the trained ones); a leaf outside it still raises.
"""

from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn


_PERM = {2: (1, 0), 4: (3, 2, 0, 1)}  # kernel rank -> transpose to the port layout


def port_name(path: str, ndim: int) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """One JAX parameter path -> (port name, transpose or None)."""
    prefix, _, leaf = path.rpartition(".")
    weight = f"{prefix}.weight" if prefix else "weight"
    if leaf == "kernel":
        if ndim not in _PERM:
            raise ValueError(f"{path}: kernel of rank {ndim} has no port layout")
        return weight, _PERM[ndim]
    if leaf in ("scale", "embedding"):
        return weight, None
    return path, None


def map_names(
    shapes: Mapping[str, Tuple[int, ...]], module: nn.Module, names: Optional[Iterable[str]] = None
) -> Dict[str, Tuple[str, Any]]:
    """JAX path -> (port name, transpose), checked one to one with equal
    shapes against `module`'s parameters (which may live on "meta"), or
    against those of them listed in `names`."""
    targets = {k: tuple(p.shape) for k, p in module.named_parameters()}
    if names is not None:
        names = set(names)
        missing = sorted(names - set(targets))
        if missing:
            raise ValueError(f"not parameters of the module: {missing[:10]}")
        targets = {k: v for k, v in targets.items() if k in names}
    mapping: Dict[str, Tuple[str, Any]] = {}
    seen: Dict[str, str] = {}
    errors = []
    for path, shape in shapes.items():
        name, perm = port_name(path, len(shape))
        if perm is None and path in targets:  # a parameter the port keeps under its JAX name
            name = path
        port_shape = tuple(shape[i] for i in perm) if perm else tuple(shape)
        if name not in targets:
            errors.append(f"JAX leaf {path} -> {name}: no such port parameter")
        elif name in seen:
            errors.append(f"JAX leaves {seen[name]} and {path} both map to {name}")
        elif targets[name] != port_shape:
            errors.append(f"{path} -> {name}: shape {port_shape} != {targets[name]}")
        else:
            seen[name] = path
            mapping[path] = (name, perm)
    errors += [f"port parameter {n}: no JAX leaf" for n in sorted(set(targets) - set(seen))]
    if errors:
        raise ValueError(f"{len(errors)} bridge errors, e.g.\n" + "\n".join(errors[:10]))
    return mapping


def tree_from_nnx(
    flat: Mapping[str, np.ndarray], module: nn.Module, names: Optional[Iterable[str]] = None
) -> Dict[str, torch.Tensor]:
    """Convert `flat` (parameters, gradients, updated parameters: any tree
    with the parameters' paths and shapes) to {port name: f32 tensor in the
    port's layout} (strict)."""
    arrays = {k: np.asarray(v) for k, v in flat.items()}
    mapping = map_names({k: v.shape for k, v in arrays.items()}, module, names)
    out: Dict[str, torch.Tensor] = {}
    for path, (name, perm) in mapping.items():
        arr = np.array(arrays[path], dtype=np.float32)
        if perm:
            arr = np.transpose(arr, perm)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def state_dict_from_nnx(flat: Mapping[str, np.ndarray], module: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert `flat` for `module` (strict); tensors take each port
    parameter's dtype."""
    dtypes = {k: p.dtype for k, p in module.named_parameters()}
    return {name: t.to(dtypes[name]) for name, t in tree_from_nnx(flat, module).items()}


def load_nnx_params(module: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Load JAX parameters into `module` in place (strict over the
    parameters; buffers are not parameters and keep their values)."""
    sd = state_dict_from_nnx(flat, module)
    device = next(module.parameters()).device
    result = module.load_state_dict({k: v.to(device) for k, v in sd.items()}, strict=False)
    buffers = {name for name, _ in module.named_buffers()}
    missing = [k for k in result.missing_keys if k not in buffers]
    if missing or result.unexpected_keys:
        raise ValueError(f"missing parameters {missing[:10]}, unexpected {result.unexpected_keys[:10]}")
    return module


def batch_stat_names(module: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """{buffer name: shape} of the running statistics of `module`'s
    `BatchNorm` layers (the counterparts of `nnx.BatchStat`)."""
    from .modules.layers import BatchNorm

    out: Dict[str, Tuple[int, ...]] = {}
    for prefix, sub in module.named_modules():
        if isinstance(sub, BatchNorm):
            for leaf in ("mean", "var"):
                out[f"{prefix}.{leaf}" if prefix else leaf] = tuple(getattr(sub, leaf).shape)
    return out


def load_nnx_batch_stats(module: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Load the JAX model's `nnx.BatchStat` leaves (`nnx.state(model,
    nnx.BatchStat)` flattened to dotted paths) into the buffers of the same
    paths, in place (strict: the two sides cover each other with equal shapes)."""
    targets = batch_stat_names(module)
    shapes = {k: tuple(np.shape(v)) for k, v in flat.items()}
    if shapes != targets:
        odd = sorted(set(shapes.items()) ^ set(targets.items()))
        raise ValueError(f"BatchStat leaves and BatchNorm buffers differ, e.g. {odd[:6]}")
    return load_nnx_buffers(module, flat)


def load_nnx_buffers(module: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Load `nnx.Variable` leaves (flattened to dotted paths) into the
    module's buffers of the same paths, in place, in each buffer's dtype
    (strict over the leaves: each names a buffer of its shape)."""
    buffers = dict(module.named_buffers())
    odd = [k for k, v in flat.items() if k not in buffers or tuple(buffers[k].shape) != tuple(np.shape(v))]
    if odd:
        raise ValueError(f"leaves without a buffer of their shape: {odd[:6]}")
    with torch.no_grad():
        for name, value in flat.items():
            buffers[name].copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
    return module
