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
* `bias` and bare parameters (the positional table) are copied.

The bridge is strict: every JAX leaf maps to exactly one port tensor of the
same shape, and every port parameter is covered. The noise-schedule buffers
are not parameters: the port recomputes them from the schedule spec.
"""

from typing import Any, Dict, Mapping, Optional, Tuple

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


def map_names(shapes: Mapping[str, Tuple[int, ...]], module: nn.Module) -> Dict[str, Tuple[str, Any]]:
    """JAX path -> (port name, transpose), checked one to one with equal
    shapes against `module`'s parameters (which may live on "meta")."""
    targets = {k: tuple(p.shape) for k, p in module.named_parameters()}
    mapping: Dict[str, Tuple[str, Any]] = {}
    seen: Dict[str, str] = {}
    errors = []
    for path, shape in shapes.items():
        name, perm = port_name(path, len(shape))
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


def state_dict_from_nnx(flat: Mapping[str, np.ndarray], module: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert `flat` for `module` (strict); tensors take each port
    parameter's dtype."""
    arrays = {k: np.asarray(v) for k, v in flat.items()}
    mapping = map_names({k: v.shape for k, v in arrays.items()}, module)
    dtypes = {k: p.dtype for k, p in module.named_parameters()}
    out: Dict[str, torch.Tensor] = {}
    for path, (name, perm) in mapping.items():
        arr = np.array(arrays[path], dtype=np.float32)
        if perm:
            arr = np.transpose(arr, perm)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(dtypes[name])
    return out


def load_nnx_params(module: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Load JAX parameters into `module` in place (strict)."""
    sd = state_dict_from_nnx(flat, module)
    device = next(module.parameters()).device
    module.load_state_dict({k: v.to(device) for k, v in sd.items()}, strict=True)
    return module
