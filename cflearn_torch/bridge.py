"""Parameter bridge: the JAX package's `nnx.Param` leaves -> the port's
`state_dict`.

Input is a flat dict from dotted path ("unet.input_blocks.0.mods.0.conv1.kernel")
to a numpy array, i.e. `nnx.state(model, nnx.Param)` flattened. The port
mirrors the JAX attribute names, so the path maps one to one; only the leaf
name and layout change (the rules of `cflearn_tpu/zoo/convert.py`, run the
other way):

* Linear `kernel` (in, out) -> `weight` (out, in);
* Conv `kernel` HWIO -> `weight` OIHW (a 1-D conv's (k, in, out) -> (out,
  in, k), a 3-D conv's DHWIO -> OIDHW);
* norm `scale` -> `weight`;
* `Embed.embedding` -> `weight`;
* `bias` and bare parameters (the positional table, a ViT's `head_token`
  and `pos_encoding`, `ChannelPadding`'s `latent_map`, the VQ codebook's
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
`shift` and `scale`, PixelCNN's masks, `GaussianBlur3`'s kernel, which the
port keeps as buffers in the JAX layout) go across by `load_nnx_buffers`,
strict over the leaves it is given. A RepVGG block after
`switch_to_deploy` holds only `conv_fused` (a 3x3 conv with a bias) and its
squeeze-excite on both sides, and maps like any conv. An `AEModel` needs no
mapping of its own: the port keeps the JAX model's attribute names (`m.*`,
`discriminator.*`, `log_var`), so its paths map like any other.

A JAX `ControlNet` builds a whole `UNetDiffuser` and runs only its encoder
half; the port's builds only that half. `control_net_params` leaves the
decoder half's leaves out by name (`CONTROL_NET_UNUSED`), and the bridge
stays strict over the rest. A JAX `LoRAPack`'s deltas, keyed by
`tree_to_npd` paths with (in, out) kernels, go across by
`lora_deltas_from_nnx`: the port's parameter names and the
(rank, in) / (out, rank) layout of `nn.Linear`.

Any tree shaped like the parameters goes the same way: `tree_from_nnx`
carries the JAX gradients or updated parameters (flattened to the same
dotted paths) into the port's names and layouts, in f32, so that a test can
compare them leaf by leaf. `names` restricts the port side to the parameters
that tree covers (the trained ones); a leaf outside it still raises.

A JAX `IDLModel.state_dict()` (every `nnx.Variable` of the model by
"/"-joined path, each ending in "/value") goes across by
`state_dict_from_jax`: parameters as above, an `EMA`'s shadows into the
port's shadow buffers (in the port's layout), the other variables into the
buffers of the same paths. The noise schedule's leaves are left out: the
port recomputes them; so are the `nnx.Rngs` streams (a key and a count
under each `rngs.<stream>`): the port's draws come from `torch.Generator`s;
and so is an `aux_loss` leaf (the MoE mixer's last recorded objective,
which each forward writes anew).

The tabular modules need no rule of their own: the categorical `Encoder`'s
`nnx.Embed` tables (`embeds.<column>.embedding`) map like any embedding, a
BatchNorm on (B, d) features keeps its scale, bias and running statistics
under the same names, NBM's (units, bases, out) `weights`, DNDF's `leaves`
and the MoE experts' tensors are bare parameters copied in their layout
(DNDF's path and sign masks are buffers of the same names), and the
recurrent cells are flax's (`cell.dense_i`, `cell.dense_h`: Linear
kernels) in the port too.
"""

from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn


# kernel rank -> transpose to the port layout: Linear (in, out); 1-D conv (k, in, out); 2-D conv HWIO; 3-D conv DHWIO
_PERM = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


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


# the decoder half of a JAX `ControlNet`'s UNet copy, which its forward never runs
CONTROL_NET_UNUSED = ("unet.output_blocks.", "unet.norm_out.", "unet.conv_out.")


def control_net_params(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The leaves of a JAX `ControlNet` that the port's `ControlNet` holds."""
    return {k: v for k, v in flat.items() if not k.startswith(CONTROL_NET_UNUSED)}


def lora_path_to_port(path: str) -> str:
    """A JAX LoRA path ("unet/mid/mods/1/blocks/0/attn1/to_q/kernel/value",
    `tree_to_npd`'s form) -> the port's parameter name."""
    dotted = path.replace("/", ".")
    if dotted.endswith(".value"):
        dotted = dotted[: -len(".value")]
    return port_name(dotted, 2)[0]


def lora_deltas_from_nnx(
    deltas: Mapping[str, Tuple[np.ndarray, np.ndarray]]
) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """JAX LoRA deltas {path: (down (in, rank), up (rank, out))} -> the
    port's {name: (down (rank, in), up (out, rank))}, in f32."""
    out: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for path, (down, up) in deltas.items():
        out[lora_path_to_port(path)] = tuple(
            torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32).T)) for a in (down, up)
        )
    return out


# the JAX DDPM's noise-schedule variables, which the port computes from the schedule's spec
SCHEDULE_LEAVES = frozenset((
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2", "lvlb_weights",
))


def state_dict_from_jax(npd: Mapping[str, np.ndarray], module: nn.Module) -> Dict[str, torch.Tensor]:
    """A JAX `IDLModel.state_dict()` -> a state dict of `module` (the port's
    counterpart): parameters through `tree_from_nnx` (strict), EMA shadows
    (`.../shadow/<path>`) into `shadow__<port name>` buffers, other leaves
    into the persistent buffers of the same paths; the random streams, the
    noise schedule's leaves and the port's own non-persistent buffers left
    out. Any other leaf raises."""
    leaves = {}
    for key, value in npd.items():
        path = key[: -len("/value")] if key.endswith("/value") else key
        if "/rngs/" in f"/{path}" or path.rpartition("/")[2] == "aux_loss":
            continue
        leaves[path.replace("/", ".")] = np.asarray(value)
    params = set(name for name, _ in module.named_parameters())
    buffers = dict(module.named_buffers())
    persistent = set(module.state_dict())
    out: Dict[str, torch.Tensor] = {}
    param_leaves, errors = {}, []
    for path, value in leaves.items():
        prefix, shadow, inner = path.partition(".shadow.") if ".shadow." in path else ("", "", path)
        if shadow:
            name, perm = port_name(inner, value.ndim)
            target = f"{prefix}.shadow__{name.replace('.', '__')}"
            if target not in buffers:
                errors.append(f"EMA leaf {path}: no buffer {target}")
                continue
            out[target] = torch.from_numpy(np.array(np.transpose(value, perm) if perm else value))
        elif port_name(path, value.ndim)[0] in params or path in params:
            param_leaves[path] = value
        elif path in persistent:
            out[path] = torch.from_numpy(np.array(value))
        elif path.rpartition(".")[2] in SCHEDULE_LEAVES or path in buffers:
            continue
        else:
            errors.append(f"JAX leaf {path}: no port parameter or buffer")
    if errors:
        raise ValueError(f"{len(errors)} bridge errors, e.g.\n" + "\n".join(errors[:10]))
    out.update(tree_from_nnx(param_leaves, module))
    return out


def jax_param_names(module: nn.Module) -> Dict[str, str]:
    """{port parameter name: the JAX package's key of that parameter}, the
    key as `tree_to_npd(nnx.state(model, nnx.Param))` writes it
    ("m/head/kernel/value"): `port_name` run backwards. A `weight` is an
    `Embed`'s `embedding`, a norm's `scale` (1-D) or a kernel (2-D and up);
    every other parameter keeps its name."""
    owners = dict(module.named_modules())
    out: Dict[str, str] = {}
    for name, p in module.named_parameters():
        prefix, _, leaf = name.rpartition(".")
        if leaf == "weight":
            if isinstance(owners.get(prefix), nn.Embedding):
                leaf = "embedding"
            else:
                leaf = "kernel" if p.ndim >= 2 else "scale"
        path = f"{prefix}.{leaf}" if prefix else leaf
        out[name] = path.replace(".", "/") + "/value"
    return out
