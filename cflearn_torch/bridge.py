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


# ---- the annotator nets: JAX npd -> the port's (upstream-named) state dict ----
#
# Each function takes `tree_to_npd(nnx.state(net, nnx.Param))` of the JAX net
# ("/"-joined paths ending in "/value"; M-LSD also its `nnx.BatchStat`s) and
# gives the port net's state dict: the JAX package's `convert_*` run the
# other way. Every leaf must be placed; `load_state_dict(strict=True)` then
# holds the result to the port net.


def _annotator_leaves(npd: Mapping[str, np.ndarray], prefixes: Mapping[str, str]) -> Dict[str, torch.Tensor]:
    """Leaves under each JAX prefix ("blocks/0/qkv") to the port's module
    path ("pretrained.model.blocks.0.attn.qkv"): kernels to `weight` in the
    port's layout (conv HWIO -> OIHW, linear (in, out) -> (out, in)),
    `scale` to `weight`, BatchNorm's `mean` / `var` to the running
    statistics (with `num_batches_tracked` at 0), `bias` as it is."""
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for jp, pp in prefixes.items():
        for leaf in ("kernel", "bias", "scale", "mean", "var"):
            key = f"{jp}/{leaf}/value"
            if key not in npd:
                continue
            arr = np.asarray(npd[key], dtype=np.float32)
            if leaf == "kernel":
                arr = np.transpose(arr, _PERM[arr.ndim])
            name = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
            out[f"{pp}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
            used.add(key)
            if leaf == "mean":
                out[f"{pp}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    left = sorted(set(npd) - used)
    if left:
        raise ValueError(f"JAX leaves the annotator bridge places nowhere: {left[:10]}")
    return out


def dpt_state_dict(npd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX `DPTDepth` -> the port's (`convert_midas` inverted): the
    ConvTranspose kernels are flipped back and laid out (in, out, kh, kw)."""
    npd = dict(npd)
    p = "pretrained.model"
    out: Dict[str, torch.Tensor] = {}
    for leaf in ("cls_token", "pos_embed"):
        out[f"{p}.{leaf}"] = torch.from_numpy(np.asarray(npd.pop(f"{leaf}/value"), dtype=np.float32))
    for name in ("resample1", "resample2"):
        w = np.asarray(npd.pop(f"{name}/kernel/value"), dtype=np.float32)[::-1, ::-1]
        i = name[-1]
        out[f"pretrained.act_postprocess{i}.4.weight"] = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))))
        out[f"pretrained.act_postprocess{i}.4.bias"] = torch.from_numpy(np.asarray(npd.pop(f"{name}/bias/value"), dtype=np.float32))
    prefixes = {"patch_embed": f"{p}.patch_embed.proj", "resample4": "pretrained.act_postprocess4.4",
                "head_conv1": "scratch.output_conv.0", "head_conv2": "scratch.output_conv.2",
                "head_conv3": "scratch.output_conv.4"}
    for i in sorted({int(k.split("/")[1]) for k in npd if k.startswith("blocks/")}):
        for ours, theirs in (("norm1", "norm1"), ("norm2", "norm2"), ("qkv", "attn.qkv"), ("proj", "attn.proj"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            prefixes[f"blocks/{i}/{ours}"] = f"{p}.blocks.{i}.{theirs}"
    for i in range(4):
        prefixes[f"readouts/{i}/project"] = f"pretrained.act_postprocess{i + 1}.0.project.0"
        prefixes[f"projects/{i}"] = f"pretrained.act_postprocess{i + 1}.3"
        prefixes[f"layer_rn/{i}"] = f"scratch.layer{i + 1}_rn"
        for ours, theirs in (("out_conv", "out_conv"), ("res1/conv1", "resConfUnit1.conv1"),
                             ("res1/conv2", "resConfUnit1.conv2"), ("res2/conv1", "resConfUnit2.conv1"),
                             ("res2/conv2", "resConfUnit2.conv2")):
            prefixes[f"refine/{i}/{ours}"] = f"scratch.refinenet{i + 1}.{theirs}"
    return {**out, **_annotator_leaves(npd, prefixes)}


def hed_state_dict(npd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX `HED` -> the port's (`convert_hed` inverted)."""
    npd = dict(npd)
    norm = np.asarray(npd.pop("norm/value"), dtype=np.float32).reshape(1, 3, 1, 1)
    prefixes = {}
    for k in npd:
        parts = k.split("/")  # blocks/{b}/convs/{c}/kernel/value or blocks/{b}/projection/...
        block = f"block{int(parts[1]) + 1}"
        if parts[2] == "convs":
            prefixes["/".join(parts[:4])] = f"{block}.convs.{parts[3]}"
        else:
            prefixes["/".join(parts[:3])] = f"{block}.projection"
    return {"norm": torch.from_numpy(norm), **_annotator_leaves(npd, prefixes)}


def pidi_state_dict(npd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX `PiDiNet` (its pdc convs already folded) -> the port's."""
    from .api.cv.third_party.pidi import BLOCK_NAMES

    prefixes = {"init_block": "init_block", "classifier": "classifier"}
    for bi, (name, _) in enumerate(BLOCK_NAMES):
        for part in ("conv1", "conv2", "shortcut"):
            prefixes[f"blocks/{bi}/{part}"] = f"{name}.{part}"
    for i in range(4):
        prefixes[f"dilations/{i}/conv1"] = f"dilations.{i}.conv1"
        for j in range(4):
            prefixes[f"dilations/{i}/dilated/{j}"] = f"dilations.{i}.conv2_{j + 1}"
        prefixes[f"attentions/{i}/conv1"] = f"attentions.{i}.conv1"
        prefixes[f"attentions/{i}/conv2"] = f"attentions.{i}.conv2"
        prefixes[f"conv_reduces/{i}"] = f"conv_reduces.{i}.conv"
    return _annotator_leaves(npd, prefixes)


def mlsd_state_dict(npd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX `MLSD` (parameters and batch statistics) -> the port's
    (`convert_mlsd` inverted)."""
    from .api.cv.third_party.mlsd import IR_SETTING

    prefixes = {"features/0/conv": "backbone.features.0.0", "features/0/bn": "backbone.features.0.1"}
    fi = 1
    for t, _, n, _ in IR_SETTING:
        for _ in range(n):
            p, o = f"backbone.features.{fi}.conv", f"features/{fi}"
            layers = [0, 1] if t != 1 else [0]
            for li in layers:
                prefixes[f"{o}/layers/{li}/conv"] = f"{p}.{li}.0"
                prefixes[f"{o}/layers/{li}/bn"] = f"{p}.{li}.1"
            prefixes[f"{o}/project"] = f"{p}.{len(layers)}"
            prefixes[f"{o}/project_bn"] = f"{p}.{len(layers) + 1}"
            fi += 1
    for i in range(15, 24):
        for j in (1, 2):
            prefixes[f"block{i}/conv{j}"] = f"block{i}.conv{j}.0"
            prefixes[f"block{i}/bn{j}"] = f"block{i}.conv{j}.1"
    prefixes["block23/conv3"] = "block23.conv3"
    return _annotator_leaves(npd, prefixes)


def _openpose_prefixes(stem: str, stem_names: Iterable[str], stages: Mapping[str, Tuple[str, Iterable[str]]]) -> Dict[str, str]:
    prefixes = {f"stem/{i}": f"{stem}.{name}" for i, name in enumerate(stem_names)}
    for ours, (module, names) in stages.items():
        for ci, name in enumerate(names):
            prefixes[f"{ours}/convs/{ci}"] = f"{module}.{name}"
    return prefixes


def openpose_state_dict(npd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX `OpenPoseBody` -> the port's (`convert_openpose` inverted)."""
    from .api.cv.third_party.openpose import _BODY_STEM

    stages = {}
    for s in range(1, 7):
        for b, ours in ((1, "stages_l1"), (2, "stages_l2")):
            names = ([f"conv5_{j}_CPM_L{b}" for j in range(1, 6)] if s == 1 else
                     [f"Mconv{j}_stage{s}_L{b}" for j in range(1, 8)])
            stages[f"{ours}/{s - 1}"] = (f"model{s}_{b}", names)
    stem = [item[0] for item in _BODY_STEM if item != "pool"]
    return _annotator_leaves(npd, _openpose_prefixes("model0", stem, stages))


def hand_state_dict(npd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX `OpenPoseHand` -> the port's (`convert_hand` inverted)."""
    from .api.cv.third_party.openpose import _HAND_STEM

    stages = {"head": ("model1_1", ["conv6_1_CPM", "conv6_2_CPM"])}
    for s in range(2, 7):
        stages[f"stages/{s - 2}"] = (f"model{s}", [f"Mconv{j}_stage{s}" for j in range(1, 8)])
    stem = [item[0] for item in _HAND_STEM if item != "pool"]
    return _annotator_leaves(npd, _openpose_prefixes("model1_0", stem, stages))
