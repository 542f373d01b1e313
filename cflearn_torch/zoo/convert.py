"""Upstream checkpoints -> the port's state dicts (counterpart of
`cflearn_tpu/zoo/convert.py` and of `cflearn_tpu/scripts/sd.py`'s ControlNet
converter).

Reading. `load_torch_state_dict` reads a `.safetensors` file with the port's
own reader (`read_safetensors`: the 8-byte little-endian header length, the
JSON header, then the tensors, mapped from the file copy-on-write, so a
4.3 GB checkpoint is not copied into host memory), and a `.ckpt` / `.pt` /
`.pth` through `torch.load(weights_only=True)` (memory-mapped where the file
is in the zip format), unwrapped from `"state_dict"` as in the JAX package,
and from `"params_ema"` / `"params"` (the Real-ESRGAN files keep their
tensors there). `write_safetensors` writes the same format: the converted
cache and synthetic checkpoints.

Converting. `build_*_mapping` emits (upstream key, port name, kind)
triplets, built exactly as the JAX package's builders walk the
architectures, with the port's names for its targets (the JAX package's
paths, dotted, with `weight` for a kernel, a norm's scale and an
embedding). Upstream tensors are OIHW / (out, in) like the port's, so most
kinds are renames: `conv1x1_to_linear` squeezes a 1x1 conv into a linear
weight (the VAE's attention), `linear_3q` / `bias_3q` (k, v) take one third
of open_clip's fused `in_proj` rows. The result of a conversion equals the
JAX package's conversion of the same dict carried across by
`bridge.state_dict_from_nnx`, tensor for tensor; the converted tensors are
views of the file's where the kind allows.

Strictness. `convert_with` raises on an upstream key that the mapping does not
take unless it is on the converter's explicit list of dropped keys
(`DROPPED`: the SD noise schedule, its EMA bookkeeping, CLIP's position ids,
open_clip's unused projection and logit scale); the loaders
(`zoo.common`) then require the result to fill every parameter of the
module and to name nothing else. The JAX package drops unknown keys and
leaves unfilled leaves at their random values.

The ControlNet mapping departs from the JAX package's on purpose: that one
places the hint encoder's last conv (`input_hint_block.14`) at a
`hint_blocks/7` the module does not have and takes no `middle_block_out`, so
a JAX ControlNet keeps its zero-initialised `hint_out` and `mid_zero`; here
they are `hint_out` and `mid_zero`.

The reference's own (cflearn) layout of the SD family goes through the
audited rename table (`sd_cflearn_mapping.json`, the port's copy of the JAX
package's) back to the upstream layout: `cflearn_sd_to_original` splits the
fused `in_w` / `qkv_bias`, squeezes `pos_encoding` and drops the
non-checkpoint buffers by the table's list; any other key raises.

`invert` runs a mapping backwards: the upstream dict from the port's state
dict, which the tests and `chip_smoke.py` write as synthetic checkpoints.
"""

import json
import struct
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Triplet = Tuple[str, str, str]  # upstream key, port name, kind

MAPPING_FILE = Path(__file__).parent / "sd_cflearn_mapping.json"


# ---- reading and writing checkpoints ----

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: Any) -> Dict[str, torch.Tensor]:
    """The tensors of a `.safetensors` file, as views of one copy-on-write
    mapping of it (a tensor whose offset does not suit its dtype is copied
    out)."""
    path = str(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    end = max((info["data_offsets"][1] for info in header.values()), default=0)
    if end:
        raw = torch.from_numpy(np.memmap(path, dtype=np.uint8, mode="c", offset=8 + n, shape=(end,)))
    else:
        raw = torch.empty(0, dtype=torch.uint8)
    out: Dict[str, torch.Tensor] = {}
    for key, info in header.items():
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {key} has dtype {info['dtype']}, which the reader does not take")
        begin, stop = info["data_offsets"]
        chunk = raw[begin:stop]
        itemsize = torch.empty(0, dtype=dtype).element_size()
        if begin % itemsize:
            chunk = chunk.clone()
        out[key] = chunk.view(dtype).reshape(info["shape"])
    return out


def write_safetensors(path: Any, tensors: Mapping[str, torch.Tensor]) -> None:
    """`tensors` to a `.safetensors` file, the widest dtypes first (every
    tensor at an offset of its own alignment), the header padded to 8 bytes."""
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, Any] = {}
    offset = 0
    for k in names:
        t = tensors[k]
        nbytes = t.numel() * t.element_size()
        header[k] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(str(path), "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in names:
            t = tensors[k].detach().contiguous().cpu().reshape(-1)
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))


def load_torch_state_dict(path: Any) -> Dict[str, torch.Tensor]:
    """A `.safetensors` (the port's reader) or `.ckpt` / `.pt` / `.pth`
    (`torch.load`, tensors only) checkpoint as {key: CPU tensor}."""
    path = str(path)
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except RuntimeError:  # a legacy (not zip) file cannot be mapped
        sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "params_ema", "params"):
        if isinstance(sd, dict) and isinstance(sd.get(wrapper), dict):
            sd = sd[wrapper]
            break
    return dict(sd)


# ---- transforms ----

def _fused_third(kind: str) -> Optional[int]:
    if kind.startswith(("linear_3", "bias_3")):
        return "qkv".index(kind[-1])
    return None


def _fwd(kind: str, w: torch.Tensor) -> torch.Tensor:
    i = _fused_third(kind)
    if i is not None:
        third = w.shape[0] // 3
        return w[i * third : (i + 1) * third]
    if kind == "conv1x1_to_linear":
        return w[:, :, 0, 0]
    if kind in ("linear", "conv", "bias", "norm", "copy", "embedding"):
        return w
    raise ValueError(kind)


def apply_mapping(mapping: Sequence[Triplet], sd: Mapping[str, Any], *, strict: bool = True) -> Dict[str, torch.Tensor]:
    """{port name: tensor} of each triplet whose upstream key `sd` holds;
    `strict`: every upstream key of the mapping must be there."""
    out: Dict[str, torch.Tensor] = {}
    missing = []
    for key, name, kind in mapping:
        w = sd.get(key)
        if w is None:
            missing.append(key)
            continue
        out[name] = _fwd(kind, torch.as_tensor(w))
    if strict and missing:
        raise KeyError(f"{len(missing)} keys missing from the checkpoint, e.g. {missing[:5]}")
    return out


def invert(mapping: Sequence[Triplet], port_sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The upstream dict of the port's state dict under `mapping` (a fused
    `in_proj` from its three parts)."""
    out: Dict[str, torch.Tensor] = {}
    fused: Dict[str, Dict[int, torch.Tensor]] = {}
    for key, name, kind in mapping:
        if name not in port_sd:
            continue
        w = port_sd[name]
        i = _fused_third(kind)
        if i is not None:
            fused.setdefault(key, {})[i] = w
        elif kind == "conv1x1_to_linear":
            out[key] = w[:, :, None, None]
        else:
            out[key] = w
    for key, parts in fused.items():
        if sorted(parts) != [0, 1, 2]:
            raise ValueError(f"{key}: the fused projection needs its q, k and v parts")
        out[key] = torch.cat([parts[0], parts[1], parts[2]], 0)
    return out


# ---- building blocks ----

def _linear(t: str, o: str) -> List[Triplet]:
    return [(f"{t}.weight", f"{o}.weight", "linear"), (f"{t}.bias", f"{o}.bias", "bias")]


def _linear_nb(t: str, o: str) -> List[Triplet]:
    return [(f"{t}.weight", f"{o}.weight", "linear")]


def _conv(t: str, o: str) -> List[Triplet]:
    return [(f"{t}.weight", f"{o}.weight", "conv"), (f"{t}.bias", f"{o}.bias", "bias")]


def _norm(t: str, o: str) -> List[Triplet]:
    return [(f"{t}.weight", f"{o}.weight", "norm"), (f"{t}.bias", f"{o}.bias", "bias")]


def _attn_qkvo_1x1(t: str, o: str) -> List[Triplet]:
    """The VAE's attention: 1x1 convs upstream, linears in the port."""
    out: List[Triplet] = []
    for a, b in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("proj_out", "to_out")):
        out.append((f"{t}.{a}.weight", f"{o}.{b}.weight", "conv1x1_to_linear"))
        out.append((f"{t}.{a}.bias", f"{o}.{b}.bias", "bias"))
    return out


# ---- UNet ----

def _res_block(t: str, o: str, *, has_shortcut: bool) -> List[Triplet]:
    out = (
        _norm(f"{t}.in_layers.0", f"{o}.norm1")
        + _conv(f"{t}.in_layers.2", f"{o}.conv1")
        + _linear(f"{t}.emb_layers.1", f"{o}.time_proj")
        + _norm(f"{t}.out_layers.0", f"{o}.norm2")
        + _conv(f"{t}.out_layers.3", f"{o}.conv2")
    )
    if has_shortcut:
        out += _conv(f"{t}.skip_connection", f"{o}.shortcut")
    return out


def _transformer(t: str, o: str, *, num_layers: int, use_linear: bool) -> List[Triplet]:
    out = _norm(f"{t}.norm", f"{o}.norm")
    proj = _linear if use_linear else _conv
    out += proj(f"{t}.proj_in", f"{o}.proj_in")
    out += proj(f"{t}.proj_out", f"{o}.proj_out")
    for m in range(num_layers):
        bt = f"{t}.transformer_blocks.{m}"
        bo = f"{o}.blocks.{m}"
        for attn in ("attn1", "attn2"):
            out += _linear_nb(f"{bt}.{attn}.to_q", f"{bo}.{attn}.to_q")
            out += _linear_nb(f"{bt}.{attn}.to_k", f"{bo}.{attn}.to_k")
            out += _linear_nb(f"{bt}.{attn}.to_v", f"{bo}.{attn}.to_v")
            out += _linear(f"{bt}.{attn}.to_out.0", f"{bo}.{attn}.to_out")
        out += _linear(f"{bt}.ff.net.0.proj", f"{bo}.ff.net1.net")
        out += _linear(f"{bt}.ff.net.2", f"{bo}.ff.linear2")
        out += _norm(f"{bt}.norm1", f"{bo}.norm1")
        out += _norm(f"{bt}.norm2", f"{bo}.norm2")
        out += _norm(f"{bt}.norm3", f"{bo}.norm3")
    return out


def build_unet_mapping(
    *,
    prefix: str = "model.diffusion_model",
    our_prefix: str = "unet",
    in_channels: int = 4,
    start_channels: int = 320,
    num_res_blocks: int = 2,
    channel_multipliers: Sequence[int] = (1, 2, 4, 4),
    attention_downsample_rates: Sequence[int] = (1, 2, 4),
    num_transformer_layers: int = 1,
    use_linear_in_transformer: bool = False,
) -> List[Triplet]:
    """The SD UNet (`UNetDiffuser`), walked as its constructor builds it."""
    t, o = prefix, our_prefix
    tr = dict(num_layers=num_transformer_layers, use_linear=use_linear_in_transformer)
    out: List[Triplet] = []
    out += _linear(f"{t}.time_embed.0", f"{o}.time_fc1")
    out += _linear(f"{t}.time_embed.2", f"{o}.time_fc2")
    out += _conv(f"{t}.input_blocks.0.0", f"{o}.conv_in")
    ch = start_channels
    ds = 1
    sd_idx = 1  # upstream input_blocks.0 is conv_in
    our_idx = 0
    for level, mult in enumerate(channel_multipliers):
        for _ in range(num_res_blocks):
            out_ch = start_channels * mult
            tb = f"{t}.input_blocks.{sd_idx}"
            ob = f"{o}.input_blocks.{our_idx}.mods"
            out += _res_block(f"{tb}.0", f"{ob}.0", has_shortcut=ch != out_ch)
            ch = out_ch
            if ds in attention_downsample_rates:
                out += _transformer(f"{tb}.1", f"{ob}.1", **tr)
            sd_idx += 1
            our_idx += 1
        if level != len(channel_multipliers) - 1:
            out += _conv(f"{t}.input_blocks.{sd_idx}.0.op", f"{o}.input_blocks.{our_idx}.mods.0.conv")
            sd_idx += 1
            our_idx += 1
            ds *= 2
    out += _res_block(f"{t}.middle_block.0", f"{o}.mid.mods.0", has_shortcut=False)
    out += _transformer(f"{t}.middle_block.1", f"{o}.mid.mods.1", **tr)
    out += _res_block(f"{t}.middle_block.2", f"{o}.mid.mods.2", has_shortcut=False)
    our_idx = 0
    for level, mult in reversed(list(enumerate(channel_multipliers))):
        for i in range(num_res_blocks + 1):
            tb = f"{t}.output_blocks.{our_idx}"
            ob = f"{o}.output_blocks.{our_idx}.mods"
            out += _res_block(f"{tb}.0", f"{ob}.0", has_shortcut=True)
            sub = 1
            if ds in attention_downsample_rates:
                out += _transformer(f"{tb}.{sub}", f"{ob}.{sub}", **tr)
                sub += 1
            if level != 0 and i == num_res_blocks:
                out += _conv(f"{tb}.{sub}.conv", f"{ob}.{sub}.conv.conv")
                ds //= 2
            our_idx += 1
    out += _norm(f"{t}.out.0", f"{o}.norm_out")
    out += _conv(f"{t}.out.2", f"{o}.conv_out")
    return out


def build_controlnet_mapping(
    *, num_res_blocks: int = 2, channel_multipliers: Sequence[int] = (1, 2, 4, 4), **unet_kwargs: Any
) -> List[Triplet]:
    """An upstream ControlNet (`control_model.*`) -> the port's `ControlNet`:
    the UNet's encoder half, the zero convs, the hint encoder and its last
    conv (`hint_out`), the middle block's zero conv (`mid_zero`)."""
    unet = build_unet_mapping(
        prefix="control_model", our_prefix="unet", num_res_blocks=num_res_blocks,
        channel_multipliers=channel_multipliers, **unet_kwargs,
    )
    out = [tr for tr in unet if not tr[0].startswith(("control_model.output_blocks.", "control_model.out."))]
    n_inputs = 1 + len(channel_multipliers) * num_res_blocks + len(channel_multipliers) - 1
    for i in range(n_inputs):
        out += _conv(f"control_model.zero_convs.{i}.0", f"zero_convs.{i}")
    for j in range(7):
        out += _conv(f"control_model.input_hint_block.{2 * j}", f"hint_blocks.{j}")
    out += _conv("control_model.input_hint_block.14", "hint_out")
    out += _conv("control_model.middle_block_out.0", "mid_zero")
    return out


# ---- VAE (the first stage) ----

def _vae_res(t: str, o: str, *, has_shortcut: bool) -> List[Triplet]:
    out = (
        _norm(f"{t}.norm1", f"{o}.norm1")
        + _conv(f"{t}.conv1", f"{o}.conv1")
        + _norm(f"{t}.norm2", f"{o}.norm2")
        + _conv(f"{t}.conv2", f"{o}.conv2")
    )
    if has_shortcut:
        out += _conv(f"{t}.nin_shortcut", f"{o}.shortcut")
    return out


def _vae_attn(t: str, o: str) -> List[Triplet]:
    return _norm(f"{t}.norm", f"{o}.norm") + _attn_qkvo_1x1(t, o)


def build_vae_mapping(
    *,
    prefix: str = "first_stage_model",
    our_prefix: str = "first_stage",
    inner_channels: int = 128,
    z_channels: int = 4,
    embedding_channels: int = 4,
    channel_multipliers: Sequence[int] = (1, 2, 4, 4),
    num_res_blocks: int = 2,
    attention_resolutions: Sequence[int] = (),
    img_size: int = 256,
) -> List[Triplet]:
    t, o = prefix, our_prefix
    out: List[Triplet] = []
    out += _conv(f"{t}.encoder.conv_in", f"{o}.encoder.conv_in")
    ch = inner_channels
    flat = 0
    resolution = img_size
    for i, mult in enumerate(channel_multipliers):
        out_ch = inner_channels * mult
        for j in range(num_res_blocks):
            out += _vae_res(f"{t}.encoder.down.{i}.block.{j}", f"{o}.encoder.blocks.{flat}", has_shortcut=ch != out_ch)
            ch = out_ch
            flat += 1
            if resolution in attention_resolutions:
                out += _vae_attn(f"{t}.encoder.down.{i}.attn.{j}", f"{o}.encoder.blocks.{flat}")
                flat += 1
        if i != len(channel_multipliers) - 1:
            out += _conv(f"{t}.encoder.down.{i}.downsample.conv", f"{o}.encoder.blocks.{flat}.conv")
            flat += 1
            resolution //= 2
    out += _vae_res(f"{t}.encoder.mid.block_1", f"{o}.encoder.mid_res1", has_shortcut=False)
    out += _vae_attn(f"{t}.encoder.mid.attn_1", f"{o}.encoder.mid_attn")
    out += _vae_res(f"{t}.encoder.mid.block_2", f"{o}.encoder.mid_res2", has_shortcut=False)
    out += _norm(f"{t}.encoder.norm_out", f"{o}.encoder.norm_out")
    out += _conv(f"{t}.encoder.conv_out", f"{o}.encoder.conv_out")
    out += _conv(f"{t}.quant_conv", f"{o}.to_embedding")
    out += _conv(f"{t}.post_quant_conv", f"{o}.from_embedding")
    out += _conv(f"{t}.decoder.conv_in", f"{o}.decoder.conv_in")
    out += _vae_res(f"{t}.decoder.mid.block_1", f"{o}.decoder.mid_res1", has_shortcut=False)
    out += _vae_attn(f"{t}.decoder.mid.attn_1", f"{o}.decoder.mid_attn")
    out += _vae_res(f"{t}.decoder.mid.block_2", f"{o}.decoder.mid_res2", has_shortcut=False)
    ch = inner_channels * channel_multipliers[-1]
    flat = 0
    resolution = img_size // (2 ** (len(channel_multipliers) - 1))
    for i, mult in reversed(list(enumerate(channel_multipliers))):
        out_ch = inner_channels * mult
        for j in range(num_res_blocks + 1):
            out += _vae_res(f"{t}.decoder.up.{i}.block.{j}", f"{o}.decoder.blocks.{flat}", has_shortcut=ch != out_ch)
            ch = out_ch
            flat += 1
            if resolution in attention_resolutions:
                out += _vae_attn(f"{t}.decoder.up.{i}.attn.{j}", f"{o}.decoder.blocks.{flat}")
                flat += 1
        if i != 0:
            out += _conv(f"{t}.decoder.up.{i}.upsample.conv", f"{o}.decoder.blocks.{flat}.conv.conv")
            flat += 1
            resolution *= 2
    out += _norm(f"{t}.decoder.norm_out", f"{o}.decoder.norm_out")
    out += _conv(f"{t}.decoder.conv_out", f"{o}.decoder.conv_out")
    return out


# ---- the text towers ----

def build_clip_text_mapping(
    *,
    prefix: str = "cond_stage_model.transformer.text_model",
    our_prefix: str = "condition_model.encoder",
    num_layers: int = 12,
) -> List[Triplet]:
    """HF's `CLIPTextModel` (SD v1's text tower)."""
    t, o = prefix, our_prefix
    out: List[Triplet] = [
        (f"{t}.embeddings.token_embedding.weight", f"{o}.token_embedding.weight", "embedding"),
        (f"{t}.embeddings.position_embedding.weight", f"{o}.positional_embedding", "embedding"),
    ]
    for n in range(num_layers):
        lt = f"{t}.encoder.layers.{n}"
        lo = f"{o}.blocks.{n}"
        out += _norm(f"{lt}.layer_norm1", f"{lo}.ln_1")
        out += _norm(f"{lt}.layer_norm2", f"{lo}.ln_2")
        for p in ("q", "k", "v"):
            out += _linear(f"{lt}.self_attn.{p}_proj", f"{lo}.attn.{p}_proj")
        out += _linear(f"{lt}.self_attn.out_proj", f"{lo}.attn.out_proj")
        out += _linear(f"{lt}.mlp.fc1", f"{lo}.mlp.fc1")
        out += _linear(f"{lt}.mlp.fc2", f"{lo}.mlp.fc2")
    out += _norm(f"{t}.final_layer_norm", f"{o}.ln_final")
    return out


def build_open_clip_text_mapping(
    *,
    prefix: str = "cond_stage_model.model",
    our_prefix: str = "condition_model.encoder",
    num_layers: int = 23,
) -> List[Triplet]:
    """open_clip's text tower (SD v2's; fused `attn.in_proj_*`)."""
    t, o = prefix, our_prefix
    out: List[Triplet] = [
        (f"{t}.token_embedding.weight", f"{o}.token_embedding.weight", "embedding"),
        (f"{t}.positional_embedding", f"{o}.positional_embedding", "embedding"),
    ]
    for n in range(num_layers):
        lt = f"{t}.transformer.resblocks.{n}"
        lo = f"{o}.blocks.{n}"
        out += _norm(f"{lt}.ln_1", f"{lo}.ln_1")
        out += _norm(f"{lt}.ln_2", f"{lo}.ln_2")
        for p in "qkv":
            out.append((f"{lt}.attn.in_proj_weight", f"{lo}.attn.{p}_proj.weight", f"linear_3{p}"))
            out.append((f"{lt}.attn.in_proj_bias", f"{lo}.attn.{p}_proj.bias", f"bias_3{p}"))
        out += _linear(f"{lt}.attn.out_proj", f"{lo}.attn.out_proj")
        out += _linear(f"{lt}.mlp.c_fc", f"{lo}.mlp.fc1")
        out += _linear(f"{lt}.mlp.c_proj", f"{lo}.mlp.fc2")
    out += _norm(f"{t}.ln_final", f"{o}.ln_final")
    return out


# ---- ESRGAN (RRDBNet) ----

def build_esrgan_mapping(*, num_blocks: int = 23, our_prefix: str = "") -> List[Triplet]:
    p = f"{our_prefix}." if our_prefix else ""
    out: List[Triplet] = []
    out += _conv("conv_first", f"{p}conv_first")
    for b in range(num_blocks):
        for d in range(3):
            tb = f"body.{b}.rdb{d + 1}"
            ob = f"{p}body.{b}.dense_blocks.{d}"
            for c in range(4):
                out += _conv(f"{tb}.conv{c + 1}", f"{ob}.convs.{c}")
            out += _conv(f"{tb}.conv5", f"{ob}.conv_out")
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr", "conv_last"):
        out += _conv(name, f"{p}{name}")
    return out


# ---- a whole SD checkpoint ----

def build_sd_mapping(version: str = "v1") -> List[Triplet]:
    """An upstream (CompVis-layout) SD checkpoint -> the port's `StableDiffusion`."""
    v2 = version.startswith("v2")
    unet = build_unet_mapping(use_linear_in_transformer=v2)
    vae = build_vae_mapping()
    clip = build_open_clip_text_mapping(num_layers=23) if v2 else build_clip_text_mapping()
    return unet + vae + clip


# upstream keys that no parameter of the port takes, dropped by name: exact keys, and prefixes ending in "."
SD_SCHEDULE_KEYS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
)
DROPPED: Dict[str, Tuple[str, ...]] = {
    # the noise schedule (recomputed from its spec), the EMA's bookkeeping, HF CLIP's position ids
    "sd": SD_SCHEDULE_KEYS + ("model_ema.", "cond_stage_model.transformer.text_model.embeddings.position_ids"),
    # and open_clip's projection and logit scale, which the text condition does not use
    "sd_v2": SD_SCHEDULE_KEYS + ("model_ema.", "cond_stage_model.model.logit_scale",
                                 "cond_stage_model.model.text_projection"),
}


def _dropped(key: str, drop: Iterable[str]) -> bool:
    return any(key == d or (d.endswith(".") and key.startswith(d)) for d in drop)


def unused_keys(mapping: Sequence[Triplet], sd: Mapping[str, Any], drop: Iterable[str] = ()) -> List[str]:
    """The keys of `sd` that no triplet takes and `drop` does not name."""
    taken = {key for key, _, _ in mapping}
    drop = tuple(drop)
    return sorted(k for k in sd if k not in taken and not _dropped(k, drop))


def convert_with(mapping: Sequence[Triplet], sd: Mapping[str, Any], drop: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """`apply_mapping` over the keys `sd` holds; an upstream key that the
    mapping does not take and `drop` does not name raises."""
    left = unused_keys(mapping, sd, drop)
    if left:
        raise ValueError(f"{len(left)} checkpoint keys that no parameter takes, e.g. {left[:8]}")
    return apply_mapping(mapping, sd, strict=False)


def convert_sd(sd: Mapping[str, Any], *, version: str = "v1") -> Dict[str, torch.Tensor]:
    return convert_with(build_sd_mapping(version), sd, DROPPED["sd_v2" if version.startswith("v2") else "sd"])


def convert_controlnet_sd(sd: Mapping[str, Any], **geometry: Any) -> Dict[str, torch.Tensor]:
    """An upstream ControlNet (SD-1.5's geometry unless `geometry` says
    otherwise: `build_controlnet_mapping`'s arguments)."""
    return convert_with(build_controlnet_mapping(**geometry), sd)


# ---- the reference's (cflearn) layout -> the upstream layout ----
#
# Every cflearn key is a rename of an upstream key (`build_sd_cflearn_renames`, derived from the architecture and
# equal to the audited table in `sd_cflearn_mapping.json`), but for three text-tower cases: the fused `in_w` /
# `qkv_bias` of each layer (split into q, k, v), `pos_encoding` (1, 77, d) (the (77, d) position table), and the
# model constants the table lists as `non_checkpoint_keys` (dropped; the port recomputes them).

_CF_UNET_RENAMES = [
    (".in_layers.0.", ".norm1."),
    (".in_layers.2.", ".conv1."),
    (".emb_layers.1.", ".time_embedding."),
    (".out_layers.0.", ".norm2."),
    (".out_layers.3.", ".conv2."),
    (".skip_connection.", ".shortcut."),
    (".op.", ".net."),
    (".proj_in.", ".to_latent."),
    (".proj_out.", ".from_latent."),
    (".transformer_blocks.", ".blocks."),
    (".to_out.0.", ".out_linear.0."),
    (".ff.net.0.proj.", ".ff.net.0.net."),
    (".ff.net.2.", ".ff.net.2.linear."),
]
_CF_VAE_RES = [("nin_shortcut", "shortcut")]
_CF_VAE_ATTN = [("norm", "group_norm"), ("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("proj_out", "to_out")]
_CF_COND_PREFIX = "condition_model.m"
_CF_COND_BLOCKS = f"{_CF_COND_PREFIX}.text_transformer.encoder.mixing_blocks"
_CF_POS = f"{_CF_COND_PREFIX}.text_transformer.encoder.pos_encoding.pos_encoding"
_CF_COND_INNER = [
    ("layer_norm1", "token_norm"),
    ("layer_norm2", "channel_norm"),
    ("self_attn.out_proj", "token_mixing.net.out_linear.linear"),
    ("mlp.fc1", "channel_mixing.net.0.linear"),
    ("mlp.fc2", "channel_mixing.net.3.linear"),
]
_HF_LAYERS = "cond_stage_model.transformer.text_model.encoder.layers"


def _cf_unet_key(orig: str) -> str:
    k = orig[len("model.diffusion_model."):]
    if k.startswith("time_embed."):
        k = "time_embedding." + k[len("time_embed."):]
    elif k.startswith("middle_block."):
        k = "residual." + k[len("middle_block."):]
    elif k.startswith("out."):
        k = "head." + k[len("out."):]
    for a, b in _CF_UNET_RENAMES:
        k = k.replace(a, b)
    return "unet." + k


def _cf_vae_inner(tail: str, table: List[Tuple[str, str]]) -> str:
    mod, _, param = tail.rpartition(".")
    for a, b in table:
        if mod == a:
            return f"{b}.{param}"
    return tail


def _cf_vae_key(orig: str, *, num_levels: int = 4, enc_blocks: int = 2, dec_blocks: int = 3) -> str:
    """upstream `first_stage_model.X` -> cflearn `first_stage.X'` (the f8
    geometry: flat encoder / decoder lists of resblocks and resamplers,
    activations holding gaps in the numbering)."""
    k = orig[len("first_stage_model."):]
    if k.startswith("quant_conv."):
        return "first_stage.to_embedding." + k.rpartition(".")[2]
    if k.startswith("post_quant_conv."):
        return "first_stage.from_embedding." + k.rpartition(".")[2]
    side, _, rest = k.partition(".")
    p = f"first_stage.generator.{side}.{side}"
    enc_stride = enc_blocks + 1
    dec_stride = dec_blocks + 1
    enc_mid = 1 + (num_levels - 1) * enc_stride + enc_blocks
    if side == "encoder":
        if rest.startswith("conv_in."):
            return f"{p}.0.{rest.rpartition('.')[2]}"
        if rest.startswith("down."):
            _, lvl, kind, idx_or_conv, *tail = rest.split(".")
            base = 1 + int(lvl) * enc_stride
            if kind == "block":
                return f"{p}.{base + int(idx_or_conv)}.{_cf_vae_inner('.'.join(tail), _CF_VAE_RES)}"
            return f"{p}.{base + enc_blocks}.conv.{tail[-1]}"
        if rest.startswith("mid."):
            _, which, *tail = rest.split(".")
            off = {"block_1": 0, "attn_1": 1, "block_2": 2}[which]
            table = _CF_VAE_ATTN if which == "attn_1" else _CF_VAE_RES
            return f"{p}.{enc_mid + off}.{_cf_vae_inner('.'.join(tail), table)}"
        if rest.startswith("norm_out."):
            return f"{p}.{enc_mid + 3}.{rest.rpartition('.')[2]}"
        if rest.startswith("conv_out."):
            return f"{p}.{enc_mid + 5}.{rest.rpartition('.')[2]}"
    if side == "decoder":
        if rest.startswith("conv_in."):
            return f"{p}.0.{rest.rpartition('.')[2]}"
        if rest.startswith("mid."):
            _, which, *tail = rest.split(".")
            off = {"block_1": 1, "attn_1": 2, "block_2": 3}[which]
            table = _CF_VAE_ATTN if which == "attn_1" else _CF_VAE_RES
            return f"{p}.{off}.{_cf_vae_inner('.'.join(tail), table)}"
        if rest.startswith("up."):
            _, lvl, kind, idx_or_conv, *tail = rest.split(".")
            base = 4 + (num_levels - 1 - int(lvl)) * dec_stride
            if kind == "block":
                return f"{p}.{base + int(idx_or_conv)}.{_cf_vae_inner('.'.join(tail), _CF_VAE_RES)}"
            return f"{p}.{base + dec_blocks}.conv.{tail[-1]}"
        if rest.startswith("norm_out."):
            return f"first_stage.generator.decoder.head.0.{rest.rpartition('.')[2]}"
        if rest.startswith("conv_out."):
            return f"first_stage.generator.decoder.head.2.{rest.rpartition('.')[2]}"
    raise ValueError(f"unmapped VAE key: {orig}")


def _cf_cond_key(orig: str) -> Optional[str]:
    """upstream HF-CLIP `cond_stage_model.X` -> cflearn key; None for the
    fused-qkv and position-table cases."""
    k = orig[len("cond_stage_model.transformer.text_model."):]
    if k == "embeddings.token_embedding.weight":
        return f"{_CF_COND_PREFIX}.token_embedding.weight"
    if k == "embeddings.position_embedding.weight":
        return None
    if k.startswith("final_layer_norm."):
        return f"{_CF_COND_PREFIX}.text_transformer.encoder.head.norms.0.{k.rpartition('.')[2]}"
    if k.startswith("encoder.layers."):
        _, _, idx, *rest = k.split(".")
        mod, _, param = ".".join(rest).rpartition(".")
        if mod.startswith("self_attn.") and mod.split(".")[1] in ("q_proj", "k_proj", "v_proj"):
            return None
        for a, b in _CF_COND_INNER:
            if mod == a:
                return f"{_CF_COND_BLOCKS}.{idx}.{b}.{param}"
    raise ValueError(f"unmapped cond key: {orig}")


def build_sd_cflearn_renames(version: str = "v1") -> Dict[str, str]:
    """{cflearn key: upstream key} of every rename of an SD-v1 checkpoint
    (the cflearn layout is published for the v1 family only)."""
    if not version.startswith("v1"):
        raise ValueError(f"cflearn-layout checkpoints are only published for the SD-v1 family (got version={version!r})")
    renames: Dict[str, str] = {}
    for orig, _, _ in build_sd_mapping("v1"):
        if orig.startswith("model.diffusion_model."):
            ck = _cf_unet_key(orig)
        elif orig.startswith("first_stage_model."):
            ck = _cf_vae_key(orig)
        else:
            ck = _cf_cond_key(orig)
            if ck is None:
                continue
        if ck in renames:
            raise ValueError(f"duplicate cflearn key {ck} ({orig} vs {renames[ck]})")
        renames[ck] = orig
    return renames


def sd_cflearn_table() -> Dict[str, Any]:
    """The port's copy of the audited rename table."""
    return json.loads(MAPPING_FILE.read_text())


def cflearn_sd_to_original(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A cflearn-layout SD state dict -> the upstream layout: the renames,
    each layer's fused `in_w` / `qkv_bias` split into q, k, v, and
    `pos_encoding` squeezed. The table's non-checkpoint keys are dropped;
    any other key raises."""
    renames = build_sd_cflearn_renames()
    out: Dict[str, torch.Tensor] = {}
    taken = set()
    for ck, ok in renames.items():
        if ck in sd:
            out[ok] = torch.as_tensor(sd[ck])
            taken.add(ck)
    if _CF_POS in sd:
        out["cond_stage_model.transformer.text_model.embeddings.position_embedding.weight"] = torch.as_tensor(sd[_CF_POS])[0]
        taken.add(_CF_POS)
    i = 0
    while f"{_CF_COND_BLOCKS}.{i}.token_mixing.net.in_w" in sd:
        w_key, b_key = f"{_CF_COND_BLOCKS}.{i}.token_mixing.net.in_w", f"{_CF_COND_BLOCKS}.{i}.token_mixing.net.qkv_bias"
        in_w, qkv_b = torch.as_tensor(sd[w_key]), torch.as_tensor(sd[b_key])
        third = in_w.shape[0] // 3
        for j, n in enumerate("qkv"):
            out[f"{_HF_LAYERS}.{i}.self_attn.{n}_proj.weight"] = in_w[j * third : (j + 1) * third]
            out[f"{_HF_LAYERS}.{i}.self_attn.{n}_proj.bias"] = qkv_b[j * third : (j + 1) * third]
        taken |= {w_key, b_key}
        i += 1
    drop = set(sd_cflearn_table()["non_checkpoint_keys"])
    left = sorted(k for k in sd if k not in taken and k not in drop)
    if left:
        raise ValueError(f"{len(left)} cflearn-layout keys that no parameter takes, e.g. {left[:8]}")
    return out


def convert_sd_cflearn(sd: Mapping[str, Any], *, version: str = "v1") -> Dict[str, torch.Tensor]:
    """A cflearn-layout SD checkpoint -> the upstream layout -> `convert_sd`."""
    return convert_sd(cflearn_sd_to_original(sd), version=version)
