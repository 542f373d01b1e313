"""Zoo presets and pretrained weights (counterpart of
`cflearn_tpu/zoo/common.py`): JSON presets under `configs/` (the port's own
copies of the JAX package's `ae/kl.json`, `ae/vq.json`, `diffusion/ldm.json`,
`multimodal/clip.json` and `sr/esr.json`), `parse_config`, `build_module` /
`load_module` and the named constructors of the first stages, of the VQ
latent-diffusion family (`ldm_vq`, `ldm_inpainting`, `ldm_semantic`), of
CLIP (`clip`: ViT-B/32, `clip_large`: ViT-L/14, `open_clip_ViT_H_14`) and of
ESRGAN (`esr`, `esr_anime`), and of Stable Diffusion (`load_sd`, `ldm_sd`,
`ldm_sd_v2`, `ldm_sd_inpainting`, `load_control_net`, with `SDVersions` and
`get_sd_tag`) and ChineseCLIP (`chinese_clip`, random weights only).

Without `pretrained` a module gets seeded random weights. With it, the
checkpoint of its entry in the index (`available.json`, the port's copy of
the JAX package's) is served from `OPT.cache_dir/download/<file name>`
(`toolkit.misc.download`: the recorded sha, else the sha pinned at first
use, the `sha_prefix` and `min_size` checks; a file that is not there is
fetched from the entry's URL, which fails offline and names the path where
the file goes), converted to the port's names (`zoo.convert`) and cached,
converted, in `OPT.cache_dir/converted/<tag>.safetensors`. The module is
built on "meta", materialised on the device (CUDA unless the caller asks for
another; never "meta"), its buffers and noise schedule set, the converted
tensors copied in, and then cast to `dtype`.

Loading is strict: the converted tensors must fill every parameter of the
module, with its shape, and name nothing else, and every key of the
checkpoint must be taken by the mapping or dropped by name. The JAX package
loads with `strict=False` and leaves whatever the file does not fill at its
random value (a standalone CLIP or VAE preset, whose mappings target an SD
checkpoint's names, and a VQ preset, which has no converter, load nothing
there); here that raises, naming the parameters and keys."""

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.nn as nn

from ..device import resolve_device
from ..modules.common import cast_parameters, materialize, module_registry
from ..modules.cv import classifier as _classifier  # noqa: F401  (registers "rrdb")
from ..modules.multimodal import clip as _clip  # noqa: F401  (registers "clip")
from ..modules.multimodal.diffusion.ldm import StableDiffusion, StableDiffusionInpainting, build, sd_unet_config
from ..modules.multimodal.diffusion.unet import ControlNet
from ..parameters import OPT

CONFIGS_DIR = Path(__file__).parent / "configs"
AVAILABLE_FILE = Path(__file__).parent / "available.json"


def parse_config(config: str) -> Dict[str, Any]:
    """`"ae/kl.f8"` -> configs/ae/kl.json with the tag "f8" applied (no tag:
    "default", the base alone). A tag may replace the base (`__replace__`)
    and name another module (`__module__`); the result carries the module
    name, the converter and the checkpoint entry under `__module__`,
    `__converter__` and `__download__`."""
    if "." in config.split("/")[-1]:
        path_part, _, tag = config.rpartition(".")
    else:
        path_part, tag = config, "default"
    json_path = CONFIGS_DIR / f"{path_part}.json"
    if not json_path.is_file():
        raise ValueError(f"no zoo preset at '{json_path}'")
    with open(json_path, "r") as f:
        preset = json.load(f)
    base = dict(preset.get("__base__", {}))
    tags = preset.get("tags", {})
    if tag != "default" and tag not in tags:
        raise ValueError(f"tag '{tag}' not found in preset '{path_part}' (available: {sorted(tags)})")
    tag_cfg = dict(tags.get(tag, {}))
    if tag_cfg.pop("__replace__", False):
        base = {}
    module_override = tag_cfg.pop("__module__", None)
    base.update(tag_cfg)
    base["__module__"] = module_override or preset["module"]
    base["__converter__"] = preset.get("converter")
    base["__download__"] = preset.get("download", {}).get(tag) or preset.get("download", {}).get("default")
    return base


def parse_json(json_path: Any) -> Dict[str, Any]:
    """A zoo preset's JSON file as it is."""
    with open(json_path, "r") as f:
        return json.load(f)


def parse_config_info(config: str) -> Dict[str, Any]:
    """`parse_config(config)` with its metadata: the preset name, the module,
    the converter, the checkpoint entry and the parsed config."""
    parsed = parse_config(config)
    return {
        "config": config,
        "module": parsed.get("__module__"),
        "converter": parsed.get("__converter__"),
        "download": parsed.get("__download__"),
        "parsed": parsed,
    }


def _module_and_config(config: str, kwargs: Dict[str, Any]) -> Any:
    parsed = parse_config(config)
    name = parsed.pop("__module__")
    converter = parsed.pop("__converter__", None)
    download_info = parsed.pop("__download__", None)
    parsed.update(kwargs)
    cls = module_registry.get(name)
    if cls is None:
        raise ValueError(f"zoo preset '{config}' names module '{name}', which the port does not register")
    return cls, parsed, converter, download_info


def get_available() -> Dict[str, Any]:
    """The checkpoint index (`available.json`)."""
    with open(AVAILABLE_FILE, "r") as f:
        return json.load(f)


def resolve_download(entry: Any) -> Dict[str, Any]:
    """A preset's `download` value, an inline dict or the name of an index
    entry, as the entry's dict (with its `tag`)."""
    if isinstance(entry, str):
        index = get_available().get("checkpoints", {})
        if entry not in index:
            raise ValueError(f"'{entry}' is not in the checkpoint index")
        info = dict(index[entry])
        info.setdefault("tag", entry)
        return info
    return dict(entry)


def converted_cache_path(tag: str) -> Path:
    """Where the converted tensors of checkpoint `tag` are cached."""
    folder = Path(OPT.cache_dir) / "converted"
    folder.mkdir(parents=True, exist_ok=True)
    return folder / f"{tag}.safetensors"


def convert_checkpoint(converter: Optional[str], sd: Mapping[str, Any], **kwargs: Any) -> Any:
    """(converted tensors by port name, the checkpoint keys that nothing
    takes and no list drops) of upstream state dict `sd` under `converter`.
    The annotators', VGG16's and LPIPS's nets take the upstream names, and a
    preset without a converter takes the file as it is. LaMa's, ISNet's and
    iharm's converters rename (`convert_lama`) or keep (`convert_isnet`,
    `convert_iharm`) every key, with BatchNorm's running statistics: a key
    their nets do not hold comes out under a name no parameter or buffer
    has, which `check_states` refuses."""
    from . import convert as C

    if converter in ("lama", "isnet", "iharm"):
        from ..api.cv import third_party as TP

        convert = {"lama": TP.convert_lama, "isnet": TP.convert_isnet, "iharm": TP.convert_iharm}[converter]
        return convert(sd), []
    if converter == "sd_cflearn":
        sd, converter = C.cflearn_sd_to_original(sd), "sd"
    mappings = {
        "sd": lambda: (C.build_sd_mapping("v1"), C.DROPPED["sd"]),
        "sd_v2": lambda: (C.build_sd_mapping("v2"), C.DROPPED["sd_v2"]),
        "esrgan": lambda: (C.build_esrgan_mapping(**kwargs), ()),
        "clip_text": lambda: (C.build_clip_text_mapping(**kwargs), ()),
        "vae": lambda: (C.build_vae_mapping(**kwargs), ()),
        "controlnet": lambda: (C.build_controlnet_mapping(**kwargs), ()),
    }
    if converter not in mappings:
        return {k: torch.as_tensor(v) for k, v in sd.items()}, []
    mapping, drop = mappings[converter]()
    return C.apply_mapping(mapping, sd, strict=False), C.unused_keys(mapping, sd, drop)


def checkpoint_targets(module: nn.Module) -> Any:
    """({name: shape} that a checkpoint must fill, {name: shape} that it
    may): every parameter and the running statistics of `torch.nn`'s
    BatchNorm layers, and their `num_batches_tracked`, which eval mode never
    reads."""
    required = {k: tuple(p.shape) for k, p in module.named_parameters()}
    optional = {}
    for prefix, sub in module.named_modules():
        if isinstance(sub, nn.modules.batchnorm._BatchNorm) and sub.track_running_stats:
            for leaf in ("running_mean", "running_var"):
                required[f"{prefix}.{leaf}"] = tuple(getattr(sub, leaf).shape)
            optional[f"{prefix}.num_batches_tracked"] = ()
    return required, optional


def check_states(module: nn.Module, states: Mapping[str, torch.Tensor], what: str, unused: List[str] = ()) -> None:
    """Raise unless `states` fills every parameter of `module` (and the
    running statistics of its BatchNorm layers, `checkpoint_targets`) with
    its shape and names nothing else, and no checkpoint key is left over."""
    required, optional = checkpoint_targets(module)
    params = {**required, **{k: v for k, v in optional.items() if k in states}}
    unfilled = sorted(set(required) - set(states))
    extra = sorted(set(states) - set(params))
    shapes = [f"{k} {tuple(states[k].shape)} != {params[k]}" for k in sorted(set(states) & set(params))
              if tuple(states[k].shape) != params[k]]
    errors = []
    if unfilled:
        errors.append(f"{len(unfilled)} parameters the checkpoint leaves unfilled, e.g. {unfilled[:8]}")
    if extra:
        errors.append(f"{len(extra)} converted tensors that are no parameter, e.g. {extra[:8]}")
    if shapes:
        errors.append(f"{len(shapes)} shapes differ, e.g. {shapes[:4]}")
    if unused:
        errors.append(f"{len(unused)} checkpoint keys that no parameter takes, e.g. {list(unused)[:8]}")
    if errors:
        raise ValueError(f"{what}: " + "; ".join(errors))


def load_states(
    download_info: Any,
    converter: Optional[str] = None,
    converter_kwargs: Optional[Dict[str, Any]] = None,
    *,
    module: Optional[nn.Module] = None,
) -> Dict[str, torch.Tensor]:
    """The converted tensors of a checkpoint entry: from the converted cache
    if it holds them, else the checkpoint from the download cache
    (`download`), converted (`converter`, or the entry's own; the cflearn
    layout through `sd_cflearn`), and cached. With `module` (which may be on
    "meta") they are checked against its parameters (`check_states`) before
    anything is cached."""
    from . import convert as C
    from ..toolkit.misc import download

    info = resolve_download(download_info)
    converter = info.get("converter", converter)
    if info.get("layout") == "cflearn":
        if converter not in (None, "sd", "sd_cflearn"):
            raise ValueError(f"cflearn-layout entries use the SD converter, got {converter!r}")
        converter = "sd_cflearn"
    tag = info.get("tag") or info["url"].split("/")[-1]
    cache = converted_cache_path(tag)
    if cache.is_file():
        states = C.read_safetensors(cache)
        if module is not None:
            check_states(module, states, f"the converted cache {cache}")
        return states
    path = download(
        info["url"], name=info.get("name"), sha=info.get("sha"), sha_prefix=info.get("sha_prefix"),
        min_size=info.get("min_size"),
    )
    states, unused = convert_checkpoint(converter, C.load_torch_state_dict(path), **(converter_kwargs or {}))
    if module is not None:
        check_states(module, states, f"checkpoint '{tag}' ({path})", unused)
    elif unused:
        raise ValueError(f"checkpoint '{tag}' ({path}): {len(unused)} keys that no parameter takes, e.g. {unused[:8]}")
    partial = cache.with_suffix(".partial")
    C.write_safetensors(partial, states)
    os.replace(partial, cache)
    return states


def _real_device(device: Any, what: str) -> torch.device:
    device = resolve_device(device)
    if device.type == "meta":
        raise ValueError(f"pretrained weights of {what} load onto a real device, not 'meta'")
    return device


def load_into(module: nn.Module, states: Mapping[str, torch.Tensor], what: str) -> nn.Module:
    """Copy `states` into `module`'s parameters (and BatchNorm statistics)
    in place (strict: `check_states`), each cast to the target's dtype; a
    BatchNorm's `num_batches_tracked` that `states` leaves out is set to 0."""
    check_states(module, states, what)
    params = {**dict(module.named_buffers()), **dict(module.named_parameters())}
    with torch.no_grad():
        for name in checkpoint_targets(module)[1]:
            if name not in states:
                params[name].zero_()
        for name, t in states.items():
            params[name].copy_(t)
    return module


def pretrained_module(
    cls: type, kwargs: Dict[str, Any], entry: Any, converter: Optional[str], *, device: Any, dtype: torch.dtype,
    what: str,
) -> nn.Module:
    """`cls(**kwargs)` with the converted weights of checkpoint `entry`:
    built on "meta", checked, materialised on `device`, loaded, cast to
    `dtype`, in eval mode."""
    device = _real_device(device, what)
    with torch.device("meta"):
        module = cls(**kwargs)
    states = load_states(entry, converter, module=module)
    module = materialize(module, device)
    load_into(module, states, what)
    return cast_parameters(module, dtype).eval()


def build_module(config: str, **kwargs: Any) -> nn.Module:
    """The preset's module, constructed (`kwargs` over the preset) on the
    current default device, with the module's own initial parameters: what
    an `LDM` builds for a first stage given by preset name."""
    cls, parsed, _, _ = _module_and_config(config, kwargs)
    return cls(**parsed)


def load_module(
    config: str,
    *,
    pretrained: bool = False,
    tag: Optional[str] = None,
    device: Any = None,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    **kwargs: Any,
) -> nn.Module:
    """A zoo module in `dtype` on `device` (CUDA unless the caller asks for
    another): seeded random weights, or with `pretrained` the weights of the
    preset's checkpoint entry (`tag` names another entry) from the local
    cache, loaded strictly."""
    cls, parsed, converter, download_info = _module_and_config(config, kwargs)
    if not pretrained:
        return build(cls, device=device, dtype=dtype, seed=seed, **parsed)
    entry = tag if tag is not None else download_info
    if entry is None:
        raise ValueError(f"no pretrained checkpoint is registered for '{config}'")
    return pretrained_module(cls, parsed, entry, converter, device=device, dtype=dtype, what=f"'{config}'")


def load_pretrained_into(module: nn.Module, config: str) -> nn.Module:
    """The pretrained weights of zoo preset `config` copied into `module`,
    which is built already (an `LDM`'s first stage given by preset name)."""
    _, _, converter, entry = _module_and_config(config, {})
    if entry is None:
        raise ValueError(f"no pretrained checkpoint is registered for '{config}'")
    return load_into(module, load_states(entry, converter, module=module), f"'{config}'")


def load_predefined_config(config: str) -> Any:
    """A zoo preset as a `DLConfig` (its module name and config)."""
    from ..schema.config import DLConfig

    parsed = parse_config(config)
    module_name = parsed.pop("__module__", None)
    parsed.pop("__converter__", None)
    parsed.pop("__download__", None)
    if module_name is None:
        raise ValueError(f"module name not found in '{config}'")
    return DLConfig(module_name=module_name, module_config=parsed)


def build_predefined_module(config: str, **kwargs: Any) -> nn.Module:
    """A zoo module without pretrained weights."""
    return load_module(config, pretrained=False, **kwargs)


def load_pretrained_weights(module: nn.Module, tag: str) -> nn.Module:
    """The converted checkpoint `tag` copied into `module` in place (strict)."""
    if tag not in get_available().get("checkpoints", {}):
        raise ValueError(f"no pretrained checkpoint registered under tag '{tag}'")
    return load_into(module, load_states(tag, None, module=module), f"checkpoint '{tag}'")


def load_pretrained_module(config: str, **kwargs: Any) -> nn.Module:
    """A zoo module with its pretrained weights."""
    return load_module(config, pretrained=True, **kwargs)


# named constructors of the first stages


def ae_kl_f8(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    return load_module("ae/kl.f8", pretrained=pretrained, **kwargs)


def ae_kl_f4(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    return load_module("ae/kl.f4", pretrained=pretrained, **kwargs)


def ae_kl_f16(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    return load_module("ae/kl.f16", pretrained=pretrained, **kwargs)


def ae_vq_f4(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    return load_module("ae/vq.f4", pretrained=pretrained, **kwargs)


def ae_vq_f4_no_attn(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    return load_module("ae/vq.f4_no_attn", pretrained=pretrained, **kwargs)


def ae_vq_f8(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    return load_module("ae/vq.f8", pretrained=pretrained, **kwargs)


# ESRGAN and CLIP


def esr(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    """ESRGAN 4x: `RRDBNet` with 23 RRDB blocks of 64 channels."""
    return load_module("sr/esr", pretrained=pretrained, **kwargs)


def esr_anime(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    """ESRGAN 4x for anime images: 6 RRDB blocks."""
    return load_module("sr/esr.anime", pretrained=pretrained, **kwargs)


def clip(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    """CLIP ViT-B/32 at 224px (50 image tokens; 512-wide embeddings)."""
    return load_module("multimodal/clip", pretrained=pretrained, **kwargs)


def clip_large(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    """CLIP ViT-L/14 at 224px (257 image tokens, 16 heads of 64; 768-wide embeddings)."""
    return load_module("multimodal/clip.large", pretrained=pretrained, **kwargs)


def chinese_clip(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    """ChineseCLIP ("clip.chinese"): a ViT-L/14 vision tower and a 24-layer
    Chinese BERT text tower, 768-wide embeddings; its tokenizer is
    `ChineseCLIPTokenizer`. Seeded random weights (`device`, `dtype`,
    `seed` as `load_module` takes them); no checkpoint in the upstream
    layout is indexed, so `pretrained` raises."""
    if pretrained:
        raise ValueError(
            "chinese_clip pretrained weights are only re-hosted in the "
            "reference's cflearn layout; convert an upstream checkpoint and "
            "load it explicitly"
        )
    return build(module_registry["clip.chinese"], **kwargs)


def open_clip_ViT_H_14(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    """open_clip's ViT-H/14 at 224px (257 image tokens, 16 heads of 80; GELU; 1024-wide embeddings)."""
    return load_module("multimodal/clip.open_clip_ViT_H_14", pretrained=pretrained, **kwargs)


# the VQ latent-diffusion family


def ldm_vq(
    latent_size: int = 64,
    latent_in_channels: int = 3,
    latent_out_channels: int = 3,
    *,
    pretrained: bool = False,
    tag: Optional[str] = None,
    **kwargs: Any,
) -> nn.Module:
    """The VQ-first-stage LDM (the CelebA-HQ preset, `diffusion/ldm.vq`):
    an f4 `AutoEncoderVQ`, a 224-channel UNet with multi-head attention at
    downsample rates 2, 4 and 8 (32 channels a head)."""
    kwargs["img_size"] = latent_size
    kwargs["in_channels"] = latent_in_channels
    kwargs["out_channels"] = latent_out_channels
    return load_module("diffusion/ldm.vq", pretrained=pretrained, tag=tag, **kwargs)


def ldm_inpainting(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    """LDM inpainting: concat conditioning over 7 latent channels (3 + the
    masked image's 3 + the mask), resblock resampling, an attention-free
    first stage."""
    kwargs.setdefault("condition_type", "concat")
    kwargs.setdefault("first_stage_config", {"img_size": 256, "attention_type": "none"})
    kwargs.setdefault(
        "unet_config",
        {
            "start_channels": 256,
            "num_res_blocks": 2,
            "channel_multipliers": [1, 2, 3, 4],
            "attention_downsample_rates": [2, 4, 8],
            "num_heads": 8,
            "use_spatial_transformer": False,
            "resample_with_resblock": True,
        },
    )
    return ldm_vq(pretrained=pretrained, latent_in_channels=7, tag="cflearn_ldm_inpainting", **kwargs)


def ldm_semantic(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    """Semantic-map-to-image LDM: concat conditioning through a `Rescaler`
    over 182 one-hot channels to 3, at 128x128 latents."""
    kwargs.setdefault("condition_type", "concat")
    kwargs.setdefault("condition_model", "rescaler")
    kwargs.setdefault("condition_config", {"num_stages": 2, "in_channels": 182, "out_channels": 3})
    kwargs.setdefault("first_stage_config", {"img_size": 256})
    kwargs.setdefault(
        "unet_config",
        {
            "start_channels": 128,
            "num_res_blocks": 2,
            "channel_multipliers": [1, 4, 8],
            "attention_downsample_rates": [8, 16, 32],
            "num_heads": 8,
            "use_spatial_transformer": False,
        },
    )
    kwargs.setdefault("latent_size", 128)
    kwargs.setdefault("latent_in_channels", 6)
    return ldm_vq(pretrained=pretrained, tag="cflearn_ldm_semantic", **kwargs)


# Stable Diffusion


# the checkpoint entry of each SD version (the JAX package's table: "v2" and "v2_v" share `sd_v2.1`)
SD_CHECKPOINTS = {
    "v1": "sd_v1.5",
    "v1.5": "sd_v1.5",
    "v1_inpainting": "sd_v1.5_inpainting",
    "v2": "sd_v2.1",
    "v2_v": "sd_v2.1",
    "v2_base": "sd_v2_base",
    "anime": "cflearn_ldm_sd_anime_nai",
    "anime_anything": "cflearn_ldm_sd_anime_anything",
    "anime_hybrid": "cflearn_ldm_sd_anime_hybrid",
    "anime_guofeng": "cflearn_ldm_sd_anime_guofeng",
    "anime_orange": "cflearn_ldm_sd_anime_orange",
    "dreamlike_v1": "cflearn_ldm_sd_dreamlike",
}


def load_sd(
    version: str = "v1",
    *,
    pretrained: bool = False,
    device: Any = None,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
) -> nn.Module:
    """SD of `version` ("v1", "v2", "v2_v", "v2_base", or one of them with
    "_inpainting" for the 9-channel model; "v1.5" and the community tags
    "anime*" and "dreamlike*" are the v1 architecture) in `dtype` on `device`,
    with seeded random weights, or with `pretrained` the weights of the
    version's checkpoint entry (`SD_CHECKPOINTS`) from the local cache.
    "v2_v" alone is a v-prediction model; "v2" is an eps model, though the
    JAX package files both under the `sd_v2.1` checkpoint."""
    arch = "v1" if version.startswith(("anime", "dreamlike")) or version == "v1.5" else version
    cls = StableDiffusionInpainting if version.endswith("_inpainting") else StableDiffusion
    kwargs = dict(version=arch.replace("_inpainting", ""))
    if not pretrained:
        return build(cls, device=device, dtype=dtype, seed=seed, **kwargs)
    entry = SD_CHECKPOINTS.get(version)
    if entry is None or entry not in get_available().get("checkpoints", {}):
        raise ValueError(f"no pretrained checkpoint registered for sd {version}")
    converter = "sd_v2" if version.startswith("v2") else "sd"
    return pretrained_module(cls, kwargs, entry, converter, device=device, dtype=dtype, what=f"sd {version}")


def load_control_net(
    hint: str,
    *,
    pretrained: bool = False,
    device: Any = None,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
) -> nn.Module:
    """An SD-1.5-scale `ControlNet` for a hint type ("canny", "depth",
    "mlsd", "softedge", "openpose"): the v1 UNet's encoder half on a
    3-channel hint, with seeded random weights, or with `pretrained` those
    of `controlnet_v11_<hint>` from the local cache."""
    cfg = dict(sd_unet_config("v1"))
    cfg.pop("out_channels", None)  # the control branch has no output head
    kwargs = dict(hint_channels=3, **cfg)
    if not pretrained:
        return build(ControlNet, device=device, dtype=dtype, seed=seed, **kwargs)
    entry = f"controlnet_v11_{hint}"
    if entry not in get_available().get("checkpoints", {}):
        raise ValueError(f"no pretrained ControlNet registered for hint '{hint}'")
    return pretrained_module(ControlNet, kwargs, entry, "controlnet", device=device, dtype=dtype, what=entry)


def ldm_sd(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    return load_sd("v1", pretrained=pretrained, **kwargs)


def ldm_sd_v2(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    return load_sd("v2", pretrained=pretrained, **kwargs)


def ldm_sd_inpainting(pretrained: bool = False, **kwargs: Any) -> nn.Module:
    return load_sd("v1_inpainting", pretrained=pretrained, **kwargs)


class SDVersions:
    """The SD version tags. The anime and dreamlike tags name community
    finetunes of SD-1.5: the v1 architecture (`load_sd`), their weights
    swapped in by `DiffusionAPI.prepare_sd` / `switch_sd`."""

    v1 = "v1"
    v1_5 = "v1.5"
    v2 = "v2"
    v2_v = "v2_v"
    ANIME = "anime"
    ANIME_ANYTHING = "anime_anything"
    ANIME_HYBRID = "anime_hybrid"
    ANIME_GUOFENG = "anime_guofeng"
    ANIME_ORANGE = "anime_orange"
    DREAMLIKE = "dreamlike_v1"


def get_sd_tag(version: Optional[str]) -> str:
    """A version's checkpoint tag: "v1.5" for none, "" and "v1"; the
    community tags' versioned names; any other version as it is."""
    if version is None or version in ("", "v1", "v1.5"):
        return "v1.5"
    return {
        SDVersions.ANIME: "anime_nai",
        SDVersions.ANIME_ANYTHING: "anime_anything_v3",
        SDVersions.ANIME_HYBRID: "anime_hybrid_v1",
        SDVersions.ANIME_GUOFENG: "anime_guofeng3",
        SDVersions.ANIME_ORANGE: "anime_orange2",
    }.get(version, version)
