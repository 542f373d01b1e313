"""Zoo presets (counterpart of `cflearn_tpu/zoo/common.py`): JSON presets
under `configs/` (the port's own copies of the JAX package's `ae/kl.json`,
`ae/vq.json`, `diffusion/ldm.json`, `multimodal/clip.json` and
`sr/esr.json`), `parse_config`, `build_module` / `load_module` and the named
constructors of the first stages, of the VQ latent-diffusion family
(`ldm_vq`, `ldm_inpainting`, `ldm_semantic`), of CLIP (`clip`: ViT-B/32,
`clip_large`: ViT-L/14, `open_clip_ViT_H_14`) and of ESRGAN (`esr`,
`esr_anime`), and of Stable Diffusion (`load_sd`, `ldm_sd`, `ldm_sd_v2`,
`ldm_sd_inpainting`, `load_control_net`, with `SDVersions` and
`get_sd_tag`). `chinese_clip` waits for the BERT text tower.

Every module gets seeded random weights: no checkpoint is in the
repository, and none is downloaded, so `pretrained=True` raises. Like the
port's other entry points, `load_module` and the constructors build on the
CUDA card unless the caller passes another `device` ("meta" allocates
nothing)."""

import json
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..modules.common import module_registry
from ..modules.cv import classifier as _classifier  # noqa: F401  (registers "rrdb")
from ..modules.multimodal import clip as _clip  # noqa: F401  (registers "clip")
from ..modules.multimodal.diffusion.ldm import StableDiffusion, StableDiffusionInpainting, build, sd_unet_config
from ..modules.multimodal.diffusion.unet import ControlNet

CONFIGS_DIR = Path(__file__).parent / "configs"


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


def _module_and_config(config: str, kwargs: Dict[str, Any]) -> Any:
    parsed = parse_config(config)
    name = parsed.pop("__module__")
    parsed.pop("__converter__", None)
    parsed.pop("__download__", None)
    parsed.update(kwargs)
    cls = module_registry.get(name)
    if cls is None:
        raise ValueError(f"zoo preset '{config}' names module '{name}', which the port does not register")
    return cls, parsed


def _no_weights(config: str) -> ValueError:
    return ValueError(f"pretrained weights of '{config}' are not in the repository and are never downloaded")


def build_module(config: str, **kwargs: Any) -> nn.Module:
    """The preset's module, constructed (`kwargs` over the preset) on the
    current default device, with the module's own initial parameters: what
    an `LDM` builds for a first stage given by preset name."""
    cls, parsed = _module_and_config(config, kwargs)
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
    """Build a zoo module with seeded random weights in `dtype` on `device`
    (CUDA unless the caller asks for another). `tag` names a checkpoint, and
    `pretrained=True` asks for one: neither is in the repository, so the
    latter raises."""
    if pretrained:
        raise _no_weights(tag or config)
    cls, parsed = _module_and_config(config, kwargs)
    return build(cls, device=device, dtype=dtype, seed=seed, **parsed)


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
    "anime*" and "dreamlike*" are the v1 architecture) with seeded random
    weights in `dtype` on `device`. "v2_v" alone is a v-prediction model;
    "v2" is an eps model, though the JAX package files both under the
    `sd_v2.1` checkpoint. No checkpoint is in the repository:
    `pretrained=True` raises."""
    if pretrained:
        raise _no_weights(f"sd {version}")
    arch = "v1" if version.startswith(("anime", "dreamlike")) or version == "v1.5" else version
    cls = StableDiffusionInpainting if version.endswith("_inpainting") else StableDiffusion
    return build(cls, device=device, dtype=dtype, seed=seed, version=arch.replace("_inpainting", ""))


def load_control_net(
    hint: str,
    *,
    pretrained: bool = False,
    device: Any = None,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
) -> nn.Module:
    """An SD-1.5-scale `ControlNet` for a hint type ("canny", "depth",
    ...): the v1 UNet's encoder half on a 3-channel hint, seeded random
    weights. `pretrained=True` raises."""
    if pretrained:
        raise _no_weights(f"controlnet_v11_{hint}")
    cfg = dict(sd_unet_config("v1"))
    cfg.pop("out_channels", None)  # the control branch has no output head
    return build(ControlNet, device=device, dtype=dtype, seed=seed, hint_channels=3, **cfg)


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
