"""LDM / Stable Diffusion (counterpart of
`cflearn_tpu/modules/multimodal/diffusion/ldm.py`)."""

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ....device import resolve_device
from ...common import cast_parameters, init_parameters, register_module
from ...cv.ae import AutoEncoderKL
from .cond_models import CLIPTextConditionModel
from .ddpm import DDPM


@register_module("ldm")
class LDM(DDPM):
    """Latent diffusion: DDPM over first-stage latents with a scale factor."""

    def __init__(
        self,
        *,
        first_stage: Optional[nn.Module] = None,
        first_stage_config: Optional[Dict[str, Any]] = None,
        latent_scale: float = 0.18215,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.latent_scale = latent_scale
        if first_stage is None and first_stage_config is not None:
            first_stage = AutoEncoderKL(**first_stage_config)
        self.first_stage = first_stage

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        assert self.first_stage is not None
        return self.first_stage.decode(z / self.latent_scale)

    def decode(self, z: torch.Tensor, *, clip_output: bool = True) -> torch.Tensor:
        out = self.decode_first_stage(z)
        return out.clamp(-1.0, 1.0) if clip_output else out


def sd_unet_config(version: str = "v1") -> Dict[str, Any]:
    if version.startswith("v2"):
        return dict(
            in_channels=4, out_channels=4, start_channels=320, num_res_blocks=2,
            attention_downsample_rates=(1, 2, 4), channel_multipliers=(1, 2, 4, 4),
            num_head_channels=64, num_heads=None, context_dim=1024, use_linear_in_transformer=True,
        )
    return dict(
        in_channels=4, out_channels=4, start_channels=320, num_res_blocks=2,
        attention_downsample_rates=(1, 2, 4), channel_multipliers=(1, 2, 4, 4),
        num_heads=8, context_dim=768, use_linear_in_transformer=False,
    )


def sd_first_stage_config() -> Dict[str, Any]:
    return dict(
        img_size=256, in_channels=3, out_channels=3, inner_channels=128, z_channels=4,
        embedding_channels=4, channel_multipliers=[1, 2, 4, 4], num_res_blocks=2,
        attention_resolutions=[],
    )


@register_module("sd")
class StableDiffusion(LDM):
    """SD v1 / v2 (v2_v: v-parameterization)."""

    def __init__(
        self,
        *,
        version: str = "v1",
        in_channels: int = 4,
        with_first_stage: bool = True,
        parameterization: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        unet_config = dict(sd_unet_config(version), in_channels=in_channels)
        if parameterization is None:
            parameterization = "v" if version == "v2_v" else "eps"
        cond_kw: Dict[str, Any] = dict(latent_dim=768, num_layers=12, num_heads=12)
        if version.startswith("v2"):
            cond_kw = dict(latent_dim=1024, num_layers=23, num_heads=16)
        super().__init__(
            img_size=64,
            in_channels=in_channels,
            out_channels=4,
            condition_model=CLIPTextConditionModel(**cond_kw),
            unet_config=unet_config,
            parameterization=parameterization,
            first_stage_config=sd_first_stage_config() if with_first_stage else None,
            linear_start=0.00085,
            linear_end=0.012,
            **kwargs,
        )
        self.version = version


def build_sd(
    version: str = "v1",
    *,
    device: Any = None,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    **kwargs: Any,
) -> StableDiffusion:
    """Entry point: Stable Diffusion with seeded random weights in `dtype`
    (schedule buffers stay f32) on `device` — CUDA unless the caller asks
    for another device. On "meta" nothing is allocated or drawn."""
    return build(StableDiffusion, device=device, dtype=dtype, seed=seed, version=version, **kwargs)


def build(cls: type, *, device: Any = None, dtype: torch.dtype = torch.float32, seed: int = 0, **kwargs: Any) -> Any:
    """Construct a DDPM-family model on `device` (CUDA unless the caller asks
    for another device) with seeded random parameters cast to `dtype`."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = cls(**kwargs)
    if device.type != "meta":
        model = model.to_empty(device=device)
        init_parameters(model, seed)
        model._rebuild_schedule()
    return cast_parameters(model, dtype).eval()
