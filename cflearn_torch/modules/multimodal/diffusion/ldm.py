"""LDM / Stable Diffusion (counterpart of
`cflearn_tpu/modules/multimodal/diffusion/ldm.py`): `LDM`,
`StableDiffusion`, `StableDiffusionInpainting`, `SDLoRAMode` and
`convert_lora`."""

from enum import Enum
from typing import Any, Dict, Optional

import torch

from ...common import build_module, register_module
from ...cv.ae import AutoEncoderKL
from ...cv.common import GaussianDistribution, VQCodebookOutput, generators
from .cond_models import CLIPTextConditionModel
from .ddpm import DDPM


@register_module("ldm")
class LDM(DDPM):
    """Latent diffusion: DDPM over the latents of a frozen first stage,
    scaled by `latent_scale` (`first_stage_scale_factor` wins where given).

    `first_stage` is a module, a `generators` name ("ae_kl", "ae_vq") or
    else a zoo preset name ("ae/vq.f4", `cflearn_torch.zoo`), built from
    `first_stage_config` (random weights: a `pretrained` entry raises);
    without either, `first_stage_config` builds an `AutoEncoderKL`. With `use_first_stage_as_condition` the raw
    condition goes through the first-stage encoder, without a gradient (the
    semantic / super-resolution LDMs, which join it to the UNet's input:
    the `concat` condition type)."""

    def __init__(
        self,
        *,
        first_stage: Optional[Any] = None,
        first_stage_config: Optional[Dict[str, Any]] = None,
        first_stage_scale_factor: Optional[float] = None,
        latent_scale: float = 0.18215,
        use_first_stage_as_condition: bool = False,
        **kwargs: Any,
    ) -> None:
        if use_first_stage_as_condition and kwargs.get("condition_learnable"):
            raise ValueError(
                "should not set `condition_learnable` to True when `use_first_stage_as_condition` is True"
            )
        super().__init__(**kwargs)
        self.latent_scale = latent_scale if first_stage_scale_factor is None else first_stage_scale_factor
        self.use_first_stage_as_condition = use_first_stage_as_condition
        if isinstance(first_stage, str):
            cfg = dict(first_stage_config or {})
            cfg.pop("prefix_module", None)
            if cfg.pop("pretrained", False):
                raise ValueError(f"pretrained weights of the first stage '{first_stage}' are not in the repository")
            if generators.has(first_stage):
                first_stage = generators.build(first_stage, **cfg)
            else:
                from ....zoo.common import build_module

                first_stage = build_module(first_stage, **cfg)
        elif first_stage is None and first_stage_config is not None:
            first_stage = AutoEncoderKL(**first_stage_config)
        self.first_stage = first_stage

    def encode_first_stage(
        self, images: torch.Tensor, *, generator: Optional[torch.Generator] = None, deterministic: bool = True
    ) -> torch.Tensor:
        """Images -> scaled latents: a KL first stage's posterior mode (or,
        not `deterministic`, a sample drawn from `generator`), a VQ first
        stage's quantised z_q, any other first stage's output as it is."""
        assert self.first_stage is not None
        out = self.first_stage.encode(images)
        if isinstance(out, GaussianDistribution):
            z = out.mode() if deterministic else out.sample(generator)
        elif isinstance(out, VQCodebookOutput):
            z = out.z_q
        else:
            z = out
        return z * self.latent_scale

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        assert self.first_stage is not None
        return self.first_stage.decode(z / self.latent_scale)

    def decode(self, z: torch.Tensor, *, clip_output: bool = True) -> torch.Tensor:
        out = self.decode_first_stage(z)
        return out.clamp(-1.0, 1.0) if clip_output else out

    def get_cond(self, cond: Any) -> Any:
        if self.use_first_stage_as_condition:
            with torch.no_grad():
                return self.encode_first_stage(cond)
        return super().get_cond(cond)


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


@register_module("sd_inpainting")
class StableDiffusionInpainting(StableDiffusion):
    """SD inpainting: the UNet takes 9 channels (the latents, the mask and
    the masked image's latents); the latents stay 4."""

    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("in_channels", 9)
        super().__init__(**kwargs)
        self.out_channels = 4


class SDLoRAMode(str, Enum):
    """Which UNet layers LoRA attaches to."""

    UNET = "unet"
    UNET_EXTENDED = "unet_extended"


def convert_lora(inp: Any) -> Any:
    """A kohya / diffusers torch LoRA checkpoint (a path or a state dict)
    as a `LoRAPack` over the port's UNet parameters."""
    from ...core.lora import LoRAManager

    return LoRAManager.load_torch_lora(inp)


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
    """Construct a DDPM-family model (or a `ControlNet`) on `device` (CUDA
    unless the caller asks for another device) with seeded random parameters
    cast to `dtype`, in eval mode (`build_module`)."""
    return build_module(cls, device=device, dtype=dtype, seed=seed, **kwargs).eval()
