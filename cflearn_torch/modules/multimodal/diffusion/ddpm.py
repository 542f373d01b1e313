"""DDPM: noise schedule buffers, condition dispatch and the eps/v/x0
parameterizations (counterpart of
`cflearn_tpu/modules/multimodal/diffusion/ddpm.py`, cross-attention
conditioning only)."""

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ...common import register_module
from .unet import UNetDiffuser

CROSS_ATTN_TYPE = "cross_attn"


def make_beta_schedule(
    schedule: str,
    num_timesteps: int,
    *,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Beta schedule on the host, in float64."""
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, num_timesteps, dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = np.arange(num_timesteps + 1, dtype=np.float64) / num_timesteps + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * math.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], 0.0, 0.999)
    elif schedule in ("sqrt_linear", "sqrt"):
        betas = np.linspace(linear_start, linear_end, num_timesteps, dtype=np.float64)
        if schedule == "sqrt":
            betas = betas**0.5
    else:
        raise ValueError(f"unrecognized schedule '{schedule}'")
    return betas.astype(np.float64)


@register_module("ddpm")
class DDPM(nn.Module):
    """UNet + schedule + condition model. The schedule buffers are computed
    on the host in float64, stored in f32, and not part of the state dict:
    they are a function of the schedule spec."""

    def __init__(
        self,
        *,
        img_size: int = 64,
        in_channels: int = 4,
        out_channels: int = 4,
        num_timesteps: int = 1000,
        beta_schedule: str = "linear",
        linear_start: float = 1e-4,
        linear_end: float = 2e-2,
        cosine_s: float = 8e-3,
        parameterization: str = "eps",
        condition_type: str = CROSS_ATTN_TYPE,
        condition_model: Optional[nn.Module] = None,
        unet_config: Optional[Dict[str, Any]] = None,
    ) -> None:
        super().__init__()
        if condition_type != CROSS_ATTN_TYPE:
            raise NotImplementedError(f"condition type '{condition_type}' is not ported yet")
        self.img_size = img_size
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.num_timesteps = num_timesteps
        self.parameterization = parameterization
        self.condition_type = condition_type
        self.condition_model = condition_model
        unet_config = dict(unet_config or {})
        unet_config.setdefault("in_channels", in_channels)
        unet_config.setdefault("out_channels", out_channels)
        self.unet = UNetDiffuser(**unet_config)
        self.schedule_info = {
            "schedule": beta_schedule,
            "num_timesteps": num_timesteps,
            "linear_start": linear_start,
            "linear_end": linear_end,
            "cosine_s": cosine_s,
        }
        self._rebuild_schedule()

    def _rebuild_schedule(self) -> None:
        """(Re)compute the schedule buffers on the current device — also after
        `to_empty`, which leaves buffers uninitialised."""
        info = self.schedule_info
        betas = make_beta_schedule(
            info["schedule"], info["num_timesteps"], linear_start=info["linear_start"],
            linear_end=info["linear_end"], cosine_s=info["cosine_s"],
        )
        acp = np.cumprod(1.0 - betas)
        device = next(self.parameters()).device
        for name, value in (
            ("betas", betas),
            ("alphas_cumprod", acp),
            ("sqrt_alphas_cumprod", np.sqrt(acp)),
            ("sqrt_one_minus_alphas_cumprod", np.sqrt(1.0 - acp)),
            ("sqrt_recip_alphas_cumprod", np.sqrt(1.0 / acp)),
            ("sqrt_recipm1_alphas_cumprod", np.sqrt(1.0 / acp - 1.0)),
        ):
            self.register_buffer(
                name, torch.tensor(value, dtype=torch.float32, device=device), persistent=False
            )

    def _coef(self, buf: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return buf[t].reshape(-1, 1, 1, 1)

    def predict_eps_from(self, x_t: torch.Tensor, t: torch.Tensor, model_out: torch.Tensor) -> torch.Tensor:
        """Model output -> eps under the configured parameterization."""
        if self.parameterization == "eps":
            return model_out
        if self.parameterization == "v":
            return self._coef(self.sqrt_alphas_cumprod, t) * model_out + self._coef(
                self.sqrt_one_minus_alphas_cumprod, t
            ) * x_t
        ra = self._coef(self.sqrt_recip_alphas_cumprod, t)
        rm = self._coef(self.sqrt_recipm1_alphas_cumprod, t)
        return (ra * x_t - model_out) / rm

    def get_cond(self, cond: Any) -> Any:
        if self.condition_model is None:
            return cond
        return self.condition_model(cond)

    def denoise(self, net: torch.Tensor, timesteps: torch.Tensor, cond: Optional[Any] = None) -> torch.Tensor:
        return self.unet(net, timesteps, cond)
