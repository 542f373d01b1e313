"""DDPM: noise schedule buffers, condition dispatch, the eps/v/x0
parameterizations, the forward process and the DeepCache settings
(counterpart of `cflearn_tpu/modules/multimodal/diffusion/ddpm.py`, no
ControlNet). The condition types: `cross_attn` (the UNet's context),
`concat` (joined to the UNet's input on the channel axis), `hybrid` (a dict
holding both) and `adm` (class labels, embedded into the time embedding)."""

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ...common import register_module
from .unet import UNetDiffuser
from .utils import ADM_TYPE, CONCAT_TYPE, CROSS_ATTN_TYPE, HYBRID_TYPE


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
        learn_log_var: bool = False,
        log_var_init: float = 0.0,
        parameterization: str = "eps",
        condition_type: str = CROSS_ATTN_TYPE,
        condition_model: Optional[nn.Module] = None,
        condition_learnable: bool = False,
        unet_config: Optional[Dict[str, Any]] = None,
        v_posterior: float = 0.0,
    ) -> None:
        super().__init__()
        if condition_type not in (CROSS_ATTN_TYPE, CONCAT_TYPE, HYBRID_TYPE, ADM_TYPE):
            raise ValueError(f"unrecognized condition type '{condition_type}'")
        self.img_size = img_size
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.num_timesteps = num_timesteps
        self.parameterization = parameterization
        self.condition_type = condition_type
        self.condition_model = condition_model
        self.condition_learnable = condition_learnable
        self.v_posterior = v_posterior
        # DeepCache (Ma et al. 2023): the samplers alternate full and shallow
        # UNet passes when `deepcache_interval` is set; the cut is clamped to
        # the UNet when used (`_effective_cache_cut`). `deepcache_center` None
        # = uniform 1:N refreshes, a fraction in [0, 1] = the paper's
        # non-uniform placement centred there (same number of full passes)
        self.deepcache_interval: Optional[int] = None
        self.deepcache_cut: int = 3
        self.deepcache_center: Optional[float] = None
        # per-timestep log-variance of the simple loss: a parameter when
        # learned (the "gamma" objective), else a constant buffer
        self.learn_log_var = learn_log_var
        self.log_var_init = float(log_var_init)
        if learn_log_var:
            self.log_var = nn.Parameter(torch.full((num_timesteps,), self.log_var_init))
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
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        posterior_variance = (1 - self.v_posterior) * betas * (1.0 - acp_prev) / (1.0 - acp) + self.v_posterior * betas
        # VLB per-timestep weights
        if self.parameterization == "eps":
            with np.errstate(divide="ignore"):
                lvlb = 0.5 * betas**2 / (posterior_variance * alphas * (1.0 - acp))
        elif self.parameterization == "x0":
            lvlb = 0.25 * np.sqrt(acp) / (1.0 - acp)
        else:  # v
            lvlb = np.ones_like(betas)
        lvlb[0] = lvlb[1]
        device = next(self.parameters()).device
        if self.learn_log_var:
            with torch.no_grad():  # `init_parameters` zeroes 1-D tensors
                self.log_var.fill_(self.log_var_init)
        else:
            self.register_buffer(
                "log_var",
                torch.full((info["num_timesteps"],), self.log_var_init, dtype=torch.float32, device=device),
                persistent=False,
            )
        for name, value in (
            ("betas", betas),
            ("alphas_cumprod", acp),
            ("posterior_variance", posterior_variance),
            ("lvlb_weights", lvlb),
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

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(acp_t) x0 + sqrt(1 - acp_t) noise."""
        return self._coef(self.sqrt_alphas_cumprod, t) * x0 + self._coef(
            self.sqrt_one_minus_alphas_cumprod, t
        ) * noise

    def get_v(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The v-parameterization's target."""
        return self._coef(self.sqrt_alphas_cumprod, t) * noise - self._coef(
            self.sqrt_one_minus_alphas_cumprod, t
        ) * x0

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

    def _effective_cache_cut(self) -> int:
        """The DeepCache cut clamped to the UNet: the shallow pass runs
        `input_blocks[:cut]` and `output_blocks[-(cut+1):]`, so 1 <= cut <=
        len(input_blocks) and cut <= len(output_blocks) - 1."""
        n_in = len(self.unet.input_blocks)
        n_out = len(self.unet.output_blocks)
        return max(1, min(self.deepcache_cut, n_in, n_out - 1))

    def denoise(
        self,
        net: torch.Tensor,
        timesteps: torch.Tensor,
        cond: Optional[Any] = None,
        *,
        deep_cache: Optional[torch.Tensor] = None,
        return_cache: bool = False,
    ) -> Any:
        """The UNet on `net` with `cond` dispatched by the condition type: the
        cross-attention context, channels joined to `net`, both (`hybrid`: a
        dict with a "concat" and a "cross_attn" entry), or class labels. A
        DeepCache pass (`deep_cache` given, or `return_cache`) runs at the
        effective cut and returns (out, cache)."""
        context = labels = None
        if cond is not None:
            if self.condition_type == CONCAT_TYPE:
                net = torch.cat([net, cond], dim=-1)
            elif self.condition_type == CROSS_ATTN_TYPE:
                context = cond
            elif self.condition_type == HYBRID_TYPE:
                net = torch.cat([net, cond[CONCAT_TYPE]], dim=-1)
                context = cond[CROSS_ATTN_TYPE]
            else:
                labels = cond
        use_cache = deep_cache is not None or return_cache
        return self.unet(
            net, timesteps, context, labels, deep_cache=deep_cache,
            cache_cut=self._effective_cache_cut() if use_cache else None, return_cache=return_cache,
        )
