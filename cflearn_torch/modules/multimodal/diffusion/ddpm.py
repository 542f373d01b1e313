"""DDPM: noise schedule buffers, condition dispatch, the eps/v/x0
parameterizations, the forward process, the DeepCache settings and the
ControlNet injection and the style-reference passes (counterpart of
`cflearn_tpu/modules/multimodal/diffusion/ddpm.py`). The condition types: `cross_attn` (the UNet's context),
`concat` (joined to the UNet's input on the channel axis), `hybrid` (a dict
holding both) and `adm` (class labels, embedded into the time embedding).
`condition_model` is a module or a registered name (`make_condition_model`,
with `condition_config`); `given_betas` replaces the beta schedule."""

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ...common import register_module
from .unet import UNetDiffuser
from .utils import ADM_TYPE, CONCAT_TYPE, CROSS_ATTN_TYPE, HYBRID_TYPE


def make_condition_model(key: str, config: Optional[Dict[str, Any]] = None) -> nn.Module:
    """Build a condition model from its registered name: a specialized one
    ("rescaler") wins over a generic encoder ("clip_text")."""
    from .cond_models import condition_models, specialized_condition_models

    registry = specialized_condition_models if specialized_condition_models.has(key) else condition_models
    return registry.build(key, **dict(config or {}))


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
        given_betas: Optional[Any] = None,
        learn_log_var: bool = False,
        log_var_init: float = 0.0,
        parameterization: str = "eps",
        condition_type: str = CROSS_ATTN_TYPE,
        condition_model: Optional[Any] = None,
        condition_config: Optional[Dict[str, Any]] = None,
        condition_learnable: bool = False,
        unet_config: Optional[Dict[str, Any]] = None,
        v_posterior: float = 0.0,
    ) -> None:
        super().__init__()
        if condition_type not in (CROSS_ATTN_TYPE, CONCAT_TYPE, HYBRID_TYPE, ADM_TYPE):
            raise ValueError(f"unrecognized condition type '{condition_type}'")
        if isinstance(condition_model, str):
            condition_model = make_condition_model(condition_model, condition_config)
        # the registered schedule's length: `given_betas` may override `num_timesteps`
        self.given_betas = None if given_betas is None else np.asarray(given_betas, np.float64)
        if self.given_betas is not None:
            num_timesteps = len(self.given_betas)
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
        betas = self.given_betas if self.given_betas is not None else make_beta_schedule(
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
        control_net: Optional[Any] = None,
        control_hint: Optional[Any] = None,
        control_scales: Optional[List[Any]] = None,
        control_gates: Optional[Any] = None,
        hooks: Optional[Any] = None,
        deep_cache: Optional[torch.Tensor] = None,
        return_cache: bool = False,
    ) -> Any:
        """The UNet on `net` with `cond` dispatched by the condition type: the
        cross-attention context, channels joined to `net`, both (`hybrid`: a
        dict with a "concat" and a "cross_attn" entry), or class labels. A
        DeepCache pass (`deep_cache` given, or `return_cache`) runs at the
        effective cut and returns (out, cache).

        ControlNet: `control_net` / `control_hint` are one net and its hint,
        or lists of them; each net's residuals are scaled by its entry of
        `control_scales` (one list of per-level scales per net, or one list
        for all), gated by its entry of `control_gates` (0 / 1 per net), and
        summed. A control net with fewer input channels than `net` (4 on a
        9-channel inpainting UNet) sees the leading channels. A shallow
        DeepCache pass computes only the cut + 1 residuals it takes.

        `hooks` (a `SpatialTransformerHooks`) reach the UNet's transformer
        blocks. With a style reference (`hooks.style` and `hooks.ref_latent`)
        the step first runs a full WRITE pass over the reference latent,
        broadcast to the batch and q-sampled at `timesteps` with noise drawn
        through `hooks._randn`, then the READ pass on `net` (with the
        control residuals and DeepCache as given), and ends the passes."""
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
        control = None
        if control_net is not None and control_hint is not None:
            multi = isinstance(control_net, (list, tuple))
            nets = list(control_net) if multi else [control_net]
            hints = list(control_hint) if multi else [control_hint]
            if control_scales is None:
                scales_per: List[Optional[List[float]]] = [None] * len(nets)
            elif isinstance(control_scales[0], (list, tuple)):
                scales_per = list(control_scales)
            else:
                scales_per = [list(control_scales)] * len(nets)
            levels = None if deep_cache is None else self._effective_cache_cut() + 1
            for i, (cn, hint) in enumerate(zip(nets, hints)):
                cn_in = cn.unet.in_channels
                ci = cn(net if cn_in == net.shape[-1] else net[..., :cn_in], hint, timesteps, context, max_levels=levels)
                sc = scales_per[i] if i < len(scales_per) else None
                if sc is not None:
                    ci = [c * s for c, s in zip(ci, sc)]
                if control_gates is not None:
                    ci = [c * control_gates[i] for c in ci]
                control = ci if control is None else [a + b for a, b in zip(control, ci)]
        use_cache = deep_cache is not None or return_cache
        kw = dict(control=control, hooks=hooks, deep_cache=deep_cache,
                  cache_cut=self._effective_cache_cut() if use_cache else None, return_cache=return_cache)
        if hooks is None or hooks.style is None or hooks.ref_latent is None:
            return self.unet(net, timesteps, context, labels, **kw)
        ref = hooks.ref_latent.to(net.dtype)
        ref = ref.expand((net.shape[0],) + tuple(ref.shape[1:]))
        ref_noisy = self.q_sample(ref, timesteps.long(), hooks._randn(ref.shape, ref))
        hooks.begin("write")
        self.unet(ref_noisy, timesteps, context, labels, hooks=hooks)
        hooks.begin("read")
        out = self.unet(net, timesteps, context, labels, **kw)
        hooks.begin(None)
        return out

    def sample(
        self,
        num_samples: int,
        *,
        sampler: Optional[Any] = None,
        cond: Optional[Any] = None,
        size: Optional[Any] = None,
        num_steps: int = 20,
        generator: Optional[torch.Generator] = None,
        **kwargs: Any,
    ) -> torch.Tensor:
        """`num_samples` samples from noise: z ~ N(0, 1) of (num_samples, *size
        (default img_size^2), out_channels) in f32 on the parameters' device,
        drawn from `generator` (default: one seeded with
        `toolkit.misc.get_seed()`), then `sampler` (default DDIM) for
        `num_steps` steps. NHWC, in the output latent space (a concat
        condition widens the UNet's input, not z)."""
        from ....toolkit.misc import new_generator
        from .samplers import ISampler

        if sampler is None:
            sampler = ISampler.make("ddim", {"model": self})
        if size is None:
            size = (self.img_size, self.img_size)
        device = next(self.parameters()).device
        if generator is None:
            generator = new_generator(device=device)
        z = torch.randn((num_samples, size[0], size[1], self.out_channels), generator=generator, device=device)
        return sampler.sample(z, cond=cond, num_steps=num_steps, generator=generator, **kwargs)
