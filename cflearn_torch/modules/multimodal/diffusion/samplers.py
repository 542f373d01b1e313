"""DDIM with batched classifier-free guidance (counterpart of
`cflearn_tpu/modules/multimodal/diffusion/samplers.py`: `ISampler._denoise`,
`_uniform_timesteps`, `DDIMSampler.sample`). A Python step loop takes the
place of `lax.scan`. DeepCache and the guidance interval are later slices.
The per-step schedule is computed on the host in float64 and cast to the
latents' dtype, as the JAX package does."""

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .ddpm import make_beta_schedule


def _uniform_timesteps(num_train: int, num_steps: int) -> np.ndarray:
    c = num_train // num_steps
    ts = np.asarray(list(range(0, num_train, c))) + 1
    return np.clip(ts, 0, num_train - 1)


class ISampler:
    d: Dict[str, type] = {}

    def __init__(self, model: Any, *, default_steps: int = 20) -> None:
        self.model = model
        self.default_steps = default_steps

    @classmethod
    def register(cls, name: str):
        def wrap(sub: type) -> type:
            cls.d[name] = sub
            return sub

        return wrap

    @classmethod
    def make(cls, name: str, config: Dict[str, Any]) -> "ISampler":
        return cls.d[name](**config)

    def _denoise(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        cond: Optional[torch.Tensor],
        uncond: Optional[torch.Tensor],
        guidance_scale: float,
    ) -> torch.Tensor:
        """CFG denoise -> eps, with cond and uncond in one UNet call. The
        guidance combination runs in the model output's dtype."""
        m = self.model
        if uncond is None or guidance_scale == 1.0:
            return m.predict_eps_from(x, t, m.denoise(x, t, cond))
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.cat([t, t], dim=0)
        out = m.denoise(x2, t2, torch.cat([cond, uncond], dim=0))
        eps_cond, eps_uncond = m.predict_eps_from(x2, t2, out).chunk(2, dim=0)
        return eps_uncond + guidance_scale * (eps_cond - eps_uncond)

    def _np_acp(self) -> np.ndarray:
        info = self.model.schedule_info
        betas = make_beta_schedule(
            info["schedule"], info["num_timesteps"],
            linear_start=info["linear_start"], linear_end=info["linear_end"],
        )
        return np.cumprod(1.0 - betas).astype(np.float64)


@ISampler.register("ddim")
class DDIMSampler(ISampler):
    """Deterministic DDIM (eta = 0; the stochastic variant is a later slice)."""

    def _schedule(self, num_steps: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        acp = self._np_acp()
        ts = _uniform_timesteps(len(acp), num_steps)
        alphas = acp[ts]
        alphas_prev = np.concatenate([[acp[0]], acp[ts[:-1]]])
        return ts, alphas, alphas_prev

    @torch.no_grad()
    def sample(
        self,
        z: torch.Tensor,
        *,
        cond: Optional[torch.Tensor] = None,
        uncond: Optional[torch.Tensor] = None,
        guidance_scale: float = 1.0,
        num_steps: Optional[int] = None,
    ) -> torch.Tensor:
        """z: (B, H, W, C) latents at the first step's noise level."""
        num_steps = num_steps or self.default_steps
        ts, alphas, alphas_prev = self._schedule(num_steps)
        order = np.arange(num_steps)[::-1]
        b = z.shape[0]

        def col(a: np.ndarray) -> torch.Tensor:
            return torch.tensor(a[order], dtype=z.dtype, device=z.device)

        a_r, ap_r = col(alphas), col(alphas_prev)
        x = z
        for i, idx in enumerate(order):
            tb = torch.full((b,), int(ts[idx]), dtype=torch.long, device=z.device)
            # the update runs in the latents' dtype (JAX promotes bf16 eps
            # against the f32 schedule scalars; torch would not for 0-d ones)
            eps = self._denoise(x, tb, cond, uncond, guidance_scale).to(x.dtype)
            a_t, a_prev = a_r[i], ap_r[i]
            x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
            dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * eps
            x = torch.sqrt(a_prev) * x0 + dir_xt
        return x
