"""DDIM with batched classifier-free guidance, the guidance interval and
DeepCache (counterpart of `cflearn_tpu/modules/multimodal/diffusion/samplers.py`:
`deepcache_refresh_mask`, `map_center_to_segment`, `ISampler._denoise`,
`_uniform_timesteps`, `DDIMSampler.sample` at eta = 0). A Python step loop
takes the place of `lax.scan`, and a Python `if` on the host-static refresh
mask the place of `lax.cond`. The per-step schedule is computed on the host
in float64 and cast to the latents' dtype, as the JAX package does."""

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .ddpm import make_beta_schedule


def deepcache_refresh_mask(
    n: int,
    interval: int,
    center: Optional[float] = None,
    power: float = 2.0,
) -> np.ndarray:
    """Host-static boolean mask over `n` sampler steps: True = run the full
    UNet (refresh the DeepCache feature), False = shallow pass.

    `center=None` is the paper's uniform 1:N schedule (`step % interval ==
    0`). A float in [0, 1] is the paper's non-uniform schedule (DeepCache
    4.2, Ma et al. 2023, arXiv:2312.00858): the same number of full steps,
    placed by a power-law map concentrated around `center * n`. Step 0 is
    always full (it seeds the cache)."""
    if n <= 0:
        return np.zeros((0,), dtype=bool)
    uniform = (np.arange(n) % interval) == 0
    if center is None:
        return uniform
    k = int(uniform.sum())  # cost parity with the uniform schedule
    c = float(np.clip(center, 0.0, 1.0)) * (n - 1)
    u = np.linspace(-1.0, 1.0, k) if k > 1 else np.zeros((1,))
    # quadratic spacing with per-side reach: endpoints land on 0 and n-1
    # while interior points cluster around c
    reach = np.where(u < 0.0, c, (n - 1) - c)
    raw = c + np.sign(u) * (np.abs(u) ** power) * reach
    chosen = {int(round(v)) for v in np.clip(raw, 0, n - 1)}
    chosen.add(0)
    # keep exactly k refreshes: top up with (or drop) the steps nearest to
    # (farthest from) the center; never drop step 0
    spare = sorted(set(range(n)) - chosen, key=lambda i: abs(i - c))
    while len(chosen) < k and spare:
        chosen.add(spare.pop(0))
    while len(chosen) > k:
        chosen.remove(max((i for i in chosen if i != 0), key=lambda i: abs(i - c)))
    mask = np.zeros((n,), dtype=bool)
    mask[sorted(chosen)] = True
    return mask


def map_center_to_segment(center: float, n: int, seg: np.ndarray) -> float:
    """Map a refresh-center fraction of the whole `n`-step loop into the
    local coordinates of segment `seg` (global step indices), so that the
    guidance interval's segments keep the unsegmented schedule's intent."""
    global_center = float(np.clip(center, 0.0, 1.0)) * (n - 1)
    return float(np.clip((global_center - seg[0]) / max(1, len(seg) - 1), 0.0, 1.0))


def _uniform_timesteps(num_train: int, num_steps: int) -> np.ndarray:
    c = num_train // num_steps
    ts = np.asarray(list(range(0, num_train, c))) + 1
    return np.clip(ts, 0, num_train - 1)


class ISampler:
    d: Dict[str, type] = {}

    def __init__(
        self, model: Any, *, default_steps: int = 20, guidance_interval: Optional[Tuple[float, float]] = None
    ) -> None:
        self.model = model
        self.default_steps = default_steps
        # CFG only inside this fraction band of the step loop (Kynkaanniemi et
        # al. 2024); outside it the uncond rows are not computed
        self.guidance_interval = guidance_interval

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
        deep_cache: Optional[torch.Tensor] = None,
        return_cache: bool = False,
    ) -> Any:
        """CFG denoise -> eps, with cond and uncond in one UNet call. The
        guidance combination runs in the model output's dtype. A DeepCache
        pass (`deep_cache` given, or `return_cache`) returns (eps, cache); in
        a CFG segment the cache lives at the CFG-batched size."""
        m = self.model
        use_cache = deep_cache is not None or return_cache
        dc_kw = {"deep_cache": deep_cache, "return_cache": True} if use_cache else {}
        cache = None
        if uncond is None or guidance_scale == 1.0:
            out = m.denoise(x, t, cond, **dc_kw)
            if use_cache:
                out, cache = out
            eps = m.predict_eps_from(x, t, out)
            return (eps, cache) if use_cache else eps
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.cat([t, t], dim=0)
        out = m.denoise(x2, t2, torch.cat([cond, uncond], dim=0), **dc_kw)
        if use_cache:
            out, cache = out
        eps_cond, eps_uncond = m.predict_eps_from(x2, t2, out).chunk(2, dim=0)
        eps = eps_uncond + guidance_scale * (eps_cond - eps_uncond)
        return (eps, cache) if use_cache else eps

    def _np_acp(self) -> np.ndarray:
        info = self.model.schedule_info
        betas = make_beta_schedule(
            info["schedule"], info["num_timesteps"],
            linear_start=info["linear_start"], linear_end=info["linear_end"],
        )
        return np.cumprod(1.0 - betas).astype(np.float64)


@ISampler.register("ddim")
class DDIMSampler(ISampler):
    """Deterministic DDIM (eta = 0; the stochastic variant is not ported)."""

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
        """z: (B, H, W, C) latents at the first step's noise level. With a
        guidance interval the loop runs in three segments, CFG only in the
        middle one; with `model.deepcache_interval` each segment's first step
        runs the full UNet and seeds the cache, and the refresh mask decides
        the others (the parity restarts per segment, so the cache never
        crosses a change of batch size)."""
        num_steps = num_steps or self.default_steps
        ts, alphas, alphas_prev = self._schedule(num_steps)
        order = np.arange(num_steps)[::-1]
        b = z.shape[0]
        n = len(order)

        def run_segment(x: torch.Tensor, seg: np.ndarray, use_cfg: bool) -> torch.Tensor:
            if seg.size == 0:
                return x
            idx = order[seg]
            a_r = torch.tensor(alphas[idx], dtype=z.dtype, device=z.device)
            ap_r = torch.tensor(alphas_prev[idx], dtype=z.dtype, device=z.device)
            seg_uncond = uncond if use_cfg else None
            seg_scale = guidance_scale if use_cfg else 1.0
            interval = getattr(self.model, "deepcache_interval", None)
            use_dc = interval is not None and interval > 1 and len(idx) >= 2
            full = np.ones(len(idx), dtype=bool)
            if use_dc:
                # the center is a fraction of the whole loop: map it into the segment
                center = getattr(self.model, "deepcache_center", None)
                if center is not None and n > 1:
                    center = map_center_to_segment(center, n, seg)
                full[1:] = deepcache_refresh_mask(len(idx), interval, center)[1:]
            cache = None
            for i, t in enumerate(ts[idx]):
                tb = torch.full((b,), int(t), dtype=torch.long, device=z.device)
                if not use_dc:
                    eps = self._denoise(x, tb, cond, seg_uncond, seg_scale)
                elif full[i]:
                    eps, cache = self._denoise(x, tb, cond, seg_uncond, seg_scale, return_cache=True)
                else:
                    eps, cache = self._denoise(x, tb, cond, seg_uncond, seg_scale, deep_cache=cache)
                # the update runs in the latents' dtype (JAX promotes bf16 eps
                # against the f32 schedule scalars; torch would not for 0-d ones)
                eps = eps.to(x.dtype)
                a_t, a_prev = a_r[i], ap_r[i]
                x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
                dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * eps
                x = torch.sqrt(a_prev) * x0 + dir_xt
            return x

        if self.guidance_interval is None or uncond is None:
            return run_segment(z, np.arange(n), True)
        lo, hi = self.guidance_interval
        s0 = max(0, min(n, int(round(lo * n))))
        s1 = max(s0, min(n, int(round(hi * n))))
        x = run_segment(z, np.arange(0, s0), False)
        x = run_segment(x, np.arange(s0, s1), True)
        return run_segment(x, np.arange(s1, n), False)
