"""Samplers (counterpart of `cflearn_tpu/modules/multimodal/diffusion/samplers.py`):
the `ISampler` registry with batched classifier-free guidance over any
condition (a tensor, or the hybrid dict of tensors) and the ControlNet hint,
`sample_from` (img2img), the control gates of a hint's start / end, and every
registered sampler: `ddim` (eta-configurable, DeepCache, guidance interval),
`basic`, `plms`, the k-samplers `k_euler`, `k_euler_a`, `k_heun`, `klms` and
`k_dpmpp_2m`, `lcm` and `solver` (multistep DPM-Solver); and
`DDPMQSampler`.

A Python step loop takes the place of `lax.scan`, and a Python `if` on a
host-static flag the place of `lax.cond` / `jnp.where`. Per-step schedules
are computed on the host in float64, as the JAX package does, and enter the
step as f32 scalars where the JAX loop carries them as f32 arrays. The
model's eps enters each update in the latents' dtype.

Every random draw of a sampler goes through `ISampler._randn`, from the
`torch.Generator` the caller passes (seed 0 when it passes none).
"""

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

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




def _f32(value: Any) -> torch.Tensor:
    """A host scalar as a 0-d f32 tensor: the f32 scalar a JAX step carries."""
    return torch.tensor(float(value), dtype=torch.float32)


def _tree_map(fn: Callable[..., torch.Tensor], *trees: Any) -> Any:
    """`jax.tree_util.tree_map` over tensors, dicts and lists / tuples."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *items) for items in zip(*trees))
    return fn(*trees)


def _int_t(t: torch.Tensor) -> torch.Tensor:
    """Timesteps as integers for the schedule's buffers: fractional ones
    (the k-samplers', the solver's) truncated, as JAX's `astype(int32)`."""
    return t.long() if t.is_floating_point() else t


def _generator(generator: Optional[torch.Generator], device: torch.device) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(0)


class ISampler:
    d: Dict[str, type] = {}

    # CFG only inside a fraction band of the step loop (Kynkaanniemi et al.
    # 2024); honoured by samplers whose update carries no cross-step history,
    # or threads it across the segments
    supports_guidance_interval = False

    def __init__(
        self, model: Any, *, default_steps: int = 20, guidance_interval: Optional[Tuple[float, float]] = None
    ) -> None:
        self.model = model
        self.default_steps = default_steps
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

    def sample(
        self,
        z: torch.Tensor,
        *,
        cond: Optional[Any] = None,
        uncond: Optional[Any] = None,
        guidance_scale: float = 1.0,
        num_steps: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        **kwargs: Any,
    ) -> torch.Tensor:
        raise NotImplementedError

    def sample_from(
        self,
        x0: torch.Tensor,
        *,
        cond: Optional[Any] = None,
        num_steps: int = 20,
        start_step: int = 0,
        generator: Optional[torch.Generator] = None,
        **kwargs: Any,
    ) -> torch.Tensor:
        """img2img entry: q-sample `x0` to the start step, then denoise."""
        raise NotImplementedError

    # -------------------------------------------------------------- helpers

    def _randn(self, shape: Tuple[int, ...], like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """N(0, 1) of `shape` in `like`'s dtype and device: every draw a
        sampler makes (for the global batch and sliced where a mesh shards it,
        `parallel.mesh.global_randn`)."""
        from ....parallel.mesh import global_randn

        return global_randn(shape, generator=generator, device=like.device, dtype=like.dtype)

    def _denoise(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        cond: Optional[Any],
        uncond: Optional[Any],
        guidance_scale: float,
        deep_cache: Optional[torch.Tensor] = None,
        return_cache: bool = False,
        **kwargs: Any,
    ) -> Any:
        """CFG denoise -> eps, with cond and uncond in one model call. `cond`
        may be a dict of tensors (the hybrid condition): each entry is
        batched. A `control_hint` in `kwargs` (a tensor or a list of them)
        is batched too; `kwargs` go on to `model.denoise`. `t` may be
        fractional (the k-samplers): the model sees it as it is, and
        `predict_eps_from` truncated to an integer. The guidance combination
        runs in the model output's dtype. A DeepCache pass (`deep_cache`
        given, or `return_cache`) returns (eps, cache); in a CFG segment the
        cache lives at the CFG-batched size."""
        m = self.model
        use_cache = deep_cache is not None or return_cache
        dc_kw = {"deep_cache": deep_cache, "return_cache": True} if use_cache else {}
        cache = None
        if uncond is None or guidance_scale == 1.0:
            out = m.denoise(x, t, cond, **kwargs, **dc_kw)
            if use_cache:
                out, cache = out
            eps = m.predict_eps_from(x, _int_t(t), out)
            return (eps, cache) if use_cache else eps
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.cat([t, t], dim=0)
        c2 = _tree_map(lambda a, b: torch.cat([a, b], dim=0), cond, uncond)
        if kwargs.get("control_hint") is not None:
            kwargs = dict(kwargs)
            kwargs["control_hint"] = _tree_map(lambda h: torch.cat([h, h], dim=0), kwargs["control_hint"])
        out = m.denoise(x2, t2, c2, **kwargs, **dc_kw)
        if use_cache:
            out, cache = out
        eps_cond, eps_uncond = m.predict_eps_from(x2, _int_t(t2), out).chunk(2, dim=0)
        eps = eps_uncond + guidance_scale * (eps_cond - eps_uncond)
        return (eps, cache) if use_cache else eps

    def _pop_control_gate_schedule(
        self, kwargs: Dict[str, Any], num_exec_steps: int
    ) -> Tuple[Dict[str, Any], Optional[np.ndarray]]:
        """Consume `control_hint_start` / `control_hint_end` and build the
        host-static gate matrix (steps, controls): a control is on at step i
        when start * n <= i <= end * n."""
        start = kwargs.pop("control_hint_start", None)
        end = kwargs.pop("control_hint_end", None)
        if start is None and end is None:
            return kwargs, None
        ch = kwargs.get("control_hint")
        n = len(ch) if isinstance(ch, (list, tuple)) else 1
        starts = list(start) if isinstance(start, (list, tuple)) else [start] * n
        ends = list(end) if isinstance(end, (list, tuple)) else [end] * n
        gates = np.ones((num_exec_steps, n), dtype=np.float32)
        for i in range(n):
            for s_idx in range(num_exec_steps):
                if starts[i] is not None and starts[i] * num_exec_steps > s_idx:
                    gates[s_idx, i] = 0.0
                if ends[i] is not None and ends[i] * num_exec_steps < s_idx:
                    gates[s_idx, i] = 0.0
        return kwargs, gates

    @staticmethod
    def _gated(kwargs: Dict[str, Any], gates: Optional[np.ndarray], row: int) -> Dict[str, Any]:
        """`kwargs` with the control gates of gate row `row`, as floats."""
        if gates is None:
            return kwargs
        return dict(kwargs, control_gates=[float(g) for g in gates[row]])

    def _start_timestep(self, num_steps: int, start_step: int) -> int:
        """The model timestep of the `start_step`-th executed step, on this
        sampler's own grid (the uniform grid of ddim / plms by default), so
        that `sample_from` q-samples to the noise level the sampler assumes."""
        acp = self._np_acp()
        ts = _uniform_timesteps(len(acp), num_steps)
        order = np.arange(num_steps)[::-1]
        return int(ts[order[start_step]]) if start_step < num_steps else 0

    def _np_acp(self) -> np.ndarray:
        """Host-side alphas_cumprod in float64, from the model's schedule spec."""
        info = getattr(self.model, "schedule_info", None)
        if info is None:
            return np.asarray(self.model.alphas_cumprod.detach().cpu(), dtype=np.float64)
        betas = make_beta_schedule(
            info["schedule"], info["num_timesteps"],
            linear_start=info["linear_start"], linear_end=info["linear_end"],
        )
        return np.cumprod(1.0 - betas).astype(np.float64)

    def _cfg_bounds(self, n: int, uncond: Optional[Any]) -> Tuple[bool, int, int]:
        """(whether the guidance interval splits the loop, its first step, its end)."""
        gi = self.guidance_interval
        if gi is None or uncond is None or not self.supports_guidance_interval:
            return False, 0, n
        s0 = max(0, min(n, int(round(gi[0] * n))))
        return True, s0, max(s0, min(n, int(round(gi[1] * n))))


@ISampler.register("ddim")
class DDIMSampler(ISampler):
    """DDIM, eta-configurable (eta = 0: deterministic), with the guidance
    interval and DeepCache."""

    supports_guidance_interval = True

    def __init__(self, model: Any, *, eta: float = 0.0, **kwargs: Any) -> None:
        super().__init__(model, **kwargs)
        self.eta = eta

    def _schedule(self, num_steps: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        acp = self._np_acp()
        ts = _uniform_timesteps(len(acp), num_steps)
        alphas = acp[ts]
        alphas_prev = np.concatenate([[acp[0]], acp[ts[:-1]]])
        sigmas = self.eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
        return ts, alphas, alphas_prev, sigmas

    @torch.no_grad()
    def sample(
        self,
        z: torch.Tensor,
        *,
        cond: Optional[Any] = None,
        uncond: Optional[Any] = None,
        guidance_scale: float = 1.0,
        num_steps: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        start_step: int = 0,
        **kwargs: Any,
    ) -> torch.Tensor:
        """z: (B, H, W, C) latents at the first executed step's noise level.
        With a guidance interval the loop runs in three segments, CFG only in
        the middle one; with `model.deepcache_interval` each segment's first
        step runs the full UNet and seeds the cache, and the refresh mask
        decides the others (the parity restarts per segment, so the cache
        never crosses a change of batch size). With eta > 0 each step draws
        its noise."""
        num_steps = num_steps or self.default_steps
        ts, alphas, alphas_prev, sigmas = self._schedule(num_steps)
        order = np.arange(num_steps)[::-1][start_step:]
        generator = _generator(generator, z.device)
        b = z.shape[0]
        n = len(order)
        kwargs, gates = self._pop_control_gate_schedule(dict(kwargs), n)

        def run_segment(x: torch.Tensor, seg: np.ndarray, use_cfg: bool) -> torch.Tensor:
            if seg.size == 0:
                return x
            idx = order[seg]
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
            for i, (step, j) in enumerate(zip(seg, idx)):
                tb = torch.full((b,), int(ts[j]), dtype=torch.long, device=z.device)
                kw = self._gated(kwargs, gates, step)
                if not use_dc:
                    eps = self._denoise(x, tb, cond, seg_uncond, seg_scale, **kw)
                elif full[i]:
                    eps, cache = self._denoise(x, tb, cond, seg_uncond, seg_scale, return_cache=True, **kw)
                else:
                    eps, cache = self._denoise(x, tb, cond, seg_uncond, seg_scale, deep_cache=cache, **kw)
                a_t, a_prev, sigma_t = _f32(alphas[j]), _f32(alphas_prev[j]), _f32(sigmas[j])
                eps = eps.to(x.dtype)
                x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
                dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t**2, min=0.0)) * eps
                x = torch.sqrt(a_prev) * x0 + dir_xt
                if self.eta > 0:
                    x = x + sigma_t * self._randn(x.shape, x, generator)
            return x

        use_gi, s0, s1 = self._cfg_bounds(n, uncond)
        if not use_gi:
            return run_segment(z, np.arange(n), True)
        x = run_segment(z, np.arange(0, s0), False)
        x = run_segment(x, np.arange(s0, s1), True)
        return run_segment(x, np.arange(s1, n), False)

    def sample_from(self, x0: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        return _generic_sample_from(self, x0, **kwargs)


@ISampler.register("basic")
class DDPMSampler(DDIMSampler):
    """Ancestral DDPM sampling: DDIM with eta = 1 (50 steps by default)."""

    def __init__(self, model: Any, **kwargs: Any) -> None:
        kwargs.setdefault("default_steps", 50)
        super().__init__(model, eta=1.0, **kwargs)


@ISampler.register("plms")
class PLMSSampler(ISampler):
    """Pseudo linear multistep (PLMS / PNDM): an improved-Euler first step,
    then up to fourth-order eps extrapolation; the eps history threads
    across guidance-interval and control-gate segments."""

    supports_guidance_interval = True

    @torch.no_grad()
    def sample(
        self,
        z: torch.Tensor,
        *,
        cond: Optional[Any] = None,
        uncond: Optional[Any] = None,
        guidance_scale: float = 1.0,
        num_steps: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        start_step: int = 0,
        **kwargs: Any,
    ) -> torch.Tensor:
        num_steps = num_steps or self.default_steps
        acp = self._np_acp()
        ts = _uniform_timesteps(len(acp), num_steps)
        alphas = acp[ts]
        alphas_prev = np.concatenate([[acp[0]], acp[ts[:-1]]])
        order = np.arange(num_steps)[::-1][start_step:]
        b = z.shape[0]
        n = len(order)

        def x_prev_fn(x: torch.Tensor, eps: torch.Tensor, a_t: torch.Tensor, a_prev: torch.Tensor) -> torch.Tensor:
            x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
            dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * eps
            return torch.sqrt(a_prev) * x0 + dir_xt

        def eps_at(x: torch.Tensor, t: int, unc: Any, scale: float, kw: Dict[str, Any]) -> torch.Tensor:
            tb = torch.full((b,), int(t), dtype=torch.long, device=z.device)
            return self._denoise(x, tb, cond, unc, scale, **kw).to(x.dtype)

        kwargs, gates = self._pop_control_gate_schedule(dict(kwargs), n)
        use_gi, s0, s1 = self._cfg_bounds(n, uncond)

        # the first step: improved Euler (a second eval at t_next, averaged)
        first_cfg = (not use_gi) or (s0 <= 0 < s1)
        f_uncond = uncond if first_cfg else None
        f_scale = guidance_scale if first_cfg else 1.0
        f_kwargs = self._gated(kwargs, gates, 0)
        i0 = order[0]
        a0, ap0 = _f32(alphas[i0]), _f32(alphas_prev[i0])
        eps0 = eps_at(z, ts[i0], f_uncond, f_scale, f_kwargs)
        x_trial = x_prev_fn(z, eps0, a0, ap0)
        t_next = int(ts[order[1]]) if n > 1 else 0
        eps_next = eps_at(x_trial, t_next, f_uncond, f_scale, f_kwargs)
        x = x_prev_fn(z, 0.5 * (eps0 + eps_next), a0, ap0)

        zeros = torch.zeros_like(z)
        old_eps = (eps0, zeros, zeros)
        count = 1
        bounds = {1, n, max(s0, 1), max(s1, 1)}
        if gates is not None:
            for i in range(2, n):
                if not np.array_equal(gates[i], gates[i - 1]):
                    bounds.add(i)
        edges = sorted(bounds)
        for lo, hi in zip(edges[:-1], edges[1:]):
            use_cfg = (not use_gi) or (s0 <= lo < s1)
            seg_uncond = uncond if use_cfg else None
            seg_scale = guidance_scale if use_cfg else 1.0
            # the gates are constant within a segment
            seg_kwargs = self._gated(kwargs, gates, lo)
            for j in order[lo:hi]:
                eps = eps_at(x, ts[j], seg_uncond, seg_scale, seg_kwargs)
                e1, e2, e3 = old_eps
                if count == 0:
                    eps_prime = eps
                elif count == 1:
                    eps_prime = (3 * eps - e1) / 2
                elif count == 2:
                    eps_prime = (23 * eps - 16 * e1 + 5 * e2) / 12
                else:
                    eps_prime = (55 * eps - 59 * e1 + 37 * e2 - 9 * e3) / 24
                x = x_prev_fn(x, eps_prime, _f32(alphas[j]), _f32(alphas_prev[j]))
                old_eps = (eps, e1, e2)
                count += 1
        return x

    def sample_from(self, x0: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        return _generic_sample_from(self, x0, **kwargs)


def _generic_sample_from(
    sampler: ISampler,
    x0: torch.Tensor,
    *,
    cond: Optional[Any] = None,
    num_steps: int = 20,
    start_step: int = 0,
    generator: Optional[torch.Generator] = None,
    **kwargs: Any,
) -> torch.Tensor:
    """q-sample `x0` to the start step's timestep on the sampler's grid (the
    noise from the generator), then sample from there."""
    t_start = sampler._start_timestep(num_steps, start_step)
    generator = _generator(generator, x0.device)
    noise = sampler._randn(x0.shape, x0, generator)
    tb = torch.full((x0.shape[0],), t_start, dtype=torch.long, device=x0.device)
    z = sampler.model.q_sample(x0, tb, noise)
    return sampler.sample(
        z, cond=cond, num_steps=num_steps, start_step=start_step, generator=generator, **kwargs
    )


class IKSampler(ISampler):
    """Shared k-diffusion machinery: integration in sigma space, with the
    Karras ramp (or the interpolated trained sigmas), the sigma -> timestep
    map by log-sigma interpolation, and segment-resumable integration over
    the guidance interval and the control gates."""

    use_karras: bool = True

    def __init__(self, model: Any, *, use_karras: Optional[bool] = None, **kwargs: Any) -> None:
        super().__init__(model, **kwargs)
        if use_karras is not None:
            self.use_karras = use_karras

    def _sigmas(self, num_steps: int, start_step: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        acp = self._np_acp()
        full_sigmas = np.sqrt((1.0 - acp) / acp)
        log_sigmas = np.log(full_sigmas)
        if self.use_karras:
            rho = 7.0
            sigma_min, sigma_max = full_sigmas[0], full_sigmas[-1]
            ramp = np.linspace(0, 1, num_steps)
            min_inv, max_inv = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
            sigmas = (max_inv + ramp * (min_inv - max_inv)) ** rho
        else:
            idx = np.linspace(len(acp) - 1, 0, num_steps)
            sigmas = np.interp(idx, np.arange(len(acp)), full_sigmas)
        sigmas = np.append(sigmas, 0.0)
        # sigma -> (fractional) timestep via log-sigma interpolation
        t_of = np.interp(np.log(np.maximum(sigmas[:-1], full_sigmas[0])), log_sigmas, np.arange(len(acp)))
        return sigmas[start_step:], t_of[start_step:]

    def _t_at(self, sigmas: np.ndarray) -> np.ndarray:
        """The sigma -> timestep map of `_sigmas`, on any sigma array."""
        acp = self._np_acp()
        full_sigmas = np.sqrt((1.0 - acp) / acp)
        log_sigmas = np.log(full_sigmas)
        return np.interp(np.log(np.maximum(sigmas, full_sigmas[0])), log_sigmas, np.arange(len(acp)))

    def _eps_denoised(
        self,
        x: torch.Tensor,
        sigma: torch.Tensor,
        t: float,
        cond: Any,
        uncond: Any,
        guidance_scale: float,
        **kwargs: Any,
    ) -> torch.Tensor:
        """k-space x -> the denoised x0 prediction; the model sees the
        fractional timestep `t` (f32)."""
        c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
        tb = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
        eps = self._denoise(x * c_in, tb, cond, uncond, guidance_scale, **kwargs).to(x.dtype)
        return x - sigma * eps

    @torch.no_grad()
    def sample(
        self,
        z: torch.Tensor,
        *,
        cond: Optional[Any] = None,
        uncond: Optional[Any] = None,
        guidance_scale: float = 1.0,
        num_steps: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        start_step: int = 0,
        initial_sigma_scaled: bool = False,
        **kwargs: Any,
    ) -> torch.Tensor:
        num_steps = num_steps or self.default_steps
        sigmas, t_of = self._sigmas(num_steps, start_step)
        if not initial_sigma_scaled:
            z = z * float(sigmas[0])
        generator = _generator(generator, z.device)
        n = len(t_of)
        # the control gates are piecewise constant over steps, so they
        # segment the integration as the guidance interval does
        kwargs, gates = self._pop_control_gate_schedule(dict(kwargs), n)
        use_gi, s0, s1 = self._cfg_bounds(n, uncond)
        if not use_gi and gates is None:
            return self._integrate(z, sigmas, t_of, cond, uncond, guidance_scale, generator, **kwargs)
        if gates is not None and not self.supports_guidance_interval:
            raise NotImplementedError("control hint start/end gating needs segment-safe integration")
        bounds = {0, n, s0, s1}
        if gates is not None:
            for i in range(1, n):
                if not np.array_equal(gates[i], gates[i - 1]):
                    bounds.add(i)
        edges = sorted(bounds)
        x = z
        carry: Any = None
        for a, b in zip(edges[:-1], edges[1:]):
            if a == b:
                continue
            use_cfg = (not use_gi) or (s0 <= a < s1)
            x, carry = self._integrate_carry(
                x, carry, sigmas[a: b + 1], t_of[a:b], cond, uncond if use_cfg else None,
                guidance_scale if use_cfg else 1.0, generator, **self._gated(kwargs, gates, a),
            )
        return x

    def sample_from(
        self,
        x0: torch.Tensor,
        *,
        cond: Optional[Any] = None,
        num_steps: int = 20,
        start_step: int = 0,
        generator: Optional[torch.Generator] = None,
        **kwargs: Any,
    ) -> torch.Tensor:
        sigmas, _ = self._sigmas(num_steps, start_step)
        generator = _generator(generator, x0.device)
        z = x0 + self._randn(x0.shape, x0, generator) * float(sigmas[0])
        return self.sample(
            z, cond=cond, num_steps=num_steps, start_step=start_step, generator=generator,
            initial_sigma_scaled=True, **kwargs,
        )

    def _integrate(self, x, sigmas, t_of, cond, uncond, scale, generator, **kwargs) -> torch.Tensor:
        raise NotImplementedError

    def _integrate_carry(self, x, carry, sigmas, t_of, cond, uncond, scale, generator, **kwargs) -> Tuple[torch.Tensor, Any]:
        """Segment-resumable integration. Stateless by default; the
        multistep samplers thread their history through `carry`."""
        return self._integrate(x, sigmas, t_of, cond, uncond, scale, generator, **kwargs), None


@ISampler.register("k_euler")
class KEulerSampler(IKSampler):
    supports_guidance_interval = True

    def _integrate(self, x, sigmas, t_of, cond, uncond, scale, generator, **kwargs) -> torch.Tensor:
        for i, t in enumerate(t_of):
            sigma, sigma_next = _f32(sigmas[i]), _f32(sigmas[i + 1])
            denoised = self._eps_denoised(x, sigma, t, cond, uncond, scale, **kwargs)
            d = (x - denoised) / sigma
            x = x + d * (sigma_next - sigma)
        return x


@ISampler.register("k_euler_a")
class KEulerAncestralSampler(IKSampler):
    supports_guidance_interval = True
    use_karras = False

    def _integrate(self, x, sigmas, t_of, cond, uncond, scale, generator, **kwargs) -> torch.Tensor:
        for i, t in enumerate(t_of):
            sigma, sigma_next = _f32(sigmas[i]), _f32(sigmas[i + 1])
            denoised = self._eps_denoised(x, sigma, t, cond, uncond, scale, **kwargs)
            up2 = sigma_next**2 * (sigma**2 - sigma_next**2) / torch.clamp(sigma**2, min=1e-20)
            sigma_up = torch.minimum(sigma_next, torch.sqrt(torch.clamp(up2, min=0.0)))
            sigma_down = torch.sqrt(torch.clamp(sigma_next**2 - sigma_up**2, min=0.0))
            d = (x - denoised) / sigma
            x = x + d * (sigma_down - sigma)
            x = x + self._randn(x.shape, x, generator) * sigma_up
        return x


@ISampler.register("k_heun")
class KHeunSampler(IKSampler):
    """Heun's method; the last step (sigma_next = 0) is plain Euler. The
    corrector's timestep comes from sigma_next on the host, so segments are
    exact."""

    supports_guidance_interval = True

    def _integrate(self, x, sigmas, t_of, cond, uncond, scale, generator, **kwargs) -> torch.Tensor:
        ts_next = self._t_at(np.asarray(sigmas)[1:]).astype(np.float32)
        for i, t in enumerate(t_of):
            sigma, sigma_next = _f32(sigmas[i]), _f32(sigmas[i + 1])
            denoised = self._eps_denoised(x, sigma, t, cond, uncond, scale, **kwargs)
            d = (x - denoised) / sigma
            x_euler = x + d * (sigma_next - sigma)
            if float(sigma_next) > 0:
                denoised2 = self._eps_denoised(x_euler, sigma_next, ts_next[i], cond, uncond, scale, **kwargs)
                d2 = (x_euler - denoised2) / torch.clamp(sigma_next, min=1e-20)
                x = x + 0.5 * (d + d2) * (sigma_next - sigma)
            else:
                x = x_euler
        return x


@ISampler.register("klms")
class KLMSSampler(IKSampler):
    """Linear multistep over sigma space (order <= 4), its coefficients the
    integrals of the Lagrange basis on the host (scipy). Segment-safe: the
    derivative history, the trailing sigma window and the global step
    offset thread across segments."""

    use_karras = False
    order = 4
    supports_guidance_interval = True

    def _run(self, x, carry_in, sigmas, t_of, cond, uncond, scale, **kwargs):
        import scipy.integrate as integrate

        n = len(t_of)
        if carry_in is None:
            prev_sig: List[float] = []
            ds_in = None
            g0 = 0
        else:
            ds_in, prev_sig, g0 = carry_in
        # the global sigma window: hist[base + i] is step g0 + i's sigma
        hist = list(prev_sig) + [float(v) for v in np.asarray(sigmas)]
        base = len(prev_sig)
        coeffs = np.zeros((n, self.order), dtype=np.float32)
        for i in range(n):
            cur_order = min(g0 + i + 1, self.order)
            for j in range(cur_order):
                # the integral of the Lagrange basis over [sigma_i, sigma_{i+1}]
                def fn(tau: float, j=j, i=i, cur_order=cur_order) -> float:
                    prod = 1.0
                    for kk in range(cur_order):
                        if kk == j:
                            continue
                        prod *= (tau - hist[base + i - kk]) / (hist[base + i - j] - hist[base + i - kk])
                    return prod

                coeffs[i, j] = integrate.quad(fn, hist[base + i], hist[base + i + 1], epsrel=1e-4)[0]
        zeros = torch.zeros_like(x)
        ds = (zeros, zeros, zeros) if ds_in is None else ds_in
        for i, t in enumerate(t_of):
            sigma = _f32(sigmas[i])
            cf = [_f32(c) for c in coeffs[i]]
            denoised = self._eps_denoised(x, sigma, t, cond, uncond, scale, **kwargs)
            d = (x - denoised) / sigma
            x = x + cf[0] * d + cf[1] * ds[0] + cf[2] * ds[1] + cf[3] * ds[2]
            ds = (d, ds[0], ds[1])
        tail = (list(prev_sig) + [float(v) for v in np.asarray(sigmas)[:-1]])[-(self.order - 1):]
        return x, (ds, tail, g0 + n)

    def _integrate(self, x, sigmas, t_of, cond, uncond, scale, generator, **kwargs) -> torch.Tensor:
        return self._run(x, None, sigmas, t_of, cond, uncond, scale, **kwargs)[0]

    def _integrate_carry(self, x, carry, sigmas, t_of, cond, uncond, scale, generator, **kwargs):
        return self._run(x, carry, sigmas, t_of, cond, uncond, scale, **kwargs)


@ISampler.register("k_dpmpp_2m")
class KDPMpp2MSampler(IKSampler):
    """DPM-Solver++(2M); the multistep history (the last denoised and its
    sigma) threads across segments."""

    supports_guidance_interval = True

    def _run(self, x, carry_in, sigmas, t_of, cond, uncond, scale, **kwargs):
        sig = np.maximum(sigmas, 0.0)

        def t_fn(sigma: torch.Tensor) -> torch.Tensor:
            return -torch.log(torch.clamp(sigma, min=1e-20))

        if carry_in is None:
            old_denoised, sigma_last, is_first = torch.zeros_like(x), _f32(sig[0]), True
        else:
            old_denoised, sigma_last = carry_in
            is_first = False
        for i, t in enumerate(t_of):
            sigma, sigma_next = _f32(sig[i]), _f32(sig[i + 1])
            denoised = self._eps_denoised(x, sigma, t, cond, uncond, scale, **kwargs)
            tt = t_fn(sigma)
            h = t_fn(torch.clamp(sigma_next, min=1e-20)) - tt
            last = float(sigma_next) == 0.0
            ratio = _f32(0.0) if last else sigma_next / sigma
            if is_first or last:
                x = ratio * x - torch.expm1(-h) * denoised
            else:
                h_last = tt - t_fn(torch.clamp(sigma_last, min=1e-20))
                r2 = 2 * torch.clamp(h_last / torch.clamp(h, min=1e-20), min=1e-20)
                denoised_d = (1 + 1 / r2) * denoised - (1 / r2) * old_denoised
                x = ratio * x - torch.expm1(-h) * denoised_d
            old_denoised, sigma_last, is_first = denoised, sigma, False
        return x, (old_denoised, sigma_last)

    def _integrate(self, x, sigmas, t_of, cond, uncond, scale, generator, **kwargs) -> torch.Tensor:
        return self._run(x, None, sigmas, t_of, cond, uncond, scale, **kwargs)[0]

    def _integrate_carry(self, x, carry, sigmas, t_of, cond, uncond, scale, generator, **kwargs):
        return self._run(x, carry, sigmas, t_of, cond, uncond, scale, **kwargs)


@ISampler.register("lcm")
class LCMSampler(ISampler):
    """Latent consistency sampling (4 steps by default): each step's
    consistency boundary scaling (sigma_data 0.5, t / 0.1), then a re-noise
    at the next step's timestep, except on the last step."""

    @torch.no_grad()
    def sample(
        self,
        z: torch.Tensor,
        *,
        cond: Optional[Any] = None,
        uncond: Optional[Any] = None,
        guidance_scale: float = 1.0,
        num_steps: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        start_step: int = 0,
        **kwargs: Any,
    ) -> torch.Tensor:
        num_steps = num_steps or 4
        acp = self._np_acp()
        ts = np.linspace(len(acp) - 1, 0, num_steps).round().astype(np.int64)[start_step:]
        n_exec = len(ts)
        ts_next = np.concatenate([ts[1:], ts[-1:]])
        generator = _generator(generator, z.device)
        b = z.shape[0]
        kwargs, gates = self._pop_control_gate_schedule(dict(kwargs), n_exec)
        sigma_data = 0.5
        t_div = torch.tensor(ts, dtype=torch.float32) / 0.1
        c_skip = sigma_data**2 / (t_div**2 + sigma_data**2)
        c_out = t_div / torch.sqrt(t_div**2 + sigma_data**2)
        x = z
        for i, t in enumerate(ts):
            tb = torch.full((b,), int(t), dtype=torch.long, device=z.device)
            eps = self._denoise(x, tb, cond, uncond, guidance_scale, **self._gated(kwargs, gates, i)).to(x.dtype)
            a_t, a_next = _f32(acp[t]), _f32(acp[ts_next[i]])
            x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
            denoised = c_out[i] * x0 + c_skip[i] * x
            if i == n_exec - 1:
                x = denoised
            else:
                noise = self._randn(x.shape, x, generator)
                x = torch.sqrt(a_next) * denoised + torch.sqrt(1.0 - a_next) * noise
        return x

    def _start_timestep(self, num_steps: int, start_step: int) -> int:
        # LCM's own grid is a plain linspace, not the uniform-stride grid
        acp = self._np_acp()
        ts = np.linspace(len(acp) - 1, 0, num_steps or 4).round().astype(np.int64)
        return int(ts[start_step]) if start_step < len(ts) else 0

    def sample_from(self, x0: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        return _generic_sample_from(self, x0, **kwargs)


@ISampler.register("solver")
class DPMSolverSampler(ISampler):
    """Multistep DPM-Solver, orders 1-3: the discrete schedule's noise
    conversion (log-alpha interpolation over alphas_cumprod) or the
    continuous `linear` / `cosine` VP schedules, the `time_uniform` /
    `logSNR` / `time_quadratic` skip types, data prediction (`predict_x0`,
    DPM-Solver++) or noise prediction, and optional dynamic thresholding.

    Every multistep coefficient is computed on the host in float64 from the
    host-static timesteps; the warm-up steps (growing order) take them as
    Python floats, the steady-state steps as f32 scalars, as the JAX
    package's unrolled warm-up and scanned steady state do."""

    def __init__(
        self,
        model: Any,
        *,
        schedule: str = "discrete",
        order: int = 2,
        skip_type: str = "time_uniform",
        predict_x0: bool = True,
        thresholding: bool = False,
        threshold_max_val: float = 1.0,
        t0: Optional[float] = None,
        tT: Optional[float] = None,
        continuous_beta_0: float = 0.1,
        continuous_beta_1: float = 20.0,
        default_steps: int = 25,
        **kwargs: Any,
    ) -> None:
        super().__init__(model, default_steps=default_steps, **kwargs)
        if order not in (1, 2, 3):
            raise ValueError("solver order must be 1, 2 or 3")
        if schedule not in ("discrete", "linear", "cosine"):
            raise ValueError("only (`discrete` | `linear` | `cosine`) can be used as `schedule`")
        self.order = order
        self.schedule = schedule
        self.skip_type = skip_type
        self.predict_x0 = predict_x0
        self.thresholding = thresholding
        self.threshold_max_val = threshold_max_val
        acp = self._np_acp().astype(np.float64)
        # the model's own grid size: `_model_fn` converts time with it,
        # whatever the solver's noise schedule
        self.model_N = len(acp)
        if schedule == "discrete":
            default_tT = 1.0
            self.total_N = len(acp)
            self._t_array = np.linspace(0.0, 1.0, self.total_N + 1)[1:]
            self._log_alpha_array = 0.5 * np.log(acp)
        else:
            default_tT = 0.9946 if schedule == "cosine" else 1.0
            self.total_N = 1000
            self.beta_0 = continuous_beta_0
            self.beta_1 = continuous_beta_1
            self.cosine_s = 0.008
            self.cosine_log_alpha_0 = math.log(math.cos(self.cosine_s / (1.0 + self.cosine_s) * math.pi / 2.0))
        self.t0 = (1.0 / self.total_N) if t0 is None else t0
        self.tT = default_tT if tT is None else tT

    # ---------------------------------------------------- marginal functions

    def _log_mean_coef(self, t: np.ndarray) -> np.ndarray:
        if self.schedule == "linear":
            return -0.25 * t**2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0
        if self.schedule == "cosine":
            log_alpha = np.log(np.cos((t + self.cosine_s) / (1.0 + self.cosine_s) * math.pi / 2.0))
            return log_alpha - self.cosine_log_alpha_0
        return np.interp(t, self._t_array, self._log_alpha_array)

    def _alpha(self, t: np.ndarray) -> np.ndarray:
        return np.exp(self._log_mean_coef(t))

    def _sigma(self, t: np.ndarray) -> np.ndarray:
        return np.sqrt(1.0 - np.exp(2.0 * self._log_mean_coef(t)))

    def _lambda(self, t: np.ndarray) -> np.ndarray:
        lmc = self._log_mean_coef(t)
        return lmc - 0.5 * np.log(1.0 - np.exp(2.0 * lmc))

    def _inverse_lambda(self, lam: np.ndarray) -> np.ndarray:
        if self.schedule == "linear":
            tmp = 2.0 * (self.beta_1 - self.beta_0) * np.logaddexp(-2.0 * lam, 0.0)
            delta = self.beta_0**2 + tmp
            return tmp / (np.sqrt(delta) + self.beta_0) / (self.beta_1 - self.beta_0)
        if self.schedule == "cosine":
            log_alpha = -0.5 * np.logaddexp(-2.0 * lam, 0.0)
            return (
                np.arccos(np.exp(log_alpha + self.cosine_log_alpha_0)) * 2.0 * (1.0 + self.cosine_s) / math.pi
                - self.cosine_s
            )
        log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * lam)
        # log_alpha_array decreases with t: flip it for np.interp
        return np.interp(log_alpha, self._log_alpha_array[::-1], self._t_array[::-1])

    def _get_time_steps(self, num_steps: int) -> np.ndarray:
        """num_steps + 1 time points from tT down to t0: num_steps updates."""
        t0, tT, n = self.t0, self.tT, num_steps
        if self.skip_type == "logSNR":
            lams = np.linspace(self._lambda(np.float64(tT)), self._lambda(np.float64(t0)), n + 1)
            return self._inverse_lambda(lams)
        if self.skip_type == "time_uniform":
            return np.linspace(tT, t0, n + 1)
        if self.skip_type == "time_quadratic":
            return np.linspace(math.sqrt(tT), math.sqrt(t0), n + 1) ** 2
        raise ValueError(f"unrecognized skip_type '{self.skip_type}' occurred")

    # ------------------------------------------------------------- model fn

    def _threshold(self, x0: torch.Tensor) -> torch.Tensor:
        s = torch.quantile(x0.abs().reshape(x0.shape[0], -1).float(), 0.995, dim=1).to(x0.dtype)
        s = torch.clamp(s, min=self.threshold_max_val).reshape((-1,) + (1,) * (x0.ndim - 1))
        return torch.clamp(x0, -s, s) / s

    def _model_fn(
        self,
        x: torch.Tensor,
        t: float,
        cond: Optional[Any],
        uncond: Optional[Any],
        guidance_scale: float,
        **kwargs: Any,
    ) -> torch.Tensor:
        """eps, or the x0 prediction, at continuous time t: the model's
        timestep is N * max(t - 1 / N, 0), N the model's grid size."""
        ts_model = self.model_N * max(t - 1.0 / self.model_N, 0.0)
        tb = torch.full((x.shape[0],), ts_model, dtype=torch.float32, device=x.device)
        eps = self._denoise(x, tb, cond, uncond, guidance_scale, **kwargs).to(x.dtype)
        if not self.predict_x0:
            return eps
        alpha_t = float(self._alpha(np.float64(t)))
        sigma_t = float(self._sigma(np.float64(t)))
        x0 = (x - sigma_t * eps) / alpha_t
        return self._threshold(x0) if self.thresholding else x0

    # --------------------------------------------------------------- updates

    def _update_coefs(self, t_prevs: List[float], t: float) -> Dict[str, float]:
        """The coefficients of an update from t_prevs[-1] to t;
        len(t_prevs) is the effective order."""
        lam_t = self._lambda(np.float64(t))
        lam_p0 = self._lambda(np.float64(t_prevs[-1]))
        h = float(lam_t - lam_p0)
        out: Dict[str, float] = {"h": h}
        if self.predict_x0:
            out["x_coef"] = float(self._sigma(np.float64(t)) / self._sigma(np.float64(t_prevs[-1])))
            out["m_coef"] = float(self._alpha(np.float64(t)) * np.expm1(-h))
        else:
            out["x_coef"] = float(np.exp(self._log_mean_coef(np.float64(t)) - self._log_mean_coef(np.float64(t_prevs[-1]))))
            out["m_coef"] = float(self._sigma(np.float64(t)) * np.expm1(h))
        if len(t_prevs) >= 2:
            h_0 = float(self._lambda(np.float64(t_prevs[-1])) - self._lambda(np.float64(t_prevs[-2])))
            out["inv_r0"] = h / h_0
        if len(t_prevs) >= 3:
            h_1 = float(self._lambda(np.float64(t_prevs[-2])) - self._lambda(np.float64(t_prevs[-3])))
            r0, r1 = h_0 / h, h_1 / h
            out["r0"] = r0
            out["r1"] = r1
            alpha_t = float(self._alpha(np.float64(t)))
            sigma_t = float(self._sigma(np.float64(t)))
            if self.predict_x0:
                em = np.expm1(-h)
                out["d1_coef"] = float(alpha_t * (em / h + 1.0))
                out["d2_coef"] = float(-alpha_t * ((em + h) / h**2 - 0.5))
            else:
                ep = np.expm1(h)
                out["d1_coef"] = float(-sigma_t * (ep / h - 1.0))
                out["d2_coef"] = float(-sigma_t * ((ep - h) / h**2 - 0.5))
        return out

    @staticmethod
    def _apply_update(x: torch.Tensor, models: List[torch.Tensor], c: Dict[str, Any]) -> torch.Tensor:
        """The order-k update (k = len(models)); the coefficients are Python
        floats or f32 scalars."""
        m0 = models[-1]
        x_t = c["x_coef"] * x - c["m_coef"] * m0
        if len(models) == 1:
            return x_t
        d1_0 = c["inv_r0"] * (m0 - models[-2])
        if len(models) == 2:
            return x_t - 0.5 * c["m_coef"] * d1_0
        m1, m2 = models[-2], models[-3]
        d1_0 = (1.0 / c["r0"]) * (m0 - m1)
        d1_1 = (1.0 / c["r1"]) * (m1 - m2)
        d1 = d1_0 + (c["r0"] / (c["r0"] + c["r1"])) * (d1_0 - d1_1)
        d2 = (1.0 / (c["r0"] + c["r1"])) * (d1_0 - d1_1)
        return x_t + c["d1_coef"] * d1 + c["d2_coef"] * d2

    # ----------------------------------------------------------------- sample

    @torch.no_grad()
    def sample(
        self,
        z: torch.Tensor,
        *,
        cond: Optional[Any] = None,
        uncond: Optional[Any] = None,
        guidance_scale: float = 1.0,
        num_steps: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        start_step: int = 0,
        **kwargs: Any,
    ) -> torch.Tensor:
        num_steps = num_steps or self.default_steps
        ts = self._get_time_steps(num_steps)  # tT -> t0, num_steps + 1 points
        if start_step:
            ts = ts[start_step:]
        total = len(ts)
        order = min(self.order, max(total - 1, 1))
        x = z
        # the model evaluations happen at indices 0 .. total - 2
        kwargs, gates = self._pop_control_gate_schedule(dict(kwargs), max(total - 1, 1))

        def mf(x_: torch.Tensor, t_: float, idx: int) -> torch.Tensor:
            return self._model_fn(x_, t_, cond, uncond, guidance_scale, **self._gated(kwargs, gates, idx))

        # warm-up: step 0 records; steps 1 .. order - 1 run with growing order
        t_prevs: List[float] = [float(ts[0])]
        models: List[torch.Tensor] = [mf(x, float(ts[0]), 0)]
        for i in range(1, order):
            t = float(ts[i])
            x = self._apply_update(x, models, self._update_coefs(t_prevs[-len(models):], t))
            t_prevs.append(t)
            models.append(mf(x, t, i))
            if len(models) > order:
                t_prevs.pop(0)
                models.pop(0)

        # steady state at full order (the JAX scan: f32 coefficients), then
        # the final update without a model evaluation after it
        win = list(t_prevs)
        for i in range(order, total - 1):
            t = float(ts[i])
            c = {k: _f32(v) for k, v in self._update_coefs(win[-order:], t).items()}
            win = (win + [t])[-order:]
            x = self._apply_update(x, models, c)
            tb = torch.full((x.shape[0],), self.total_N * max(t - 1.0 / self.total_N, 0.0), dtype=torch.float32,
                            device=x.device)
            eps = self._denoise(x, tb, cond, uncond, guidance_scale, **self._gated(kwargs, gates, i)).to(x.dtype)
            if self.predict_x0:
                a_t, s_t = _f32(self._alpha(np.float64(t))), _f32(self._sigma(np.float64(t)))
                m_new = (x - s_t * eps) / a_t
                if self.thresholding:
                    m_new = self._threshold(m_new)
            else:
                m_new = eps
            models = models[1:] + [m_new]
        if total > 1:
            x = self._apply_update(x, models, self._update_coefs(win[-order:], float(ts[-1])))
        return x

    def _start_timestep(self, num_steps: int, start_step: int) -> int:
        # the solver integrates its own continuous grid: q-sample to the
        # model timestep of the start point
        ts = self._get_time_steps(num_steps or self.default_steps)
        t = float(ts[min(start_step, len(ts) - 1)])
        return int(round(self.total_N * max(t - 1.0 / self.total_N, 0.0)))

    def sample_from(self, x0: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        return _generic_sample_from(self, x0, **kwargs)


class IQSampler:
    """Forward-noising interface."""

    def __init__(self, model: Any) -> None:
        self.model = model

    def q_sample(
        self,
        net: torch.Tensor,
        timesteps: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        raise NotImplementedError


class DDPMQSampler(IQSampler):
    """q(x_t | x_0) with the model's cumulative-alpha schedule; without
    `noise` it draws N(0, 1) from `generator` (seed 0 when none is given)."""

    def q_sample(
        self,
        net: torch.Tensor,
        timesteps: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if noise is None:
            generator = _generator(generator, net.device)
            noise = torch.randn(net.shape, generator=generator, device=net.device, dtype=net.dtype)
        return self.model.q_sample(net, timesteps, noise)


def is_misc_key(key: str) -> bool:
    """Condition-dict keys that are not cross-attention context."""
    from .utils import CONCAT_KEY, CONTROL_HINT_END_KEY, CONTROL_HINT_KEY, CONTROL_HINT_START_KEY

    return key in (CONCAT_KEY, CONTROL_HINT_KEY, CONTROL_HINT_START_KEY, CONTROL_HINT_END_KEY)


# the reference's name of DDIM's step
DDIMMixin = DDIMSampler
