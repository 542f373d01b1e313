"""DDPM training semantics (counterpart of `cflearn_tpu/models/cv/diffusion.py`).

`DDPMStep.loss_fn` is the p-loss: MSE against the eps / x0 / v target,
reweighted by the (optionally learned) per-timestep log-variance, plus an
optional VLB term. `DDPMModel` wraps a `DDPM` with an optional `EMA`, names
the parameters a scope trains, runs the monitoring forward and the post-step
update. The batch's input is what the model diffuses: x0 for a plain DDPM;
for an LDM with a first stage, images, which the frozen first stage encodes
to its scaled latents first, without a gradient (the JAX `stop_gradient`:
the encoder's activations stay off the autograd tape).

`DDPMModel` is the `IDLModel` registered as "ddpm": `IDLModel.from_config(
DLConfig(model="ddpm", module_name="sd", module_config={...}))` builds the
registered module from `module_config` (its `ema_decay` entry adds the EMA)
and takes the loss weights from `loss_config`; `DDPMModel(module)` wraps a
module built already.

The JAX package draws t and the noise from the model's `nnx.Rngs`; here the
draws take an explicit `torch.Generator` (by default the model's `default`
generator, which `from_config` seeds, else PyTorch's global one), or the
caller passes `t` and `noise`, so that a test can feed both packages the
same draws.
"""

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn

from ...constants import INPUT_KEY, LOSS_KEY, PREDICTIONS_KEY
from ...modules.common import EMA, build_module
from ...modules.multimodal.diffusion.ddpm import DDPM
from ...modules.multimodal.diffusion.ldm import LDM
from ...parallel.mesh import global_randint, global_randn
from ...schema.config import DLConfig
from ...schema.model import IDLModel, TrainStep


def _to_diffusion_space(ddpm: DDPM, x0: torch.Tensor) -> torch.Tensor:
    """An LDM's images -> its first stage's scaled latents, without a
    gradient; a plain DDPM's x0 as it is."""
    if isinstance(ddpm, LDM) and ddpm.first_stage is not None:
        with torch.no_grad():
            return ddpm.encode_first_stage(x0)
    return x0


class DDPMStep(TrainStep):
    """p-losses: per-sample simple loss reweighted by the (optionally
    learned) per-timestep log-variance, plus an optional VLB term
    (`original_elbo_weight`)."""

    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0
    # the loss draws its own t and noise and reads no forward results
    uses_forward_results = False

    def loss_fn(
        self,
        m: "DDPMModel",
        batch: Dict[str, Any],
        forward_results: Optional[Dict[str, Any]] = None,
        *,
        generator: Optional[torch.Generator] = None,
        t: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        ddpm: DDPM = m.m
        x0 = _to_diffusion_space(ddpm, batch[INPUT_KEY])
        b = x0.shape[0]
        if generator is None:
            generator = getattr(m, "rngs", {}).get("default")
        # drawn for the global batch and sliced where a mesh shards it (`parallel.mesh`), as the JAX step draws
        if t is None:
            t = global_randint(0, ddpm.num_timesteps, (b,), generator=generator, device=x0.device)
        if noise is None:
            noise = global_randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
        x_t = ddpm.q_sample(x0, t, noise)
        cond = batch.get("cond")
        if cond is not None:
            cond = ddpm.get_cond(cond)
        model_out = ddpm.denoise(x_t, t, cond)
        if ddpm.parameterization == "eps":
            target = noise
        elif ddpm.parameterization == "x0":
            target = x0
        else:  # v
            target = ddpm.get_v(x0, noise, t)
        per_sample = (model_out - target).square().mean(dim=tuple(range(1, x0.ndim)))
        losses = {"simple": per_sample.mean()}
        log_var_t = ddpm.log_var[t]
        loss_simple = per_sample / torch.exp(log_var_t) + log_var_t
        if ddpm.learn_log_var:
            losses["gamma"] = loss_simple.mean()
            losses["log_var"] = ddpm.log_var.mean()
        loss = self.l_simple_weight * loss_simple.mean()
        if self.original_elbo_weight > 0:
            loss_vlb = (ddpm.lvlb_weights[t] * per_sample).mean()
            losses["vlb"] = loss_vlb
            loss = loss + self.original_elbo_weight * loss_vlb
        losses[LOSS_KEY] = loss
        return losses


@IDLModel.register("ddpm")
class DDPMModel(IDLModel):
    """A DDPM-family module with an optional EMA of its parameters."""

    def __init__(
        self,
        m: Union[DDPM, DLConfig, None] = None,
        *,
        ema_decay: Optional[float] = None,
        l_simple_weight: float = 1.0,
        original_elbo_weight: float = 0.0,
    ) -> None:
        if m is None or isinstance(m, DLConfig):  # `from_config` builds it
            super().__init__(m)
            return
        super().__init__(DLConfig(model="ddpm"))
        self._setup(m, ema_decay, l_simple_weight, original_elbo_weight)

    def build(self, config: DLConfig) -> None:
        self.rngs = self.make_rngs()
        module_config = dict(config.module_config or {})
        ema_decay = module_config.pop("ema_decay", None)
        m = build_module(
            config.module_name or "ddpm", config=module_config, device=self.build_device,
            generator=self.rngs["params"],
        )
        loss_config = dict(config.loss_config or {})
        self._setup(
            m, ema_decay, loss_config.get("l_simple_weight", 1.0), loss_config.get("original_elbo_weight", 0.0)
        )

    def _setup(self, m: DDPM, ema_decay: Optional[float], l_simple_weight: float, original_elbo_weight: float) -> None:
        self.m = m
        self._l_simple_weight = float(l_simple_weight)
        self._original_elbo_weight = float(original_elbo_weight)
        self.ema = EMA(ema_decay, m) if ema_decay is not None else None

    @property
    def train_steps(self) -> List[DDPMStep]:
        step = DDPMStep("all")
        step.l_simple_weight = self._l_simple_weight
        step.original_elbo_weight = self._original_elbo_weight
        return [step]

    def params_filter(self, scope: str) -> List[Tuple[str, nn.Parameter]]:
        """(name, parameter) of what `scope` trains: the UNet (and a learned
        log-variance), but no EMA shadow, not the first stage, and the
        condition model only when `condition_learnable`."""
        learn_cond = getattr(self.m, "condition_learnable", True)
        out = []
        for name, p in self.named_parameters():
            parts = name.split(".")
            if "ema" in parts or "first_stage" in parts:
                continue
            if not learn_cond and "condition_model" in parts:
                continue
            out.append((name, p))
        return out

    def run(
        self,
        batch: Dict[str, Any],
        *,
        training: bool = False,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        **kwargs: Any,
    ) -> Dict[str, torch.Tensor]:
        """The forward for monitoring: one denoise of the input noised to
        t = num_timesteps // 2 (noise from `generator`, or given). The p-loss
        does not read it."""
        self.set_mode(training)
        ddpm: DDPM = self.m
        x0 = _to_diffusion_space(ddpm, batch[INPUT_KEY])
        t = torch.full((x0.shape[0],), ddpm.num_timesteps // 2, dtype=torch.long, device=x0.device)
        if noise is None:
            noise = torch.randn(
                x0.shape, generator=generator or self.rngs.get("default"), device=x0.device, dtype=x0.dtype
            )
        x_t = ddpm.q_sample(x0, t, noise)
        cond = batch.get("cond")
        if cond is not None:
            cond = ddpm.get_cond(cond)
        return {PREDICTIONS_KEY: ddpm.denoise(x_t, t, cond), "noise": noise, "timesteps": t}

    def post_step_update(self) -> None:
        if self.ema is not None:
            self.ema.update(self.m)

    @property
    def all_modules(self) -> List[nn.Module]:
        return [self.m] if self.ema is None else [self.m, self.ema]
