"""Adversarial autoencoder training (counterpart of
`cflearn_tpu/models/cv/ae.py`: `AEGeneratorStep`, `AEDiscriminatorStep`,
`AEModel` ("ae_kl") and `AEVQModel` ("ae_vq")).

One train step is two scopes in order: `core` (the autoencoder: L1
reconstruction plus `perceptual_weight` x LPIPS, an optional learned
reconstruction log-variance, KL x `kl_weight` or the VQ codebook and
commitment terms, and the adversarial term -mean(D(recon)) x `d_weight` once
the discriminator plays) and `discriminator` (the PatchGAN: hinge on the
inputs and on the detached reconstruction of a new forward).

With `use_adaptive_weight` the adversarial weight is the ratio of the
gradient norms of the reconstruction term and of the adversarial term, both
taken at the reconstruction (a detached leaf, so the outer backward gets no
second path), clipped to [0, 1e4], detached and times `d_weight`; the
discriminator runs in eval mode for it (its BatchNorm statistics untouched).

LPIPS (`use_perceptual`, on by default as in the JAX package) is frozen: the
`core` scope does not train it. Its pretrained weights are not in the
repository, so the model takes random ones with the JAX package's warning.
The schema classes (`IDLModel`, `TrainStep`, `DLConfig`) are not ported: the
class, method and option names are kept for them.
"""

import math
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ...device import resolve_device
from ...losses.lpips import LPIPS
from ...modules.common import cast_parameters, init_parameters
from ...modules.cv.ae import AutoEncoderKL, AutoEncoderVQ  # noqa: F401  (register the generators)
from ...modules.cv.common import discriminators, generators
from ...modules.cv.gan import NLayerDiscriminator  # noqa: F401  (registers "basic")
from .diffusion import INPUT_KEY, LOSS_KEY, PREDICTIONS_KEY
from .gan import gan_loss


def _g_loss(logits: Any) -> torch.Tensor:
    """Generator adversarial term: -mean(fake), whatever the d_loss mode."""
    if isinstance(logits, list):
        return sum(_g_loss(item) for item in logits) / len(logits)
    return -logits.mean()


class AEGeneratorStep:
    scope = "core"
    requires_grad_in_forward = True

    def __init__(
        self,
        *,
        kl_weight: float = 1.0e-6,
        perceptual_weight: float = 1.0,
        d_weight: float = 0.5,
        d_factor: float = 1.0,
        d_loss: str = "hinge",
        use_adaptive_weight: bool = False,
    ) -> None:
        self.kl_weight = kl_weight
        self.perceptual_weight = perceptual_weight
        self.d_weight = d_weight
        self.d_factor = d_factor
        self.d_loss = d_loss
        self.use_adaptive_weight = use_adaptive_weight
        # scope -> whether that scope's step runs in this train step; set by
        # the trainer before every step
        self.step_actives: Dict[str, bool] = {}
        # the adversarial weight of the last loss (detached), with use_adaptive_weight
        self.adaptive_weight: Optional[torch.Tensor] = None

    def should_skip(self, m: "AEModel", state: Any) -> bool:
        return False

    def loss_fn(
        self, m: "AEModel", batch: Dict[str, Any], forward_results: Dict[str, Any], **kwargs: Any
    ) -> Dict[str, torch.Tensor]:
        inputs = batch[INPUT_KEY]
        recon = forward_results[PREDICTIONS_KEY]
        use_perceptual = m.perceptual is not None and self.perceptual_weight > 0

        def nll_of(r: torch.Tensor, perceptual: Optional[torch.Tensor] = None) -> torch.Tensor:
            net = (inputs - r).abs().mean()
            if use_perceptual:
                if perceptual is None:
                    perceptual = m.perceptual(r, inputs).mean()
                net = net + self.perceptual_weight * perceptual
            if m.log_var is not None:
                # learned reconstruction variance: nll = recon / exp(log_var) + log_var
                net = net / torch.exp(m.log_var) + m.log_var
            return net

        losses = {"l1": (inputs - recon).abs().mean()}
        perceptual = None
        if use_perceptual:
            perceptual = losses["perceptual"] = m.perceptual(recon, inputs).mean()
        total = nll_of(recon, perceptual)
        if "distribution" in forward_results:
            kl = forward_results["distribution"].kl().mean()
            losses["kl"] = kl
            total = total + self.kl_weight * kl
        if "codebook_loss" in forward_results:
            vq = forward_results["codebook_loss"] + 0.25 * forward_results["commitment_loss"]
            losses["vq"] = vq
            total = total + vq
        # the adversarial term only once the discriminator step is live
        d_on = m.discriminator is not None and self.step_actives.get("discriminator", True)
        if d_on and self.d_factor > 0:
            g_loss = _g_loss(m.discriminator(recon))
            losses["g"] = g_loss
            d_weight = self._adaptive_weight(m, nll_of, recon) if self.use_adaptive_weight else self.d_weight
            total = total + d_weight * self.d_factor * g_loss
        losses[LOSS_KEY] = total
        return losses

    def _adaptive_weight(self, m: "AEModel", nll_of: Callable[[torch.Tensor], torch.Tensor], recon: torch.Tensor) -> torch.Tensor:
        """||d nll / d recon|| / (||d g / d recon|| + 1e-4), clipped to [0,
        1e4], detached, x d_weight: both gradients at a detached copy of the
        reconstruction, the discriminator (and LPIPS) in eval mode."""
        leaf = recon.detach().requires_grad_()
        m.discriminator.eval()
        if m.perceptual is not None:
            m.perceptual.eval()
        try:
            with torch.enable_grad():
                (nll_grads,) = torch.autograd.grad(nll_of(leaf), leaf)
                (g_grads,) = torch.autograd.grad(_g_loss(m.discriminator(leaf)), leaf)
        finally:
            m.discriminator.train()
        weight = torch.linalg.vector_norm(nll_grads) / (torch.linalg.vector_norm(g_grads) + 1.0e-4)
        self.adaptive_weight = weight.clamp(0.0, 1.0e4).detach() * self.d_weight
        return self.adaptive_weight


class AEDiscriminatorStep:
    scope = "discriminator"
    requires_grad_in_forward = False

    def __init__(self, *, d_factor: float = 1.0, d_loss: str = "hinge") -> None:
        self.d_factor = d_factor
        self.d_loss = d_loss
        self.step_actives: Dict[str, bool] = {}

    def should_skip(self, m: "AEModel", state: Any) -> bool:
        # the adversarial game starts at `d_loss_start_step`
        return state is not None and state.step < m.d_loss_start_step

    def loss_fn(
        self, m: "AEModel", batch: Dict[str, Any], forward_results: Dict[str, Any], **kwargs: Any
    ) -> Dict[str, torch.Tensor]:
        inputs = batch[INPUT_KEY]
        recon = forward_results[PREDICTIONS_KEY].detach()
        d_real = gan_loss(m.discriminator(inputs), True, mode=self.d_loss)
        d_fake = gan_loss(m.discriminator(recon), False, mode=self.d_loss)
        d_loss = self.d_factor * 0.5 * (d_real + d_fake)
        return {LOSS_KEY: d_loss, "d": d_loss}


class AEModel(nn.Module):
    """`ae_kl` with its PatchGAN discriminator and LPIPS. `module_config` is
    the generator's config plus the training options the JAX model pops
    from it (`use_discriminator`, `use_perceptual`, `kl_weight`,
    `d_loss_start_step`, `d_weight`, `d_factor`, `d_loss`,
    `perceptual_weight`, `use_adaptive_weight`, `log_var_init`)."""

    module_name = "ae_kl"

    def __init__(self, module_config: Optional[Dict[str, Any]] = None) -> None:
        super().__init__()
        module_config = dict(module_config or {})
        use_discriminator = module_config.pop("use_discriminator", True)
        use_perceptual = module_config.pop("use_perceptual", True)
        self.kl_weight = module_config.pop("kl_weight", 1.0e-6)
        self.d_loss_start_step = module_config.pop("d_loss_start_step", 0)
        self.d_weight = module_config.pop("d_weight", 0.5)
        self.d_factor = module_config.pop("d_factor", 1.0)
        self.d_loss_mode = module_config.pop("d_loss", "hinge")
        self.perceptual_weight = module_config.pop("perceptual_weight", 1.0)
        self.use_adaptive_weight = module_config.pop("use_adaptive_weight", False)
        log_var_init = module_config.pop("log_var_init", None)
        self.log_var = None if log_var_init is None else nn.Parameter(torch.tensor(float(log_var_init)))
        self.m = generators.build(self.module_name, **module_config)
        if use_discriminator:
            # cap the PatchGAN depth by the image size: each layer halves the
            # map, and a zero-sized output turns the hinge means into NaN
            img_size = int(module_config.get("img_size", 64))
            max_layers = max(1, int(math.log2(max(2, img_size))) - 2)
            self.discriminator = discriminators.build(
                "basic", in_channels=module_config.get("out_channels", 3), num_layers=min(3, max_layers)
            )
        else:
            self.discriminator = None
        if use_perceptual:
            warnings.warn("LPIPS pretrained weights unavailable; using random weights")
            self.perceptual = LPIPS()
        else:
            self.perceptual = None

    @property
    def train_steps(self) -> List[Any]:
        steps: List[Any] = [
            AEGeneratorStep(
                kl_weight=self.kl_weight, perceptual_weight=self.perceptual_weight, d_weight=self.d_weight,
                d_factor=self.d_factor, d_loss=self.d_loss_mode, use_adaptive_weight=self.use_adaptive_weight,
            )
        ]
        if self.discriminator is not None:
            steps.append(AEDiscriminatorStep(d_factor=self.d_factor, d_loss=self.d_loss_mode))
        return steps

    def params_filter(self, scope: str) -> List[Tuple[str, nn.Parameter]]:
        """(name, parameter) of what `scope` trains: the discriminator's
        parameters, or the autoencoder's (and `log_var`); LPIPS is frozen."""
        if scope == "discriminator":
            return [(n, p) for n, p in self.named_parameters() if n.split(".")[0] == "discriminator"]
        return [(n, p) for n, p in self.named_parameters() if n.split(".")[0] not in ("discriminator", "perceptual")]

    def run(self, batch: Dict[str, Any], *, training: bool = False, **kwargs: Any) -> Dict[str, Any]:
        """The forward of a step: the autoencoder on the batch's input.
        `kwargs` (`sample`, `generator`, `noise`) reach `AutoEncoderKL.forward`."""
        self.train(training)
        return self.m(batch[INPUT_KEY], **kwargs)

    def post_step_update(self) -> None:
        pass


class AEVQModel(AEModel):
    """`ae_vq`: the VQ autoencoder, its `vq` loss term (codebook + 0.25 x
    commitment) in place of the KL."""

    module_name = "ae_vq"


ae_models = {"ae_kl": AEModel, "ae_vq": AEVQModel}


def build_ae(
    module_config: Optional[Dict[str, Any]] = None, *, model: str = "ae_kl", device: Any = None,
    dtype: torch.dtype = torch.float32, seed: int = 0,
) -> AEModel:
    """Entry point: an `AEModel` ("ae_kl") or `AEVQModel` ("ae_vq") with
    seeded random parameters in `dtype` (buffers: BatchNorm's running
    statistics and LPIPS's constants stay f32) on `device`: CUDA unless the
    caller asks for another device."""
    if model not in ae_models:
        raise ValueError(f"autoencoder model '{model}' is not one of {sorted(ae_models)}")
    device = resolve_device(device)
    with torch.device(device):
        ae = ae_models[model](module_config)
    log_var = None if ae.log_var is None else ae.log_var.detach().clone()
    init_parameters(ae, seed)
    if log_var is not None:
        with torch.no_grad():
            ae.log_var.copy_(log_var)
    return cast_parameters(ae, dtype)
