"""Adversarial autoencoder training (counterpart of
`cflearn_tpu/models/cv/ae.py`: `AEGeneratorStep`, `AEDiscriminatorStep`,
`AEModel`).

One train step is two scopes in order: `core` (the autoencoder: L1
reconstruction, KL x `kl_weight`, an optional learned reconstruction
log-variance, and the adversarial term -mean(D(recon)) x `d_weight` once the
discriminator plays) and `discriminator` (the PatchGAN: hinge on the inputs
and on the detached reconstruction of a new forward).

Not ported yet: the LPIPS perceptual term (its pretrained weights are not in
the repository, so `use_perceptual=True` raises), the adaptive discriminator
weight (`use_adaptive_weight=True` raises `NotImplementedError`), and the VQ
variant (`ae_vq`). The schema classes (`IDLModel`, `TrainStep`, `DLConfig`)
are not ported either: the class, method and option names are kept for them.
"""

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ...device import resolve_device
from ...modules.common import cast_parameters, init_parameters
from ...modules.cv.ae import AutoEncoderKL
from ...modules.cv.common import discriminators
from ...modules.cv.gan import NLayerDiscriminator  # noqa: F401  (registers "basic")
from .diffusion import INPUT_KEY, LOSS_KEY
from .gan import gan_loss

PREDICTIONS_KEY = "predictions"


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
        d_weight: float = 0.5,
        d_factor: float = 1.0,
        use_adaptive_weight: bool = False,
    ) -> None:
        self.kl_weight = kl_weight
        self.d_weight = d_weight
        self.d_factor = d_factor
        self.use_adaptive_weight = use_adaptive_weight
        # scope -> whether that scope's step runs in this train step; set by
        # the trainer before every step
        self.step_actives: Dict[str, bool] = {}

    def should_skip(self, m: "AEModel", state: Any) -> bool:
        return False

    def loss_fn(
        self, m: "AEModel", batch: Dict[str, Any], forward_results: Dict[str, Any], **kwargs: Any
    ) -> Dict[str, torch.Tensor]:
        inputs = batch[INPUT_KEY]
        recon = forward_results[PREDICTIONS_KEY]
        l1 = (inputs - recon).abs().mean()
        losses = {"l1": l1}
        nll_loss = l1
        if m.log_var is not None:
            # learned reconstruction variance: nll = recon / exp(log_var) + log_var
            nll_loss = nll_loss / torch.exp(m.log_var) + m.log_var
        total = nll_loss
        if "distribution" in forward_results:
            kl = forward_results["distribution"].kl().mean()
            losses["kl"] = kl
            total = total + self.kl_weight * kl
        # the adversarial term only once the discriminator step is live
        d_on = m.discriminator is not None and self.step_actives.get("discriminator", True)
        if d_on and self.d_factor > 0:
            g_loss = _g_loss(m.discriminator(recon))
            losses["g"] = g_loss
            d_weight = self._adaptive_weight(m, recon) if self.use_adaptive_weight else self.d_weight
            total = total + d_weight * self.d_factor * g_loss
        losses[LOSS_KEY] = total
        return losses

    def _adaptive_weight(self, m: "AEModel", recon: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "the adaptive discriminator weight (ratio of the gradient norms at the reconstruction) "
            "is not ported yet; use the fixed d_weight"
        )


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
    """`ae_kl` with its PatchGAN discriminator. `module_config` is the
    `AutoEncoderKL` config plus the training options the JAX model pops from
    it (`use_discriminator`, `use_perceptual`, `kl_weight`,
    `d_loss_start_step`, `d_weight`, `d_factor`, `d_loss`,
    `use_adaptive_weight`, `log_var_init`; `perceptual_weight` is accepted
    and unused)."""

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
        module_config.pop("perceptual_weight", None)  # weighs the LPIPS term, which is not ported
        self.use_adaptive_weight = module_config.pop("use_adaptive_weight", False)
        log_var_init = module_config.pop("log_var_init", None)
        if use_perceptual:
            raise NotImplementedError(
                "use_perceptual=True needs the pretrained LPIPS weights, which are not in the "
                "repository; pass use_perceptual=False"
            )
        self.perceptual = None
        self.log_var = None if log_var_init is None else nn.Parameter(torch.tensor(float(log_var_init)))
        self.m = AutoEncoderKL(**module_config)
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

    @property
    def train_steps(self) -> List[Any]:
        steps: List[Any] = [
            AEGeneratorStep(
                kl_weight=self.kl_weight, d_weight=self.d_weight, d_factor=self.d_factor,
                use_adaptive_weight=self.use_adaptive_weight,
            )
        ]
        if self.discriminator is not None:
            steps.append(AEDiscriminatorStep(d_factor=self.d_factor, d_loss=self.d_loss_mode))
        return steps

    def params_filter(self, scope: str) -> List[Tuple[str, nn.Parameter]]:
        """(name, parameter) of what `scope` trains: the discriminator's
        parameters, or everything else (the autoencoder and `log_var`)."""
        want = scope == "discriminator"
        return [(n, p) for n, p in self.named_parameters() if ("discriminator" in n.split(".")) == want]

    def run(self, batch: Dict[str, Any], *, training: bool = False, **kwargs: Any) -> Dict[str, Any]:
        """The forward of a step: the autoencoder on the batch's input.
        `kwargs` (`sample`, `generator`, `noise`) reach `AutoEncoderKL.forward`."""
        self.train(training)
        return self.m(batch[INPUT_KEY], **kwargs)

    def post_step_update(self) -> None:
        pass


def build_ae(
    module_config: Optional[Dict[str, Any]] = None, *, device: Any = None, dtype: torch.dtype = torch.float32,
    seed: int = 0,
) -> AEModel:
    """Entry point: an `AEModel` with seeded random parameters in `dtype`
    (BatchNorm's running statistics stay f32) on `device`: CUDA unless the
    caller asks for another device."""
    device = resolve_device(device)
    with torch.device(device):
        model = AEModel(module_config)
    log_var = None if model.log_var is None else model.log_var.detach().clone()
    init_parameters(model, seed)
    if log_var is not None:
        with torch.no_grad():
            model.log_var.copy_(log_var)
    return cast_parameters(model, dtype)
