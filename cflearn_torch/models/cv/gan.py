"""GAN training (counterpart of `cflearn_tpu/models/cv/gan.py`): `gan_loss`,
`GANTarget`, `DiscriminatorOutput`, `gradient_norm_penalty`, the two steps
`GeneratorStep` (scope "core") and `DiscriminatorStep` ("discriminator",
on a new forward without a gradient), and `GANModel` ("gan").

The generator draws z (and the penalty's mix eps) from the model's
"default" generator through `IConditional._randn` / `_uniform`, in the JAX
model's order: the core step's z, the discriminator step's z, then eps.
The gradient penalty differentiates the discriminator at the mix with
`create_graph`, the discriminator in eval mode there, as in the JAX step."""

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...constants import INPUT_KEY, LABEL_KEY, LOSS_KEY, PREDICTIONS_KEY
from ...modules.common import build_module, init_parameters
from ...modules.cv import gan as _gan_modules  # noqa: F401  (register "gan", "basic", "multi_scale")
from ...modules.cv.common import discriminators
from ...schema.config import DLConfig
from ...schema.losses_schema import loss_dict_type
from ...schema.model import IDLModel, TrainStep
from ..common import attach_generator


class GANTarget(NamedTuple):
    target_is_real: bool
    labels: Optional[torch.Tensor] = None


class DiscriminatorOutput(NamedTuple):
    """(patch logits, optional class logits)."""

    output: Any
    cond_logits: Optional[torch.Tensor] = None


def gan_loss(logits: Any, target_real: bool, *, mode: str = "vanilla") -> torch.Tensor:
    """vanilla (BCE on logits), lsgan (MSE), wgangp (+-mean; the gradient
    penalty belongs to the discriminator step) and hinge (the autoencoders'
    adversarial loss). A list of logits (multi-scale) is averaged."""
    if isinstance(logits, list):
        return sum(gan_loss(item, target_real, mode=mode) for item in logits) / len(logits)
    if mode == "hinge":
        return F.relu(1.0 - logits).mean() if target_real else F.relu(1.0 + logits).mean()
    if mode == "lsgan":
        return (logits - (1.0 if target_real else 0.0)).square().mean()
    if mode == "wgangp":
        return -logits.mean() if target_real else logits.mean()
    target = torch.ones_like(logits) if target_real else torch.zeros_like(logits)
    return -(target * F.logsigmoid(logits) + (1.0 - target) * F.logsigmoid(-logits)).mean()


def gradient_norm_penalty(disc: nn.Module, x: torch.Tensor, *, k: float = 1.0) -> torch.Tensor:
    """mean over samples of (||d sum(D(x)) / dx||_2 - k)^2, differentiable
    in D's parameters (the gradient is taken with `create_graph`)."""
    x = x.detach().requires_grad_()
    with torch.enable_grad():
        (grads,) = torch.autograd.grad(disc(x).sum(), x, create_graph=True)
    norms = torch.linalg.vector_norm(grads.reshape(x.shape[0], -1), dim=1)
    return (norms - k).square().mean()


def _cond_ce(cond_logits: Optional[torch.Tensor], labels: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if cond_logits is None or labels is None:
        return None
    log_probs = torch.log_softmax(cond_logits, dim=-1)
    return -log_probs.gather(-1, labels.reshape(-1, 1).long()).mean()


class GeneratorStep(TrainStep):
    """The generator's loss: the adversarial term on its samples as real
    (plus the class head's cross entropy against the batch's labels)."""

    def __init__(self, *, loss_mode: str = "vanilla") -> None:
        super().__init__("core")
        self.loss_mode = loss_mode

    def loss_fn(self, m: "GANModel", batch: Dict[str, Any], forward_results: Dict[str, Any], **kwargs: Any) -> loss_dict_type:
        logits, cond_logits = m.discriminate(forward_results[PREDICTIONS_KEY])
        g_loss = gan_loss(logits, True, mode=self.loss_mode)
        losses = {"g": g_loss}
        ce = _cond_ce(cond_logits, batch.get(LABEL_KEY))
        if ce is not None:
            losses["g_cond"] = ce
            g_loss = g_loss + ce
        losses[LOSS_KEY] = g_loss
        return losses


class DiscriminatorStep(TrainStep):
    """The discriminator's loss on the batch (real, plus the class head's
    cross entropy) and on a new forward's samples (fake), averaged; with
    "wgangp" plus `lambda_gp` x the gradient penalty at eps real + (1 - eps)
    fake, one eps ~ U[0, 1) a step."""

    def __init__(self, *, loss_mode: str = "vanilla", lambda_gp: float = 10.0) -> None:
        super().__init__("discriminator", requires_new_forward=True, requires_grad_in_forward=False)
        self.loss_mode = loss_mode
        self.lambda_gp = lambda_gp

    def loss_fn(self, m: "GANModel", batch: Dict[str, Any], forward_results: Dict[str, Any], **kwargs: Any) -> loss_dict_type:
        real = batch[INPUT_KEY]
        fake = forward_results[PREDICTIONS_KEY].detach()
        real_logits, real_cond = m.discriminate(real)
        d_real = gan_loss(real_logits, True, mode=self.loss_mode)
        d_fake = gan_loss(m.discriminator(fake), False, mode=self.loss_mode)
        losses = {"d_real": d_real, "d_fake": d_fake}
        ce = _cond_ce(real_cond, batch.get(LABEL_KEY))
        if ce is not None:
            losses["d_cond"] = ce
            d_real = d_real + ce
        d_loss = 0.5 * (d_real + d_fake)
        if self.loss_mode == "wgangp":
            eps = m.m._uniform(())
            merged = eps * real + (1.0 - eps) * fake
            m.discriminator.eval()
            try:
                gp = gradient_norm_penalty(m.discriminator, merged)
            finally:
                m.discriminator.train()
            losses["d_gp"] = gp
            d_loss = d_loss + self.lambda_gp * gp
        losses["d"] = d_loss
        losses[LOSS_KEY] = d_loss
        return losses


@IDLModel.register("gan")
class GANModel(IDLModel):
    """The generator (`m`, scope "core") and a discriminator (scope
    "discriminator", "basic" unless `module_config["discriminator"]` names
    another, with `discriminator_config`; a class head when the generator is
    conditional). `loss_config` holds `gan_mode` ("vanilla", "lsgan",
    "wgangp", "hinge") and `lambda_gp`."""

    def build(self, config: DLConfig) -> None:
        self.rngs = self.make_rngs()
        module_config = dict(config.module_config or {})
        discriminator = module_config.pop("discriminator", "basic")
        discriminator_config = module_config.pop("discriminator_config", {})
        loss_config = dict(config.loss_config or {})
        self.loss_mode = loss_config.get("gan_mode", module_config.pop("gan_loss", "vanilla"))
        self.lambda_gp = float(loss_config.get("lambda_gp", module_config.pop("lambda_gp", 10.0)))
        self.m = build_module(
            config.module_name or "gan", config=module_config, device=self.build_device, generator=self.rngs["params"]
        )
        attach_generator(self.m, self.rngs["default"])
        d_config = dict(discriminator_config)
        d_config.setdefault("in_channels", module_config.get("out_channels", 3))
        if self.m.is_conditional and discriminator == "basic":
            d_config.setdefault("num_classes", self.m.num_classes)
        self.discriminator = discriminators.build(discriminator, **d_config)
        if self.build_device.type != "meta":
            init_parameters(self.discriminator, generator=self.rngs["params"])
        self.loss = None

    @property
    def train_steps(self) -> List[TrainStep]:
        return [GeneratorStep(loss_mode=self.loss_mode), DiscriminatorStep(loss_mode=self.loss_mode, lambda_gp=self.lambda_gp)]

    def discriminate(self, x: torch.Tensor) -> DiscriminatorOutput:
        fwd = getattr(self.discriminator, "forward_with_cond", None)
        if fwd is None:
            return DiscriminatorOutput(self.discriminator(x), None)
        return DiscriminatorOutput(*fwd(x))

    def params_filter(self, scope: str) -> List[Tuple[str, nn.Parameter]]:
        inside = scope == "discriminator"
        return [(n, p) for n, p in self.named_parameters() if ("discriminator" in n.split(".")) == inside]

    def forward(self, batch: Dict[str, Any], **kwargs: Any) -> torch.Tensor:
        labels = batch.get(LABEL_KEY) if self.m.is_conditional else None
        return self.m.sample(batch[INPUT_KEY].shape[0], labels=labels)

    def run(self, batch: Dict[str, Any], *, training: bool = False, **kwargs: Any) -> Dict[str, Any]:
        self.set_mode(training)
        return {PREDICTIONS_KEY: self.forward(batch, **kwargs)}

    @property
    def all_modules(self) -> List[nn.Module]:
        return [self.m, self.discriminator]
