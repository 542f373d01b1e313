"""Vision models (counterpart of `cflearn_tpu/models/cv/`)."""

from .ae import AEDiscriminatorStep, AEGeneratorStep, AEModel, AEVQModel
from .diffusion import DDPMModel, DDPMStep
from .gan import (
    DiscriminatorOutput, DiscriminatorStep, GANModel, GANTarget, GeneratorStep, gan_loss, gradient_norm_penalty,
)
from .vae import AutoRegressorLoss, AutoRegressorModel, VAELoss, VAEModel, VQVAELoss, VQVAEModel

__all__ = [
    "AEDiscriminatorStep", "AEGeneratorStep", "AEModel", "AEVQModel", "AutoRegressorLoss", "AutoRegressorModel",
    "DDPMModel", "DDPMStep", "DiscriminatorOutput", "DiscriminatorStep", "GANModel", "GANTarget", "GeneratorStep",
    "VAELoss", "VAEModel", "VQVAELoss", "VQVAEModel", "gan_loss", "gradient_norm_penalty",
]
