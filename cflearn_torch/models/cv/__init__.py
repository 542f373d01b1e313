"""Vision models (counterpart of `cflearn_tpu/models/cv/`)."""

from .ae import AEDiscriminatorStep, AEGeneratorStep, AEModel, AEVQModel
from .diffusion import DDPMModel, DDPMStep
from .gan import gan_loss

__all__ = ["AEDiscriminatorStep", "AEGeneratorStep", "AEModel", "AEVQModel", "DDPMModel", "DDPMStep", "gan_loss"]
