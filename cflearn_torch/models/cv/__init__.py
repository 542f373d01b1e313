"""Vision models (counterpart of `cflearn_tpu/models/cv/`)."""

from .diffusion import DDPMModel, DDPMStep

__all__ = ["DDPMModel", "DDPMStep"]
