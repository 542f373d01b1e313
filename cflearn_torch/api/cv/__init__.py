"""CV entry points (counterpart of `cflearn_tpu/api/cv/`): `TranslatorAPI`
(ESRGAN) and `VQVAEInference` (a prior over a VQ-VAE's codes)."""

from .translator import TranslatorAPI
from .vq_vae import VQVAEInference, register_callback

__all__ = ["TranslatorAPI", "VQVAEInference", "register_callback"]
