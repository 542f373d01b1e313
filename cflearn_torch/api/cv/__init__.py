"""CV entry points (counterpart of `cflearn_tpu/api/cv/`): `TranslatorAPI`
(ESRGAN), `VQVAEInference` (a prior over a VQ-VAE's codes) and the
ControlNet hint annotators (`Annotator`, `ControlNetHints`; their nets in
`third_party`)."""

from .annotator import Annotator, ControlNetHints
from .translator import TranslatorAPI
from .vq_vae import VQVAEInference, register_callback

__all__ = ["Annotator", "ControlNetHints", "TranslatorAPI", "VQVAEInference", "register_callback"]
