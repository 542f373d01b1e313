"""Training-side models (counterpart of `cflearn_tpu/models/`), each an
`IDLModel` registered by name: "common", "ensemble", "ddpm", "ae_kl",
"ae_vq"."""

from .common import CommonDLModel, CommonTrainStep, DLEnsembleModel
from .cv import AEDiscriminatorStep, AEGeneratorStep, AEModel, AEVQModel, DDPMModel, DDPMStep

__all__ = [
    "AEDiscriminatorStep", "AEGeneratorStep", "AEModel", "AEVQModel", "CommonDLModel", "CommonTrainStep",
    "DDPMModel", "DDPMStep", "DLEnsembleModel",
]
