"""Training-side models (counterpart of `cflearn_tpu/models/`), each an
`IDLModel` registered by name: "common", "ensemble", "ddpm", "ae_kl",
"ae_vq", "gan", "vae", "vq_vae", "ar", and the tabular "ml.common",
"ml.temporal", "ml.wnd", "ml.ddr"."""

from .common import CommonDLModel, CommonTrainStep, DLEnsembleModel
from .cv import (
    AEDiscriminatorStep, AEGeneratorStep, AEModel, AEVQModel, AutoRegressorModel, DDPMModel, DDPMStep,
    DiscriminatorStep, GANModel, GeneratorStep, VAEModel, VQVAEModel,
)
from .ml import CommonMLModel, DDRModel, TemporalMLModel, WideAndDeepModel
from . import common, cv
from .ml import common as ml_common

__all__ = [
    "AEDiscriminatorStep", "AEGeneratorStep", "AEModel", "AEVQModel", "AutoRegressorModel", "CommonDLModel",
    "CommonMLModel", "DDRModel", "TemporalMLModel", "WideAndDeepModel",
    "CommonTrainStep", "DDPMModel", "DDPMStep", "DLEnsembleModel", "DiscriminatorStep", "GANModel", "GeneratorStep",
    "VAEModel", "VQVAEModel",
]
