"""The model core (counterpart of `cflearn_tpu/schema/`): the configs, the
loss interface and the model wrapper with its train steps."""

from .config import Config, DLConfig, MLConfig, MLEncoderSettings, MLGlobalEncoderSettings, TrainerConfig
from .losses_schema import ILoss, build_loss, register_loss
from .model import AuxLossVariable, IDLModel, StepOutputs, TrainStep, TrainStepLoss

__all__ = [
    "AuxLossVariable", "Config", "DLConfig", "IDLModel", "ILoss", "MLConfig", "MLEncoderSettings",
    "MLGlobalEncoderSettings", "StepOutputs", "TrainStep", "TrainStepLoss",
    "TrainerConfig", "build_loss", "register_loss",
]
