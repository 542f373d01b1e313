"""The model core (counterpart of `cflearn_tpu/schema/`): the configs, the
data interfaces, the loss and metric interfaces, the model wrapper with its
train steps and the trainer's interfaces."""

from .config import (
    Config,
    DLConfig,
    MeshConfig,
    MLConfig,
    MLEncoderSettings,
    MLGlobalEncoderSettings,
    TrainerConfig,
)
from .data import (
    DataBundle,
    DataConfig,
    DataProcessor,
    DataProcessorConfig,
    IData,
    IDataBlock,
    IDataLoader,
    IDataset,
    INoInitDataBlock,
    data_type,
    norm_sw,
)
from .losses_schema import ILoss, build_loss, loss_dict_type, register_loss
from .metrics_schema import IMetric, MetricsOutputs, MultipleMetrics, weighted_loss_score
from .model import AuxLossVariable, IDLModel, StepOutputs, TrainStep, TrainStepLoss, forward_results_type
from .train_schema import ITrainer, MonitorResults, TrainerCallback, TrainerMonitor, TrainerState

__all__ = [
    "AuxLossVariable", "Config", "DLConfig", "DataBundle", "DataConfig", "DataProcessor", "DataProcessorConfig",
    "IDLModel", "IData", "IDataBlock", "IDataLoader", "IDataset", "ILoss", "IMetric", "INoInitDataBlock",
    "ITrainer", "MLConfig", "MLEncoderSettings", "MLGlobalEncoderSettings", "MeshConfig", "MetricsOutputs",
    "MonitorResults", "MultipleMetrics", "StepOutputs", "TrainStep", "TrainStepLoss", "TrainerCallback",
    "TrainerConfig", "TrainerMonitor", "TrainerState", "build_loss", "data_type", "forward_results_type",
    "loss_dict_type", "norm_sw", "register_loss", "weighted_loss_score",
]
