"""Pipelines (counterpart of `cflearn_tpu/pipeline/`): the framework's
training, inference and evaluation pipelines and their serializer
(`api.py`, `blocks.py`, `common.py`), and the SD family's entry points
(`sd.py`: `txt2img`, `configure`, `finetune_unet`, `train_autoencoder`),
whose names stay importable from `cflearn_torch.pipeline`. The export of a
model (`pipeline/export.py`, whose counterpart is `torch.export`) and the
third-party pipelines are still to be ported."""

from .api import (
    DLEvaluationPipeline, DLInferencePipeline, DLPipelineSerializer, DLTrainingPipeline, MLEvaluationPipeline,
    MLInferencePipeline, MLTrainingPipeline, TrainingPipeline,
)
from .blocks import Block
from .common import Pipeline
from .sd import (
    ACCEL_DC, AE_DEFAULT_LR, CONFIGS, DEFAULT_LR, FAITHFUL_DC, GUIDANCE_INTERVAL, TOME_RATIO, configure,
    default_tokenizer, finetune_unet, train_autoencoder, txt2img,
)

__all__ = [
    "ACCEL_DC", "AE_DEFAULT_LR", "Block", "CONFIGS", "DEFAULT_LR", "DLEvaluationPipeline", "DLInferencePipeline",
    "DLPipelineSerializer", "DLTrainingPipeline", "FAITHFUL_DC", "MLEvaluationPipeline", "MLInferencePipeline",
    "MLTrainingPipeline", "GUIDANCE_INTERVAL", "Pipeline", "TOME_RATIO", "TrainingPipeline", "configure", "default_tokenizer", "finetune_unet",
    "train_autoencoder", "txt2img",
]
