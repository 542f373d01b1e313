"""Pipelines (counterpart of `cflearn_tpu/pipeline/`): the framework's
training, inference and evaluation pipelines and their serializer
(`api.py`, `blocks.py`, `common.py`), and the SD family's entry points
(`sd.py`: `txt2img`, `configure`, `finetune_unet`, `train_autoencoder`),
whose names stay importable from `cflearn_torch.pipeline`; the ensembles
(`FusedInferencePipeline`, `FusedEvaluationPipeline`), the export of a model
(`export.py`: `torch.export` programs and CUDA-graph capture) and the
third-party evaluation (`third_party.py`)."""

from .api import (
    DLEvaluationPipeline, DLInferencePipeline, DLPipelineSerializer, DLTrainingPipeline, FusedEvaluationPipeline,
    FusedInference, FusedInferencePipeline, MLEvaluationPipeline, MLInferencePipeline, MLTrainingPipeline,
    TrainingPipeline,
)
from .export import (
    CapturedForward, ExportedModel, aot_compile, export_model, load_exported, op_counts, pack_exported, pack_stablehlo,
)
from .third_party import GeneralEvaluationPipeline, IPredictor, SKLearnClassifier
from .blocks import Block
from .common import Pipeline
from .sd import (
    ACCEL_DC, AE_DEFAULT_LR, CONFIGS, DEFAULT_LR, FAITHFUL_DC, GUIDANCE_INTERVAL, TOME_RATIO, configure,
    default_tokenizer, finetune_unet, train_autoencoder, txt2img,
)

__all__ = [
    "CapturedForward", "ExportedModel", "FusedEvaluationPipeline", "FusedInference", "FusedInferencePipeline",
    "GeneralEvaluationPipeline", "IPredictor", "SKLearnClassifier", "aot_compile", "export_model", "load_exported",
    "op_counts", "pack_exported", "pack_stablehlo",
    "ACCEL_DC", "AE_DEFAULT_LR", "Block", "CONFIGS", "DEFAULT_LR", "DLEvaluationPipeline", "DLInferencePipeline",
    "DLPipelineSerializer", "DLTrainingPipeline", "FAITHFUL_DC", "MLEvaluationPipeline", "MLInferencePipeline",
    "MLTrainingPipeline", "GUIDANCE_INTERVAL", "Pipeline", "TOME_RATIO", "TrainingPipeline", "configure", "default_tokenizer", "finetune_unet",
    "train_autoencoder", "txt2img",
]
