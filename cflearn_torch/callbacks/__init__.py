"""Trainer callbacks (counterpart of `cflearn_tpu/callbacks/`): the general
ones and the image-grid callbacks of `generator.py`."""

from .general import ArtifactCallback, LogMetricsMsgCallback, MLFlowCallback
from .generator import (
    GeneratorCallback, ImageCallback, ImageClassificationCallback, SigmoidCallback, VQVAECallback, save_image_grid,
)

__all__ = [
    "ArtifactCallback", "GeneratorCallback", "ImageCallback", "ImageClassificationCallback", "LogMetricsMsgCallback",
    "MLFlowCallback", "SigmoidCallback", "VQVAECallback", "save_image_grid",
]
