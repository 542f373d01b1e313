"""Trainer callbacks (counterpart of `cflearn_tpu/callbacks/`): the general
ones. The image-grid callbacks of `callbacks/generator.py` are still to be
ported."""

from .general import ArtifactCallback, LogMetricsMsgCallback, MLFlowCallback

__all__ = ["ArtifactCallback", "LogMetricsMsgCallback", "MLFlowCallback"]
