"""Tabular models (counterpart of `cflearn_tpu/models/ml/`): "ml.common",
"ml.temporal", "ml.wnd" and "ml.ddr"."""

from .common import CommonMLModel, TemporalMLModel, WideAndDeepModel, register_ml_model, to_ml_model
from .ddr import DDRModel
