"""Third-party evaluation (counterpart of `cflearn_tpu/pipeline/third_party.py`):
any predictor scored by the framework's metrics, so that its scores sit in
the same tables as `evaluate`'s.

* `IPredictor` — `predict(x) -> logits or values`, numpy in and out;
* `SKLearnClassifier` — a fitted classifier with `predict_log_proba`, whose
  log-probabilities play the logits' part. Duck-typed: nothing of sklearn is
  imported;
* `GeneralEvaluationPipeline` — `evaluate(loader)`: the predictor on the
  loader's full batch, then the config's metrics.
"""

from abc import ABC, abstractmethod
from typing import Any

import numpy as np

from ..constants import INPUT_KEY, PREDICTIONS_KEY
from ..schema.config import DLConfig
from ..schema.data import IDataLoader
from ..schema.metrics_schema import IMetric, MetricsOutputs


class IPredictor(ABC):
    @abstractmethod
    def predict(self, x: np.ndarray) -> np.ndarray:
        """Features -> prediction logits or values."""


class SKLearnClassifier(IPredictor):
    def __init__(self, m: Any) -> None:
        self.m = m

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.m.predict_log_proba(x)


class GeneralEvaluationPipeline:
    """The metrics of `config.metric_names` over an `IPredictor`."""

    def __init__(self, config: DLConfig, predictor: IPredictor) -> None:
        if config.metric_names is None:
            raise ValueError("`metric_names` should be provided in `config` for `GeneralEvaluationPipeline`")
        self.m = predictor
        self.metrics = IMetric.fuse(config.metric_names, config.metric_configs, metric_weights=config.metric_weights)

    def evaluate(self, loader: IDataLoader) -> MetricsOutputs:
        full_batch = loader.get_full_batch()
        predictions = self.m.predict(full_batch[INPUT_KEY])
        return self.metrics.evaluate(full_batch, {PREDICTIONS_KEY: predictions})
