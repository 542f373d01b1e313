"""Metrics interface (counterpart of `cflearn_tpu/schema/metrics_schema.py`):
`IMetric` (a direction, `is_positive`, and `requires_all` for metrics that
need the whole dataset, such as AUC), `MultipleMetrics` (a weighted fusion
into one score), `MetricsOutputs` and `weighted_loss_score`. Metrics run on
the host, on numpy outputs.
"""

import dataclasses
from typing import Any, Dict, List, Optional, Union

from ..constants import LABEL_KEY, PREDICTIONS_KEY
from ..toolkit.misc import np_dict_type
from ..toolkit.registry import WithRegister


@dataclasses.dataclass
class MetricsOutputs:
    final_score: float
    metric_values: Dict[str, float]
    is_positive: Dict[str, bool]


class IMetric(WithRegister):
    d: Dict[str, type] = {}

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        pass

    @property
    def is_positive(self) -> bool:
        raise NotImplementedError

    def forward(self, *args: Any) -> float:
        raise NotImplementedError

    @property
    def requires_all(self) -> bool:
        return False

    def get_forward_args(self, np_batch: np_dict_type, np_outputs: np_dict_type) -> Any:
        return np_outputs[PREDICTIONS_KEY], np_batch[LABEL_KEY]

    def evaluate(self, np_batch: np_dict_type, np_outputs: np_dict_type) -> MetricsOutputs:
        k = getattr(self, "__identifier__", self.__class__.__name__)
        args = self.get_forward_args(np_batch, np_outputs)
        metric = self.forward(*args)
        score = metric * (1.0 if self.is_positive else -1.0)
        return MetricsOutputs(score, {k: metric}, {k: self.is_positive})

    @staticmethod
    def fuse(
        names: Union[str, List[str]],
        configs: Optional[Dict[str, Any]] = None,
        *,
        metric_weights: Optional[Dict[str, float]] = None,
    ) -> "IMetric":
        metrics = IMetric.make_multiple(names, configs)
        if isinstance(metrics, IMetric):
            return metrics
        if len(metrics) == 1:
            return metrics[0]
        return MultipleMetrics(metrics, weights=metric_weights)


class MultipleMetrics(IMetric):
    @property
    def is_positive(self) -> bool:
        raise NotImplementedError

    @property
    def requires_all(self) -> bool:
        return any(m.requires_all for m in self.metrics)

    def forward(self, *args: Any) -> float:
        raise NotImplementedError

    def __init__(self, metrics: List[IMetric], *, weights: Optional[Dict[str, float]] = None) -> None:
        super().__init__()
        self.metrics = metrics
        self.weights = weights or {}

    def evaluate(self, np_batch: np_dict_type, np_outputs: np_dict_type) -> MetricsOutputs:
        scores: List[float] = []
        weights: List[float] = []
        metric_values: Dict[str, float] = {}
        is_positive: Dict[str, bool] = {}
        for metric in self.metrics:
            out = metric.evaluate(np_batch, np_outputs)
            w = self.weights.get(next(iter(out.metric_values)), 1.0)
            scores.append(out.final_score * w)
            weights.append(w)
            metric_values.update(out.metric_values)
            is_positive.update(out.is_positive)
        return MetricsOutputs(sum(scores) / max(sum(weights), 1e-12), metric_values, is_positive)


def weighted_loss_score(
    loss_items: Dict[str, float],
    loss_metrics_weights: Optional[Dict[str, float]] = None,
) -> float:
    """The score from the losses where no metric is given: lower is better,
    so the score is the negated (weighted) loss."""
    if not loss_items:
        return 0.0
    if not loss_metrics_weights:
        from ..constants import LOSS_KEY

        if LOSS_KEY in loss_items:
            return -loss_items[LOSS_KEY]
        return -sum(loss_items.values()) / len(loss_items)
    score = 0.0
    w_sum = 0.0
    for k, w in loss_metrics_weights.items():
        v = loss_items.get(k)
        if v is None:
            continue
        score -= v * w
        w_sum += w
    return score / max(w_sum, 1e-12)
