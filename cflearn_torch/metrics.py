"""Metrics (counterpart of `cflearn_tpu/metrics.py`): acc, mae, mse,
quantile, r2, corr, ber, f1, auc, iou under the JAX package's registry
names; f1 and auc need the whole dataset (`requires_all`). numpy on the
host, the same arithmetic as the JAX package's.
"""

from typing import Any

import numpy as np

from .schema.metrics_schema import IMetric


class IRequiresAllMixin:
    @property
    def requires_all(self) -> bool:
        return True


def _flat(x: np.ndarray) -> np.ndarray:
    return np.asarray(x).ravel()


def _classes(predictions: np.ndarray) -> np.ndarray:
    predictions = np.asarray(predictions)
    if predictions.ndim >= 2 and predictions.shape[-1] > 1:
        return np.argmax(predictions, axis=-1).ravel()
    return (_flat(predictions) > 0.5).astype(np.int64) if predictions.dtype.kind == "f" else _flat(predictions)


@IMetric.register("acc")
class Accuracy(IMetric):
    def __init__(self, threshold: float = 0.5) -> None:
        super().__init__()
        self.threshold = threshold

    @property
    def is_positive(self) -> bool:
        return True

    def forward(self, predictions: np.ndarray, labels: np.ndarray) -> float:
        predictions = np.asarray(predictions)
        labels = _flat(labels)
        if predictions.ndim >= 2 and predictions.shape[-1] > 1:
            classes = np.argmax(predictions, axis=-1).ravel()
        else:
            classes = (_flat(predictions) >= self.threshold).astype(np.int64)
        return float(np.mean(classes == labels))


@IMetric.register("mae")
class MAE(IMetric):
    @property
    def is_positive(self) -> bool:
        return False

    def forward(self, predictions: np.ndarray, labels: np.ndarray) -> float:
        return float(np.mean(np.abs(_flat(predictions) - _flat(labels))))


@IMetric.register("mse")
class MSE(IMetric):
    @property
    def is_positive(self) -> bool:
        return False

    def forward(self, predictions: np.ndarray, labels: np.ndarray) -> float:
        return float(np.mean(np.square(_flat(predictions) - _flat(labels))))


@IMetric.register("quantile")
class Quantile(IMetric):
    def __init__(self, q: Any = 0.5) -> None:
        super().__init__()
        self.q = q

    @property
    def is_positive(self) -> bool:
        return False

    def forward(self, predictions: np.ndarray, labels: np.ndarray) -> float:
        # multi-quantile: predictions (B, k) vs labels (B, 1) broadcast, per-
        # quantile mean then summed over columns
        p = np.asarray(predictions, np.float64)
        y = np.asarray(labels, np.float64)
        if p.ndim >= 2 and p.shape[-1] > 1:
            if y.ndim < p.ndim:
                y = y[..., None]
            q = np.asarray(self.q, np.float64).reshape((1,) * (p.ndim - 1) + (-1,))
            diff = y - p
            return float(np.maximum(q * diff, (q - 1.0) * diff).mean(0).sum())
        diff = _flat(labels) - _flat(predictions)
        return float(np.mean(np.maximum(self.q * diff, (self.q - 1.0) * diff)))


@IMetric.register("r2")
class R2Score(IMetric):
    @property
    def is_positive(self) -> bool:
        return True

    def forward(self, predictions: np.ndarray, labels: np.ndarray) -> float:
        y = _flat(labels).astype(np.float64)
        p = _flat(predictions).astype(np.float64)
        ss_res = np.sum(np.square(y - p))
        ss_tot = np.sum(np.square(y - y.mean())) + 1e-12
        return float(1.0 - ss_res / ss_tot)


@IMetric.register("corr")
class Correlation(IMetric):
    @property
    def is_positive(self) -> bool:
        return True

    def forward(self, predictions: np.ndarray, labels: np.ndarray) -> float:
        p = _flat(predictions).astype(np.float64)
        y = _flat(labels).astype(np.float64)
        p -= p.mean()
        y -= y.mean()
        denom = np.sqrt(np.sum(p * p) * np.sum(y * y)) + 1e-12
        return float(np.sum(p * y) / denom)


@IMetric.register("ber")
class BER(IMetric):
    """Balanced error rate."""

    @property
    def is_positive(self) -> bool:
        return False

    def forward(self, predictions: np.ndarray, labels: np.ndarray) -> float:
        classes = _classes(predictions)
        labels = _flat(labels)
        rates = []
        for c in np.unique(labels):
            mask = labels == c
            rates.append(1.0 - float(np.mean(classes[mask] == c)))
        return float(np.mean(rates))


@IMetric.register("f1")
class F1Score(IRequiresAllMixin, IMetric):
    def __init__(self, average: str = "macro") -> None:
        super().__init__()
        self.average = average

    @property
    def is_positive(self) -> bool:
        return True

    def forward(self, predictions: np.ndarray, labels: np.ndarray) -> float:
        classes = _classes(predictions)
        labels = _flat(labels)
        all_classes = np.unique(np.concatenate([labels, classes]))
        if self.average == "binary" or (self.average == "macro" and len(all_classes) <= 2):
            # binary: positive-class F1 (sklearn's default)
            tp = float(np.sum((classes == 1) & (labels == 1)))
            fp = float(np.sum((classes == 1) & (labels != 1)))
            fn = float(np.sum((classes != 1) & (labels == 1)))
            denom = 2 * tp + fp + fn
            return 2 * tp / denom if denom > 0 else 0.0
        f1s = []
        supports = []
        for c in all_classes:
            tp = float(np.sum((classes == c) & (labels == c)))
            fp = float(np.sum((classes == c) & (labels != c)))
            fn = float(np.sum((classes != c) & (labels == c)))
            denom = 2 * tp + fp + fn
            f1s.append(2 * tp / denom if denom > 0 else 0.0)
            supports.append(float(np.sum(labels == c)))
        if self.average == "micro":
            tp = float(np.sum(classes == labels))
            return tp / len(labels)
        if self.average == "weighted":
            total = sum(supports)
            return float(sum(f * s for f, s in zip(f1s, supports)) / total)
        return float(np.mean(f1s))


@IMetric.register("auc")
class AUC(IRequiresAllMixin, IMetric):
    @property
    def is_positive(self) -> bool:
        return True

    def forward(self, predictions: np.ndarray, labels: np.ndarray) -> float:
        predictions = np.asarray(predictions)
        labels = _flat(labels)
        if predictions.ndim >= 2 and predictions.shape[-1] > 1:
            # rank PROBABILITIES, not raw logits: p1 is monotone in l1-l0,
            # not in l1 alone (as the JAX package does)
            z = predictions.astype(np.float64)
            z = z - z.max(-1, keepdims=True)
            e = np.exp(z)
            probs = e / e.sum(-1, keepdims=True)
            if predictions.shape[-1] == 2:
                scores = probs[..., 1].ravel()
            else:
                # macro one-vs-rest AUC for multi-class
                aucs = []
                for c in range(probs.shape[-1]):
                    aucs.append(self._binary_auc(probs[..., c].ravel(), (labels == c).astype(np.int64)))
                return float(np.mean(aucs))
        else:
            scores = _flat(predictions)
        return self._binary_auc(scores, labels)

    @staticmethod
    def _binary_auc(scores: np.ndarray, labels: np.ndarray) -> float:
        pos = scores[labels == 1]
        neg = scores[labels == 0]
        if len(pos) == 0 or len(neg) == 0:
            return 0.5
        order = np.argsort(scores, kind="mergesort")
        ranks = np.empty_like(order, dtype=np.float64)
        sorted_scores = scores[order]
        ranks[order] = np.arange(1, len(scores) + 1)
        # average ranks for ties
        i = 0
        while i < len(scores):
            j = i
            while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
                j += 1
            if j > i:
                avg = (i + j + 2) / 2.0
                ranks[order[i : j + 1]] = avg
            i = j + 1
        r_pos = np.sum(ranks[labels == 1])
        n_pos, n_neg = len(pos), len(neg)
        return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


@IMetric.register("iou")
class IOU(IMetric):
    @property
    def is_positive(self) -> bool:
        return True

    def forward(self, predictions: np.ndarray, labels: np.ndarray) -> float:
        logits = np.asarray(predictions)
        probs = 1.0 / (1.0 + np.exp(-logits))
        labels = np.asarray(labels).astype(np.float64)
        axes = tuple(range(1, probs.ndim))
        intersect = np.sum(probs * labels, axis=axes)
        union = np.sum(probs + labels - probs * labels, axis=axes)
        return float(np.mean(intersect / (union + 1e-12)))
