"""Basic losses (counterpart of `cflearn_tpu/losses/basic.py`), under the JAX
package's registry names: "mae", "sigmoid_mae", "mse", "recon", "bce",
"cross_entropy", "label_smooth_cross_entropy", "focal", "quantile", "corr"
and "iou". Each returns the per-sample (or per-element) loss, which `ILoss`
reduces; labels are cast to the predictions' dtype, class labels (B,) or
(B, 1) to i64."""

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from ..constants import INPUT_KEY, PREDICTIONS_KEY
from ..schema.losses_schema import ILoss


@ILoss.register("mae")
class MAELoss(ILoss):
    def forward(self, predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return (predictions - labels.to(predictions.dtype)).abs()


@ILoss.register("sigmoid_mae")
class SigmoidMAELoss(ILoss):
    def forward(self, predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return (torch.sigmoid(predictions) - labels.to(predictions.dtype)).abs()


@ILoss.register("mse")
class MSELoss(ILoss):
    def forward(self, predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return (predictions - labels.to(predictions.dtype)).square()


@ILoss.register("recon")
class ReconstructionLoss(ILoss):
    """The distance of the predictions to the input: "mae" (the default) or "mse"."""

    def __init__(self, reduction: str = "mean", *, base_loss: str = "mae") -> None:
        super().__init__(reduction)
        if base_loss not in ("mae", "mse"):
            raise ValueError(f"unsupported recon base_loss '{base_loss}'")
        self.base_loss = base_loss

    def get_forward_args(self, forward_results: Any, batch: Any) -> Any:
        return forward_results[PREDICTIONS_KEY], batch[INPUT_KEY]

    def forward(self, predictions: torch.Tensor, net: torch.Tensor) -> torch.Tensor:
        diff = predictions - net
        return diff.abs() if self.base_loss == "mae" else diff.square()


@ILoss.register("bce")
class BCELoss(ILoss):
    def forward(self, predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        labels = labels.to(predictions.dtype)
        return -(labels * F.logsigmoid(predictions) + (1.0 - labels) * F.logsigmoid(-predictions))


def _class_labels(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if labels.ndim == logits.ndim and labels.shape[-1] == 1:
        labels = labels[..., 0]
    return logits, labels.long()


@ILoss.register("cross_entropy")
class CrossEntropyLoss(ILoss):
    """-log softmax(logits)[label] per sample."""

    def forward(self, predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logits, labels = _class_labels(predictions, labels)
        return -torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]


@ILoss.register("label_smooth_cross_entropy")
class LabelSmoothCrossEntropyLoss(ILoss):
    def __init__(self, reduction: str = "mean", *, eps: float = 0.1) -> None:
        super().__init__(reduction)
        self.eps = eps

    def forward(self, predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logits, labels = _class_labels(predictions, labels)
        num_classes = logits.shape[-1]
        log_probs = torch.log_softmax(logits, dim=-1)
        smoothed = F.one_hot(labels, num_classes).to(log_probs.dtype) * (1.0 - self.eps) + self.eps / num_classes
        return -(smoothed * log_probs).sum(dim=-1)


@ILoss.register("focal")
class FocalLoss(ILoss):
    """-(1 - p_t)^gamma log p_t, p_t clipped to [eps, 1]; `alpha` weights the
    classes (a scalar a means [a, 1 - a])."""

    def __init__(
        self,
        reduction: str = "mean",
        *,
        input_logits: bool = True,
        eps: float = 1e-6,
        gamma: float = 2.0,
        alpha: Optional[Any] = None,
    ) -> None:
        super().__init__(reduction)
        self.input_logits = input_logits
        self.eps = eps
        self.gamma = gamma
        self.alpha = alpha

    def forward(self, predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logits, labels = _class_labels(predictions, labels)
        probs = torch.softmax(logits, dim=-1) if self.input_logits else logits
        pt = probs.clamp(self.eps, 1.0).gather(-1, labels[..., None])[..., 0]
        loss = -torch.pow(1.0 - pt, self.gamma) * torch.log(pt)
        if self.alpha is not None:
            a = self.alpha
            if isinstance(a, (int, float)):
                a = [float(a), 1.0 - float(a)]
            loss = torch.as_tensor(a, dtype=loss.dtype, device=loss.device)[labels] * loss
        return loss


@ILoss.register("quantile")
class QuantileLoss(ILoss):
    def __init__(self, reduction: str = "mean", *, q: Any = 0.5) -> None:
        super().__init__(reduction)
        self.q = q

    def forward(self, predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        q = torch.as_tensor(self.q, dtype=predictions.dtype, device=predictions.device)
        error = labels.to(predictions.dtype) - predictions
        return torch.maximum(q * error, (q - 1.0) * error)


@ILoss.register("corr")
class CorrelationLoss(ILoss):
    """Minus the correlation of the predictions and the labels over the batch."""

    def forward(self, predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        labels = labels.to(predictions.dtype)
        p = predictions - predictions.mean()
        t = labels - labels.mean()
        return -(p * t).sum() / (torch.sqrt((p * p).sum() * (t * t).sum()) + 1e-12)


@ILoss.register("iou")
class IOULoss(ILoss):
    """1 - the soft IoU of sigmoid(logits) and the labels, per sample."""

    def forward(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        probs = torch.sigmoid(logits)
        labels = labels.to(probs.dtype)
        dims = tuple(range(1, probs.ndim))
        intersect = (probs * labels).sum(dim=dims)
        union = (probs + labels - probs * labels).sum(dim=dims)
        return 1.0 - intersect / (union + 1e-12)
