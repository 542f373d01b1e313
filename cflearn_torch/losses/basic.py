"""Basic losses (counterpart of `cflearn_tpu/losses/basic.py`): so far
"cross_entropy", the image classifier's loss. The others wait for the
framework slice."""

import torch

from ..schema.losses_schema import ILoss


@ILoss.register("cross_entropy")
class CrossEntropyLoss(ILoss):
    """-log softmax(logits)[label] per sample; labels (B,) or (B, 1)."""

    def forward(self, predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if labels.ndim == predictions.ndim and labels.shape[-1] == 1:
            labels = labels[..., 0]
        log_probs = torch.log_softmax(predictions, dim=-1)
        return -log_probs.gather(-1, labels.long()[..., None])[..., 0]
