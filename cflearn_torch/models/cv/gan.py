"""GAN losses (counterpart of `cflearn_tpu/models/cv/gan.py`: `gan_loss`).
`GANModel` and its steps and the gradient-norm penalty are not ported yet."""

from typing import Any

import torch
import torch.nn.functional as F


def gan_loss(logits: Any, target_real: bool, *, mode: str = "vanilla") -> torch.Tensor:
    """vanilla (BCE on logits), lsgan (MSE), wgangp (+-mean; the gradient
    penalty belongs to the discriminator step) and hinge (the autoencoders'
    adversarial loss). A list of logits (multi-scale) is averaged."""
    if isinstance(logits, list):
        return sum(gan_loss(item, target_real, mode=mode) for item in logits) / len(logits)
    if mode == "hinge":
        return F.relu(1.0 - logits).mean() if target_real else F.relu(1.0 + logits).mean()
    if mode == "lsgan":
        return (logits - (1.0 if target_real else 0.0)).square().mean()
    if mode == "wgangp":
        return -logits.mean() if target_real else logits.mean()
    target = torch.ones_like(logits) if target_real else torch.zeros_like(logits)
    return -(target * F.logsigmoid(logits) + (1.0 - target) * F.logsigmoid(-logits)).mean()
