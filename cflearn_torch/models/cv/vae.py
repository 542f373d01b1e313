"""VAE, VQ-VAE and auto-regressor training (counterpart of
`cflearn_tpu/models/cv/vae.py`): the losses `VAELoss` ("vae": mse + kl x
`kl_weight`), `VQVAELoss` ("vq_vae": recon, codebook and commitment terms)
and `AutoRegressorLoss` ("ar": cross entropy over the codes), and the
`IDLModel`s "vae", "vq_vae" and "ar" on `CommonDLModel`: each takes its
loss by default and feeds the batch's labels to a conditional module."""

from typing import Any, Dict, Tuple

import torch

from ...constants import INPUT_KEY, LABEL_KEY, LOSS_KEY, PREDICTIONS_KEY
from ...modules.cv import classifier, gan, vae  # noqa: F401  (register "pixel_cnn", "gan", "vae", "vq_vae")
from ...schema.config import DLConfig
from ...schema.losses_schema import ILoss, loss_dict_type
from ...schema.model import IDLModel
from ..common import CommonDLModel


@ILoss.register("vae")
class VAELoss(ILoss):
    """mean((recon - x)^2) + kl_weight x mean(kl)."""

    def __init__(self, reduction: str = "mean", *, kl_weight: float = 1.0e-3) -> None:
        super().__init__(reduction)
        self.kl_weight = kl_weight

    def run(self, forward_results: Dict[str, Any], batch: Dict[str, Any], **kwargs: Any) -> loss_dict_type:
        recon = (forward_results[PREDICTIONS_KEY] - batch[INPUT_KEY]).square().mean()
        kl = forward_results["kl"].mean()
        return {LOSS_KEY: recon + self.kl_weight * kl, "recon": recon, "kl": kl}


@ILoss.register("vq_vae")
class VQVAELoss(ILoss):
    """lb_recon x mse + lb_vq x codebook + lb_commit x commitment."""

    def __init__(
        self, reduction: str = "mean", *, lb_vq: float = 1.0, lb_commit: float = 0.25, lb_recon: float = 1.0
    ) -> None:
        super().__init__(reduction)
        self.lb_vq = lb_vq
        self.lb_commit = lb_commit
        self.lb_recon = lb_recon

    def run(self, forward_results: Dict[str, Any], batch: Dict[str, Any], **kwargs: Any) -> loss_dict_type:
        recon = (forward_results[PREDICTIONS_KEY] - batch[INPUT_KEY]).square().mean()
        codebook = forward_results["codebook_loss"]
        commit = forward_results["commitment_loss"]
        total = self.lb_recon * recon + self.lb_vq * codebook + self.lb_commit * commit
        return {LOSS_KEY: total, "recon": recon, "codebook": codebook, "commit": commit}


@ILoss.register("ar")
class AutoRegressorLoss(ILoss):
    """Mean cross entropy of each pixel's code under its logits."""

    def run(self, forward_results: Dict[str, Any], batch: Dict[str, Any], **kwargs: Any) -> loss_dict_type:
        logits = forward_results[PREDICTIONS_KEY]
        target = batch[INPUT_KEY].long()
        if target.ndim == logits.ndim:
            target = target[..., 0]
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, target[..., None])
        return {LOSS_KEY: nll.mean()}


def _with_labels(batch: Dict[str, Any]) -> Tuple[Any, ...]:
    return batch[INPUT_KEY], batch.get(LABEL_KEY)


class _LabelledModel(CommonDLModel):
    default_loss = ""

    def build(self, config: DLConfig) -> None:
        if config.loss_name is None:
            config.loss_name = self.default_loss
        super().build(config)

    def get_forward_args(self, batch: Dict[str, Any], **kwargs: Any) -> Tuple[Any, ...]:
        return _with_labels(batch)


@IDLModel.register("vae")
class VAEModel(_LabelledModel):
    default_loss = "vae"


@IDLModel.register("vq_vae")
class VQVAEModel(_LabelledModel):
    default_loss = "vq_vae"


@IDLModel.register("ar")
class AutoRegressorModel(_LabelledModel):
    default_loss = "ar"
