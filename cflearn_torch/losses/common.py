"""Composed losses (counterpart of `cflearn_tpu/losses/common.py`):
`MultiTaskLoss` ("multi_task"), the weighted sum of named losses on the
same forward results, and `MultiStageLoss` ("multi_stage"), every named
loss on each stage's predictions (a list), summed."""

from typing import Any, Dict, List, Optional

import torch.nn as nn

from ..constants import LOSS_KEY, PREDICTIONS_KEY
from ..schema.losses_schema import ILoss, build_loss, loss_dict_type


class _MultiLoss(ILoss):
    def __init__(
        self,
        reduction: str = "mean",
        *,
        loss_names: List[str],
        loss_configs: Optional[Dict[str, Dict[str, Any]]] = None,
        loss_weights: Optional[Dict[str, float]] = None,
    ) -> None:
        super().__init__(reduction)
        loss_configs = loss_configs or {}
        loss_weights = loss_weights or {}
        self.loss_names = loss_names
        self.weights = {k: loss_weights.get(k, 1.0) for k in loss_names}
        self.base_losses = nn.ModuleList(build_loss(name, loss_configs.get(name, {})) for name in loss_names)


@ILoss.register("multi_task")
class MultiTaskLoss(_MultiLoss):
    def run(self, forward_results: Dict[str, Any], batch: Dict[str, Any], **kwargs: Any) -> loss_dict_type:
        losses: loss_dict_type = {}
        total: Any = 0.0
        for name, loss_mod in zip(self.loss_names, self.base_losses):
            sub = loss_mod.run(forward_results, batch, **kwargs)
            losses[name] = sub[LOSS_KEY]
            total = total + self.weights[name] * sub[LOSS_KEY]
        losses[LOSS_KEY] = total
        return losses


@ILoss.register("multi_stage")
class MultiStageLoss(_MultiLoss):
    def run(self, forward_results: Dict[str, Any], batch: Dict[str, Any], **kwargs: Any) -> loss_dict_type:
        losses: loss_dict_type = {}
        total: Any = 0.0
        for i, pred in enumerate(forward_results[PREDICTIONS_KEY]):
            fr = dict(forward_results)
            fr[PREDICTIONS_KEY] = pred
            for name, loss_mod in zip(self.loss_names, self.base_losses):
                sub = loss_mod.run(fr, batch, **kwargs)
                losses[f"{i}_{name}"] = sub[LOSS_KEY]
                total = total + self.weights[name] * sub[LOSS_KEY]
        losses[LOSS_KEY] = total
        return losses
