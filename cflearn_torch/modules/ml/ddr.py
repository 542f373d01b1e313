"""DDR, distribution regression (counterpart of
`cflearn_tpu/modules/ml/ddr.py`): a mish MLP backbone, a median head,
monotone quantiles around the median (softplus increments summed outwards
over `num_anchors` anchors), and a CDF head F(y | x); its "ddr" loss is the
median's MAE, the pinball loss at the anchors' levels (0.05 .. 0.95) and a
monotonicity penalty."""

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...constants import LABEL_KEY, LOSS_KEY, PREDICTIONS_KEY
from ...schema.losses_schema import ILoss
from ..common import register_module
from ..core.mappings import MappingBlock
from ..layers import Linear


@register_module("ddr")
class DDR(nn.Module):
    def __init__(
        self, input_dim: int, output_dim: int = 1, hidden_units: Optional[List[int]] = None, *, num_anchors: int = 16
    ) -> None:
        super().__init__()
        hidden_units = hidden_units or [64, 64]
        self.num_anchors = num_anchors
        blocks = []
        in_dim = input_dim
        for h in hidden_units:
            blocks.append(MappingBlock(in_dim, h, norm_type=None, activation="mish"))
            in_dim = h
        self.backbone = nn.ModuleList(blocks)
        self.median_head = Linear(in_dim, output_dim)
        self.q_head = Linear(in_dim, num_anchors * output_dim)
        self.cdf_head = Linear(in_dim + 1, output_dim)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.backbone:
            x = block(x)
        return x

    def forward(self, x: torch.Tensor, *, tau: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        feats = self.features(x)
        median = self.median_head(feats)
        increments = F.softplus(self.q_head(feats)).reshape(x.shape[0], self.num_anchors, -1)
        half = self.num_anchors // 2
        lower = median[:, None] - increments[:, :half].flip(1).cumsum(dim=1).flip(1)
        upper = median[:, None] + increments[:, half:].cumsum(dim=1)
        quantiles = torch.cat([lower, median[:, None], upper], dim=1)
        return {PREDICTIONS_KEY: median, "quantiles": quantiles, "features": feats}

    def cdf(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.cdf_head(torch.cat([self.features(x), y], dim=-1)))


@ILoss.register("ddr")
class DDRLoss(ILoss):
    def __init__(self, reduction: str = "mean", *, lb_monotonous: float = 1.0) -> None:
        super().__init__(reduction)
        self.lb_monotonous = lb_monotonous

    def run(self, forward_results: Dict[str, Any], batch: Dict[str, Any], **kwargs: Any) -> Dict[str, torch.Tensor]:
        labels = batch[LABEL_KEY].float()
        median = forward_results[PREDICTIONS_KEY]
        quantiles = forward_results["quantiles"]
        num_anchors = quantiles.shape[1]
        taus = torch.linspace(0.05, 0.95, num_anchors, device=labels.device).reshape(1, num_anchors, 1)
        diff = labels[:, None] - quantiles
        pinball = torch.maximum(taus * diff, (taus - 1.0) * diff).mean()
        median_loss = (labels - median).abs().mean()
        mono = F.relu(quantiles[:, :-1] - quantiles[:, 1:]).mean()
        total = median_loss + pinball + self.lb_monotonous * mono
        return {LOSS_KEY: total, "median": median_loss, "pinball": pinball, "mono": mono}
