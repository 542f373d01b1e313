"""Common model wrappers (counterpart of `cflearn_tpu/models/common.py`):
`CommonTrainStep` runs the model's registered loss and adds the recorded
auxiliary objectives; `CommonDLModel` ("common") is a registered module
and a registered loss; `DLEnsembleModel` ("ensemble") is `num_repeat`
copies of the module, each from its own seed, with averaged outputs."""

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from ..constants import AUX_LOSS_KEY, LOSS_KEY
from ..modules.common import build_module
from ..schema.config import DLConfig
from ..schema.losses_schema import ILoss, build_loss, loss_dict_type
from ..schema.model import IDLModel, TrainStep


class CommonTrainStep(TrainStep):
    """One scope ("all") running `loss` (the model's when not given)."""

    def __init__(self, loss: Optional[ILoss] = None, **kwargs: Any) -> None:
        super().__init__("all", **kwargs)
        self.loss = loss

    def loss_fn(
        self, m: IDLModel, batch: Dict[str, Any], forward_results: Dict[str, Any], **kwargs: Any
    ) -> loss_dict_type:
        loss = self.loss if self.loss is not None else m.loss
        assert loss is not None, "loss is not built"
        losses = loss.run(forward_results, batch, **kwargs)
        aux = forward_results.get(AUX_LOSS_KEY)
        if aux is not None:
            losses[AUX_LOSS_KEY] = aux
            losses[LOSS_KEY] = losses[LOSS_KEY] + aux
        return losses


def _build_loss(config: DLConfig) -> Optional[ILoss]:
    return None if config.loss_name is None else build_loss(config.loss_name, config.loss_config)


def attach_generator(module: nn.Module, generator: torch.Generator) -> None:
    """Give every drawing module under `module` (an `IConditional`: the
    VAEs, the GAN generator, PixelCNN) `generator` for its draws."""
    from ..modules.cv.common import IConditional

    for sub in module.modules():
        if isinstance(sub, IConditional):
            sub.generator = generator


@IDLModel.register("common")
class CommonDLModel(IDLModel):
    """A registered module and a registered loss; the module draws (where
    it does) from the model's "default" generator."""

    def build(self, config: DLConfig) -> None:
        self.rngs = self.make_rngs()
        self.m = build_module(
            config.module_name, config=config.module_config, device=self.build_device, generator=self.rngs["params"]
        )
        attach_generator(self.m, self.rngs["default"])
        self.loss = _build_loss(config)

    @property
    def train_steps(self) -> List[TrainStep]:
        return [CommonTrainStep()]


@IDLModel.register("ensemble")
class DLEnsembleModel(IDLModel):
    def build(self, config: DLConfig) -> None:
        modules = []
        for i in range(config.num_repeat or 2):
            rngs = self.make_rngs(seed=(config.seed or 0) + i)
            modules.append(build_module(
                config.module_name, config=config.module_config, device=self.build_device, generator=rngs["params"]
            ))
        self.m = nn.ModuleList(modules)
        self.loss = _build_loss(config)

    def forward(self, batch: Dict[str, Any], **kwargs: Any) -> Any:
        args = self.get_forward_args(batch, **kwargs)
        return self.reduce([m(*args) for m in self.m])

    def reduce(self, outputs: List[Any]) -> Any:
        if isinstance(outputs[0], dict):
            return {k: torch.stack([o[k] for o in outputs]).mean(dim=0) for k in outputs[0]}
        return torch.stack(outputs).mean(dim=0)

    @property
    def train_steps(self) -> List[TrainStep]:
        return [CommonTrainStep()]

    def set_mode(self, training: bool) -> None:
        self.m.train(training)
        if self.loss is not None:
            self.loss.train(training)
