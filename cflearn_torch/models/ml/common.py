"""Tabular model wrappers (counterpart of `cflearn_tpu/models/ml/common.py`):
"ml.common" is a categorical `Encoder` (from the config's encoder settings)
before a registered module whose `input_dim` grows by the encoding's
increment; "ml.temporal" keeps a (B, T, d) input's time axis; "ml.wnd" is
"ml.common" under the wide-and-deep name. The "all" scope trains the net's
parameters (`m`) and the encoder's embedding tables (`encoder`); the JAX
package's trains `m` alone (`cflearn_tpu/schema/model.py:152-153`), so its
tables keep their random initialisation through every fit."""

from typing import Any, List, Optional, Tuple

import torch.nn as nn

from ...constants import INPUT_KEY
from ...modules import ml as _ml_modules  # noqa: F401  (registers the tabular modules)
from ...modules.common import build_module, init_parameters
from ...modules.core.ml_encoder import Encoder
from ...schema.config import DLConfig, MLConfig
from ...schema.model import IDLModel
from ..common import CommonDLModel, _build_loss, attach_generator


@IDLModel.register("ml.common")
class CommonMLModel(CommonDLModel):
    encoder: Optional[Encoder]

    def build(self, config: DLConfig) -> None:
        self.rngs = self.make_rngs()
        module_config = dict(config.module_config or {})
        encoder_settings = module_config.pop("encoder_settings", None)
        if encoder_settings is None and isinstance(config, MLConfig):
            encoder_settings = config.encoder_settings
        global_settings = {}
        if isinstance(config, MLConfig) and config.global_encoder_settings:
            global_settings = dict(config.global_encoder_settings)
        self.encoder = None
        if encoder_settings:
            self.encoder = Encoder(encoder_settings, **global_settings)
            if self.build_device.type != "meta":
                init_parameters(self.encoder, generator=self.rngs["params"])
            if "input_dim" in module_config:
                module_config["input_dim"] = module_config["input_dim"] + self.encoder.dim_increment
        self.m = build_module(
            config.module_name, config=module_config, device=self.build_device, generator=self.rngs["params"]
        )
        attach_generator(self.m, self.rngs["default"])
        self.loss = _build_loss(config)

    def forward(self, batch: Any, **kwargs: Any) -> Any:
        net = batch[INPUT_KEY]
        if self.encoder is not None:
            net = self.encoder(net).merged
        return self.m(net)

    @property
    def all_modules(self) -> List[nn.Module]:
        mods = super().all_modules
        if self.encoder is not None:
            mods.append(self.encoder)
        return mods

    def params_filter(self, scope: str) -> List[Tuple[str, nn.Parameter]]:
        """As `IDLModel.params_filter`, with the encoder's tables in "all" and "core"."""
        if scope not in ("all", "core"):
            return super().params_filter(scope)
        return [(n, p) for n, p in self.named_parameters() if {"m", "encoder"} & set(n.split("."))]


@IDLModel.register("ml.temporal")
class TemporalMLModel(CommonMLModel):
    """The encoder and the net on a (B, T, d) input, its time axis kept."""


def to_ml_model(name: str) -> str:
    return f"ml.{name}"


def register_ml_model(name: str) -> Any:
    """Register an `IDLModel` under the "ml." namespace."""
    return IDLModel.register(to_ml_model(name))


@register_ml_model("wnd")
class WideAndDeepModel(CommonMLModel):
    """"ml.common" for the "wnd" module."""
