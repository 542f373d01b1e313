"""The DDR model (counterpart of `cflearn_tpu/models/ml/ddr.py`): "common"
with the "ddr" loss unless the config names another."""

from ...schema.config import DLConfig
from ...schema.model import IDLModel
from ..common import CommonDLModel


@IDLModel.register("ml.ddr")
class DDRModel(CommonDLModel):
    def build(self, config: DLConfig) -> None:
        if config.loss_name is None:
            config.loss_name = "ddr"
        super().build(config)
