"""`Block` and `Pipeline` (counterpart of `cflearn_tpu/pipeline/common.py`):
named, registered blocks that build from one `DLConfig`, run on the data and
save into / load from a pipeline folder; a pipeline runs its blocks in order.
A pipeline holds the device its model lives on (the CUDA card unless the
caller names another)."""

from typing import Any, Dict, List, Optional, Type, TypeVar

import torch

from ..device import resolve_device
from ..schema.config import DLConfig, config_registry
from ..schema.data import IData
from ..toolkit.block_pipeline import IBlock, IPipeline
from ..toolkit.misc import is_local_rank_0
from ..toolkit.registry import WithRegister

TPipeline = TypeVar("TPipeline", bound="Pipeline")


class Block(IBlock, WithRegister):
    """A build / run / serialise unit of a training or inference pipeline."""

    d: Dict[str, type] = {}

    pipeline: Optional["Pipeline"] = None
    # the defaults this block put into the config, for `report.txt`
    _defaults: Dict[str, Any]

    def __init__(self, **kwargs: Any) -> None:
        self._defaults = {}

    @property
    def name(self) -> str:
        return getattr(self, "__identifier__", self.__class__.__name__)

    def build(self, config: DLConfig) -> None:
        pass

    def run(self, data: IData, **kwargs: Any) -> None:
        pass

    def save_extra(self, folder: str) -> None:
        pass

    def load_from(self, folder: str) -> None:
        pass

    @property
    def is_local_rank_0(self) -> bool:
        return is_local_rank_0()

    @property
    def training_workspace(self) -> Optional[str]:
        if self.pipeline is None:
            return None
        return getattr(self.pipeline, "_workspace", None)

    @property
    def device(self) -> torch.device:
        assert self.pipeline is not None, "the block belongs to no pipeline"
        return self.pipeline.device


class Pipeline(IPipeline):
    """Blocks sharing one `DLConfig`."""

    d: Dict[str, type] = {}
    blocks: List[Block]

    def __init__(self, *, device: Any = None) -> None:
        super().__init__()
        self._config: Optional[DLConfig] = None
        self._workspace: Optional[str] = None
        self.data: Optional[IData] = None
        self.device = resolve_device(device)

    @property
    def config(self) -> DLConfig:
        assert self._config is not None
        return self._config

    @classmethod
    def init(cls: Type[TPipeline], config: DLConfig, *, device: Any = None) -> TPipeline:
        self = cls(device=device)
        self._config = config
        self.prepare()
        return self

    @property
    def block_names(self) -> List[str]:
        return []

    @property
    def building_blocks(self) -> List[Block]:
        return [Block.make(name, {}) for name in self.block_names]

    def prepare(self) -> None:
        blocks = self.building_blocks
        for b in blocks:
            b.pipeline = self
        self.build(*blocks)

    def run(self, data: IData, **kwargs: Any) -> None:
        for block in self.blocks:
            block.run(data, **kwargs)

    def to_info(self) -> Dict[str, Any]:
        config_type = "dl"
        for name, cls in config_registry.items():
            if type(self.config) is cls:
                config_type = name
        return {"config": self.config.to_info(), "config_type": config_type, "blocks": [b.name for b in self.blocks]}

    def from_info(self, info: Dict[str, Any]) -> None:
        self._config = config_registry.get(info.get("config_type", "dl"), DLConfig)()
        self._config.from_info(info["config"])
        self.prepare()


class InjectDefaultsMixin:
    """Records the defaults a block injected, for the report (the reference's
    standalone name: `Block` carries `_defaults` itself)."""

    _defaults: Dict[str, Any]

    def __init__(self) -> None:
        self._defaults = {}

    def process_defaults(self, _defaults: Dict[str, Any]) -> None:
        for k, v in self._defaults.items():
            _defaults[k] = v
