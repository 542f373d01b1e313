"""Block pipelines (counterpart of `cflearn_tpu/toolkit/block_pipeline.py`):
`IBlock` / `IPipeline`, the base of both the `DataProcessor` and the
training `Pipeline`. Blocks are named and built in order, each with the
blocks built before it (`previous`)."""

from typing import Any, Dict, List, Optional, Type, TypeVar

from .serialization import ISerializable

TBlock = TypeVar("TBlock", bound="IBlock")


class IBlock:
    """A named unit in a pipeline; `build` receives the shared config object."""

    previous: Dict[str, "IBlock"]

    @property
    def requirements(self) -> List[Type["IBlock"]]:
        return []

    @property
    def name(self) -> str:
        raise NotImplementedError

    def build(self, config: Any) -> None:
        raise NotImplementedError

    def try_get_previous(self, block: Type[TBlock]) -> Optional[TBlock]:
        for b in self.previous.values():
            if isinstance(b, block):
                return b
        return None

    def get_previous(self, block: Type[TBlock]) -> TBlock:
        b = self.try_get_previous(block)
        if b is None:
            raise ValueError(f"`{block.__name__}` not found in previous blocks of `{self.name}`")
        return b


class IPipeline(ISerializable):
    """An ordered collection of `IBlock`s sharing one config."""

    d: Dict[str, type] = {}

    def __init__(self) -> None:
        self.blocks: List[IBlock] = []

    @classmethod
    def init(cls, config: Any) -> "IPipeline":
        raise NotImplementedError

    @property
    def config(self) -> Any:
        raise NotImplementedError

    @property
    def block_mappings(self) -> Dict[str, IBlock]:
        return {b.name: b for b in self.blocks}

    def try_get_block(self, block: Any) -> Optional[IBlock]:
        if isinstance(block, str):
            return self.block_mappings.get(block)
        for b in self.blocks:
            if isinstance(b, block):
                return b
        return None

    def get_block(self, block: Any) -> IBlock:
        b = self.try_get_block(block)
        if b is None:
            raise ValueError(f"block `{block}` not found in pipeline")
        return b

    def remove(self, *names: str) -> None:
        self.blocks = [b for b in self.blocks if b.name not in names]

    def build(self, *blocks: IBlock) -> None:
        previous: Dict[str, IBlock] = self.block_mappings
        for block in blocks:
            block.previous = dict(previous)
            for requirement in block.requirements:
                if not any(isinstance(b, requirement) for b in previous.values()):
                    raise ValueError(
                        f"block `{block.name}` requires `{requirement.__name__}` "
                        "to be built beforehand"
                    )
            block.build(self.config)
            previous[block.name] = block
            self.blocks.append(block)
