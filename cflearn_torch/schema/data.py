"""Data interfaces (counterpart of `cflearn_tpu/schema/data.py`): dataset,
loader, bundle, data blocks, processor and the `IData` facade, with
`split_validation` and sample weights. Loaders yield numpy dict batches (the
keys of `constants.py`); the host-to-card boundary is the trainer's
`DeviceBatcher` (`data/utils.py`), not here.
"""

import dataclasses
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple, Type, TypeVar, Union

import numpy as np

from ..toolkit.block_pipeline import IBlock, IPipeline
from ..toolkit.misc import is_local_rank_0, np_dict_type
from ..toolkit.serialization import DataClassBase, ISerializable

data_type = Optional[Union[np.ndarray, List[Any], Dict[str, Any], str]]
TData = TypeVar("TData", bound="IData")
TDataBlock = TypeVar("TDataBlock", bound="IDataBlock")


# ----------------------------------------------------------------------------
# dataset / loader
# ----------------------------------------------------------------------------

class IDataset:
    """Minimal dataset: length + fancy-index `__getitem__` → numpy dict.

    """

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, item: Union[int, List[int], np.ndarray]) -> np_dict_type:
        raise NotImplementedError


class IDataLoader:
    """Iterating yields numpy dict batches."""

    dataset: IDataset
    batch_size: int

    def __init__(self, *, sample_weights: Optional[np.ndarray] = None) -> None:
        self.sample_weights = sample_weights

    def __iter__(self) -> Iterator[np_dict_type]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def copy(self) -> "IDataLoader":
        import copy as _copy

        return _copy.deepcopy(self)

    def disable_shuffle(self) -> None:
        raise NotImplementedError

    def recover_shuffle(self) -> None:
        raise NotImplementedError

    def temporarily_disable_shuffle(self) -> "_ShuffleCtx":
        return _ShuffleCtx(self)

    def get_one_batch(self) -> np_dict_type:
        return next(iter(self))

    def get_full_batch(self) -> np_dict_type:
        batch_size = self.batch_size
        self.batch_size = len(self.dataset)
        try:
            with self.temporarily_disable_shuffle():
                full = next(iter(self))
        finally:
            self.batch_size = batch_size
        return full


class _ShuffleCtx:
    def __init__(self, loader: IDataLoader) -> None:
        self.loader = loader

    def __enter__(self) -> None:
        self.loader.disable_shuffle()

    def __exit__(self, *args: Any) -> None:
        self.loader.recover_shuffle()


# ----------------------------------------------------------------------------
# bundle
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class DataBundle(DataClassBase):
    """x / y train / valid arrays and the `*_others` dicts."""

    x_train: data_type = None
    y_train: data_type = None
    x_valid: data_type = None
    y_valid: data_type = None
    train_others: Optional[np_dict_type] = None
    valid_others: Optional[np_dict_type] = None

    @classmethod
    def empty(cls) -> "DataBundle":
        return cls()

    def to_info(self) -> Dict[str, Any]:
        info: Dict[str, Any] = {}
        for f in self.fields:
            v = getattr(self, f.name)
            if v is None or isinstance(v, np.ndarray):
                continue
            if isinstance(v, dict):
                # arrays go through to_npd; keep the NON-array entries here so
                # mixed dicts survive the round trip intact
                rest = {k: vv for k, vv in v.items() if not isinstance(vv, np.ndarray)}
                if rest:
                    info[f.name] = rest
                continue
            info[f.name] = v
        return info

    def to_npd(self) -> Dict[str, np.ndarray]:
        npd: Dict[str, np.ndarray] = {}
        for f in self.fields:
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                npd[f.name] = v
            elif isinstance(v, dict):
                for k, vv in v.items():
                    if isinstance(vv, np.ndarray):
                        npd[f"{f.name}::{k}"] = vv
        return npd

    def from_npd(self, npd: Dict[str, np.ndarray]) -> None:
        for k, v in npd.items():
            if "::" in k:
                field, sub = k.split("::", 1)
                d = getattr(self, field) or {}
                d[sub] = v
                setattr(self, field, d)
            else:
                setattr(self, k, v)


# ----------------------------------------------------------------------------
# data blocks
# ----------------------------------------------------------------------------

class IDataBlock(IBlock, ISerializable):
    """A data-transform block with four jobs:

    * `transform(bundle, for_inference)` — pure bundle→bundle transform;
    * `fit_transform(bundle)` — fit internal state on train split, then transform;
    * `postprocess_item(item, for_inference)` — on-the-fly per-batch transform;
    * `recover_labels(y)` — inverse label transform (run reversed by processor).

    Serializable state is declared via `fields` and flows through `to_info`.
    """

    d: Dict[str, type] = {}

    def __init__(self, **kwargs: Any) -> None:
        not_exist = object()
        for field in self.fields:
            value = kwargs.get(field, not_exist)
            if value is not_exist:
                value = self.init_fields.get(field)
            setattr(self, field, value)

    @property
    def name(self) -> str:
        return getattr(self, "__identifier__", self.__class__.__name__)

    @property
    def fields(self) -> List[str]:
        return []

    @property
    def init_fields(self) -> Dict[str, Any]:
        return {}

    @property
    def is_local_rank_0(self) -> bool:
        return is_local_rank_0()

    def build(self, config: Any) -> None:
        pass

    def to_info(self) -> Dict[str, Any]:
        return {field: getattr(self, field, None) for field in self.fields}

    def from_info(self, info: Dict[str, Any]) -> None:
        for field, value in info.items():
            setattr(self, field, value)

    # the 4 jobs --------------------------------------------------------------

    def transform(self, bundle: DataBundle, for_inference: bool) -> DataBundle:
        return bundle

    def fit_transform(self, bundle: DataBundle) -> DataBundle:
        return self.transform(bundle, False)

    def postprocess_item(self, item: Any, for_inference: bool) -> Any:
        return item

    def recover_labels(self, y: np.ndarray) -> np.ndarray:
        return y


class INoInitDataBlock(IDataBlock):
    """A block with no configuration."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()


# ----------------------------------------------------------------------------
# processor
# ----------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class DataProcessorConfig(DataClassBase, ISerializable):
    d: Dict[str, type] = dataclasses.field(default_factory=dict, repr=False)
    block_names: Optional[List[str]] = None
    block_configs: Optional[Dict[str, Dict[str, Any]]] = None

    def __post_init__(self) -> None:
        pass

    @property
    def default_blocks(self) -> List[IDataBlock]:
        return []

    def add_blocks(self, *blocks: IDataBlock) -> None:
        if self.block_names is None:
            self.block_names = []
        for b in blocks:
            name = b.name
            if name in self.block_names:
                continue
            self.block_names.append(name)
            bc = b.to_info()
            if bc:
                if self.block_configs is None:
                    self.block_configs = {}
                self.block_configs.setdefault(name, bc)

    def set_blocks(self, *blocks: IDataBlock) -> None:
        self.block_names = []
        self.add_blocks(*blocks)

    def to_info(self) -> Dict[str, Any]:
        return dict(block_names=self.block_names, block_configs=self.block_configs)


DataProcessorConfig.d = {}


class DataProcessor(IPipeline):
    """Runs its `IDataBlock`s in order; `recover_labels` runs them reversed."""

    d: Dict[str, type] = {}
    blocks: List[IDataBlock]
    is_ready: bool = False

    def __init__(self) -> None:
        super().__init__()
        self._config: Optional[DataProcessorConfig] = None

    @property
    def config(self) -> Optional[DataProcessorConfig]:
        return self._config

    @classmethod
    def init(cls, config: Optional[DataProcessorConfig]) -> "DataProcessor":
        self = cls()
        config = config.copy() if config is not None else DataProcessorConfig()
        self._config = config
        if config.block_names is None:
            blocks = list(getattr(config, "default_blocks", []))
            # block_configs apply to default blocks too — silently ignoring
            # them made e.g. `{"ml_file_parser": {"label_header": ...}}` a
            # no-op with the bundled preset
            for b in blocks:
                for k, v in (config.block_configs or {}).get(b.name, {}).items():
                    setattr(b, k, v)
        else:
            block_configs = config.block_configs or {}
            blocks = [
                IDataBlock.make(name, block_configs.get(name, {}))
                for name in config.block_names
            ]
        self.build(*blocks)
        return self

    def _run(self, fn: str, bundle: DataBundle, for_inference: bool) -> DataBundle:
        for block in self.blocks:
            if fn == "fit_transform":
                bundle = block.fit_transform(bundle)
            else:
                bundle = block.transform(bundle, for_inference)
        return bundle

    def transform(self, bundle: DataBundle, *, for_inference: bool) -> DataBundle:
        return self._run("transform", bundle, for_inference)

    def fit_transform(self, bundle: DataBundle) -> DataBundle:
        bundle = self._run("fit_transform", bundle, False)
        self.is_ready = True
        return bundle

    def postprocess_item(self, item: Any, *, for_inference: bool = False) -> Any:
        for block in self.blocks:
            item = block.postprocess_item(item, for_inference)
        return item

    def recover_labels(self, y: np.ndarray) -> np.ndarray:
        for block in self.blocks[::-1]:
            y = block.recover_labels(y)
        return y

    # serialization ------------------------------------------------------------

    def to_info(self) -> Dict[str, Any]:
        return {
            "is_ready": self.is_ready,
            "blocks": [
                {"type": b.name, "info": b.to_info()}
                for b in self.blocks
            ],
        }

    def from_info(self, info: Dict[str, Any]) -> None:
        self.is_ready = info.get("is_ready", False)
        self._config = DataProcessorConfig()
        blocks = []
        for pack in info.get("blocks", []):
            block = IDataBlock.get(pack["type"])()
            block.from_info(pack["info"])
            blocks.append(block)
        self.blocks = []
        self.build(*blocks)


DataProcessor.register("base")(DataProcessor)


# ----------------------------------------------------------------------------
# IData facade
# ----------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class DataConfig(DataClassBase, ISerializable):
    d: Dict[str, type] = dataclasses.field(default_factory=dict, repr=False)
    batch_size: int = 128
    valid_batch_size: Optional[int] = None
    shuffle_train: bool = True
    shuffle_valid: bool = False
    drop_last: bool = False
    for_inference: bool = False
    pad_to_multiple: Optional[int] = None

    def to_info(self) -> Dict[str, Any]:
        return self.asdict()

    @classmethod
    def inference_with(cls, batch_size: int) -> "DataConfig":
        cfg = cls()
        cfg.batch_size = batch_size
        cfg.for_inference = True
        cfg.shuffle_train = False
        return cfg


DataConfig.d = {}


class IData(ISerializable):
    """`init(config, processor_config)`, then `fit(x, y, ...)`, then
    `get_loaders()`."""

    d: Dict[str, type] = {}
    processor_base: Type[DataProcessor] = DataProcessor
    config_base: Type[DataConfig] = DataConfig
    processor_config_base: Type[DataProcessorConfig] = DataProcessorConfig

    def __init__(self) -> None:
        self.config = self.config_base()
        self.processor: Optional[DataProcessor] = None
        self.bundle: Optional[DataBundle] = None
        self.train_weights: Optional[np.ndarray] = None
        self.valid_weights: Optional[np.ndarray] = None

    # lifecycle ---------------------------------------------------------------

    @classmethod
    def init(
        cls: Type[TData],
        config: Optional[DataConfig] = None,
        processor_config: Optional[DataProcessorConfig] = None,
    ) -> TData:
        self = cls()
        if config is not None:
            self.config = config
        self.processor = self.processor_base.init(processor_config)
        return self

    def fit(
        self: TData,
        x_train: data_type = None,
        y_train: data_type = None,
        x_valid: data_type = None,
        y_valid: data_type = None,
        train_others: Optional[np_dict_type] = None,
        valid_others: Optional[np_dict_type] = None,
        **kwargs: Any,
    ) -> TData:
        bundle = DataBundle(x_train, y_train, x_valid, y_valid, train_others, valid_others)
        assert self.processor is not None
        self.bundle = self.processor.fit_transform(bundle)
        return self

    def transform(self, x: data_type, y: data_type = None, **kwargs: Any) -> DataBundle:
        assert self.processor is not None and self.processor.is_ready
        bundle = DataBundle(x, y)
        # always the inference path: labelled evaluation inputs must not run
        # train-only transforms (row drops, augmentation) that break row
        # alignment with the caller's arrays
        return self.processor.transform(bundle, for_inference=True)

    def recover_labels(self, y: np.ndarray) -> np.ndarray:
        assert self.processor is not None
        return self.processor.recover_labels(y)

    def get_loaders(self) -> Tuple[IDataLoader, Optional[IDataLoader]]:
        raise NotImplementedError

    def build_loader(self, x: data_type, y: data_type = None, **kwargs: Any) -> IDataLoader:
        raise NotImplementedError

    def split_validation(self: TData, split: Union[int, float], *, seed: int = 0) -> TData:
        """Carve a validation set out of ``x_train`` when none was provided.

        ``split`` < 1 is a portion of the train rows, otherwise a sample
        count. Rows are drawn with a seeded permutation so repeated fits see
        the same split (consumed by `TrainerConfig.validation_split`)."""
        assert self.bundle is not None, "`fit` the data before splitting"
        if self.bundle.x_valid is not None:
            return self
        n = _num_samples(self.bundle.x_train)
        if isinstance(split, float) and split < 1.0:
            n_valid = int(round(n * split))
        else:
            n_valid = int(split)
        n_valid = max(1, min(n_valid, n - 1))
        perm = np.random.default_rng(seed).permutation(n)
        valid_idx, train_idx = perm[:n_valid], perm[n_valid:]

        def take(x: Any, idx: np.ndarray) -> Any:
            if x is None:
                return None
            if isinstance(x, np.ndarray):
                return x[idx]
            if isinstance(x, dict):
                return {k: take(v, idx) for k, v in x.items()}
            if isinstance(x, list):
                return [x[int(i)] for i in idx]
            raise TypeError(f"cannot split data of type {type(x)}")

        b = self.bundle
        b.x_valid = take(b.x_train, valid_idx)
        b.y_valid = take(b.y_train, valid_idx)
        b.valid_others = take(b.train_others, valid_idx)
        b.x_train = take(b.x_train, train_idx)
        b.y_train = take(b.y_train, train_idx)
        b.train_others = take(b.train_others, train_idx)
        return self

    def set_sample_weights(self: TData, sample_weights: Optional[np.ndarray]) -> TData:
        if sample_weights is None:
            self.train_weights = self.valid_weights = None
            return self
        assert self.bundle is not None
        n_train = _num_samples(self.bundle.x_train)
        self.train_weights = sample_weights[:n_train]
        if self.bundle.x_valid is not None:
            self.valid_weights = sample_weights[n_train:]
        return self

    # serialization -------------------------------------------------------------

    def to_info(self) -> Dict[str, Any]:
        assert self.processor is not None
        return {
            "config": self.config.to_info(),
            "processor": self.processor.to_info(),
            "bundle_info": self.bundle.to_info() if self.bundle is not None else None,
        }

    def from_info(self, info: Dict[str, Any]) -> None:
        self.config = self.config_base()
        self.config.from_info(info["config"])
        self.processor = self.processor_base()
        self.processor.from_info(info["processor"])
        if info.get("bundle_info") is not None:
            self.bundle = DataBundle()
            self.bundle.from_info(info["bundle_info"])

    def to_npd(self) -> Dict[str, np.ndarray]:
        return self.bundle.to_npd() if self.bundle is not None else {}

    def from_npd(self, npd: Dict[str, np.ndarray]) -> None:
        if npd:
            if self.bundle is None:
                self.bundle = DataBundle()
            self.bundle.from_npd(npd)

    # properties ----------------------------------------------------------------

    @property
    def num_train(self) -> int:
        assert self.bundle is not None
        return _num_samples(self.bundle.x_train)

    @property
    def num_valid(self) -> int:
        if self.bundle is None or self.bundle.x_valid is None:
            return 0
        return _num_samples(self.bundle.x_valid)


def _num_samples(x: data_type) -> int:
    if x is None:
        return 0
    if isinstance(x, np.ndarray):
        return x.shape[0]
    if isinstance(x, dict):
        for v in x.values():
            if isinstance(v, np.ndarray):
                return v.shape[0]
        return 0
    return len(x)


def norm_sw(sample_weights: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Sample weights scaled to sum to 1 (None stays None)."""
    if sample_weights is None:
        return None
    return sample_weights / np.sum(sample_weights)


# sample weights: the training set's, or (training, validation)
sample_weights_type = Optional[Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]]


def split_sw(sample_weights: sample_weights_type) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(training, validation) sample weights, each scaled to sum to 1; one
    array is the training set's."""
    if sample_weights is None:
        train_weights = valid_weights = None
    elif not isinstance(sample_weights, np.ndarray):
        train_weights, valid_weights = sample_weights
    else:
        train_weights, valid_weights = sample_weights, None
    return norm_sw(train_weights), norm_sw(valid_weights)


class DataArgs(NamedTuple):
    """A slice of a data bundle: (x, y, others)."""

    x: Any
    y: Any
    others: Optional[np_dict_type]

    @property
    def xy(self) -> Tuple[Any, Any]:
        return self.x, self.y


# the reference's type aliases
texts_type = Union[str, List[str]]
configs_type = Optional[Union[List[Dict[str, Any]], Dict[str, Any]]]
general_config_type = Optional[Union[str, Dict[str, Any]]]
states_callback_type = Optional[Any]
