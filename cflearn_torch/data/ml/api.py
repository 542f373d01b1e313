"""`MLData`, the tabular data facade (counterpart of
`cflearn_tpu/data/ml/api.py`): the processor configs (`MLProcessorConfig`,
"ml", only the `GatherBlock`; `MLBundledProcessorConfig`, "ml.bundled",
parser -> recogniser -> NaN handler -> splitter -> preprocessor -> gather;
`MLAdvancedProcessorConfig` for arrays the tabular stack must not touch),
`MLDataProcessor`, `MLData` ("ml", the bundled stack by default) with the
dims, the classification flag and the recogniser's encoder settings, and
`MLBatch`, `MLFileProcessorConfig`, `MLDataConfig` under the JAX package's
names and registry keys, so that a data folder either package saved loads
in the other.
"""

import dataclasses
from enum import Enum
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from ...schema.data import DataConfig, DataProcessor, DataProcessorConfig, IData, IDataBlock
from ..array import ArrayData
from ..blocks.ml import (
    FileParserBlock,
    GatherBlock,
    NanHandlerBlock,
    PreProcessorBlock,
    RecognizerBlock,
    SplitterBlock,
)
from ..utils import ArrayDataset, ArrayLoader, IArrayDataMixin


@dataclasses.dataclass(eq=False)
class MLProcessorConfig(DataProcessorConfig):
    @property
    def default_blocks(self) -> List[IDataBlock]:
        return [GatherBlock()]


@dataclasses.dataclass(eq=False)
class MLBundledProcessorConfig(MLProcessorConfig):
    """FileParser -> Recognizer -> NanHandler -> Splitter -> PreProcessor ->
    Gather."""

    @property
    def default_blocks(self) -> List[IDataBlock]:
        return [
            FileParserBlock(),
            RecognizerBlock(),
            NanHandlerBlock(),
            SplitterBlock(),
            PreProcessorBlock(),
            GatherBlock(),
        ]


@dataclasses.dataclass(eq=False)
class MLAdvancedProcessorConfig(MLBundledProcessorConfig):
    """Only the `GatherBlock`: for array inputs (temporal (B, T, d) ones, say)
    that the tabular parser and recogniser must not touch."""

    @property
    def default_blocks(self) -> List[IDataBlock]:
        return [GatherBlock()]


MLProcessorConfig.d = DataProcessorConfig.d
DataProcessorConfig.register("ml")(MLProcessorConfig)
DataProcessorConfig.register("ml.bundled")(MLBundledProcessorConfig)


class MLDataProcessor(DataProcessor):
    pass


DataProcessor.register("ml")(MLDataProcessor)


@IData.register("ml")
class MLData(IArrayDataMixin, IData):
    """Tabular data with the bundled block stack by default."""

    processor_base = MLDataProcessor
    processor_config_base = MLBundledProcessorConfig

    @classmethod
    def init(
        cls,
        config: Any = None,
        processor_config: Optional[DataProcessorConfig] = None,
    ) -> "MLData":
        if processor_config is None:
            processor_config = MLBundledProcessorConfig()
        return super().init(config, processor_config)  # type: ignore[return-value]

    # the gathered dims and the recogniser's settings

    def _gather(self) -> Optional[GatherBlock]:
        if self.processor is None:
            return None
        return self.processor.try_get_block(GatherBlock)  # type: ignore[return-value]

    @property
    def num_features(self) -> Optional[int]:
        g = self._gather()
        return None if g is None else g.num_features

    @property
    def num_labels(self) -> Optional[int]:
        g = self._gather()
        return None if g is None else g.num_labels

    @property
    def num_classes(self) -> Optional[int]:
        g = self._gather()
        return None if g is None else g.num_classes

    @property
    def is_classification(self) -> Optional[bool]:
        g = self._gather()
        return None if g is None else g.is_classification

    @property
    def encoder_settings(self) -> Dict[str, Dict[str, Any]]:
        if self.processor is None:
            return {}
        recognizer = self.processor.try_get_block(RecognizerBlock)
        if recognizer is None:
            return {}
        return recognizer.encoder_settings

    def get_arrays(self, for_valid: bool) -> Optional[Dict[str, np.ndarray]]:
        return ArrayData.get_arrays(self, for_valid)  # type: ignore[arg-type]


# the JAX package's names of the tabular batch, file config and data config

class MLDatasetTag(str, Enum):
    TRAIN = "train"
    VALID = "validation"


class MLBatch(NamedTuple):
    input: np.ndarray
    labels: Optional[np.ndarray]
    others: Optional[Dict[str, np.ndarray]] = None


@dataclasses.dataclass(eq=False)
class MLFileProcessorConfig(MLProcessorConfig):
    """CSV/file-parsing preset (the FileParserBlock consumes these keys)."""

    delimiter: str = ","
    has_header: bool = True
    label_names: Optional[List[str]] = None
    label_indices: Optional[List[int]] = None
    contain_labels: bool = True
    auto_convert_labels: bool = True
    custom_dtypes: Optional[Dict[str, str]] = None
    custom_mappings: Optional[Dict[str, Dict[str, int]]] = None
    default_values: Optional[Dict[str, int]] = None


@dataclasses.dataclass(eq=False)
class MLDataConfig(DataConfig):
    batch_size: int = 128
    valid_batch_size: int = 256


# the tabular dataset and loader are the array ones
MLDataset = ArrayDataset
MLLoader = ArrayLoader
