"""Data (counterpart of `cflearn_tpu/data/`): the array datasets and
loaders, the host-to-card batcher, and the tabular data (`MLData` and the
ML blocks). The CV blocks and the image-folder data are still to be
ported."""

from .array import ArrayData, ArrayDictData
from .blocks import ml as ml_blocks
from .ml.api import MLData
from .utils import (
    ArrayDataset, ArrayLoader, DeviceBatcher, IArrayDataMixin, get_weighted_indices, predict_array_data,
)

__all__ = [
    "ArrayData", "ArrayDataset", "ArrayDictData", "ArrayLoader", "DeviceBatcher", "IArrayDataMixin", "MLData",
    "get_weighted_indices", "predict_array_data",
]
