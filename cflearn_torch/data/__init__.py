"""Data (counterpart of `cflearn_tpu/data/`): the array datasets and
loaders, and the host-to-card batcher. The tabular data (`MLData`, the ML
blocks) belongs to the tabular side; the CV blocks and the image-folder data
are still to be ported."""

from .array import ArrayData, ArrayDictData
from .utils import (
    ArrayDataset, ArrayLoader, DeviceBatcher, IArrayDataMixin, get_weighted_indices, predict_array_data,
)

__all__ = [
    "ArrayData", "ArrayDataset", "ArrayDictData", "ArrayLoader", "DeviceBatcher", "IArrayDataMixin",
    "get_weighted_indices", "predict_array_data",
]
