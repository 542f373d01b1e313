"""Data (counterpart of `cflearn_tpu/data/`): the array datasets and
loaders, the host-to-card batcher, the tabular data (`MLData` and the ML
blocks), the CV blocks, the image-folder data (`data/cv/`) and external
datasets (`external.py`)."""

from .array import ArrayData, ArrayDictData
from .blocks import cv as cv_blocks
from .blocks import ml as ml_blocks
from .cv import DefaultPreparation, ImageFolderData, IPreparation, ResizedPreparation, prepare_image_folder
from .external import ExternalData, ExternalDataset
from .ml.api import MLData
from .utils import (
    ArrayDataset, ArrayLoader, DeviceBatcher, IArrayDataMixin, get_weighted_indices, predict_array_data,
)

__all__ = [
    "ArrayData", "ArrayDataset", "ArrayDictData", "ArrayLoader", "DefaultPreparation", "DeviceBatcher",
    "ExternalData", "ExternalDataset", "IArrayDataMixin", "IPreparation", "ImageFolderData", "MLData",
    "ResizedPreparation", "get_weighted_indices", "predict_array_data", "prepare_image_folder",
]
