"""`ArrayData` / `ArrayDictData` (counterpart of `cflearn_tpu/data/array.py`):
in-memory arrays in, loaders out; registered "array" and "array_dict", the
JAX package's names, so that a data folder either package saved loads in
the other."""

from typing import Dict, Optional

import numpy as np

from ..constants import INPUT_KEY, LABEL_KEY
from ..schema.data import IData
from .utils import IArrayDataMixin


@IData.register("array")
class ArrayData(IArrayDataMixin, IData):
    """x / y numpy arrays in, loaders out."""

    def get_arrays(self, for_valid: bool) -> Optional[Dict[str, np.ndarray]]:
        assert self.bundle is not None
        x = self.bundle.x_valid if for_valid else self.bundle.x_train
        y = self.bundle.y_valid if for_valid else self.bundle.y_train
        others = self.bundle.valid_others if for_valid else self.bundle.train_others
        if x is None:
            return None
        arrays = {INPUT_KEY: np.asarray(x)}
        if y is not None:
            arrays[LABEL_KEY] = np.asarray(y)
        if others:
            arrays.update({k: v for k, v in others.items() if isinstance(v, np.ndarray)})
        return arrays


@IData.register("array_dict")
class ArrayDictData(IArrayDataMixin, IData):
    """A dict of arrays in: `x_train` itself is the batch dict."""

    def get_arrays(self, for_valid: bool) -> Optional[Dict[str, np.ndarray]]:
        assert self.bundle is not None
        x = self.bundle.x_valid if for_valid else self.bundle.x_train
        y = self.bundle.y_valid if for_valid else self.bundle.y_train
        if x is None:
            return None
        assert isinstance(x, dict), "`ArrayDictData` expects dict inputs"
        arrays = {k: np.asarray(v) for k, v in x.items()}
        if y is not None:
            arrays[LABEL_KEY] = np.asarray(y)
        return arrays


# the reference's dataset names: dict batches are served by the same fancy-indexing array dataset
from .utils import ArrayDataset as ArrayDictDataset  # noqa: E402

IArrayDictDataset = ArrayDictDataset
