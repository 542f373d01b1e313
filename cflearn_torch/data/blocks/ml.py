"""The tabular data blocks (counterpart of `cflearn_tpu/data/blocks/ml.py`),
numpy only, a copy of the JAX package's so that on the same data both
packages produce the same column types, category maps, split indices and
statistics (the splitter draws from numpy's global generator as there):

* `FileParserBlock` — a CSV path (or a list of rows) into an object array
  and a header, the label column split off;
* `RecognizerBlock` — each column numerical, categorical or redundant, the
  categorical values mapped to indices, the labels' kind;
* `NanHandlerBlock` — NaN cells filled (median, mean, most frequent or a
  constant) or their rows dropped;
* `SplitterBlock` / `DataSplitter` — a stratified train / valid split with
  at least one sample of each class on both sides;
* `PreProcessorBlock` — each numerical column (and a regression label)
  scaled (normalize, min-max or robust), with label recovery;
* `GatherBlock` — the final feature and label dims.

The enums and config dataclasses at the end carry the JAX package's names
and string values.
"""

import dataclasses
import math
from enum import Enum
from typing import Any, Dict, List, Optional

import numpy as np

from ...schema.data import DataBundle, IDataBlock

NUMERICAL = "numerical"
CATEGORICAL = "categorical"
REDUNDANT = "redundant"


def _to_2d(x: Any) -> np.ndarray:
    arr = np.asarray(x)
    if arr.ndim == 1:
        arr = arr[:, None]
    return arr


def _try_float_column(col: np.ndarray) -> Optional[np.ndarray]:
    if col.dtype.kind in "fiub":
        return col.astype(np.float64)
    try:
        out = np.empty(len(col), dtype=np.float64)
        for i, v in enumerate(col):
            if v is None or (isinstance(v, str) and not v.strip()):
                out[i] = np.nan
            else:
                out[i] = float(v)
        return out
    except (TypeError, ValueError):
        return None


@IDataBlock.register("ml_file_parser")
class FileParserBlock(IDataBlock):
    """Parse a CSV path (or list-of-rows) into an object array + header."""

    @property
    def fields(self) -> List[str]:
        return ["header", "label_header", "delimiter", "has_header", "label_index", "num_columns"]

    @property
    def init_fields(self) -> Dict[str, Any]:
        return {
            "header": None,
            "label_header": None,
            "delimiter": ",",
            "has_header": True,
            "label_index": None,
            "num_columns": None,
        }

    def _parse(self, x: Any) -> Any:
        import csv

        if isinstance(x, str):
            with open(x, "r", newline="") as f:
                rows = list(csv.reader(f, delimiter=self.delimiter))
        elif isinstance(x, list) and x and isinstance(x[0], (list, tuple)):
            rows = [list(r) for r in x]
        else:
            return x
        if (
            self.has_header
            and rows
            and _try_float_column(np.array(rows[0], dtype=object)) is None
        ):
            if self.header is None:
                self.header = rows[0]
            rows = rows[1:]
        return np.array(rows, dtype=object)

    def _split_xy(self, parsed: np.ndarray, y: Any, for_inference: bool) -> Any:
        if y is not None or parsed is None or not isinstance(parsed, np.ndarray):
            return parsed, y
        if parsed.ndim != 2:
            return parsed, y
        # the label column position is recorded at fit time — later splits
        # (valid CSV, inference CSV) must NOT re-derive it from the header,
        # which had the label removed after the first split
        if self.label_index is not None:
            if self.num_columns is not None and parsed.shape[1] == self.num_columns - 1:
                # a feature-only file (no label column)
                return parsed, y
            idx: Optional[int] = self.label_index
        elif self.label_header is not None and self.header is not None and self.label_header in self.header:
            idx = self.header.index(self.label_header)
        elif self.header is not None or parsed.dtype == object:
            idx = parsed.shape[1] - 1
        else:
            return parsed, y
        if idx is None:
            return parsed, y
        if for_inference and self.label_index is None:
            # never fitted with labels — don't strip a feature column
            return parsed, y
        y_arr = parsed[:, idx : idx + 1]
        x_arr = np.delete(parsed, idx, axis=1)
        if self.label_index is None:
            self.label_index = int(idx)
            self.num_columns = int(parsed.shape[1])
        if self.header is not None and len(self.header) == parsed.shape[1]:
            self.header = [h for i, h in enumerate(self.header) if i != idx]
        return x_arr, y_arr

    def transform(self, bundle: DataBundle, for_inference: bool) -> DataBundle:
        for attr_x, attr_y in (("x_train", "y_train"), ("x_valid", "y_valid")):
            x = getattr(bundle, attr_x)
            if isinstance(x, str) or (isinstance(x, list) and x and isinstance(x[0], (list, tuple))):
                parsed = self._parse(x)
                y = getattr(bundle, attr_y)
                new_x, new_y = self._split_xy(parsed, y, for_inference)
                setattr(bundle, attr_x, new_x)
                if new_y is not None:
                    setattr(bundle, attr_y, new_y)
        return bundle

    def fit_transform(self, bundle: DataBundle) -> DataBundle:
        return self.transform(bundle, False)


@IDataBlock.register("ml_recognizer")
class RecognizerBlock(IDataBlock):
    """Column type inference + categorical → index mapping."""

    @property
    def fields(self) -> List[str]:
        return ["column_types", "categorical_maps", "num_unique_bound", "index_mapping", "is_classification", "label_map"]

    @property
    def init_fields(self) -> Dict[str, Any]:
        return {
            "column_types": None,
            "categorical_maps": None,
            "num_unique_bound": 8,
            "index_mapping": None,
            "is_classification": None,
            "label_map": None,
        }

    # feature handling --------------------------------------------------------

    def _fit_columns(self, x: np.ndarray) -> None:
        n, d = x.shape
        self.column_types = {}
        self.categorical_maps = {}
        for j in range(d):
            col = x[:, j]
            floats = _try_float_column(col)
            if floats is None:
                values = sorted({str(v) for v in col})
                if len(values) <= 1:
                    self.column_types[str(j)] = REDUNDANT
                    continue
                self.column_types[str(j)] = CATEGORICAL
                self.categorical_maps[str(j)] = {v: i for i, v in enumerate(values)}
            else:
                finite = floats[np.isfinite(floats)]
                unique = np.unique(finite)
                if len(unique) <= 1:
                    self.column_types[str(j)] = REDUNDANT
                elif (
                    self.num_unique_bound is not None
                    and len(unique) <= self.num_unique_bound
                    and np.allclose(unique, np.round(unique))
                ):
                    self.column_types[str(j)] = CATEGORICAL
                    self.categorical_maps[str(j)] = {str(float(v)): i for i, v in enumerate(unique)}
                else:
                    self.column_types[str(j)] = NUMERICAL
        self.index_mapping = {}
        new_idx = 0
        for j in range(d):
            if self.column_types[str(j)] != REDUNDANT:
                self.index_mapping[str(j)] = new_idx
                new_idx += 1

    def _convert(self, x: np.ndarray) -> np.ndarray:
        assert self.column_types is not None
        n, d = x.shape
        cols = []
        for j in range(d):
            t = self.column_types.get(str(j), NUMERICAL)
            if t == REDUNDANT:
                continue
            col = x[:, j]
            if t == CATEGORICAL:
                mapping = self.categorical_maps[str(j)]
                floats = _try_float_column(col)
                if floats is not None and all(not isinstance(k, str) or "." in k for k in mapping):
                    keys = [str(float(v)) if np.isfinite(v) else "nan" for v in floats]
                else:
                    keys = [str(v) for v in col]
                converted = np.array([mapping.get(k, len(mapping)) for k in keys], dtype=np.float64)
            else:
                floats = _try_float_column(col)
                converted = floats if floats is not None else np.zeros(n)
            cols.append(converted)
        return np.stack(cols, axis=1) if cols else np.zeros((n, 0))

    # labels ------------------------------------------------------------------

    def _fit_labels(self, y: np.ndarray) -> None:
        col = y[:, 0]
        floats = _try_float_column(col)
        if floats is None:
            values = sorted({str(v) for v in col})
            self.is_classification = True
            self.label_map = {v: i for i, v in enumerate(values)}
        else:
            unique = np.unique(floats[np.isfinite(floats)])
            if len(unique) <= max(2, int(math.sqrt(len(col)))) and np.allclose(unique, np.round(unique)):
                self.is_classification = True
                self.label_map = None
            else:
                self.is_classification = False
                self.label_map = None

    def _convert_labels(self, y: np.ndarray) -> np.ndarray:
        col = y[:, 0]
        if self.label_map is not None:
            out = np.array([self.label_map.get(str(v), 0) for v in col], dtype=np.int64)
            return out[:, None]
        floats = _try_float_column(col)
        assert floats is not None
        if self.is_classification:
            return floats.astype(np.int64)[:, None]
        return floats.astype(np.float64)[:, None]

    # jobs --------------------------------------------------------------------

    def fit_transform(self, bundle: DataBundle) -> DataBundle:
        x = _to_2d(bundle.x_train)
        self._fit_columns(x)
        if bundle.y_train is not None:
            self._fit_labels(_to_2d(bundle.y_train))
        return self.transform(bundle, False)

    def transform(self, bundle: DataBundle, for_inference: bool) -> DataBundle:
        assert self.column_types is not None, "`fit_transform` should be called first"
        for attr_x, attr_y in (("x_train", "y_train"), ("x_valid", "y_valid")):
            x = getattr(bundle, attr_x)
            if x is None:
                continue
            setattr(bundle, attr_x, self._convert(_to_2d(x)))
            y = getattr(bundle, attr_y)
            if y is not None and self.is_classification is not None:
                setattr(bundle, attr_y, self._convert_labels(_to_2d(y)))
        return bundle

    def recover_labels(self, y: np.ndarray) -> np.ndarray:
        if self.label_map is not None:
            inv = {i: v for v, i in self.label_map.items()}
            flat = y.ravel().astype(np.int64)
            return np.array([inv.get(int(v), "") for v in flat], dtype=object).reshape(y.shape)
        return y

    # info used by `SetMLDefaultsBlock` for encoder settings ------------------

    @property
    def encoder_settings(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        if not self.column_types:
            return out
        for j, t in self.column_types.items():
            if t == CATEGORICAL:
                mapping = self.categorical_maps[j]
                idx = self.index_mapping[j]
                out[str(idx)] = {"dim": len(mapping) + 1}
        return out


@IDataBlock.register("ml_nan_handler")
class NanHandlerBlock(IDataBlock):
    """Fill NaNs: mean / median / most_frequent / constant / drop."""

    @property
    def fields(self) -> List[str]:
        return ["method", "fill_values", "constant"]

    @property
    def init_fields(self) -> Dict[str, Any]:
        return {"method": "median", "fill_values": None, "constant": 0.0}

    def fit_transform(self, bundle: DataBundle) -> DataBundle:
        x = np.asarray(bundle.x_train, dtype=np.float64)
        self.fill_values = {}
        for j in range(x.shape[1]):
            col = x[:, j]
            finite = col[np.isfinite(col)]
            if len(finite) == 0:
                value = self.constant
            elif self.method == "mean":
                value = float(np.mean(finite))
            elif self.method == "median":
                value = float(np.median(finite))
            elif self.method == "most_frequent":
                values, counts = np.unique(finite, return_counts=True)
                value = float(values[np.argmax(counts)])
            else:
                value = self.constant
            self.fill_values[str(j)] = value
        return self.transform(bundle, False)

    def transform(self, bundle: DataBundle, for_inference: bool) -> DataBundle:
        if self.method == "drop" and not for_inference:
            # drop NaN rows from BOTH splits — leaving x_valid untouched
            # would leak NaNs into validation metrics
            for attr_x, attr_y in (("x_train", "y_train"), ("x_valid", "y_valid")):
                xv = getattr(bundle, attr_x)
                if xv is None:
                    continue
                x = np.asarray(xv, dtype=np.float64)
                mask = np.isfinite(x).all(axis=1)
                setattr(bundle, attr_x, x[mask])
                yv = getattr(bundle, attr_y)
                if yv is not None:
                    setattr(bundle, attr_y, np.asarray(yv)[mask])
            return bundle
        for attr in ("x_train", "x_valid"):
            x = getattr(bundle, attr)
            if x is None:
                continue
            x = np.asarray(x, dtype=np.float64).copy()
            for j in range(x.shape[1]):
                fill = (self.fill_values or {}).get(str(j), self.constant)
                col = x[:, j]
                col[~np.isfinite(col)] = fill
            setattr(bundle, attr, x)
        return bundle


class DataSplitter:
    """A stratified splitter that keeps at least one sample of each class on
    both sides."""

    def __init__(self, *, shuffle: bool = True) -> None:
        self.shuffle = shuffle

    def split(self, x: np.ndarray, y: Optional[np.ndarray], portion: float) -> Any:
        n = len(x)
        n_split = max(1, int(round(n * portion)))
        indices = np.arange(n)
        if y is not None and np.issubdtype(np.asarray(y).dtype, np.integer):
            labels = np.asarray(y).ravel()
            split_idx: List[int] = []
            rest_idx: List[int] = []
            for c in np.unique(labels):
                c_idx = indices[labels == c]
                if self.shuffle:
                    np.random.shuffle(c_idx)
                k = max(1, int(round(len(c_idx) * portion)))
                k = min(k, len(c_idx) - 1) if len(c_idx) > 1 else len(c_idx)
                split_idx.extend(c_idx[:k])
                rest_idx.extend(c_idx[k:])
            return np.array(rest_idx), np.array(split_idx)
        if self.shuffle:
            np.random.shuffle(indices)
        return indices[n_split:], indices[:n_split]


@IDataBlock.register("ml_splitter")
class SplitterBlock(IDataBlock):
    """Auto train/valid split when no valid set provided."""

    @property
    def fields(self) -> List[str]:
        return ["split", "shuffle"]

    @property
    def init_fields(self) -> Dict[str, Any]:
        return {"split": 0.1, "shuffle": True}

    def fit_transform(self, bundle: DataBundle) -> DataBundle:
        if bundle.x_valid is not None or not self.split:
            return bundle
        x = np.asarray(bundle.x_train)
        y = np.asarray(bundle.y_train) if bundle.y_train is not None else None
        if len(x) <= 4:
            return bundle
        portion = self.split if self.split < 1.0 else self.split / len(x)
        train_idx, valid_idx = DataSplitter(shuffle=self.shuffle).split(x, y, portion)
        bundle.x_valid = x[valid_idx]
        bundle.x_train = x[train_idx]
        if y is not None:
            bundle.y_valid = y[valid_idx]
            bundle.y_train = y[train_idx]
        return bundle

    def transform(self, bundle: DataBundle, for_inference: bool) -> DataBundle:
        return bundle


@IDataBlock.register("ml_preprocessor")
class PreProcessorBlock(IDataBlock):
    """Per-column feature (and regression-label) scaling."""

    @property
    def fields(self) -> List[str]:
        return ["method", "label_method", "feature_stats", "label_stats", "skip_columns"]

    @property
    def init_fields(self) -> Dict[str, Any]:
        return {
            "method": "normalize",
            "label_method": "normalize",
            "feature_stats": None,
            "label_stats": None,
            "skip_columns": None,
        }

    def _compute_stats(self, col: np.ndarray, method: str) -> Dict[str, float]:
        if method == "min_max":
            lo, hi = float(np.min(col)), float(np.max(col))
            return {"center": lo, "scale": max(hi - lo, 1e-8)}
        if method == "robust":
            q1, q2, q3 = np.percentile(col, [25, 50, 75])
            return {"center": float(q2), "scale": max(float(q3 - q1), 1e-8)}
        return {"center": float(np.mean(col)), "scale": max(float(np.std(col)), 1e-8)}

    def fit_transform(self, bundle: DataBundle) -> DataBundle:
        x = np.asarray(bundle.x_train, dtype=np.float64)
        skip = set(self.skip_columns or [])
        recognizer = self.try_get_previous(RecognizerBlock) if hasattr(self, "previous") else None
        if recognizer is not None and recognizer.column_types:
            for j_orig, t in recognizer.column_types.items():
                if t == CATEGORICAL and recognizer.index_mapping and j_orig in recognizer.index_mapping:
                    skip.add(recognizer.index_mapping[j_orig])
        self.skip_columns = sorted(skip)
        self.feature_stats = {}
        for j in range(x.shape[1]):
            if j in skip:
                continue
            self.feature_stats[str(j)] = self._compute_stats(x[:, j], self.method)
        y = bundle.y_train
        self.label_stats = None
        if y is not None and np.issubdtype(np.asarray(y).dtype, np.floating) and self.label_method:
            self.label_stats = self._compute_stats(np.asarray(y, dtype=np.float64).ravel(), self.label_method)
        return self.transform(bundle, False)

    def transform(self, bundle: DataBundle, for_inference: bool) -> DataBundle:
        assert self.feature_stats is not None, "`fit_transform` should be called first"
        for attr in ("x_train", "x_valid"):
            x = getattr(bundle, attr)
            if x is None:
                continue
            x = np.asarray(x, dtype=np.float64).copy()
            for j_str, stats in self.feature_stats.items():
                j = int(j_str)
                if j < x.shape[1]:
                    x[:, j] = (x[:, j] - stats["center"]) / stats["scale"]
            setattr(bundle, attr, x.astype(np.float32))
        if self.label_stats is not None:
            for attr in ("y_train", "y_valid"):
                y = getattr(bundle, attr)
                if y is None:
                    continue
                y = np.asarray(y, dtype=np.float64)
                y = (y - self.label_stats["center"]) / self.label_stats["scale"]
                setattr(bundle, attr, y.astype(np.float32))
        return bundle

    def recover_labels(self, y: np.ndarray) -> np.ndarray:
        if self.label_stats is None:
            return y
        return y * self.label_stats["scale"] + self.label_stats["center"]


@IDataBlock.register("ml_gather")
class GatherBlock(IDataBlock):
    """Record the final feature / label dims."""

    @property
    def fields(self) -> List[str]:
        return ["num_features", "num_labels", "num_classes", "is_classification"]

    @property
    def init_fields(self) -> Dict[str, Any]:
        return {"num_features": None, "num_labels": None, "num_classes": None, "is_classification": None}

    def fit_transform(self, bundle: DataBundle) -> DataBundle:
        x = np.asarray(bundle.x_train)
        self.num_features = int(x.shape[1]) if x.ndim == 2 else int(np.prod(x.shape[1:]))
        if bundle.y_train is not None:
            y = np.asarray(bundle.y_train)
            self.is_classification = bool(np.issubdtype(y.dtype, np.integer))
            if self.is_classification:
                # count classes over BOTH splits: the stratified splitter can
                # move a singleton top class entirely into valid
                ys = [y]
                if bundle.y_valid is not None:
                    ys.append(np.asarray(bundle.y_valid))
                self.num_classes = int(max(int(np.max(a)) for a in ys)) + 1
                self.num_labels = self.num_classes
            else:
                self.num_labels = int(y.shape[1]) if y.ndim == 2 else 1
        recognizer = self.try_get_previous(RecognizerBlock) if hasattr(self, "previous") else None
        if recognizer is not None and recognizer.is_classification is not None:
            self.is_classification = recognizer.is_classification
        return self.transform(bundle, False)

    def transform(self, bundle: DataBundle, for_inference: bool) -> DataBundle:
        for attr in ("x_train", "x_valid"):
            x = getattr(bundle, attr)
            if x is not None:
                setattr(bundle, attr, np.ascontiguousarray(np.asarray(x, dtype=np.float32)))
        return bundle


# ---------------------------------------------------------------------------
# the enums and per-block config dataclasses of the JAX package (the blocks above consume the same string
# values)
# ---------------------------------------------------------------------------

class DataTypes(str, Enum):
    INT = "int"
    FLOAT = "float"
    STRING = "string"


class ColumnTypes(str, Enum):
    REDUNDANT = REDUNDANT
    NUMERICAL = NUMERICAL
    CATEGORICAL = CATEGORICAL


class DataOrder(str, Enum):
    NONE = "none"
    TOP_DOWN = "top_down"
    BOTTOM_UP = "bottom_up"


class NanReplaceMethod(str, Enum):
    MEAN = "mean"
    MEDIAN = "median"


class NanDropStrategy(str, Enum):
    NONE = "none"
    DROP_Y = "drop_y"
    DROP_ALL = "drop_all"


class PreProcessMethods(str, Enum):
    MIN_MAX = "min_max"
    NORMALIZE = "normalize"
    QUANTILE_NORMALIZE = "quantile_normalize"


@dataclasses.dataclass
class MLNanHandlerConfig:
    drop_strategy: str = NanDropStrategy.DROP_Y
    replace_method: str = NanReplaceMethod.MEDIAN


@dataclasses.dataclass
class MLRecognizerConfig:
    all_close_threshold: float = 1.0e-6
    redundancy_threshold: float = 0.5
    custom_feature_types: Optional[Dict[str, str]] = None


@dataclasses.dataclass
class MLSplitterConfig:
    num_split: Optional[Any] = None
    min_split: Optional[int] = None
    max_split: int = 10000
    split_order: str = DataOrder.NONE
    split_shuffle: bool = True
    is_classification: Optional[bool] = None


@dataclasses.dataclass
class MLPreProcessConfig:
    auto_preprocess: bool = True
    preprocess_methods: Optional[Dict[str, str]] = None
    preprocess_configs: Optional[Dict[str, Dict[str, Any]]] = None
    label_preprocess_methods: Optional[Dict[str, str]] = None
    label_preprocess_configs: Optional[Dict[str, Dict[str, Any]]] = None
