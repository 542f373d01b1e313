"""Array loaders and the host-to-card batcher (counterpart of
`cflearn_tpu/data/utils.py`).

`ArrayLoader` resamples by the sample weights (`get_weighted_indices`),
shuffles with the global `np.random` and slices batches, adding
`BATCH_INDICES_KEY`, exactly as the JAX loader does: the same numpy seed
gives the same batches on both sides.

`DeviceBatcher` turns the loader's numpy batches into tensors on a device:
f64 arrays become f32 (integer arrays keep their dtype: PyTorch indexes with
i64 where the JAX package moves i32), host memory is pinned and the copies
are `non_blocking` on a CUDA device, and `prefetch` batches (2) are in
flight ahead of the step that consumes them (`convert` moves one batch).
Batches are not sharded: the port trains on one device, and a mesh of more
than one device is refused by the `Trainer`.
"""

import collections
import itertools
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..constants import BATCH_INDICES_KEY, INPUT_KEY, LABEL_KEY, PREDICTIONS_KEY
from ..schema.data import DataConfig, IDataLoader, IDataset
from ..toolkit.misc import np_dict_type, to_device_dtype


def get_weighted_indices(n: int, weights: Optional[np.ndarray], ensure_all_occur: bool = False) -> np.ndarray:
    """Multinomial resampling of range(n) by `weights` (range(n) without)."""
    indices = np.arange(n)
    if weights is not None:
        p = np.asarray(weights, dtype=np.float64)
        p = p / p.sum()
        numbers = np.random.multinomial(n, p)
        if ensure_all_occur:
            numbers += 1
        indices = indices.repeat(numbers)
    return indices


class ArrayDataset(IDataset):
    """An in-memory dict of arrays."""

    def __init__(self, arrays: Dict[str, np.ndarray]) -> None:
        self.arrays = arrays
        lens = {v.shape[0] for v in arrays.values() if isinstance(v, np.ndarray)}
        if len(lens) > 1:
            raise ValueError(f"arrays have inconsistent lengths: {lens}")
        self._len = lens.pop() if lens else 0

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, item: Any) -> np_dict_type:
        return {k: v[item] for k, v in self.arrays.items()}


class ArrayLoader(IDataLoader):
    """Weighted resampling, shuffle, batch slicing and `BATCH_INDICES_KEY`."""

    def __init__(
        self,
        dataset: ArrayDataset,
        *,
        batch_size: int = 128,
        shuffle: bool = False,
        drop_last: bool = False,
        sample_weights: Optional[np.ndarray] = None,
        postprocess_fn: Optional[Any] = None,
        for_inference: bool = False,
    ) -> None:
        super().__init__(sample_weights=sample_weights)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.shuffle_backup = shuffle
        self.drop_last = drop_last
        self.postprocess_fn = postprocess_fn
        self.for_inference = for_inference

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return int(math.ceil(n / self.batch_size))

    def __iter__(self) -> Iterator[np_dict_type]:
        n = len(self.dataset)
        indices = get_weighted_indices(n, self.sample_weights)
        if self.shuffle:
            np.random.shuffle(indices)
        for i in range(len(self)):
            batch_indices = indices[i * self.batch_size : (i + 1) * self.batch_size]
            if len(batch_indices) == 0:
                continue
            batch = self.dataset[batch_indices]
            batch[BATCH_INDICES_KEY] = batch_indices
            if self.postprocess_fn is not None:
                batch = self.postprocess_fn(batch, for_inference=self.for_inference)
            yield batch

    def disable_shuffle(self) -> None:
        self.shuffle = False

    def recover_shuffle(self) -> None:
        self.shuffle = self.shuffle_backup


def _postprocess_fn(processor: Any) -> Optional[Any]:
    if processor is None:
        return None
    return lambda item, for_inference: processor.postprocess_item(item, for_inference=for_inference)


class IArrayDataMixin:
    """`get_loaders` / `build_loader` of an array-based `IData`."""

    def get_arrays(self, for_valid: bool) -> Optional[Dict[str, np.ndarray]]:
        raise NotImplementedError

    def get_loaders(self) -> Tuple[IDataLoader, Optional[IDataLoader]]:
        config: DataConfig = self.config  # type: ignore[attr-defined]
        postprocess = _postprocess_fn(self.processor)  # type: ignore[attr-defined]
        train_arrays = self.get_arrays(False)
        assert train_arrays is not None, "`fit` should be called first"
        train_loader = ArrayLoader(
            ArrayDataset(train_arrays),
            batch_size=config.batch_size,
            shuffle=config.shuffle_train and not config.for_inference,
            drop_last=config.drop_last,
            sample_weights=self.train_weights,  # type: ignore[attr-defined]
            postprocess_fn=postprocess,
            for_inference=config.for_inference,
        )
        valid_arrays = self.get_arrays(True)
        if valid_arrays is None:
            return train_loader, None
        valid_loader = ArrayLoader(
            ArrayDataset(valid_arrays),
            batch_size=config.valid_batch_size or config.batch_size,
            shuffle=config.shuffle_valid,
            sample_weights=self.valid_weights,  # type: ignore[attr-defined]
            postprocess_fn=postprocess,
            for_inference=True,
        )
        return train_loader, valid_loader

    def build_loader(
        self, x: Any, y: Any = None, *, batch_size: Optional[int] = None, shuffle: bool = False, **kwargs: Any
    ) -> IDataLoader:
        config: DataConfig = self.config  # type: ignore[attr-defined]
        bundle = self.transform(x, y)  # type: ignore[attr-defined]
        arrays = {INPUT_KEY: np.asarray(bundle.x_train)}
        if bundle.y_train is not None:
            arrays[LABEL_KEY] = np.asarray(bundle.y_train)
        if bundle.train_others:
            arrays.update({k: v for k, v in bundle.train_others.items() if isinstance(v, np.ndarray)})
        return ArrayLoader(
            ArrayDataset(arrays),
            batch_size=batch_size or config.batch_size,
            shuffle=shuffle,
            postprocess_fn=_postprocess_fn(self.processor),  # type: ignore[attr-defined]
            for_inference=True,
        )


def convert(np_batch: np_dict_type, device: torch.device) -> Dict[str, Any]:
    """One numpy batch as tensors on `device`; object arrays and other
    values are kept as they are."""
    batch: Dict[str, Any] = {}
    for k, v in np_batch.items():
        if not isinstance(v, np.ndarray) or v.dtype == object:
            batch[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(to_device_dtype(v)))
        if device.type == "cuda":
            # pinned host memory: the copy runs asynchronously, ahead of the step
            t = t.pin_memory().to(device, non_blocking=True)
        elif device.type != "cpu":
            t = t.to(device)
        batch[k] = t
    return batch


class DeviceBatcher:
    """The loader's numpy batches as tensors on `device`, `prefetch` ahead.
    `device=None` is the CUDA card, and raises without one
    (`resolve_device`): a caller that wants the CPU passes it."""

    def __init__(self, loader: IDataLoader, *, device: Any = None, prefetch: int = 2) -> None:
        self.loader = loader
        self.device = resolve_device(device)
        self.prefetch = max(1, prefetch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        it = iter(self.loader)
        queue: "collections.deque" = collections.deque(
            convert(b, self.device) for b in itertools.islice(it, self.prefetch)
        )
        while queue:
            out = queue.popleft()
            for b in itertools.islice(it, 1):
                queue.append(convert(b, self.device))
            yield out


def predict_array_data(
    m: Any,
    data: IArrayDataMixin,
    run_fn: Optional[Any] = None,
    *,
    batch_size: Optional[int] = None,
    **predict_kwargs: Any,
) -> Dict[str, np.ndarray]:
    """The model over every batch of `data`'s train loader (on the model's
    device, without a gradient), the outputs concatenated on the host."""
    if batch_size is not None:
        data.config.batch_size = batch_size  # type: ignore[attr-defined]
    loader = data.get_loaders()[0]
    device = next(m.parameters()).device
    batcher = DeviceBatcher(loader, device=device)
    results: Dict[str, List[np.ndarray]] = {}
    with torch.no_grad():
        for i, batch in enumerate(batcher):
            out = m.run(batch, training=False, **predict_kwargs) if run_fn is None else run_fn(m, i, batch, **predict_kwargs)
            if not isinstance(out, dict):
                out = {PREDICTIONS_KEY: out}
            for k, v in out.items():
                if v is not None:
                    results.setdefault(k, []).append(to_numpy(v))
    return {k: np.concatenate(v, axis=0) for k, v in results.items()}


def to_numpy(v: Any) -> np.ndarray:
    """A tensor on the host as numpy (bf16 and fp16 as f32: numpy has no bf16)."""
    if torch.is_tensor(v):
        v = v.detach()
        if v.dtype in (torch.bfloat16, torch.float16):
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


# the reference's interface name
IArrayDataset = ArrayDataset
