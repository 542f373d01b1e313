"""External datasets (counterpart of `cflearn_tpu/data/external.py`):
`ExternalDataset` wraps any indexable dataset, a `torch.utils.data.Dataset`
included, whose items are (x, y) pairs, dicts or arrays, and gives numpy
dict batches; `ExternalData` ("external") is the `IData` over a train and an
optional valid dataset.

With a process group up (`torch.distributed`), each process takes a
round-robin shard of the indices, rank::world_size, as PyTorch's
`DistributedSampler` does (the JAX package slices by `jax.process_index()`);
without one, all of them. The valid set is not sharded unless asked, so that
every rank scores the same samples.
"""

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..constants import INPUT_KEY, LABEL_KEY
from ..schema.data import DataConfig, IData, IDataset
from .utils import ArrayLoader, IArrayDataMixin


def process_shard() -> Tuple[int, int]:
    """(rank, world size) of this process's group, (0, 1) without one."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


class ExternalDataset(IDataset):
    """Numpy dict batches from an indexable dataset of (x, y) pairs, dicts
    or arrays, after `transform` where given."""

    def __init__(
        self,
        dataset: Any,
        *,
        transform: Optional[Callable[[Any], Any]] = None,
        shard_by_process: bool = True,
    ) -> None:
        self.dataset = dataset
        self.transform = transform
        rank, world = process_shard() if shard_by_process else (0, 1)
        self._indices = np.arange(rank, len(dataset), world)

    def __len__(self) -> int:
        return len(self._indices)

    def _item(self, i: int) -> Dict[str, np.ndarray]:
        item = self.dataset[int(self._indices[i])]
        if self.transform is not None:
            item = self.transform(item)
        if isinstance(item, dict):
            return {k: np.asarray(v) for k, v in item.items()}
        if isinstance(item, (tuple, list)) and len(item) == 2:
            x, y = item
            return {INPUT_KEY: np.asarray(x), LABEL_KEY: np.asarray(y)}
        return {INPUT_KEY: np.asarray(item)}

    def __getitem__(self, item: Any) -> Dict[str, np.ndarray]:
        rows = [self._item(int(i)) for i in np.atleast_1d(np.asarray(item))]
        batch = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        if LABEL_KEY in batch and batch[LABEL_KEY].ndim == 1:
            batch[LABEL_KEY] = batch[LABEL_KEY][:, None]
        return batch


@IData.register("external")
class ExternalData(IArrayDataMixin, IData):
    """The `IData` over external train / valid datasets."""

    def __init__(self) -> None:
        super().__init__()
        self.train_dataset: Optional[ExternalDataset] = None
        self.valid_dataset: Optional[ExternalDataset] = None

    @classmethod
    def from_datasets(
        cls,
        train: Any,
        valid: Any = None,
        *,
        config: Optional[DataConfig] = None,
        transform: Optional[Callable[[Any], Any]] = None,
        shard_valid: bool = False,
    ) -> "ExternalData":
        self = cls.init(config)
        self.train_dataset = ExternalDataset(train, transform=transform)
        self.valid_dataset = (
            None if valid is None else ExternalDataset(valid, transform=transform, shard_by_process=shard_valid)
        )
        return self

    def get_loaders(self) -> Tuple[ArrayLoader, Optional[ArrayLoader]]:
        assert self.train_dataset is not None
        postprocess = None
        if self.processor is not None:
            processor = self.processor
            postprocess = lambda item, for_inference: processor.postprocess_item(item, for_inference=for_inference)
        train = ArrayLoader(
            self.train_dataset,
            batch_size=self.config.batch_size,
            shuffle=self.config.shuffle_train,
            drop_last=self.config.drop_last,
            sample_weights=self.train_weights,
            postprocess_fn=postprocess,
            for_inference=self.config.for_inference,
        )
        valid = None
        if self.valid_dataset is not None:
            valid = ArrayLoader(
                self.valid_dataset,
                batch_size=self.config.valid_batch_size or self.config.batch_size,
                shuffle=self.config.shuffle_valid,
                sample_weights=self.valid_weights,
                postprocess_fn=postprocess,
                for_inference=True,
            )
        return train, valid

    @property
    def num_train(self) -> int:
        return len(self.train_dataset) if self.train_dataset is not None else 0

    @property
    def num_valid(self) -> int:
        return len(self.valid_dataset) if self.valid_dataset is not None else 0


# the reference's name of the external-dataset loader config
TorchDataConfig = DataConfig
