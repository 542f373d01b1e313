"""Mode contexts and small helpers (counterpart of
`cflearn_tpu/toolkit/contexts.py`): `eval_context` / `train_context` /
`mode_context` switch a model (an `IDLModel` through `set_mode`, any other
module through `eval()` / `train()`) for the duration of a block;
`no_grad_context` is `torch.no_grad`; `gradient_checkpoint` recomputes a
call's activations in the backward (`torch.utils.checkpoint`);
`auto_num_layers` counts the halvings from an image size to `min_size`."""

import math
from contextlib import contextmanager
from typing import Any, Callable, Iterator, Optional

import torch


@contextmanager
def _mode(model: Any, training: bool) -> Iterator[None]:
    set_mode = getattr(model, "set_mode", None)
    if set_mode is not None:
        set_mode(training)
        try:
            yield
        finally:
            set_mode(not training)
        return
    model.train(training)
    try:
        yield
    finally:
        model.train(not training)


def eval_context(model: Any) -> Any:
    """`model` in eval mode inside the block, in train mode after it."""
    return _mode(model, False)


def train_context(model: Any) -> Any:
    """`model` in train mode inside the block, in eval mode after it."""
    return _mode(model, True)


def mode_context(model: Any, *, to_train: bool) -> Any:
    return train_context(model) if to_train else eval_context(model)


def no_grad_context() -> Any:
    return torch.no_grad()


def gradient_checkpoint(fn: Callable, *args: Any, **kwargs: Any) -> Any:
    """`fn(*args, **kwargs)` with its activations recomputed in the backward."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False, **kwargs)


def auto_num_layers(img_size: int, *, min_size: int = 4, max_layers: Optional[int] = None) -> int:
    """The number of halvings that take `img_size` to `min_size` (rounded, at least one)."""
    num = int(round(math.log2(img_size / min_size)))
    if max_layers is not None:
        num = min(num, max_layers)
    return max(1, num)
