"""The loss interface (counterpart of `cflearn_tpu/schema/losses_schema.py`):
an `ILoss` is an `nn.Module` whose `run(forward_results, batch)` returns a
dict of losses holding at least `LOSS_KEY`, each reduced by `reduction`;
`register_loss` / `build_loss` name them."""

from typing import Any, Dict, Tuple, Union

import torch
import torch.nn as nn

from ..constants import LABEL_KEY, LOSS_KEY, PREDICTIONS_KEY

loss_dict_type = Dict[str, torch.Tensor]


class ILoss(nn.Module):
    d: Dict[str, type] = {}
    __identifier__: str

    placeholder_key = "[PLACEHOLDER]"

    def __init__(self, reduction: str = "mean", **kwargs: Any) -> None:
        super().__init__()
        self.reduction = reduction

    @classmethod
    def register(cls, name: str, *, allow_duplicate: bool = False) -> Any:
        def _core(sub: type) -> type:
            if not allow_duplicate and name in ILoss.d and ILoss.d[name] is not sub:
                raise ValueError(f"loss '{name}' already registered")
            ILoss.d[name] = sub
            sub.__identifier__ = name
            return sub

        return _core

    @classmethod
    def has(cls, name: str) -> bool:
        return name in ILoss.d

    def get_forward_args(self, forward_results: Dict[str, Any], batch: Dict[str, Any]) -> Tuple[Any, ...]:
        return forward_results[PREDICTIONS_KEY], batch[LABEL_KEY]

    def forward(self, *args: Any, **kwargs: Any) -> Union[torch.Tensor, loss_dict_type]:
        raise NotImplementedError

    def postprocess(self, losses: Union[torch.Tensor, loss_dict_type]) -> loss_dict_type:
        if not isinstance(losses, dict):
            losses = {LOSS_KEY: losses}
        return {k: self._reduce(v) for k, v in losses.items()}

    def _reduce(self, v: torch.Tensor) -> torch.Tensor:
        if v.ndim == 0:
            return v
        if self.reduction == "mean":
            return v.mean()
        if self.reduction == "sum":
            return v.sum()
        if self.reduction in ("none", None):
            return v
        raise ValueError(f"unrecognized reduction '{self.reduction}'")

    def run(self, forward_results: Dict[str, Any], batch: Dict[str, Any], **kwargs: Any) -> loss_dict_type:
        args = self.get_forward_args(forward_results, batch)
        return self.postprocess(self.forward(*args, **kwargs))

    def __call__(self, forward_results: Dict[str, Any], batch: Dict[str, Any], **kwargs: Any) -> loss_dict_type:
        return self.run(forward_results, batch, **kwargs)


def build_loss(name: str, config: Any = None, **kwargs: Any) -> ILoss:
    kw = dict(config or {})
    kw.update(kwargs)
    if name not in ILoss.d:
        raise ValueError(f"loss '{name}' is not registered (available: {sorted(ILoss.d)})")
    return ILoss.d[name](**kw)


def register_loss(name: str, *, allow_duplicate: bool = False) -> Any:
    return ILoss.register(name, allow_duplicate=allow_duplicate)
