"""API wrappers and pools (counterpart of `cflearn_tpu/api/common.py`):
`IAPI`, an inference model on a device with its precision and host
offloading; `Weights`, a named pool of state dicts; `APIPool`, a pool of
lazily built APIs that offloads the one it evicts."""

import collections
from typing import Any, Callable, Dict, Generic, Optional, TypeVar

import torch
import torch.nn as nn

from ..device import resolve_device
from ..modules.common import cast_parameters

T = TypeVar("T")

# the JAX package's `OPT.sd_weights_pool_limit`: -1, no bound
SD_WEIGHTS_POOL_LIMIT = -1


class IAPI:
    """An inference module on `device` (the CUDA card unless the caller asks
    for another). `use_bf16` casts its parameters (not its buffers) to bf16;
    inputs keep their dtype, so an f32 input meets bf16 weights in f32, as
    in the JAX package."""

    def __init__(self, module: nn.Module, *, use_bf16: bool = False, device: Any = None) -> None:
        self.device = resolve_device(device)
        self.m = module.to(self.device).eval()
        self.use_bf16 = use_bf16
        self.offloaded = False
        if use_bf16:
            self.to_bf16()

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.use_bf16 else torch.float32

    def to_bf16(self) -> None:
        cast_parameters(self.m, torch.bfloat16)
        self.use_bf16 = True

    def to_f32(self) -> None:
        cast_parameters(self.m, torch.float32)
        self.use_bf16 = False

    def offload(self) -> None:
        """Move every parameter and buffer to a host tensor and free the
        device copies (with the convs' cached kernel layouts of them)."""
        self.m.to("cpu")
        for m in self.m.modules():
            if getattr(m, "_kernel_cache", None) is not None:
                m._kernel_cache = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.offloaded = True

    def restore(self) -> None:
        """Put the offloaded state back on the API's device, bit for bit."""
        if self.offloaded:
            self.m.to(self.device)
            self.offloaded = False


class Weights:
    """A named pool of state dicts with a size bound (-1: none)."""

    def __init__(self, limit: int = -1) -> None:
        self.limit = limit
        self._pool: "collections.OrderedDict[str, Dict[str, Any]]" = collections.OrderedDict()

    def __contains__(self, key: str) -> bool:
        return key in self._pool

    def register(self, key: str, states: Dict[str, Any]) -> None:
        # re-registering replaces the stored states
        self._pool[key] = states
        self._pool.move_to_end(key)
        if 0 < self.limit < len(self._pool):
            self._pool.popitem(last=False)

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        states = self._pool.get(key)
        if states is not None:
            self._pool.move_to_end(key)
        return states

    def keys(self) -> Any:
        return self._pool.keys()


class APIPool(Generic[T]):
    """A pool of lazily built APIs, least recently used first out; an
    evicted `IAPI` is offloaded to the host."""

    def __init__(self, limit: Optional[int] = None) -> None:
        self.limit = SD_WEIGHTS_POOL_LIMIT if limit is None else limit
        self._pool: "collections.OrderedDict[str, T]" = collections.OrderedDict()

    def __contains__(self, key: str) -> bool:
        return key in self._pool

    def get(self, key: str, init_fn: Optional[Callable[[], T]] = None) -> Optional[T]:
        api = self._pool.get(key)
        if api is None and init_fn is not None:
            api = init_fn()
            self.register(key, api)
        elif api is not None:
            self._pool.move_to_end(key)
        return api

    def register(self, key: str, api: T) -> None:
        self._pool[key] = api
        if 0 < self.limit < len(self._pool):
            _, old = self._pool.popitem(last=False)
            if isinstance(old, IAPI):
                old.offload()
