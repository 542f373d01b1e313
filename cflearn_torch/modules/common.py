"""Registry and shared helpers (counterpart of `cflearn_tpu/modules/common.py`).

A minimal copy: a name -> class registry with prefixed views,
`build_module`, `zero_module`, the seeded initialisers and `EMA`.
"""

from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.nn as nn

from ..device import resolve_device

module_registry: Dict[str, type] = {}


def register_module(name: str, *, allow_duplicate: bool = False) -> Callable[[type], type]:
    def wrap(cls: type) -> type:
        if name in module_registry and not allow_duplicate and module_registry[name] is not cls:
            raise ValueError(f"module '{name}' is already registered")
        module_registry[name] = cls
        return cls

    return wrap


def build_module(
    name: Union[str, type],
    *,
    config: Optional[Dict[str, Any]] = None,
    device: Any = None,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    **kwargs: Any,
) -> nn.Module:
    """A registered module (by name, or its class) built from `config` and
    `kwargs`: constructed on "meta", materialised on `device` (CUDA unless
    the caller asks for another device), its parameters drawn by
    `init_parameters` from `generator` (one seeded with `seed` when not
    given) and cast to `dtype`. On "meta" nothing is allocated or drawn.
    Each submodule with an `after_build(device)` method runs it then (an
    `LDM` loads its pretrained first stage there)."""
    cls = name if isinstance(name, type) else module_registry.get(name)
    if cls is None:
        raise ValueError(f"module '{name}' is not registered (available: {sorted(module_registry)})")
    device = resolve_device(device)
    with torch.device("meta"):
        module = cls(**dict(config or {}, **kwargs))
    if device.type != "meta":
        module = module.to_empty(device=device)
        init_parameters(module, seed, generator=generator)
    for m in module.modules():
        if hasattr(m, "after_build"):
            m.after_build(device)
    return cast_parameters(module, dtype)


def materialize(module: nn.Module, device: Any) -> nn.Module:
    """A module built on "meta" allocated on `device` without drawing its
    parameters (they are to be loaded), its buffers and constants set
    (`set_buffers`)."""
    module = module.to_empty(device=device)
    set_buffers(module)
    return module


def set_buffers(module: nn.Module) -> nn.Module:
    """What a module materialised from "meta" holds uninitialised and no
    checkpoint fills: each submodule with a `reset_buffers` method
    (BatchNorm's running statistics, fixed kernels and masks) sets its
    buffers, each with an `init_constants` method (CLIP's logit scale) its
    constants, and a noise schedule is recomputed."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset_buffers"):
                m.reset_buffers()
            if hasattr(m, "init_constants"):
                m.init_constants()
    if hasattr(module, "_rebuild_schedule"):
        module._rebuild_schedule()
    return module


class PrefixModules:
    """Namespaced registry view."""

    def __init__(self, prefix: str) -> None:
        self._prefix = prefix

    @property
    def all(self) -> List[str]:
        prefix = f"{self._prefix}."
        return [k[len(prefix):] for k in module_registry if k.startswith(prefix)]

    def has(self, name: str) -> bool:
        return f"{self._prefix}.{name}" in module_registry

    def register(self, name: str, **kwargs: Any) -> Callable[[type], type]:
        return register_module(f"{self._prefix}.{name}", **kwargs)

    def get(self, name: str) -> Optional[type]:
        return module_registry.get(f"{self._prefix}.{name}")

    def build(self, name: str, *args: Any, **kwargs: Any) -> nn.Module:
        cls = self.get(name)
        if cls is None:
            raise ValueError(f"'{name}' is not registered under '{self._prefix}' (available: {self.all})")
        return cls(*args, **kwargs)


def zero_module(module: nn.Module) -> nn.Module:
    """Zero all parameters of a module (diffusion output layers). The module
    is marked, so that `init_parameters` zeroes it again after a fresh draw."""
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()
    module.zero_init = True
    return module


def cast_parameters(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast floating parameters only; buffers (the f32 noise schedule) keep
    their dtype, as the JAX package casts `nnx.Param`s only."""
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module


def init_parameters(module: nn.Module, seed: int = 0, *, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Seeded random init of every parameter, drawn on the parameter's own
    device by one explicit `torch.Generator` (`generator`, or one seeded
    with `seed`), in `named_parameters` order:
    weights of rank >= 2 ~ N(0, 1 / fan_in), 1-D norm scales = 1, other 1-D
    tensors (biases) = 0, embeddings (and a ViT's class embedding) ~ N(0,
    0.02^2) and the positional table ~ N(0, 0.01^2). Modules marked by
    `zero_module` are zeroed; then `set_buffers` sets the buffers and
    constants."""
    params = list(module.named_parameters())
    device = params[0][1].device if params else torch.device("cpu")
    gen = generator if generator is not None else torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in params:
            leaf = name.rsplit(".", 1)[-1]
            if p.ndim >= 2:
                std = 0.01 if leaf == "positional_embedding" else (
                    0.02 if "embedding" in name else p[0].numel() ** -0.5
                )
                p.copy_(torch.randn(p.shape, generator=gen, device=device) * std)
            elif leaf == "class_embedding":
                p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
            elif leaf == "weight":
                p.fill_(1.0)
            else:
                p.zero_()
        for m in module.modules():
            if getattr(m, "zero_init", False):
                for p in m.parameters():
                    p.zero_()
    return set_buffers(module)


def redraw_zero_init(module: nn.Module, seed: int, scale: float = 0.1) -> int:
    """Give the modules marked by `zero_module` small seeded weights, N(0,
    scale^2 / fan_in) (1-D tensors N(0, scale^2)), so that a randomly
    initialised diffusion model's conditioning reaches its output. Returns
    the number of modules redrawn."""
    params = list(module.parameters())
    device = params[0].device if params else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    n = 0
    with torch.no_grad():
        for m in module.modules():
            if getattr(m, "zero_init", False):
                for p in m.parameters():
                    std = scale * (p[0].numel() ** -0.5 if p.ndim > 1 else 1.0)
                    p.copy_((torch.randn(p.shape, generator=gen, device=device) * std).to(p.dtype))
                n += 1
    return n


class EMA(nn.Module):
    """Exponential moving average of a module's parameters. The shadows are
    buffers (never parameters, so no optimizer sees them), one per parameter
    of `module`, named by the parameter's path with "." written as "__".
    `update()` runs in place under `torch.no_grad()`."""

    def __init__(self, decay: float, module: nn.Module) -> None:
        super().__init__()
        self.decay = decay
        self.register_buffer("num_updates", torch.zeros((), dtype=torch.int32))
        self._names = [name for name, _ in module.named_parameters()]
        for name, p in module.named_parameters():
            self.register_buffer(self._key(name), p.detach().clone())

    @staticmethod
    def _key(name: str) -> str:
        return "shadow__" + name.replace(".", "__")

    def shadow(self) -> Dict[str, torch.Tensor]:
        """{parameter path: shadow tensor}."""
        return {name: getattr(self, self._key(name)) for name in self._names}

    @torch.no_grad()
    def update(self, module: nn.Module) -> None:
        self.num_updates += 1
        n = float(self.num_updates)
        decay = min(self.decay, (1.0 + n) / (10.0 + n))
        params = dict(module.named_parameters())
        for name, s in self.shadow().items():
            s.mul_(decay).add_(params[name].detach().to(s.dtype), alpha=1.0 - decay)

    @torch.no_grad()
    def copy_to(self, module: nn.Module) -> None:
        params = dict(module.named_parameters())
        for name, s in self.shadow().items():
            params[name].copy_(s)

    @torch.no_grad()
    def store(self, module: nn.Module) -> Dict[str, torch.Tensor]:
        return {name: p.detach().clone() for name, p in module.named_parameters()}

    @torch.no_grad()
    def restore(self, module: nn.Module, stored: Dict[str, torch.Tensor]) -> None:
        for name, p in module.named_parameters():
            p.copy_(stored[name])
