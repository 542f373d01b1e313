"""Weight initialisers and the model summary (counterpart of
`cflearn_tpu/toolkit/init_summary.py`).

`Initializer(config).initialize(module, method)` redraws every parameter of
`module` by a named method ("xavier_uniform", "xavier_normal", "normal",
"truncated_normal", "orthogonal", "zeros"; 1-D parameters, the biases and
norm scales, become zeros, as in the JAX package) from a generator seeded by
`config["seed"]`; `Initializer.register(name)` adds a method
`fn(initializer, generator, parameter) -> tensor`. The draws are PyTorch's,
not JAX's: the same method, other numbers.

`summary(model)` is the parameter table the `Trainer` writes to
`summary.txt`: one row per direct submodule of each of the model's
`all_modules`, and the total.
"""

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn as nn


class Initializer:
    defined_initialization = {"xavier_uniform", "xavier_normal", "normal", "truncated_normal", "orthogonal", "zeros"}
    custom_initializer: Dict[str, Callable] = {}

    def __init__(self, config: Optional[Dict[str, Any]] = None) -> None:
        self.config = config or {}

    @classmethod
    def register(cls, name: str) -> Callable:
        def _core(fn: Callable) -> Callable:
            cls.defined_initialization.add(name)
            cls.custom_initializer[name] = fn
            return fn

        return _core

    @torch.no_grad()
    def initialize(self, module: nn.Module, method: str, *, generator: Optional[torch.Generator] = None) -> None:
        custom = self.custom_initializer.get(method)
        for p in module.parameters():
            if generator is None or generator.device != p.device:
                generator = torch.Generator(device=p.device).manual_seed(self.config.get("seed", 0))
            p.copy_(custom(self, generator, p) if custom is not None else self._apply(method, generator, p))

    def _apply(self, method: str, generator: torch.Generator, p: torch.Tensor) -> torch.Tensor:
        if p.ndim == 0:
            return p
        if method == "zeros" or p.ndim == 1:
            return torch.zeros_like(p)
        out = torch.empty_like(p)
        if method == "xavier_uniform":
            return nn.init.xavier_uniform_(out, generator=generator)
        if method == "xavier_normal":
            return nn.init.xavier_normal_(out, generator=generator)
        if method == "normal":
            return nn.init.normal_(out, self.config.get("mean", 0.0), self.config.get("std", 0.02), generator=generator)
        if method == "truncated_normal":
            std = self.config.get("std", 0.02)
            return nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        if method == "orthogonal":
            return nn.init.orthogonal_(out, self.config.get("gain", 1.0), generator=generator)
        raise ValueError(f"unrecognized init method '{method}'")


def summary(model: Any, *, return_only: bool = False) -> str:
    """Parameter counts and sizes by direct submodule of each of the model's
    `all_modules` (or of `model`), and the total."""
    lines = ["=" * 70, f"{'Layer':<40}{'# params':>15}{'size':>14}", "-" * 70]
    modules = model.all_modules if hasattr(model, "all_modules") else [model]
    total_params = total_bytes = 0
    for mod in modules:
        for name, sub in mod.named_children():
            params = list(sub.parameters())
            n = sum(p.numel() for p in params)
            if n:
                size = sum(p.numel() * p.element_size() for p in params)
                lines.append(f"{name:<40}{n:>15,}{size / 1e6:>12.2f}MB")
        params = list(mod.parameters())
        total_params += sum(p.numel() for p in params)
        total_bytes += sum(p.numel() * p.element_size() for p in params)
    lines += ["-" * 70, f"{'TOTAL':<40}{total_params:>15,}{total_bytes / 1e6:>12.2f}MB", "=" * 70]
    out = "\n".join(lines)
    if not return_only:
        print(out)
    return out
