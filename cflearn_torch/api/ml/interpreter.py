"""Feature importances of a tabular model (counterpart of
`cflearn_tpu/api/ml/interpreter.py`): integrated gradients by
`torch.autograd` over the straight line from a baseline (zeros by default)
to the input, the midpoint rule at `steps` points; `Interpreter` averages
them over rows and can plot them (matplotlib, imported only then)."""

import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from ...constants import INPUT_KEY, PREDICTIONS_KEY


def integrated_gradients(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    *,
    baseline: Optional[torch.Tensor] = None,
    steps: int = 32,
    target: Optional[int] = None,
) -> torch.Tensor:
    """(x - x0) * mean over a of grad f(x0 + a (x - x0)), the gradient taken
    at the interpolated point. `model_fn(x) -> (B, D_out)`; the output
    attributed is column `target`, else each row's predicted class (at x),
    else the single output, summed over the rows."""
    if baseline is None:
        baseline = torch.zeros_like(x)
    cls = None
    if target is None:
        with torch.no_grad():
            out = model_fn(x)
        if out.ndim >= 2 and out.shape[-1] > 1:
            cls = out.argmax(dim=-1, keepdim=True)
    total = torch.zeros_like(x)
    for i in range(steps):
        alpha = (i + 0.5) / steps
        xi = (baseline + alpha * (x - baseline)).detach().requires_grad_(True)
        with torch.enable_grad():
            out = model_fn(xi)
            if target is not None:
                scalar = out[:, target].sum()
            elif cls is not None:
                scalar = torch.gather(out, -1, cls).sum()
            else:
                scalar = out.sum()
            (grad,) = torch.autograd.grad(scalar, xi)
        total = total + grad
    return (x - baseline) * (total / steps)


class IntegratedGradients:
    """`attribute(x, baselines=..., n_steps=..., target=...)` over
    `integrated_gradients`."""

    def __init__(self, model_fn: Callable[[torch.Tensor], torch.Tensor]) -> None:
        self.model_fn = model_fn

    def attribute(
        self, x: Any, *, baselines: Optional[Any] = None, n_steps: int = 32, target: Optional[int] = None
    ) -> torch.Tensor:
        x = torch.as_tensor(x)
        return integrated_gradients(
            self.model_fn, x, baseline=None if baselines is None else torch.as_tensor(baselines, device=x.device),
            steps=n_steps, target=target,
        )


class Interpreter:
    """The average integrated-gradients importance of each feature of a
    fitted tabular pipeline's `data` and `model`."""

    def __init__(self, data: Any, model: Any) -> None:
        self.data = data
        self.model = model

    def importances(self, x: Any, *, steps: int = 32) -> np.ndarray:
        batch = self.data.build_loader(x).get_full_batch()
        device = next(self.model.parameters()).device
        feats = torch.as_tensor(np.asarray(batch[INPUT_KEY], np.float32), device=device)

        def model_fn(xi: torch.Tensor) -> torch.Tensor:
            return self.model.run({INPUT_KEY: xi}, training=False)[PREDICTIONS_KEY]

        return integrated_gradients(model_fn, feats, steps=steps).mean(dim=0).cpu().numpy()

    def interpret(
        self,
        x: Any,
        *,
        title: str = "Average Feature Importances",
        axis_title: str = "Features",
        export_path: Optional[str] = None,
        steps: int = 32,
    ) -> np.ndarray:
        importances = self.importances(x, steps=steps)
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError as e:
            raise RuntimeError("`matplotlib` is needed for `Interpreter.interpret`") from e
        names = getattr(self.data, "feature_header", None) or [f"f{i}" for i in range(len(importances))]
        pos = np.arange(len(names))
        plt.figure(figsize=(12, 6))
        plt.title(title)
        plt.bar(pos, importances, align="center")
        plt.xticks(pos, names, wrap=True)
        plt.xlabel(axis_title)
        if export_path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(export_path)), exist_ok=True)
            plt.savefig(export_path)
        plt.close()
        return importances
