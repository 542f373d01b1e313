"""DDR queries and figures (counterpart of `cflearn_tpu/api/ml/ddr.py`):
`DDRPredictor` answers median, quantile and cdf / pdf queries of a trained
`DDR` (the pdf is the gradient of the CDF head in y, by `torch.autograd`);
`DDRVisualizer` draws the quantile bands and the cdf / pdf curves with
matplotlib, which is imported only when it is built."""

import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ...constants import PREDICTIONS_KEY
from ...modules.ml.ddr import DDR


def _device(m: torch.nn.Module) -> torch.device:
    return next(m.parameters()).device


class DDRPredictor:
    def __init__(self, ddr: DDR) -> None:
        self.m = ddr

    def _x(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=_device(self.m))

    def median(self, x: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return self.m(self._x(x))[PREDICTIONS_KEY].cpu().numpy()

    def quantile(self, x: np.ndarray, tau: Any) -> np.ndarray:
        """The quantiles at the anchors nearest to each `tau`: (B, len(tau), D)."""
        with torch.no_grad():
            quantiles = self.m(self._x(x))["quantiles"].cpu().numpy()
        taus = np.atleast_1d(np.asarray(tau, np.float32))
        anchors = np.linspace(0.05, 0.95, quantiles.shape[1])
        return quantiles[:, np.abs(anchors[None, :] - taus[:, None]).argmin(axis=1)]

    def cdf_pdf(self, x: np.ndarray, y: Any) -> Tuple[np.ndarray, np.ndarray]:
        """F(y | x) and its derivative in y, each row at `y` (a scalar or (B, 1))."""
        xt = self._x(x)
        y_arr = torch.as_tensor(np.asarray(y, np.float32), device=xt.device).expand(xt.shape[0], 1).clone()
        y_arr.requires_grad_(True)
        with torch.enable_grad():
            cdf = self.m.cdf(xt, y_arr)
            (pdf,) = torch.autograd.grad(cdf.sum(), y_arr)
        return cdf.detach().cpu().numpy(), pdf.cpu().numpy()

    @classmethod
    def from_pipeline(cls, m: Any) -> "DDRPredictor":
        core = m.model.m
        return cls(getattr(core, "module", core))


class DDRVisualizer:
    """Quantile-band and cdf / pdf figures of a `DDR`."""

    def __init__(self, ddr: DDR, dpi: int = 200, figsize: Tuple[int, int] = (8, 6)) -> None:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise RuntimeError("`matplotlib` is needed for `DDRVisualizer`") from e
        self.m = ddr
        self.dpi = dpi
        self.figsize = figsize
        self.predictor = DDRPredictor(ddr)

    def _new_figure(self, x: np.ndarray, y: np.ndarray, title: str) -> Any:
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=self.figsize, dpi=self.dpi)
        plt.title(title)
        plt.scatter(x[:, 0], y[:, 0], color="gray", s=15)
        return fig

    def visualize_quantiles(
        self, x: np.ndarray, y: np.ndarray, export_path: Optional[str] = None, *, title: str = "DDR quantiles"
    ) -> Optional[str]:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        order = np.argsort(x[:, 0])
        with torch.no_grad():
            out = self.m(self.predictor._x(x))
        quantiles = out["quantiles"].cpu().numpy()[order]
        self._new_figure(x, y, title)
        xs = x[order, 0]
        for a in range(quantiles.shape[1]):
            plt.plot(xs, quantiles[:, a, 0], alpha=0.6)
        plt.plot(xs, out[PREDICTIONS_KEY].cpu().numpy()[order, 0], color="red", label="median")
        plt.legend()
        return self._export(export_path)

    def visualize_cdf(
        self, x: np.ndarray, y: np.ndarray, y_anchor: float, export_path: Optional[str] = None, *,
        title: str = "DDR cdf / pdf",
    ) -> Optional[str]:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        order = np.argsort(x[:, 0])
        cdf, pdf = self.predictor.cdf_pdf(x, y_anchor)
        self._new_figure(x, y, title)
        plt.plot(x[order, 0], cdf[order, 0], label=f"cdf @ y={y_anchor:.2f}")
        plt.plot(x[order, 0], pdf[order, 0], label=f"pdf @ y={y_anchor:.2f}")
        plt.legend()
        return self._export(export_path)

    @staticmethod
    def _export(export_path: Optional[str]) -> Optional[str]:
        import matplotlib.pyplot as plt

        if export_path is None:
            plt.show()
            plt.close()
            return None
        os.makedirs(os.path.dirname(os.path.abspath(export_path)), exist_ok=True)
        plt.savefig(export_path)
        plt.close()
        return export_path
