"""`DLInference` (counterpart of `cflearn_tpu/inference.py`): a model over a
loader, batch by batch, and the metrics of what it gives.

`get_outputs` runs the model in eval mode under `torch.no_grad`, each numpy
batch moved to the model's device (`data.utils.convert`), with the loader's
shuffle switched off for the pass and at most `portion` of its batches. It
keeps the outputs on the host as numpy, evaluates the metrics per batch
(averaged by batch size) or, for a metric that `requires_all`, once on the
concatenation, and can return the train steps' losses averaged over the
pass (`use_losses_as_metrics`): a train step whose loss cannot be computed
in eval is skipped, as in the JAX package.
"""

import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .constants import LABEL_KEY, PREDICTIONS_KEY
from .data.utils import convert, to_numpy
from .schema.data import IDataLoader
from .schema.metrics_schema import IMetric, MetricsOutputs
from .schema.model import IDLModel
from .toolkit.misc import np_dict_type


class InferenceOutputs:
    def __init__(
        self,
        forward_results: np_dict_type,
        labels: Optional[np.ndarray],
        metric_outputs: Optional[MetricsOutputs],
        loss_items: Optional[Dict[str, float]],
    ) -> None:
        self.forward_results = forward_results
        self.labels = labels
        self.metric_outputs = metric_outputs
        self.loss_items = loss_items


class DLInference:
    def __init__(self, *, model: Optional[IDLModel] = None) -> None:
        self.model = model
        self.trainer: Any = None

    def bind(self, trainer: Any) -> None:
        self.trainer = trainer
        self.model = trainer.model

    @torch.no_grad()
    def _eval(self, model: IDLModel, batch: Dict[str, Any], compute_losses: bool) -> Any:
        fwd = model.run(batch, training=False)
        losses: Dict[str, torch.Tensor] = {}
        train_steps = model.train_steps if compute_losses else []
        for ts in train_steps:
            try:
                sub = ts.loss_fn(model, batch, fwd)
            except Exception:  # noqa: BLE001 — a loss that cannot be computed in eval
                continue
            prefix = "" if len(train_steps) == 1 else f"{ts.scope}_"
            losses.update({prefix + k: v for k, v in sub.items()})
        return fwd, losses

    def get_outputs(
        self,
        loader: IDataLoader,
        *,
        portion: float = 1.0,
        metrics: Optional[IMetric] = None,
        use_losses_as_metrics: bool = False,
        return_outputs: bool = True,
        return_labels: bool = False,
        recover_labels_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        **kwargs: Any,
    ) -> InferenceOutputs:
        model = self.model
        assert model is not None, "model is not provided/bound"
        device = next(model.parameters()).device
        num_batches = max(1, int(math.ceil(len(loader) * portion)))
        requires_all = metrics is not None and metrics.requires_all
        keep_outputs = return_outputs or requires_all

        all_np_outputs: List[np_dict_type] = []
        all_labels: List[np.ndarray] = []
        batch_sizes: List[int] = []
        metric_batches: List[MetricsOutputs] = []
        loss_sums: Dict[str, float] = {}
        loss_weights = 0.0

        model.set_mode(False)
        with loader.temporarily_disable_shuffle():
            for i, np_batch in enumerate(loader):
                if i >= num_batches:
                    break
                fwd, losses = self._eval(model, convert(np_batch, torch.device(device)), use_losses_as_metrics)
                np_outputs = {k: to_numpy(v) for k, v in fwd.items() if torch.is_tensor(v)}
                bs = _batch_len(np_batch)
                batch_sizes.append(bs)
                if keep_outputs:
                    all_np_outputs.append(np_outputs)
                label = np_batch.get(LABEL_KEY)
                if label is not None and (return_labels or requires_all):
                    all_labels.append(np.asarray(label))
                if use_losses_as_metrics:
                    for k, v in losses.items():
                        loss_sums[k] = loss_sums.get(k, 0.0) + float(v) * bs
                    loss_weights += bs
                if metrics is not None and not requires_all:
                    metric_batches.append(metrics.evaluate(np_batch, np_outputs))

        stacked: np_dict_type = {}
        if keep_outputs and all_np_outputs:
            stacked = {
                k: np.concatenate([o[k] for o in all_np_outputs], axis=0)
                if all_np_outputs[0][k].ndim > 0
                else np.stack([o[k] for o in all_np_outputs])
                for k in all_np_outputs[0]
            }
        labels = np.concatenate(all_labels, axis=0) if all_labels else None

        loss_items: Optional[Dict[str, float]] = None
        if use_losses_as_metrics and loss_weights > 0:
            loss_items = {k: v / loss_weights for k, v in loss_sums.items()}

        metric_outputs: Optional[MetricsOutputs] = None
        if metrics is not None:
            if requires_all:
                metric_outputs = metrics.evaluate({LABEL_KEY: labels}, stacked)
            elif metric_batches:
                total = float(sum(batch_sizes[: len(metric_batches)]))
                score = sum(m.final_score * b for m, b in zip(metric_batches, batch_sizes)) / total
                values: Dict[str, float] = {}
                is_positive: Dict[str, bool] = {}
                for m, b in zip(metric_batches, batch_sizes):
                    for k, v in m.metric_values.items():
                        values[k] = values.get(k, 0.0) + v * b
                    is_positive.update(m.is_positive)
                metric_outputs = MetricsOutputs(score, {k: v / total for k, v in values.items()}, is_positive)

        if recover_labels_fn is not None and PREDICTIONS_KEY in stacked:
            stacked[PREDICTIONS_KEY] = recover_labels_fn(stacked[PREDICTIONS_KEY])

        return InferenceOutputs(
            stacked if return_outputs else {},
            labels if return_labels else None,
            metric_outputs,
            loss_items,
        )


def _batch_len(np_batch: np_dict_type) -> int:
    for v in np_batch.values():
        if isinstance(v, np.ndarray) and v.ndim >= 1:
            return v.shape[0]
    return 1


# the reference's interface name
IInference = DLInference
