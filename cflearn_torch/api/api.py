"""The functional API (counterpart of `cflearn_tpu/api/api.py`):
`fit_ml`, `fit_array`, `make_toy_ml_model`, `save` / `pack` /
`load_training` / `load_inference` / `load_evaluation`, `Evaluator` /
`evaluate`, `make_model`, `make_metric` and the `supported_*` registry
views.

`fit_ml(x, y, config=MLConfig(...))` is `MLData` (the tabular block stack)
then `MLTrainingPipeline.init(config).fit(data)`; `fit_array(x, y,
config=DLConfig(...))` is `ArrayData` then `DLTrainingPipeline`. Both run
on the CUDA card unless `device` names another ("cpu" runs the plain
PyTorch path); without a card and without a device they raise. `repeat_ml`
and `run_multiple` train copies of one config as tasks of
`dist.ml.Experiment`, each in a process of its own, on the cards unless the
caller passes `force_cpu=True`. `fuse_inference` / `fuse_evaluation` load
an ensemble of pipeline folders (`pipeline/api.py`).
"""

from typing import Any, Dict, List, Optional, Union

import numpy as np

from ..data.array import ArrayData
from ..data.ml.api import MLData
from ..pipeline.api import DLEvaluationPipeline, DLInferencePipeline, DLPipelineSerializer, DLTrainingPipeline
from ..pipeline.api import MLTrainingPipeline, TrainingPipeline
from ..schema.config import DLConfig, MLConfig
from ..schema.data import DataConfig, DataProcessorConfig
from ..schema.losses_schema import ILoss
from ..schema.metrics_schema import IMetric, MetricsOutputs
from ..schema.model import IDLModel
from ..toolkit.misc import check_is_ci


def _make_ml_data(
    x_train: Any,
    y_train: Any = None,
    x_valid: Any = None,
    y_valid: Any = None,
    *,
    data_config: Optional[DataConfig] = None,
    processor_config: Optional[DataProcessorConfig] = None,
    sample_weights: Optional[np.ndarray] = None,
) -> MLData:
    data = MLData.init(data_config, processor_config)
    data.fit(x_train, y_train, x_valid, y_valid)
    if sample_weights is not None:
        data.set_sample_weights(sample_weights)
    return data


def _ml_config(config: Optional[MLConfig], debug: bool = False) -> MLConfig:
    """A copy of `config` (default `MLConfig(module_name="fcnn")`) as `fit_ml`
    trains it: a "common" model becomes "ml.<module>" where one is
    registered, else "ml.common"; `debug` (or the `CI` flag) makes it a
    one-step run."""
    config = MLConfig(module_name="fcnn") if config is None else config.copy()
    if config.model == "common":
        specialized = f"ml.{config.module_name}"
        config.model = specialized if IDLModel.has(specialized) else "ml.common"
    if debug or check_is_ci():
        config.to_debug()
    return config


def fit_ml(
    x_train: Any,
    y_train: Any = None,
    x_valid: Any = None,
    y_valid: Any = None,
    *,
    config: Optional[MLConfig] = None,
    data_config: Optional[DataConfig] = None,
    processor_config: Optional[DataProcessorConfig] = None,
    sample_weights: Optional[np.ndarray] = None,
    debug: bool = False,
    device: Any = None,
    **kwargs: Any,
) -> MLTrainingPipeline:
    """Tabular training: numpy or CSV in (strings, NaN cells and categorical
    columns recognised and encoded), the fitted pipeline out, also saved to
    `<workspace>/pipeline`. `config` (`MLConfig(module_name="fcnn")` by
    default) is copied, never changed; a "common" model becomes
    "ml.<module>" where one is registered, else "ml.common". `debug` (or the
    `CI` flag) turns the copy into a one-step run."""
    config = _ml_config(config, debug)
    data = _make_ml_data(
        x_train, y_train, x_valid, y_valid, data_config=data_config, processor_config=processor_config,
        sample_weights=sample_weights,
    )
    return MLTrainingPipeline.init(config, device=device).fit(data, **kwargs)


def repeat_ml(
    x_train: Any,
    y_train: Any = None,
    *,
    config: Optional[MLConfig] = None,
    workspace: str = "_repeat",
    num_repeat: int = 2,
    num_jobs: int = 1,
    force_cpu: bool = False,
    **kwargs: Any,
) -> Any:
    """`num_repeat` copies of one tabular fit, each a task of
    `dist.ml.Experiment` in a process of its own: the data is fitted here
    (`kwargs`: `x_valid`, `y_valid`, `data_config`, `processor_config`,
    `sample_weights`) and dumped once into `workspace`, and every task
    trains `config` as `fit_ml` would on it, into
    `workspace/<module>/<index>`. The tasks run `num_jobs` at a time on the
    cards this process sees unless `force_cpu`; a failed task raises after
    every task has ended. Returns the `ExperimentResults`."""
    from ..dist.ml.experiment import Experiment

    config = _ml_config(config)
    data = _make_ml_data(x_train, y_train, **kwargs)
    experiment = Experiment(num_jobs=num_jobs, force_cpu=force_cpu)
    data_folder = Experiment.dump_data(data, workspace)
    for _ in range(num_repeat):
        experiment.add_task(model=config.module_name, config=config.to_info(), data_folder=data_folder)
    return experiment.run_tasks(workspace)


def run_multiple(
    config: MLConfig,
    data: MLData,
    *,
    workspace: str = "_multiple",
    num_multiple: int = 2,
    num_jobs: int = 1,
    is_fix: bool = False,
    force_cpu: bool = False,
) -> Any:
    """`num_multiple` runs of one config on fitted `data`, as `repeat_ml`'s
    tasks. With `is_fix` only the task folders of `workspace` that lack
    their saved pipeline (`Experiment.is_buggy`) run again, each into its own
    folder; the results then hold those tasks alone."""
    import os

    from ..dist.ml.experiment import Experiment

    config = _ml_config(config)
    experiment = Experiment(num_jobs=num_jobs, force_cpu=force_cpu)
    data_folder = Experiment.dump_data(data, workspace)
    for i in range(num_multiple):
        if is_fix and not Experiment.is_buggy(os.path.join(workspace, config.module_name, str(i))):
            continue
        experiment.add_task(model=config.module_name, config=config.to_info(), data_folder=data_folder, index=i)
    return experiment.run_tasks(workspace)


def fit_array(
    x_train: Any,
    y_train: Any = None,
    x_valid: Any = None,
    y_valid: Any = None,
    *,
    config: DLConfig,
    data_config: Optional[DataConfig] = None,
    debug: bool = False,
    device: Any = None,
    **kwargs: Any,
) -> TrainingPipeline:
    """Array training with no preprocessing: the fitted pipeline, also saved
    to `<workspace>/pipeline`. `debug` (or the `CI` flag) turns `config` into
    a one-step run, as in the JAX package."""
    if debug or check_is_ci():
        config.to_debug()
    data = ArrayData.init(data_config).fit(x_train, y_train, x_valid, y_valid)
    return DLTrainingPipeline.init(config, device=device).fit(data, **kwargs)


def make_toy_ml_model(config: Optional[MLConfig] = None, *, device: Any = None, **kwargs: Any) -> MLTrainingPipeline:
    """A two-step fit of a tiny FCNN on 16 random rows of 4 features and a
    binary label (numpy's global generator), for tests."""
    if config is None:
        config = MLConfig(module_name="fcnn", module_config={"hidden_units": [8]})
    config.fixed_steps = 2
    config.num_epoch = 1
    x = np.random.randn(16, 4).astype(np.float32)
    y = (x.sum(1, keepdims=True) > 0).astype(np.int64)
    return fit_ml(x, y, config=config, device=device, **kwargs)


def save(pipeline: TrainingPipeline, folder: str) -> str:
    DLPipelineSerializer.save(pipeline, folder)
    return folder


def pack(workspace: str, export_folder: str, **kwargs: Any) -> str:
    return DLPipelineSerializer.pack(workspace, export_folder, **kwargs)


def load_training(folder: str, *, device: Any = None) -> TrainingPipeline:
    return DLPipelineSerializer.load_training(folder, device=device)


def load_inference(folder: str, *, device: Any = None) -> DLInferencePipeline:
    return DLPipelineSerializer.load_inference(folder, device=device)


def load_evaluation(folder: str, *, device: Any = None) -> DLEvaluationPipeline:
    return DLPipelineSerializer.load_evaluation(folder, device=device)


def fuse_inference(src_folders: List[str], **kwargs: Any) -> Any:
    """The pipelines in `src_folders` as one ensemble (`num_picked`, `device`)."""
    return DLPipelineSerializer.fuse_inference(src_folders, **kwargs)


def fuse_evaluation(src_folders: List[str], **kwargs: Any) -> Any:
    """The ensemble of `fuse_inference` with `evaluate` on its fused outputs."""
    return DLPipelineSerializer.fuse_evaluation(src_folders, **kwargs)


class Evaluator:
    """The same metrics over several pipelines, and a table of them."""

    def __init__(self, metrics: Union[str, List[str]], *, metric_configs: Optional[Dict[str, Any]] = None) -> None:
        self.metric = IMetric.fuse(metrics, metric_configs)

    def evaluate(
        self, pipelines: Dict[str, Any], x: Any, y: Any = None, *, batch_size: int = 128
    ) -> Dict[str, MetricsOutputs]:
        results: Dict[str, MetricsOutputs] = {}
        for name, pipeline in pipelines.items():
            loader = pipeline._as_loader(x, y, batch_size)
            outputs = pipeline.inference.get_outputs(loader, metrics=self.metric, return_outputs=False)
            assert outputs.metric_outputs is not None
            results[name] = outputs.metric_outputs
        return results

    @staticmethod
    def report(results: Dict[str, MetricsOutputs]) -> str:
        """One row a pipeline (the best marked "*"), one column a metric, and the score."""
        names = sorted(results)
        metric_keys = sorted({k for r in results.values() for k in r.metric_values})
        lines = [" | ".join(["pipeline".ljust(24)] + [k.ljust(12) for k in metric_keys] + ["score".ljust(12)])]
        best = max(results.items(), key=lambda kv: kv[1].final_score)[0]
        for name in names:
            r = results[name]
            mark = "*" if name == best else " "
            cells = [f"{mark}{name}".ljust(24)]
            cells += [f"{r.metric_values.get(k, float('nan')):.6f}".ljust(12) for k in metric_keys]
            cells.append(f"{r.final_score:.6f}".ljust(12))
            lines.append(" | ".join(cells))
        return "\n".join(lines)


def evaluate(
    pipelines: Union[Any, Dict[str, Any]],
    x: Any,
    y: Any = None,
    *,
    metrics: Union[str, List[str]] = "acc",
    verbose: bool = True,
    **kwargs: Any,
) -> Dict[str, MetricsOutputs]:
    if not isinstance(pipelines, dict):
        pipelines = {"pipeline": pipelines}
    results = Evaluator(metrics).evaluate(pipelines, x, y, **kwargs)
    if verbose:
        print(Evaluator.report(results))
    return results


def make_model(name: str, config: Optional[DLConfig] = None, *, device: Any = None, **kwargs: Any) -> IDLModel:
    if config is None:
        config = DLConfig(module_name=name, **kwargs)
    return IDLModel.from_config(config, device=device)


def make_metric(name: str, **kwargs: Any) -> IMetric:
    return IMetric.make(name, kwargs)


def supported_losses() -> List[str]:
    return sorted(ILoss.d)


def supported_metrics() -> List[str]:
    return sorted(IMetric.d)


def supported_modules() -> List[str]:
    from ..modules.common import module_registry

    return sorted(module_registry)


def supported_samplers() -> List[str]:
    from ..modules.multimodal.diffusion.samplers import ISampler

    return sorted(ISampler.d)


def supported_optimizers() -> List[str]:
    from ..optimizers import optimizer_dict

    return sorted(optimizer_dict)


def supported_schedulers() -> List[str]:
    from ..schedulers import scheduler_dict

    return sorted(scheduler_dict)
