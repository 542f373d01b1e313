"""Training, inference and evaluation pipelines and their serializer
(counterpart of `cflearn_tpu/pipeline/api.py`): `TrainingPipeline.fit`
(the blocks, then the pipeline folder in `<workspace>/pipeline`),
`DLTrainingPipeline`, `DLInferencePipeline.predict` (classes, probabilities,
label recovery), `DLEvaluationPipeline.evaluate` and `DLPipelineSerializer`
(save, pack, load_training / load_inference / load_evaluation), and the
tabular `MLTrainingPipeline` ("ml.training": `SetMLDefaultsBlock` first),
`MLInferencePipeline` and `MLEvaluationPipeline`. A folder the JAX package
wrote loads here (its model through the bridge), `dl.*` and `ml.*` alike,
and the port's folders keep the JAX layout and file names. Every load takes
the `device` of the model (the CUDA card unless named).

The ensembles: `DLPipelineSerializer.fuse_inference` / `fuse_evaluation`
load N folders (the best `num_picked` by their checkpoint scores) into a
`FusedInferencePipeline` / `FusedEvaluationPipeline`, which average the
members' raw predictions (each member through its own data processor) and
derive classes, probabilities and metrics from the average.
"""

import abc
import json
import os
import shutil
from enum import Enum
from typing import Any, Dict, List, Optional

import numpy as np

from ..constants import CHECKPOINTS_FOLDER, LABEL_KEY, PREDICTIONS_KEY, SCORES_FILE
from ..data import ml as _ml_data  # noqa: F401  (registers MLData and the tabular blocks)
from ..inference import DLInference, InferenceOutputs
from ..schema.data import IData, IDataLoader
from ..schema.metrics_schema import IMetric, MetricsOutputs
from ..schema.model import IDLModel
from .blocks import (
    BuildCallbacksBlock,
    BuildInferenceBlock,
    BuildMetricsBlock,
    BuildModelBlock,
    BuildMonitorsBlock,
    BuildOptimizersBlock,
    BuildTrainerBlock,
    ExtractStateInfoBlock,
    PrepareWorkplaceBlock,
    RecordNumSamplesBlock,
    ReportBlock,
    SerializeDataBlock,
    SerializeModelBlock,
    SerializeOptimizerBlock,
    SetDefaultsBlock,
    SetMLDefaultsBlock,
    TrainingBlock,
)
from .common import Block, Pipeline

PIPELINE_INFO_FILE = "pipeline.json"


def _postprocess_predictions(
    results: Dict[str, np.ndarray],
    *,
    return_classes: bool,
    binary_threshold: float,
    return_probabilities: bool,
    recover_labels: bool,
    data: Optional[IData],
) -> Dict[str, np.ndarray]:
    """Classes, probabilities or recovered labels from the raw predictions.
    A binary threshold applies to the probability (the logit's sigmoid)."""
    predictions = results.get(PREDICTIONS_KEY)
    if predictions is None:
        return results
    if return_classes and return_probabilities:
        raise ValueError("`return_classes` and `return_probabilities` are exclusive")
    if return_classes:
        if predictions.ndim >= 2 and predictions.shape[-1] > 1:
            results[PREDICTIONS_KEY] = np.argmax(predictions, axis=-1)[..., None]
        else:
            probs = 1.0 / (1.0 + np.exp(-predictions))
            results[PREDICTIONS_KEY] = (probs > binary_threshold).astype(np.int64)
    elif return_probabilities:
        logits = predictions
        if logits.ndim >= 2 and logits.shape[-1] > 1:
            e = np.exp(logits - logits.max(-1, keepdims=True))
            results[PREDICTIONS_KEY] = e / e.sum(-1, keepdims=True)
        else:
            sig = 1.0 / (1.0 + np.exp(-logits))
            results[PREDICTIONS_KEY] = np.concatenate([1.0 - sig, sig], axis=-1)
    elif recover_labels and data is not None:
        if np.issubdtype(results[PREDICTIONS_KEY].dtype, np.floating) and (
            results[PREDICTIONS_KEY].ndim < 2 or results[PREDICTIONS_KEY].shape[-1] == 1
        ):
            results[PREDICTIONS_KEY] = data.recover_labels(results[PREDICTIONS_KEY])
    return results


class _InferencePipelineMixin:
    """`predict`: the inference over a loader (or arrays, through the data's
    processor), then the postprocess."""

    def predict(
        self,
        loader_or_x: Any,
        y: Any = None,
        *,
        batch_size: int = 128,
        return_classes: bool = False,
        binary_threshold: float = 0.5,
        return_probabilities: bool = False,
        recover_labels: bool = True,
        **kwargs: Any,
    ) -> Dict[str, np.ndarray]:
        loader = self._as_loader(loader_or_x, y, batch_size)
        outputs = self.inference.get_outputs(loader, **kwargs)
        results = dict(outputs.forward_results)
        return _postprocess_predictions(
            results,
            return_classes=return_classes,
            binary_threshold=binary_threshold,
            return_probabilities=return_probabilities,
            recover_labels=recover_labels,
            data=self.data,
        )

    def _as_loader(self, loader_or_x: Any, y: Any, batch_size: int) -> IDataLoader:
        if isinstance(loader_or_x, IDataLoader):
            return loader_or_x
        assert self.data is not None, "data (processor) is required to build loaders"
        return self.data.build_loader(loader_or_x, y, batch_size=batch_size)


class TrainingPipeline(_InferencePipelineMixin, Pipeline):
    """The blocks built from the config, run on the data, then the pipeline
    saved to `<workspace>/pipeline`."""

    is_fitted: bool = False

    @property
    def set_defaults_block(self) -> Block:
        return SetDefaultsBlock()

    @property
    def building_blocks(self) -> List[Block]:
        return [
            self.set_defaults_block,
            PrepareWorkplaceBlock(),
            ExtractStateInfoBlock(),
            BuildModelBlock(),
            BuildMetricsBlock(),
            BuildInferenceBlock(),
            BuildMonitorsBlock(),
            BuildCallbacksBlock(),
            BuildOptimizersBlock(),
            BuildTrainerBlock(),
            RecordNumSamplesBlock(),
            ReportBlock(),
            TrainingBlock(),
            SerializeDataBlock(),
            SerializeModelBlock(),
            SerializeOptimizerBlock(),
        ]

    def fit(self, data: IData, **kwargs: Any) -> "TrainingPipeline":
        self.data = data
        self.run(data, **kwargs)
        self.is_fitted = True
        data_block = self.try_get_block(SerializeDataBlock)
        if data_block is not None:
            data_block.data = data
        workspace = self._workspace or self.config.workspace
        if workspace:
            DLPipelineSerializer.save(self, os.path.join(workspace, "pipeline"))
        return self

    @property
    def model(self) -> IDLModel:
        return self.get_block(BuildModelBlock).model

    @property
    def trainer(self) -> Any:
        return self.get_block(BuildTrainerBlock).trainer

    @property
    def inference(self) -> DLInference:
        return self.get_block(BuildInferenceBlock).inference


@Pipeline.register("dl.training")
class DLTrainingPipeline(TrainingPipeline):
    pass


@Pipeline.register("ml.training")
class MLTrainingPipeline(TrainingPipeline):
    @property
    def set_defaults_block(self) -> Block:
        return SetMLDefaultsBlock()


@Pipeline.register("dl.inference")
class DLInferencePipeline(_InferencePipelineMixin, Pipeline):
    is_built: bool = False

    @property
    def building_blocks(self) -> List[Block]:
        return [BuildModelBlock(), BuildInferenceBlock(), SerializeDataBlock()]

    @property
    def model(self) -> IDLModel:
        return self.get_block(BuildModelBlock).model

    @property
    def inference(self) -> DLInference:
        inference = self.get_block(BuildInferenceBlock).inference
        if inference.model is None:
            inference.model = self.model
        return inference

    @classmethod
    def from_model(cls, model: IDLModel, data: Optional[IData] = None) -> "DLInferencePipeline":
        self = cls.init(model.config, device=next(model.parameters()).device)
        self.get_block(BuildModelBlock).model = model
        self.data = data
        self.is_built = True
        return self


@Pipeline.register("ml.inference")
class MLInferencePipeline(DLInferencePipeline):
    pass


@Pipeline.register("dl.evaluation")
class DLEvaluationPipeline(DLInferencePipeline):
    def evaluate(self, loader_or_x: Any, y: Any = None, **kwargs: Any) -> MetricsOutputs:
        config = self.config
        metrics = IMetric.fuse(
            config.metric_names or "acc",
            config.metric_configs,
            metric_weights=config.metric_weights,
        )
        loader = self._as_loader(loader_or_x, y, 128)
        outputs = self.inference.get_outputs(loader, metrics=metrics, return_outputs=False)
        assert outputs.metric_outputs is not None
        return outputs.metric_outputs


@Pipeline.register("ml.evaluation")
class MLEvaluationPipeline(DLEvaluationPipeline):
    pass


class DLPipelineSerializer:
    """Folder save / load of pipelines."""

    @staticmethod
    def save(pipeline: Pipeline, folder: str) -> None:
        os.makedirs(folder, exist_ok=True)
        info = {
            "type": getattr(pipeline, "__identifier__", "dl.training"),
            "info": pipeline.to_info(),
        }
        with open(os.path.join(folder, PIPELINE_INFO_FILE), "w") as f:
            json.dump(info, f, indent=2)
        for block in pipeline.blocks:
            block.save_extra(folder)

    @staticmethod
    def _load(folder: str, *, swap_id: Optional[str] = None, device: Any = None) -> Pipeline:
        with open(os.path.join(folder, PIPELINE_INFO_FILE), "r") as f:
            pack = json.load(f)
        type_id = swap_id or pack["type"]
        pipeline = Pipeline.get(type_id)(device=device)
        pipeline.from_info(pack["info"])
        for block in pipeline.blocks:
            block.load_from(folder)
        data_block = pipeline.try_get_block(SerializeDataBlock)
        if data_block is not None and data_block.data is not None:
            pipeline.data = data_block.data
        return pipeline

    @classmethod
    def load_training(cls, folder: str, *, device: Any = None) -> TrainingPipeline:
        with open(os.path.join(folder, PIPELINE_INFO_FILE), "r") as f:
            pack = json.load(f)
        swap = pack["type"].replace("inference", "training").replace("evaluation", "training")
        pipeline = cls._load(folder, swap_id=swap, device=device)
        assert isinstance(pipeline, TrainingPipeline)
        # carry over pretrained states into the new model when present
        loaded_model_block = pipeline.try_get_block(BuildModelBlock)
        if loaded_model_block is not None and loaded_model_block.model is not None:
            pipeline._pretrained_model = loaded_model_block.model  # type: ignore[attr-defined]
        return pipeline

    @classmethod
    def load_inference(cls, folder: str, *, device: Any = None) -> DLInferencePipeline:
        with open(os.path.join(folder, PIPELINE_INFO_FILE), "r") as f:
            pack = json.load(f)
        swap = pack["type"].replace("training", "inference").replace("evaluation", "inference")
        pipeline = cls._load(folder, swap_id=swap, device=device)
        assert isinstance(pipeline, DLInferencePipeline)
        pipeline.is_built = True
        return pipeline

    @classmethod
    def load_evaluation(cls, folder: str, *, device: Any = None) -> DLEvaluationPipeline:
        with open(os.path.join(folder, PIPELINE_INFO_FILE), "r") as f:
            pack = json.load(f)
        swap = pack["type"].replace("training", "evaluation").replace("inference", "evaluation")
        pipeline = cls._load(folder, swap_id=swap, device=device)
        assert isinstance(pipeline, DLEvaluationPipeline)
        return pipeline

    # pack: a training workspace's pipeline folder, copied (or zipped) for deployment

    @classmethod
    def pack(
        cls,
        workspace: str,
        export_folder: str,
        *,
        compress: bool = False,
    ) -> str:
        pipeline_folder = os.path.join(workspace, "pipeline")
        if not os.path.isdir(pipeline_folder):
            raise ValueError(f"no serialized pipeline under workspace '{workspace}'")
        os.makedirs(os.path.dirname(os.path.abspath(export_folder)) or ".", exist_ok=True)
        if os.path.isdir(export_folder):
            shutil.rmtree(export_folder)
        shutil.copytree(pipeline_folder, export_folder)
        if compress:
            archive = shutil.make_archive(export_folder, "zip", export_folder)
            shutil.rmtree(export_folder)
            return archive
        return export_folder

    # fuse: an ensemble of trained pipelines

    @staticmethod
    def _pick_folders(src_folders: List[str], num_picked: Any) -> List[str]:
        """`num_picked` (an int, or a fraction of the folders) keeps the best
        folders by their best recorded checkpoint score; folders without
        scores rank last, in their given order."""
        if num_picked is None:
            return list(src_folders)

        def score_of(folder: str) -> float:
            path = os.path.join(folder, CHECKPOINTS_FOLDER, SCORES_FILE)
            if not os.path.isfile(path):
                path = os.path.join(folder, SCORES_FILE)
            if os.path.isfile(path):
                with open(path, "r") as f:
                    scores = json.load(f)
                if scores:
                    return max(float(v) for v in scores.values())
            return float("-inf")

        n = num_picked if isinstance(num_picked, int) else max(1, round(num_picked * len(src_folders)))
        return sorted(src_folders, key=score_of, reverse=True)[:n]

    @classmethod
    def fuse_inference(
        cls, src_folders: List[str], *, num_picked: Any = None, device: Any = None,
    ) -> "FusedInferencePipeline":
        """The members' inference pipelines, loaded on `device` (the JAX
        package's `cuda`), fused."""
        folders = cls._pick_folders(src_folders, num_picked)
        return FusedInferencePipeline([cls.load_inference(f, device=device) for f in folders])

    @classmethod
    def fuse_evaluation(
        cls, src_folders: List[str], *, num_picked: Any = None, device: Any = None,
    ) -> "FusedEvaluationPipeline":
        """The members' evaluation pipelines, loaded on `device`, fused;
        `evaluate` scores the fused predictions."""
        folders = cls._pick_folders(src_folders, num_picked)
        return FusedEvaluationPipeline([cls.load_evaluation(f, device=device) for f in folders])


class FusedInferencePipeline(_InferencePipelineMixin):
    """The mean of N pipelines' raw predictions. Each member runs its own data
    processor, so that `fused.predict(x)` is the mean of the members' own
    `predict(x)` even where they were fitted with different statistics."""

    def __init__(self, pipelines: List[DLInferencePipeline]) -> None:
        self.pipelines = pipelines
        self.data = pipelines[0].data

    def predict(
        self,
        loader_or_x: Any,
        y: Any = None,
        *,
        batch_size: int = 128,
        return_classes: bool = False,
        binary_threshold: float = 0.5,
        return_probabilities: bool = False,
        recover_labels: bool = True,
        **kwargs: Any,
    ) -> Dict[str, np.ndarray]:
        # the raw predictions fused first, then classes / probabilities from the mean: averaging each member's
        # class indices would make classes that no member predicted
        members = [
            p.predict(loader_or_x, y, batch_size=batch_size, recover_labels=False, **kwargs) for p in self.pipelines
        ]
        fused = {k: np.mean([r[k] for r in members], axis=0) for k in members[0]}
        return _postprocess_predictions(
            fused,
            return_classes=return_classes,
            binary_threshold=binary_threshold,
            return_probabilities=return_probabilities,
            recover_labels=recover_labels,
            data=self.data,
        )

    @property
    def inference(self) -> "FusedInference":
        return FusedInference(self.pipelines)


class FusedEvaluationPipeline(FusedInferencePipeline):
    """`evaluate`: the first member's metrics on the fused predictions."""

    def evaluate(self, loader_or_x: Any, y: Any = None, **kwargs: Any) -> MetricsOutputs:
        config = self.pipelines[0].config
        metrics = IMetric.fuse(config.metric_names or "acc", config.metric_configs,
                               metric_weights=config.metric_weights)
        loader = self.pipelines[0]._as_loader(loader_or_x, y, 128)
        outputs = self.inference.get_outputs(loader, metrics=metrics, return_outputs=False)
        assert outputs.metric_outputs is not None
        return outputs.metric_outputs


class FusedInference:
    """Loader-level fusion: every member runs on a copy of the same loader,
    the outputs are averaged, and the metrics scored on the average."""

    def __init__(self, pipelines: List[DLInferencePipeline]) -> None:
        self.pipelines = pipelines
        self.model = pipelines[0].model

    def get_outputs(self, loader: IDataLoader, **kwargs: Any) -> InferenceOutputs:
        metrics = kwargs.pop("metrics", None)
        sub_kwargs = dict(kwargs, return_outputs=True)
        if metrics is not None:
            sub_kwargs["return_labels"] = True
        members = [p.inference.get_outputs(loader.copy(), **sub_kwargs) for p in self.pipelines]
        fused = {k: np.mean([o.forward_results[k] for o in members], axis=0) for k in members[0].forward_results}
        first = members[0]
        metric_outputs = first.metric_outputs
        if metrics is not None:
            metric_outputs = metrics.evaluate({LABEL_KEY: first.labels}, fused)
        return InferenceOutputs(fused, first.labels, metric_outputs, first.loss_items)


class PipelineTypes(str, Enum):
    DL_TRAINING = "dl.training"
    ML_TRAINING = "ml.training"
    DL_INFERENCE = "dl.inference"
    DL_EVALUATION = "dl.evaluation"


class PackType(str, Enum):
    TRAINING = "training"
    INFERENCE = "inference"
    EVALUATION = "evaluation"


class IEvaluationPipeline(abc.ABC):
    """`evaluate(loader) -> MetricsOutputs`."""

    @abc.abstractmethod
    def evaluate(self, loader: Any, **kwargs: Any) -> Any:
        ...


IEvaluationPipeline.register(DLEvaluationPipeline)
