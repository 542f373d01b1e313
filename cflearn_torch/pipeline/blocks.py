"""The blocks of the training and inference pipelines (counterpart of
`cflearn_tpu/pipeline/blocks.py`): defaults (and the tabular defaults read
from the fitted data: input and output dims, the loss, the metrics, the
categorical encoder's settings), the workspace, the model (built
on the pipeline's device by `IDLModel.from_config`), metrics, inference,
monitors, callbacks, optimizer defaults, the `Trainer`, the sample counts,
`report.txt`, the training itself, and the data, model and optimizer files
of a pipeline folder. The folder's layout and file names are the JAX
package's: `model.npz`, `data_module/`, `optimizers.npz`.
"""

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from .. import callbacks, metrics, monitors  # noqa: F401  (register the callbacks, metrics and monitors)
from ..inference import DLInference
from ..parallel.mesh import run_timestamp
from ..schema.config import DLConfig, MLConfig
from ..schema.data import IData
from ..schema.metrics_schema import IMetric
from ..schema.model import IDLModel
from ..schema.train_schema import TrainerCallback, TrainerMonitor
from ..toolkit.serialization import Serializer
from ..trainer import Trainer, get_sorted_checkpoints, read_states
from .common import Block


@Block.register("set_defaults")
class SetDefaultsBlock(Block):
    """The default loss (the module's own, where one is registered under its
    name), monitors and callbacks."""

    def build(self, config: DLConfig) -> None:
        if config.loss_name is None and getattr(config, "module_name", ""):
            from ..schema.losses_schema import ILoss

            if ILoss.has(config.module_name):
                config.loss_name = config.module_name
                self._defaults["loss_name"] = config.loss_name
        if config.monitor_names is None:
            config.monitor_names = ["basic", "mean_std", "plateau"]
            self._defaults["monitor_names"] = config.monitor_names
        if config.callback_names is None and config.auto_callback:
            config.callback_names = ["log_metrics_msg"]
            self._defaults["callback_names"] = config.callback_names


@Block.register("set_ml_defaults")
class SetMLDefaultsBlock(SetDefaultsBlock):
    """The tabular defaults: the loss "mse" where none is named, then, from
    the fitted data, the module's `input_dim` and `output_dim`,
    "cross_entropy" for a classification whose loss was defaulted, the
    metrics ("acc", or "mae" and "mse"), and the recogniser's encoder
    settings (which turn a "common" model into "ml.common")."""

    def build(self, config: DLConfig) -> None:
        super().build(config)
        if config.loss_name is None:
            config.loss_name = "mse"
            self._defaults["loss_name"] = "mse"

    def run(self, data: IData, **kwargs: Any) -> None:
        config = self.pipeline.config if self.pipeline is not None else None
        if config is None:
            return
        is_clf = getattr(data, "is_classification", None)
        module_config = dict(config.module_config or {})
        num_features = getattr(data, "num_features", None)
        num_labels = getattr(data, "num_labels", None)
        if num_features is not None:
            module_config.setdefault("input_dim", num_features)
        if num_labels is not None:
            module_config.setdefault("output_dim", num_labels)
        config.module_config = module_config
        if is_clf is not None:
            if is_clf and config.loss_name in (None, "mse") and "loss_name" in self._defaults:
                config.loss_name = "cross_entropy"
                self._defaults["loss_name"] = "cross_entropy"
            if config.metric_names is None:
                config.metric_names = ["acc"] if is_clf else ["mae", "mse"]
                self._defaults["metric_names"] = config.metric_names
        if isinstance(config, MLConfig) and config.infer_encoder_settings:
            settings = getattr(data, "encoder_settings", None)
            if settings:
                config.encoder_settings = settings
                if config.model == "common":
                    config.model = "ml.common"
                self._defaults["encoder_settings"] = list(settings)

@Block.register("prepare_workspace")
class PrepareWorkplaceBlock(Block):
    """A timestamped sub-workspace of `config.workspace`."""

    def build(self, config: DLConfig) -> None:
        if config.create_sub_workspace:
            # every rank derives the same sub-workspace (the launcher pins it, or rank 0's is broadcast)
            workspace = os.path.join(config.workspace, run_timestamp())
            config.workspace = workspace
            config.create_sub_workspace = False
            self._defaults["workspace"] = workspace
        if self.is_local_rank_0 and not config.in_loading:
            os.makedirs(config.workspace, exist_ok=True)
        if self.pipeline is not None:
            self.pipeline._workspace = config.workspace


@Block.register("extract_state_info")
class ExtractStateInfoBlock(Block):
    """A placeholder of the JAX block sequence: the `Trainer` derives its
    cadences from the data."""

    def run(self, data: IData, **kwargs: Any) -> None:
        pass


@Block.register("build_model")
class BuildModelBlock(Block):
    model: IDLModel

    def build(self, config: DLConfig) -> None:
        self.config = config
        self.model = None  # built lazily in run (needs data-inferred dims)

    def run(self, data: IData, **kwargs: Any) -> None:
        if self.model is None:
            self.build_model()

    def build_model(self) -> IDLModel:
        if getattr(self, "model", None) is None:
            config = self.config
            if config.num_repeat is not None and config.model == "common":
                config.model = "ensemble"
            self.model = IDLModel.from_config(config, device=self.device)
        return self.model

    def save_extra(self, folder: str) -> None:
        if self.model is not None:
            self.model.save(os.path.join(folder, "model.npz"))

    def load_from(self, folder: str) -> None:
        path = os.path.join(folder, "model.npz")
        if os.path.isfile(path):
            self.model = IDLModel.load(path, device=self.device)
            self.config = self.model.config


@Block.register("build_metrics")
class BuildMetricsBlock(Block):
    metrics: Optional[IMetric] = None

    def build(self, config: DLConfig) -> None:
        self.config = config
        self._try_build()

    def run(self, data: IData, **kwargs: Any) -> None:
        # again at run time: a block before it may fill `metric_names` from the fitted data
        self._try_build()

    def _try_build(self) -> None:
        config = self.config
        if config.metric_names is not None:
            self.metrics = IMetric.fuse(
                config.metric_names,
                config.metric_configs,
                metric_weights=config.metric_weights,
            )


@Block.register("build_inference")
class BuildInferenceBlock(Block):
    inference: DLInference

    def build(self, config: DLConfig) -> None:
        self.inference = DLInference()


@Block.register("build_monitors")
class BuildMonitorsBlock(Block):
    monitors: List[TrainerMonitor]

    def build(self, config: DLConfig) -> None:
        names = config.monitor_names or ["basic"]
        if isinstance(names, str):
            names = [names]
        configs = config.monitor_configs or {}
        self.monitors = [TrainerMonitor.make(n, configs.get(n, {})) for n in names]


@Block.register("build_callbacks")
class BuildCallbacksBlock(Block):
    callbacks: List[TrainerCallback]

    def build(self, config: DLConfig) -> None:
        names = config.callback_names or []
        if isinstance(names, str):
            names = [names]
        configs = config.callback_configs or {}
        self.callbacks = [TrainerCallback.make(n, configs.get(n, {})) for n in names]


@Block.register("build_optimizers")
class BuildOptimizersBlock(Block):
    """The optimizer defaults in the config (the `Trainer` builds the
    optimizers)."""

    def build(self, config: DLConfig) -> None:
        if config.optimizer_name is None and config.scheduler_name is None:
            config.optimizer_name = "adam"
            self._defaults["optimizer_name"] = "adam"
        if config.lr is None:
            config.lr = 1.0e-3
            self._defaults["lr"] = config.lr


@Block.register("build_trainer")
class BuildTrainerBlock(Block):
    trainer: Trainer

    def build(self, config: DLConfig) -> None:
        self.config = config
        self.trainer = None

    def run(self, data: IData, **kwargs: Any) -> None:
        if self.trainer is None:
            metrics_block = self.get_previous(BuildMetricsBlock)
            monitors_block = self.get_previous(BuildMonitorsBlock)
            callbacks_block = self.get_previous(BuildCallbacksBlock)
            inference_block = self.get_previous(BuildInferenceBlock)
            config = self.config.copy()
            config.create_sub_workspace = False
            self.trainer = Trainer(
                config,
                metrics=metrics_block.metrics,
                monitors=monitors_block.monitors,
                callbacks=callbacks_block.callbacks,
                inference=inference_block.inference,
            )


@Block.register("record_num_samples")
class RecordNumSamplesBlock(Block):
    def run(self, data: IData, **kwargs: Any) -> None:
        if self.pipeline is not None and self.is_local_rank_0:
            workspace = self.training_workspace
            if workspace:
                info = {"num_train": data.num_train, "num_valid": data.num_valid}
                with open(os.path.join(workspace, "num_samples.json"), "w") as f:
                    json.dump(info, f)


@Block.register("report")
class ReportBlock(Block):
    """`report.txt`: the defaults the blocks injected, and the config."""

    def run(self, data: IData, **kwargs: Any) -> None:
        if not self.is_local_rank_0 or self.pipeline is None:
            return
        workspace = self.training_workspace
        if not workspace:
            return
        lines = ["=" * 50, "Internal Defaults", "-" * 50]
        for block in self.pipeline.blocks:
            for k, v in getattr(block, "_defaults", {}).items():
                lines.append(f"{k:>24s} : {v}  [{block.name}]")
        lines += ["=" * 50, "External Configurations", "-" * 50]
        for k, v in self.pipeline.config.to_info().items():
            if v is not None:
                lines.append(f"{k:>24s} : {v}")
        lines.append("=" * 50)
        with open(os.path.join(workspace, "report.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


@Block.register("training")
class TrainingBlock(Block):
    """`trainer.fit` on the data and the model."""

    def run(self, data: IData, **kwargs: Any) -> None:
        trainer_block = self.get_previous(BuildTrainerBlock)
        model_block = self.get_previous(BuildModelBlock)
        # SerializeOptimizerBlock is built AFTER TrainingBlock, so it is not
        # in `previous` — look it up on the whole pipeline or optimizer-state
        # resume silently never happens
        opt_block = None
        if self.pipeline is not None:
            opt_block = self.pipeline.try_get_block(SerializeOptimizerBlock)
        if opt_block is not None and getattr(opt_block, "opt_npd", None):
            trainer_block.trainer._preloaded_opt_npd = opt_block.opt_npd
        trainer_block.trainer.fit(data, model_block.model, **kwargs)


@Block.register("serialize_data")
class SerializeDataBlock(Block):
    data: Optional[IData] = None
    package_folder: str = "data_module"

    def save_extra(self, folder: str) -> None:
        if self.data is not None:
            Serializer.save(os.path.join(folder, self.package_folder), self.data, save_npd=False)

    def load_from(self, folder: str) -> None:
        data_folder = os.path.join(folder, self.package_folder)
        if os.path.isdir(data_folder):
            self.data = Serializer.load(data_folder, IData, load_npd=False)


@Block.register("serialize_model")
class SerializeModelBlock(Block):
    """The model with the states of the best checkpoint, as `model.npz`."""

    verbose: bool = True

    def save_extra(self, folder: str) -> None:
        model_block = self.try_get_previous(BuildModelBlock)
        if model_block is None or model_block.model is None:
            return
        trainer_block = self.try_get_previous(BuildTrainerBlock)
        # prefer the best checkpoint from training
        if trainer_block is not None and trainer_block.trainer is not None:
            trainer = trainer_block.trainer
            try:
                ckpt_folder = trainer.checkpoint_folder
                best = get_sorted_checkpoints(ckpt_folder)
                if best:
                    model_block.model.load_state_dict(read_states(os.path.join(ckpt_folder, best[0])))
            except AssertionError:
                pass
        model_block.model.save(os.path.join(folder, "model.npz"))

    def load_from(self, folder: str) -> None:
        pass  # handled by BuildModelBlock.load_from


@Block.register("serialize_optimizer")
class SerializeOptimizerBlock(Block):
    """The optimizers' states as `optimizers.npz`, which a resumed training reads."""

    opt_npd: Optional[Dict[str, Any]] = None

    def save_extra(self, folder: str) -> None:
        trainer_block = self.try_get_previous(BuildTrainerBlock)
        if trainer_block is None or trainer_block.trainer is None or not trainer_block.trainer.optimizers:
            return
        np.savez(os.path.join(folder, "optimizers.npz"), **trainer_block.trainer.optimizer_states())

    def load_from(self, folder: str) -> None:
        path = os.path.join(folder, "optimizers.npz")
        if os.path.isfile(path):
            with np.load(path, allow_pickle=False) as z:
                self.opt_npd = {k: z[k] for k in z.files}


class TryLoadBlock(Block):
    """A block that loads its state from `serialize_folder` / its name when
    that holds it (`try_load` returns True), and builds it from scratch
    otherwise; `save_extra` dumps it. Subclasses implement `try_load`,
    `from_scratch` and `dump_to`."""

    serialize_folder: Optional[str] = None

    def try_load(self, folder: str) -> bool:
        raise NotImplementedError

    def from_scratch(self, config: DLConfig) -> None:
        raise NotImplementedError

    def dump_to(self, folder: str) -> None:
        raise NotImplementedError

    def build(self, config: DLConfig) -> None:
        if self.serialize_folder is not None:
            if self.try_load(os.path.join(self.serialize_folder, self.name)):
                return
        self.from_scratch(config)

    def save_extra(self, folder: str) -> None:
        os.makedirs(folder, exist_ok=True)
        self.dump_to(folder)


# the reference's names of the blocks that set the trainer's defaults: here the defaults blocks do
SetTrainerDefaultsBlock = SetDefaultsBlock
SetMLTrainerDefaultsBlock = SetMLDefaultsBlock
