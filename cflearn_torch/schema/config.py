"""The configs (counterpart of `cflearn_tpu/schema/config.py`):
`MeshConfig` (the five named axes of a device mesh), `TrainerConfig`,
`Config` and `DLConfig`, dataclasses with the JAX
package's fields and defaults, so that a config's `to_info()` goes across
either way; the port's `Trainer` reads them (the JAX placement options
among them are documented there). `MLConfig` adds the tabular fields (the
categorical columns' encoder settings), with `MLEncoderSettings` and
`MLGlobalEncoderSettings` accepted where it takes plain dicts."""

import dataclasses
from typing import Any, Dict, List, Optional, Union

from ..toolkit.serialization import DataClassBase


@dataclasses.dataclass(eq=False)
class MeshConfig(DataClassBase):
    """The sizes of the mesh's named axes, one process per device: `data`
    (batch), `fsdp` (batch, and the optimizer's states and updates),
    `model` (tensor and expert parallelism), `context` (the sequence, in
    self-attention) and `pipe` (pipeline stages). A size of -1 takes the
    devices the others leave; with none at -1, `data` takes the rest."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    context: int = 1
    pipe: int = 1

    @property
    def axis_names(self) -> List[str]:
        return ["data", "fsdp", "model", "context", "pipe"]

    def axis_sizes(self, num_devices: int) -> List[int]:
        sizes = [self.data, self.fsdp, self.model, self.context, self.pipe]
        fixed = 1
        for s in sizes:
            if s > 0:
                fixed *= s
        if num_devices % fixed != 0:
            raise ValueError(f"mesh sizes {sizes} do not divide {num_devices} devices")
        remaining = num_devices // fixed
        out = []
        used_free = False
        for s in sizes:
            if s > 0:
                out.append(s)
            elif used_free:
                out.append(1)
            else:
                out.append(remaining)
                used_free = True
        if not used_free and remaining != 1:
            out[0] *= remaining
        return out


@dataclasses.dataclass(eq=False)
class TrainerConfig(DataClassBase):
    workspace: str = "_logs"
    create_sub_workspace: bool = True
    state_config: Optional[Dict[str, Any]] = None
    num_epoch: int = 40
    max_epoch: int = 1000
    fixed_epoch: Optional[int] = None
    fixed_steps: Optional[int] = None
    log_steps: Optional[int] = None
    valid_portion: float = 1.0
    clip_norm: float = 0.0
    grad_accumulate: int = 1
    # "no" | "fp16" | "bf16": either of the last two computes in bf16
    mixed_precision: str = "no"
    optimizer_name: Optional[str] = None
    scheduler_name: Optional[str] = None
    optimizer_config: Optional[Dict[str, Any]] = None
    scheduler_config: Optional[Dict[str, Any]] = None
    update_scheduler_per_epoch: bool = False
    optimizer_settings: Optional[Dict[str, Optional[Dict[str, Any]]]] = None
    use_incrementer_for_train_loss: bool = True
    metric_names: Optional[Union[str, List[str]]] = None
    metric_configs: Optional[Dict[str, Any]] = None
    metric_weights: Optional[Dict[str, float]] = None
    metric_forward_kwargs: Optional[Dict[str, Any]] = None
    use_losses_as_metrics: Optional[bool] = None
    loss_metrics_weights: Optional[Dict[str, float]] = None
    recompute_train_losses_in_eval: bool = True
    validation_split: Optional[float] = None
    monitor_names: Optional[Union[str, List[str]]] = None
    monitor_configs: Optional[Dict[str, Any]] = None
    auto_callback: bool = True
    callback_names: Optional[Union[str, List[str]]] = None
    callback_configs: Optional[Dict[str, Any]] = None
    lr: Optional[float] = None
    optimizer_packs: Optional[List[Dict[str, Any]]] = None
    # either one shards the optimizer's states and updates over the mesh's `fsdp` axis
    use_zero: bool = False
    shard_optimizer_states: bool = False
    finetune_config: Optional[Dict[str, Any]] = None
    save_pipeline_in_realtime: bool = False
    max_snapshot_file: int = 25
    min_num_sample: int = 3000
    num_snapshot_per_epoch: float = 2.0
    max_step_per_snapshot: int = 1000
    min_snapshot_epoch_gap: int = 0
    # {axis: size} of a `MeshConfig`, over the processes of `torch.distributed`
    mesh: Optional[Dict[str, int]] = None
    donate_buffers: bool = True
    steps_per_dispatch: int = 1
    # activation checkpointing around the loss: False, True (only the step's inputs are kept) or a
    # checkpoint policy name (`toolkit.misc.CHECKPOINT_POLICY_NAMES`)
    remat: Union[bool, str] = False
    profile_steps: Optional[List[int]] = None
    tqdm_settings: Optional[Dict[str, Any]] = None
    debug_nans: bool = False
    transfer_guard: Optional[str] = None
    async_checkpointing: bool = True
    save_on_preemption: bool = True
    resume_from_preemption: bool = True

    @property
    def is_debug(self) -> bool:
        return self.fixed_steps == 1

    @property
    def compute_dtype(self) -> str:
        return "bfloat16" if self.mixed_precision in ("fp16", "bf16") else "float32"

    def get_mesh_config(self) -> MeshConfig:
        mc = MeshConfig()
        if self.mesh:
            mc.from_info(dict(self.mesh))
        return mc


@dataclasses.dataclass(eq=False)
class Config(TrainerConfig):
    """+ the loss."""

    loss_name: Optional[str] = None
    loss_config: Optional[Dict[str, Any]] = None
    in_loading: bool = False
    cudnn_benchmark: bool = False

    def to_debug(self) -> "Config":
        self.fixed_steps = 1
        self.valid_portion = 1.0e-4
        return self

    def sanity_check(self) -> None:
        if self.fixed_steps is not None and self.fixed_steps <= 0:
            raise ValueError("`fixed_steps` should be positive when provided")


@dataclasses.dataclass(eq=False)
class DLConfig(Config):
    """+ the model (an `IDLModel` name) and its module (a registered module
    name and its config)."""

    model: str = "common"
    model_config: Optional[Dict[str, Any]] = None
    module_name: str = ""
    module_config: Optional[Dict[str, Any]] = None
    num_repeat: Optional[int] = None
    inference_type: str = "dl"
    seed: Optional[int] = None

    def sanity_check(self) -> None:
        super().sanity_check()
        if not self.module_name:
            raise ValueError("`module_name` should be provided")

    @property
    def model_name(self) -> str:
        return self.model


@dataclasses.dataclass(eq=False)
class MLConfig(DLConfig):
    """+ the tabular fields: `encoder_settings` {column index: {"dim": number
    of values, "methods": "embedding" | "one_hot"}} (inferred from the data
    by `SetMLDefaultsBlock` where `infer_encoder_settings`), the global
    encoder settings (`embedding_dim`, `dropout`) and the recogniser's
    `index_mapping`."""

    encoder_settings: Optional[Dict[str, Dict[str, Any]]] = None
    global_encoder_settings: Optional[Dict[str, Any]] = None
    index_mapping: Optional[Dict[str, int]] = None
    infer_encoder_settings: bool = True

    def __post_init__(self) -> None:
        if self.encoder_settings:
            self.encoder_settings = {
                k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v for k, v in self.encoder_settings.items()
            }
        if dataclasses.is_dataclass(self.global_encoder_settings):
            self.global_encoder_settings = dataclasses.asdict(self.global_encoder_settings)

    @classmethod
    def inherit_from(cls, config: DLConfig) -> "MLConfig":
        obj = cls()
        obj.from_info(config.to_info())
        return obj


config_registry: Dict[str, type] = {"trainer": TrainerConfig, "config": Config, "dl": DLConfig, "ml": MLConfig}


@dataclasses.dataclass
class MLEncoderSettings(DataClassBase):
    """One categorical column's encoding: `dim` values, by "embedding" and / or
    "one_hot"."""

    dim: int
    methods: Union[str, List[str]] = "embedding"
    method_configs: Optional[Dict[str, Any]] = None

    @property
    def use_one_hot(self) -> bool:
        return "one_hot" in (self.methods if isinstance(self.methods, list) else [self.methods])

    @property
    def use_embedding(self) -> bool:
        return "embedding" in (self.methods if isinstance(self.methods, list) else [self.methods])


@dataclasses.dataclass
class MLGlobalEncoderSettings(DataClassBase):
    embedding_dim: Optional[int] = None
    embedding_dropout: Optional[float] = None


@dataclasses.dataclass
class TqdmSettings(DataClassBase):
    """Progress-bar settings."""

    use_tqdm: bool = False
    use_step_tqdm: bool = False
    use_tqdm_in_validation: bool = False
    in_distributed: bool = False
    position: int = 0
    desc: str = "epoch"
