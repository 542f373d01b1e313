"""Training interfaces (counterpart of `cflearn_tpu/schema/train_schema.py`):

- `TrainerState`: the step and epoch counters and the cadences derived from
  them (`num_step_per_snapshot`, `num_step_per_log`, `snapshot_start_step`
  from `min_num_sample`), the epoch extension and the end of training;
- `TrainerMonitor`: `should_snapshot` / `should_terminate`, and the epoch
  extension up to `max_epoch`;
- `TrainerCallback`: the trainer's hooks;
- `MonitorResults`, `ITrainer`.
"""

import dataclasses
import math
from typing import Any, Dict, List, Optional, TYPE_CHECKING

from ..toolkit.misc import is_local_rank_0
from ..toolkit.registry import WithRegister
from .config import TrainerConfig
from .metrics_schema import MetricsOutputs

if TYPE_CHECKING:  # pragma: no cover
    from .model import IDLModel


class TrainerState:
    def __init__(
        self,
        *,
        num_step_per_epoch: int,
        batch_size: int,
        num_epoch: int = 40,
        max_epoch: int = 1000,
        fixed_steps: Optional[int] = None,
        extension: int = 5,
        enable_logging: bool = True,
        min_num_sample: int = 3000,
        snapshot_start_step: Optional[int] = None,
        max_snapshot_file: int = 25,
        min_snapshot_epoch_gap: int = 0,
        num_snapshot_per_epoch: float = 2.0,
        num_step_per_log: Optional[int] = None,
        max_step_per_snapshot: int = 1000,
    ) -> None:
        self.step = 0
        self.epoch = 0
        self.batch_size = batch_size
        self.num_step_per_epoch = max(1, num_step_per_epoch)
        self.num_epoch = num_epoch
        self.max_epoch = max_epoch
        self.fixed_steps = fixed_steps
        self.extension = extension
        self.enable_logging = enable_logging
        self.min_num_sample = min_num_sample
        if snapshot_start_step is None:
            snapshot_start_step = max(1, int(math.ceil(min_num_sample / max(1, batch_size))))
        self.snapshot_start_step = snapshot_start_step
        self.max_snapshot_file = max_snapshot_file
        self.min_snapshot_epoch_gap = min_snapshot_epoch_gap
        self._last_snapshot_epoch = 0
        self.num_snapshot_per_epoch = num_snapshot_per_epoch
        num_step_per_snapshot = int(round(self.num_step_per_epoch / num_snapshot_per_epoch))
        num_step_per_snapshot = max(1, min(max_step_per_snapshot, num_step_per_snapshot))
        self.num_step_per_snapshot = num_step_per_snapshot
        if num_step_per_log is None:
            num_step_per_log = num_step_per_snapshot
        self.num_step_per_log = num_step_per_log
        self.terminate = False

    @classmethod
    def from_config(cls, config: TrainerConfig, *, num_step_per_epoch: int, batch_size: int) -> "TrainerState":
        kwargs: Dict[str, Any] = dict(config.state_config or {})
        kwargs.setdefault("num_epoch", config.fixed_epoch or config.num_epoch)
        kwargs.setdefault("max_epoch", config.fixed_epoch or config.max_epoch)
        kwargs.setdefault("fixed_steps", config.fixed_steps)
        kwargs.setdefault("min_num_sample", config.min_num_sample)
        kwargs.setdefault("max_snapshot_file", config.max_snapshot_file)
        kwargs.setdefault("min_snapshot_epoch_gap", config.min_snapshot_epoch_gap)
        kwargs.setdefault("num_snapshot_per_epoch", config.num_snapshot_per_epoch)
        kwargs.setdefault("max_step_per_snapshot", config.max_step_per_snapshot)
        kwargs.setdefault("num_step_per_log", config.log_steps)
        return cls(num_step_per_epoch=num_step_per_epoch, batch_size=batch_size, **kwargs)

    def to_info(self) -> Dict[str, Any]:
        return dict(step=self.step, epoch=self.epoch, num_epoch=self.num_epoch)

    @property
    def is_terminate(self) -> bool:
        return self.terminate

    @property
    def should_train(self) -> bool:
        if self.terminate:
            return False
        if self.fixed_steps is not None:
            return self.step < self.fixed_steps
        return self.epoch < self.num_epoch

    @property
    def should_monitor(self) -> bool:
        return self.step % self.num_step_per_snapshot == 0

    @property
    def should_log_lr(self) -> bool:
        return self.should_log_losses

    @property
    def should_log_losses(self) -> bool:
        if not self.enable_logging:
            return False
        return self.step % self.num_step_per_log == 0

    @property
    def should_log_artifacts(self) -> bool:
        return self.should_log_metrics_msg

    @property
    def should_log_metrics_msg(self) -> bool:
        if not self.enable_logging:
            return False
        return self.should_monitor

    @property
    def can_snapshot(self) -> bool:
        if self.is_terminate:
            return True
        return self.epoch - self._last_snapshot_epoch >= self.min_snapshot_epoch_gap

    @property
    def should_start_snapshot(self) -> bool:
        return self.step >= self.snapshot_start_step

    @property
    def should_extend_epoch(self) -> bool:
        return self.epoch == self.num_epoch and self.epoch < self.max_epoch

    @property
    def reached_max_epoch(self) -> bool:
        return self.epoch > self.max_epoch

    @property
    def disable_logging(self) -> "_LoggingCtx":
        return _LoggingCtx(self)

    def extend_epoch(self, extension: Optional[int] = None) -> None:
        self.num_epoch = min(self.max_epoch, self.num_epoch + (extension or self.extension))

    def update_snapshot_epoch(self) -> None:
        self._last_snapshot_epoch = self.epoch


class _LoggingCtx:
    def __init__(self, state: TrainerState) -> None:
        self.state = state
        self._backup = state.enable_logging

    def __enter__(self) -> None:
        self._backup = self.state.enable_logging
        self.state.enable_logging = False

    def __exit__(self, *args: Any) -> None:
        self.state.enable_logging = self._backup


class TrainerMonitor(WithRegister):
    d: Dict[str, type] = {}

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        pass

    def should_snapshot(self, new_score: float) -> bool:
        raise NotImplementedError

    def should_terminate(self, new_score: float) -> bool:
        raise NotImplementedError

    def punish_extension(self) -> None:
        pass

    def handle_extension(self, state: TrainerState) -> None:
        if state.should_extend_epoch:
            self.punish_extension()
            state.extend_epoch()


class TrainerCallback(WithRegister):
    """The trainer's hooks."""

    d: Dict[str, type] = {}

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        pass

    @property
    def is_local_rank_0(self) -> bool:
        return is_local_rank_0()

    def initialize(self) -> None:
        pass

    def mutate_train_forward_kwargs(self, kwargs: Dict[str, Any], trainer: "ITrainer") -> None:
        pass

    def mutate_train_loss_kwargs(self, kwargs: Dict[str, Any], trainer: "ITrainer") -> None:
        pass

    def before_loop(self, trainer: "ITrainer") -> None:
        pass

    def log_lr(self, key: str, lr: float, state: TrainerState) -> None:
        pass

    def log_metrics(self, metrics_outputs: MetricsOutputs, state: TrainerState) -> None:
        pass

    def log_metrics_msg(self, metrics_outputs: MetricsOutputs, metrics_log_path: str, state: TrainerState) -> None:
        pass

    def log_artifacts(self, trainer: "ITrainer") -> None:
        pass

    def after_step(self, step_outputs: Any, state: TrainerState) -> None:
        pass

    def after_monitor(self, monitor_results: Any, state: TrainerState) -> None:
        pass

    def finalize(self, trainer: "ITrainer") -> None:
        pass


@dataclasses.dataclass
class MonitorResults:
    terminate: bool
    save_checkpoint: bool
    metric_outputs: Optional[MetricsOutputs]


class ITrainer:
    """The trainer's contract."""

    config: TrainerConfig
    model: "IDLModel"
    state: TrainerState
    metrics: Any
    monitors: List[TrainerMonitor]
    callbacks: List[TrainerCallback]

    @property
    def workspace(self) -> str:
        raise NotImplementedError

    def fit(self, data: Any, model: "IDLModel", *args: Any, **kwargs: Any) -> "ITrainer":
        raise NotImplementedError
