"""General callbacks (counterpart of `cflearn_tpu/callbacks/general.py`):
"log_metrics_msg" (the metrics line on the console and in `metrics.txt`),
"update_artifacts" (per-step artifact folders) and "mlflow", which logs
where `mlflow` is installed and does nothing where it is not (it is not a
dependency of the port).
"""

import os
import time
from typing import Any, Optional

from ..schema.metrics_schema import MetricsOutputs
from ..schema.train_schema import TrainerCallback, TrainerState
from ..toolkit.misc import truncate_string_to_length


@TrainerCallback.register("log_metrics_msg")
class LogMetricsMsgCallback(TrainerCallback):
    def __init__(self, verbose: bool = True) -> None:
        super().__init__()
        self.verbose = verbose
        self.timer = time.time()
        self.metrics_log_path: Optional[str] = None

    @staticmethod
    def _step_str(state: TrainerState) -> str:
        total_step = state.num_step_per_epoch
        if state.step == -1:
            current_step = -1
        else:
            current_step = state.step % total_step
            if current_step == 0:
                current_step = total_step if state.step > 0 else 0
        length = len(str(total_step))
        return f"[{current_step:{length}d} / {total_step}]"

    def log_metrics_msg(
        self,
        metrics_outputs: MetricsOutputs,
        metrics_log_path: str,
        state: TrainerState,
    ) -> None:
        if not self.is_local_rank_0:
            return
        metric_values = metrics_outputs.metric_values
        core = " | ".join(
            f"{truncate_string_to_length(k, 16)} : {v:8.6f}"
            for k, v in sorted(metric_values.items())
        )
        step_str = self._step_str(state)
        timer_str = f"[{time.time() - self.timer:6.2f}s]"
        msg = (
            f"| epoch {state.epoch:4d} {step_str} {timer_str} | {core} | "
            f"score : {metrics_outputs.final_score:8.6f} |"
        )
        if self.verbose:
            print(msg)
        with open(metrics_log_path, "a") as f:
            f.write(f"{msg}\n")
        self.timer = time.time()
        self.metrics_log_path = metrics_log_path

    def after_step(self, step_outputs: Any, state: TrainerState) -> None:
        pass


@TrainerCallback.register("update_artifacts")
class ArtifactCallback(TrainerCallback):
    """Per-step artifact folders under `<workspace>/artifacts`."""

    key: str = "artifacts"

    def __init__(self) -> None:
        super().__init__()
        self._folder: Optional[str] = None

    def _prepare_folder(self, trainer: Any, *, check_log_step: bool = True) -> Optional[str]:
        state = trainer.state
        if check_log_step and state is not None and not state.should_log_artifacts:
            return None
        folder = os.path.join(trainer.workspace, self.key, str(state.step if state else 0))
        os.makedirs(folder, exist_ok=True)
        self._folder = folder
        return folder


@TrainerCallback.register("mlflow")
class MLFlowCallback(TrainerCallback):
    """Optional mlflow logging; silently no-ops when mlflow is absent."""

    def __init__(self, experiment_name: Optional[str] = None, tracking_folder: str = os.getcwd()) -> None:
        super().__init__()
        self.experiment_name = experiment_name
        self.tracking_folder = tracking_folder
        self._client = None
        self._run_id = None

    def initialize(self) -> None:
        try:
            import mlflow  # type: ignore

            mlflow.set_tracking_uri(os.path.join(self.tracking_folder, "mlruns"))
            if self.experiment_name:
                mlflow.set_experiment(self.experiment_name)
            self._client = mlflow
            self._run = mlflow.start_run()
        except ImportError:
            self._client = None

    def log_metrics(self, metrics_outputs: MetricsOutputs, state: TrainerState) -> None:
        if self._client is None or not self.is_local_rank_0:
            return
        self._client.log_metrics(metrics_outputs.metric_values, step=state.step)

    def finalize(self, trainer: Any) -> None:
        if self._client is not None:
            self._client.end_run()
