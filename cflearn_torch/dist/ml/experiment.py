"""Many independent training tasks, each in its own process (counterpart
of `cflearn_tpu/dist/ml/experiment.py`; the reference's `dist/ml`).

`Task` is one job: a config, a data folder and a command, saved into its
task folder (`__task_meta__.json`) and run as a subprocess
(`python -m cflearn_torch.dist.ml.runs.basic --task_folder ...` by
default: `MLTrainingPipeline.fit` on the task's data). `Experiment` holds a
table of tasks keyed (model, index), dumps and fetches shared data
(`Serializer`), runs the tasks `num_jobs` at a time and collects their
workspaces; a task is given one card of `available_cards` (round robin,
`CUDA_VISIBLE_DEVICES`), else the cards this process sees, and runs on the
CPU only where the caller asks (`force_cpu=True`: `CFLEARN_TORCH_FORCE_CPU=1`).
A task whose command exits with an error fails the run: `run_tasks` raises
after every task has ended, naming each failed task and its exit code.
`is_buggy` finds a task folder without its saved pipeline, and
`add_task(index=)` puts a task back into that folder (`run_multiple(is_fix=
True)`). `ExperimentResults.load_pipelines` loads each task's saved pipeline for
inference."""

import json
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Any, Dict, List, Optional, Tuple


from ...toolkit.serialization import Serializer

TASK_META_FILE = "__task_meta__.json"
DATA_FOLDER = "__data__"


class Task:
    """One training job: its config, data folder, command and model name."""

    def __init__(
        self,
        *,
        config: Optional[Dict[str, Any]] = None,
        run_command: Optional[str] = None,
        data_folder: Optional[str] = None,
        model: Optional[str] = None,
    ) -> None:
        self.config = config or {}
        self.run_command = run_command
        self.data_folder = data_folder
        self.model = model

    def to_info(self) -> Dict[str, Any]:
        return {
            "config": self.config,
            "run_command": self.run_command,
            "data_folder": self.data_folder,
            "model": self.model,
        }

    @classmethod
    def from_info(cls, info: Dict[str, Any]) -> "Task":
        return cls(**info)

    def dump(self, folder: str) -> None:
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, TASK_META_FILE), "w") as f:
            json.dump(self.to_info(), f, indent=2)

    @classmethod
    def load(cls, folder: str) -> "Task":
        with open(os.path.join(folder, TASK_META_FILE), "r") as f:
            return cls.from_info(json.load(f))

    def run(self, task_folder: str, *, visible_devices: Optional[str] = None, force_cpu: bool = False) -> int:
        """Save the task into `task_folder` and run its command there, on
        `visible_devices` (else the cards this process sees) or, with
        `force_cpu`, on the CPU; its exit code."""
        self.dump(task_folder)
        cmd = self.run_command or f"{sys.executable} -m cflearn_torch.dist.ml.runs.basic"
        env = dict(os.environ)
        env["CFLEARN_TORCH_TASK_FOLDER"] = task_folder
        if force_cpu:
            env["CFLEARN_TORCH_FORCE_CPU"] = "1"
        elif visible_devices is not None:
            env["CUDA_VISIBLE_DEVICES"] = visible_devices
        full_cmd = f"{cmd} --task_folder {task_folder}"
        return subprocess.call(full_cmd.split(), env=env)


def _run_task(args: Tuple[str, Dict[str, Any], Optional[str], bool]) -> Tuple[str, int]:
    task_folder, info, devices, force_cpu = args
    task = Task.from_info(info)
    code = task.run(task_folder, visible_devices=devices, force_cpu=force_cpu)
    return task_folder, code


class Experiment:
    """The task table and its runner."""

    def __init__(
        self, *, num_jobs: int = 1, available_cards: Optional[List[str]] = None, force_cpu: bool = False
    ) -> None:
        self.num_jobs = max(1, num_jobs)
        self.available_cards = available_cards
        self.force_cpu = force_cpu
        self.tasks: Dict[Tuple[str, int], Task] = {}
        self.results: Dict[Tuple[str, int], str] = {}

    # task table --------------------------------------------------------------

    def add_task(
        self,
        *,
        model: str = "fcnn",
        config: Optional[Dict[str, Any]] = None,
        data_folder: Optional[str] = None,
        run_command: Optional[str] = None,
        index: Optional[int] = None,
    ) -> Tuple[str, int]:
        """Add a task as the next index of `model`, or at `index` (a repair
        run retrains into the buggy task's folder, not into a new one); its
        key (model, index)."""
        if index is None:
            indices = [idx for (m, idx) in self.tasks if m == model]
            index = max(indices) + 1 if indices else 0
        task = Task(config=config or {}, run_command=run_command, data_folder=data_folder, model=model)
        self.tasks[(model, index)] = task
        return model, index

    # data --------------------------------------------------------------------

    @staticmethod
    def dump_data(data: Any, workspace: str) -> str:
        folder = os.path.join(workspace, DATA_FOLDER)
        Serializer.save(folder, data)
        return folder

    @staticmethod
    def fetch_data(folder: str) -> Any:
        from ...schema.data import IData

        return Serializer.load(folder, IData)

    # run ---------------------------------------------------------------------

    def run_tasks(self, workspace: str) -> "ExperimentResults":
        """Run every task in `workspace/model/index`, `num_jobs` at a time;
        raises after the last one if any exited with an error."""
        os.makedirs(workspace, exist_ok=True)
        folders = {key: os.path.join(workspace, key[0], str(key[1])) for key in sorted(self.tasks)}
        jobs: List[Tuple[str, Dict[str, Any], Optional[str], bool]] = []
        for i, (key, folder) in enumerate(folders.items()):
            devices = None
            if self.available_cards:
                devices = self.available_cards[i % len(self.available_cards)]
            jobs.append((folder, self.tasks[key].to_info(), devices, self.force_cpu))
        if self.num_jobs <= 1:
            codes = dict(map(_run_task, jobs))
        else:
            with ProcessPoolExecutor(max_workers=self.num_jobs) as pool:
                futures = [pool.submit(_run_task, args) for args in jobs]
                codes = dict(fut.result() for fut in as_completed(futures))
        failed = {folder: codes[folder] for folder in folders.values() if codes[folder] != 0}
        if failed:
            raise RuntimeError(f"{len(failed)} of {len(jobs)} tasks failed (task folder: exit code): {failed}")
        self.results.update(folders)
        return ExperimentResults(workspace, dict(self.tasks), folders)

    # repair ------------------------------------------------------------------

    @staticmethod
    def is_buggy(task_folder: str) -> bool:
        """Whether a task's folder lacks its saved pipeline: a task that did
        not run to its end."""
        return pipeline_folder(task_folder) is None


def pipeline_folder(task_folder: str) -> Optional[str]:
    """A task's saved pipeline: `pipeline` in its folder, or in a
    (timestamped) sub-folder of it; None when there is none."""
    subs = sorted(os.listdir(task_folder)) if os.path.isdir(task_folder) else []
    for folder in [task_folder] + [os.path.join(task_folder, sub) for sub in subs]:
        if os.path.isdir(os.path.join(folder, "pipeline")):
            return os.path.join(folder, "pipeline")
    return None


class ExperimentResults:
    def __init__(
        self,
        workspace: str,
        tasks: Dict[Tuple[str, int], Task],
        checkpoint_folders: Dict[Tuple[str, int], str],
    ) -> None:
        self.workspace = workspace
        self.tasks = tasks
        self.checkpoint_folders = checkpoint_folders

    def load_pipelines(self, *, device: Any = None) -> Dict[Tuple[str, int], Any]:
        """Each task's saved pipeline for inference, on `device` (the card by default)."""
        from ...pipeline.api import DLPipelineSerializer

        out: Dict[Tuple[str, int], Any] = {}
        for key, folder in self.checkpoint_folders.items():
            found = pipeline_folder(folder)
            if found is not None:
                out[key] = DLPipelineSerializer.load_inference(found, device=device)
        return out
