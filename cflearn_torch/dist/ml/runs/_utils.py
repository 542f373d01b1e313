"""`get_info()` for a task's own `run_command` script: its workspace, its
meta (with the `module` it was scheduled as), its config and the
experiment's shared data."""

import argparse
import os
from typing import Any, Dict, NamedTuple, Optional

from ..experiment import Experiment, Task


class Info(NamedTuple):
    workspace: str
    meta: Dict[str, Any]
    config: Optional[Dict[str, Any]]
    data: Optional[Any]


def get_info(*, requires_data: bool = True) -> Info:
    parser = argparse.ArgumentParser()
    parser.add_argument("--task_folder", type=str, default=os.environ.get("CFLEARN_TORCH_TASK_FOLDER"))
    args, _ = parser.parse_known_args()
    task_folder = args.task_folder
    if not task_folder:
        raise ValueError("`--task_folder` (or CFLEARN_TORCH_TASK_FOLDER) is required")
    task = Task.load(task_folder)
    meta: Dict[str, Any] = {"workspace": task_folder, "module": task.model}
    if requires_data:
        if task.data_folder is None:
            raise ValueError("`data_folder` should be provided when `requires_data` is True")
        data = Experiment.fetch_data(task.data_folder)
    else:
        data = None
    return Info(task_folder, meta, task.config or None, data)


__all__ = ["Info", "get_info"]
