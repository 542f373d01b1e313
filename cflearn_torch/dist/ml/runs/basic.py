"""A task's default command: load the task, its data and config, and fit
an `MLTrainingPipeline` in the task folder (on the CPU under
`CFLEARN_TORCH_FORCE_CPU=1`, else on the card); a config with a `seed`
seeds the global generators first (`seed_everything`), so that the
loader's shuffles repeat. The task prints the device it fits on."""

import argparse
import os
import sys


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--task_folder", type=str, default=os.environ.get("CFLEARN_TORCH_TASK_FOLDER"))
    args = parser.parse_args()
    task_folder = args.task_folder
    assert task_folder, "--task_folder is required"

    from cflearn_torch.dist.ml.experiment import Experiment, Task
    from cflearn_torch.pipeline.api import MLTrainingPipeline
    from cflearn_torch.schema.config import MLConfig
    from cflearn_torch.toolkit.misc import seed_everything

    task = Task.load(task_folder)
    config = MLConfig()
    config.from_info(task.config)
    config.workspace = task_folder
    config.create_sub_workspace = False
    assert task.data_folder is not None, "task has no data folder"
    data = Experiment.fetch_data(task.data_folder)
    if config.seed is not None:
        seed_everything(config.seed)  # the loader's shuffles: a seeded task is reproducible
    device = "cpu" if os.environ.get("CFLEARN_TORCH_FORCE_CPU") == "1" else None
    pipeline = MLTrainingPipeline.init(config, device=device)
    print(f"task {task_folder}: fitting on {pipeline.device}", flush=True)
    pipeline.fit(data)
    return 0


if __name__ == "__main__":
    sys.exit(main())
