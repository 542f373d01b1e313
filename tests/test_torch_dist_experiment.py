"""`dist.ml.Experiment` runs each task in a process of its own: a task sees
the card it is given (`available_cards`) and runs on the CPU only where the
caller asks (`force_cpu=True`); a task that exits with an error fails the
run, after every task has ended. The default command fits an
`MLTrainingPipeline` on the experiment's shared data, and its pipeline
loads for inference."""

import json
import os
import sys

import numpy as np
import pytest

from cflearn_torch.dist.ml import Experiment

SCRIPT = """
import json, os, sys
from cflearn_torch.dist.ml.runs._utils import get_info

info = get_info(requires_data=False)
with open(os.path.join(info.workspace, "seen.json"), "w") as f:
    json.dump({"force_cpu": os.environ.get("CFLEARN_TORCH_FORCE_CPU"),
               "cards": os.environ.get("CUDA_VISIBLE_DEVICES"), "config": info.config}, f)
sys.exit(int(info.config["code"]))
"""


@pytest.fixture(autouse=True)
def _importable(monkeypatch):
    """The tasks' processes import the port from this checkout."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))


def _experiment(tmp_path, codes, **kwargs):
    script = tmp_path / "task.py"
    script.write_text(SCRIPT)
    experiment = Experiment(**kwargs)
    for code in codes:
        experiment.add_task(model="probe", config={"code": code}, run_command=f"{sys.executable} {script}")
    return experiment


def _seen(workspace, index):
    with open(os.path.join(workspace, "probe", str(index), "seen.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("num_jobs", [1, 2])
def test_a_failed_task_fails_the_run(tmp_path, num_jobs):
    workspace = str(tmp_path / "ws")
    experiment = _experiment(tmp_path, [0, 3], num_jobs=num_jobs, force_cpu=True)
    with pytest.raises(RuntimeError, match="1 of 2 tasks failed") as info:
        experiment.run_tasks(workspace)
    assert os.path.join(workspace, "probe", "1") in str(info.value) and ": 3}" in str(info.value)
    # the task that succeeded ran to its end all the same
    assert _seen(workspace, 0) == {"force_cpu": "1", "cards": os.environ.get("CUDA_VISIBLE_DEVICES"),
                                   "config": {"code": 0}}
    assert not experiment.results


def test_tasks_take_the_cards_unless_the_cpu_is_asked_for(tmp_path):
    workspace = str(tmp_path / "ws")
    results = _experiment(tmp_path, [0, 0], available_cards=["0", "1"]).run_tasks(workspace)
    assert [_seen(workspace, i)["cards"] for i in (0, 1)] == ["0", "1"]
    assert [_seen(workspace, i)["force_cpu"] for i in (0, 1)] == [os.environ.get("CFLEARN_TORCH_FORCE_CPU")] * 2
    assert sorted(results.checkpoint_folders) == [("probe", 0), ("probe", 1)]


def test_the_default_task_fits_and_loads(tmp_path):
    from cflearn_torch.data import MLData

    rs = np.random.RandomState(0)
    x = rs.randn(64, 4).astype(np.float32)
    y = (x.sum(1, keepdims=True) > 0).astype(np.int64)
    workspace = str(tmp_path / "ws")
    experiment = Experiment(force_cpu=True)
    data_folder = experiment.dump_data(MLData.init().fit(x, y), workspace)
    config = {"module_name": "fcnn", "fixed_steps": 2, "callback_names": []}
    key = experiment.add_task(model="fcnn", config=config, data_folder=data_folder)
    results = experiment.run_tasks(workspace)
    pipeline = results.load_pipelines(device="cpu")[key]
    assert pipeline.predict(x[:4], return_classes=True)["predictions"].shape == (4, 1)
