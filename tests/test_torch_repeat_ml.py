"""`repeat_ml` and `run_multiple` (`cflearn_torch/api/api.py`) on the CPU:
two tiny `fcnn` tasks, each a process of its own through
`dist.ml.Experiment(force_cpu=True)`, trained into
`<workspace>/fcnn/<index>` as the JAX package lays them out; each task's
loaded pipeline predicts what the same config fitted in this process
predicts (the config's seed seeds the task's shuffles: bit for bit); then
`run_multiple(is_fix=True)` after one task's `pipeline` folder is removed
reruns that task alone, into its own folder.

The JAX package's `repeat_ml` would start JAX processes; what it shares
with the port without them is held here: `Experiment.is_buggy` on the same
folders and `add_task(index=)`'s keys, against the JAX `Experiment`'s."""

import os
import shutil

import numpy as np
import pytest

import _torch_bridge_common  # noqa: F401  (one thread a process, no network)
from cflearn_torch import MLConfig
from cflearn_torch.api import repeat_ml, run_multiple
from cflearn_torch.api.api import _ml_config
from cflearn_torch.data import MLData
from cflearn_torch.dist.ml import Experiment
from cflearn_torch.pipeline.api import MLTrainingPipeline
from cflearn_torch.toolkit.misc import seed_everything
from cflearn_tpu.dist.ml.experiment import Experiment as JExperiment


@pytest.fixture(autouse=True)
def _importable(monkeypatch):
    """The tasks' processes import the port from this checkout."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))


def _table(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(96, 5).astype(np.float32)
    y = (x[:, :1] + x[:, 1:2] > 0).astype(np.int64)
    return x, y


def _config():
    return MLConfig(module_name="fcnn", fixed_steps=4, callback_names=[], seed=3)


def test_repeat_ml_and_the_is_fix_rerun(tmp_path):
    x, y = _table()
    workspace = str(tmp_path / "repeat")
    np.random.seed(5)  # the splitter's draws: repeat_ml fits the data here
    results = repeat_ml(x, y, config=_config(), workspace=workspace, num_repeat=2, force_cpu=True)
    assert sorted(results.checkpoint_folders) == [("fcnn", 0), ("fcnn", 1)]
    pipelines = results.load_pipelines(device="cpu")
    preds = [pipelines[("fcnn", i)].predict(x)["predictions"] for i in (0, 1)]
    # the same config fitted here as `fit_ml` fits it, on data fitted as repeat_ml fits it, its shuffles seeded as
    # the task seeds them
    np.random.seed(5)
    data = MLData.init().fit(x, y)
    seed_everything(3)
    here = MLTrainingPipeline.init(_ml_config(_config()), device="cpu").fit(data).predict(x)["predictions"]
    assert np.array_equal(preds[0], here) and np.array_equal(preds[1], here)

    # one task loses its pipeline: the rerun trains it alone, into its own folder
    kept = os.path.join(workspace, "fcnn", "0", "pipeline")
    stamp = os.stat(kept).st_mtime_ns
    shutil.rmtree(os.path.join(workspace, "fcnn", "1", "pipeline"))
    assert [Experiment.is_buggy(os.path.join(workspace, "fcnn", str(i))) for i in (0, 1)] == [False, True]
    fixed = run_multiple(_config(), data, workspace=workspace, num_multiple=2, is_fix=True, force_cpu=True)
    assert sorted(fixed.checkpoint_folders) == [("fcnn", 1)]
    assert not Experiment.is_buggy(os.path.join(workspace, "fcnn", "1")) and os.stat(kept).st_mtime_ns == stamp
    again = fixed.load_pipelines(device="cpu")[("fcnn", 1)].predict(x)["predictions"]
    assert np.array_equal(again, here)


def test_is_buggy_and_add_task_index_match_jax(tmp_path):
    layouts = {"empty": [], "pipeline": ["pipeline"], "nested": ["run_1/pipeline"], "other": ["checkpoints"]}
    for name, subs in layouts.items():
        folder = tmp_path / name
        for sub in subs:
            (folder / sub).mkdir(parents=True)
        assert Experiment.is_buggy(str(folder)) == JExperiment.is_buggy(str(folder)) == (name in ("empty", "other"))
    assert Experiment.is_buggy(str(tmp_path / "missing")) and JExperiment.is_buggy(str(tmp_path / "missing"))
    port, ref = Experiment(force_cpu=True), JExperiment()
    for kw in ({}, {"index": 5}, {}, {"model": "other"}, {"index": 1}):
        assert port.add_task(**kw) == ref.add_task(**kw)
    assert sorted(port.tasks) == sorted(ref.tasks)
