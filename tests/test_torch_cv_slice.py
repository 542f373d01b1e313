"""The slice as a whole on the CPU, against the JAX package: a seeded PNG
folder packed at 64 px by `prepare_image_folder` (rcache), `ImageFolderData`
with the normalize blocks, `DLTrainingPipeline.fit` of a tiny ViT "clf"
(257 tokens, so that its attention takes the flash operation) with
`ImageClassificationCallback`, on both sides from one model file the JAX
package saved and on the same batches (numpy seeded before each
fit): the loss items and the validation predictions within 1e-5 (f32
against f32, as the framework's fit tests hold them), the callback's grids
the same; then, in the port, two members fused (the members' mean, bit for
bit), member 0 exported and loaded (one flash node a layer, bit for bit the
eager predict), captured by `aot_compile` (eager on the CPU) and scored by
`GeneralEvaluationPipeline` as its own `evaluate` scores it."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import cflearn_torch
import cflearn_tpu as jcf
import cflearn_tpu.models.common  # noqa: F401  (registers "common")
from _torch_cv_common import fast_build
from cflearn_torch.data.utils import ArrayDataset, ArrayLoader
from cflearn_torch.schema.data import DataProcessorConfig as TPC
from cflearn_torch.schema.train_schema import TrainerCallback
from cflearn_tpu.data.cv import ImageFolderData as JImageFolderData
from cflearn_tpu.schema import DLConfig as JDLConfig
from cflearn_tpu.schema.data import DataConfig as JDataConfig
from cflearn_tpu.schema.data import DataProcessorConfig as JPC
from cflearn_tpu.schema.model import IDLModel as JIDLModel
from cflearn_tpu.schema.train_schema import TrainerCallback as JTrainerCallback

REL = 1e-5
SIZE = 64
# 24 training and 8 validation images in batches of 8: whole batches, which the JAX `Trainer` would otherwise pad
# to a multiple of the test session's 8 virtual devices
BATCH = 8
VIT = dict(model="common", module_name="clf", loss_name="cross_entropy", module_config=dict(
    img_size=SIZE, in_channels=3, num_classes=3, encoder="vit", latent_dim=8,
    encoder_config=dict(patch_size=4, num_layers=2, num_heads=2)))
BLOCKS = {"block_names": ["static_normalize", "affine_normalize"],
          "block_configs": {"affine_normalize": {"center": 0.5, "scale": 0.5}}}


class _Record:
    def __init__(self) -> None:
        self.logs = []

    def after_step(self, step_outputs, state) -> None:
        self.logs.append((state.step, dict(step_outputs.loss_items)))


TrainerCallback.register("cv_slice_record")(type("Record", (_Record, TrainerCallback), {}))
JTrainerCallback.register("cv_slice_record")(type("Record", (_Record, JTrainerCallback), {}))


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    root = tmp_path_factory.mktemp("cv_slice")
    rs = np.random.RandomState(17)
    for i in range(32):
        folder = root / "src" / f"c{i % 3}"
        os.makedirs(folder, exist_ok=True)
        side = rs.randint(70, 90)
        img = np.clip(60 * (i % 3) + 40 + rs.randn(side, side + 3, 3) * 30, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(folder / f"{i}.png")
    np.random.seed(2)
    folder = cflearn_torch.prepare_image_folder(str(root / "src"), str(root / "packed"),
                                                preparation=cflearn_torch.ResizedPreparation(SIZE), valid_split=0.25)
    ckpt = str(root / "start.npz")
    fast_build(lambda: JIDLModel.from_config(JDLConfig(**VIT))).save(ckpt)
    return folder, ckpt, root


def _fit(side, packed, workspace, seed=0):
    folder, ckpt, _ = packed
    kwargs = dict(**VIT, workspace=workspace, fixed_steps=4, min_num_sample=0, num_snapshot_per_epoch=1,
                  metric_names=["acc"], log_steps=1, callback_names=["image_classification", "cv_slice_record"],
                  finetune_config={"pretrained_ckpt": ckpt}, seed=seed)
    np.random.seed(seed)
    if side == "jax":
        config = JDataConfig()
        config.batch_size = BATCH
        data = JImageFolderData.from_folder(folder, config=config, processor_config=JPC(**BLOCKS))
        return jcf.DLTrainingPipeline.init(JDLConfig(**kwargs)).fit(data)
    config = cflearn_torch.DataConfig()
    config.batch_size = BATCH
    data = cflearn_torch.ImageFolderData.from_folder(folder, config=config, processor_config=TPC(**BLOCKS))
    return cflearn_torch.DLTrainingPipeline.init(cflearn_torch.DLConfig(**kwargs), device="cpu").fit(data)


def _valid_loader(folder, side="port"):
    if side == "jax":
        config = JDataConfig()
        config.batch_size = BATCH
        return JImageFolderData.from_folder(folder, config=config, processor_config=JPC(**BLOCKS)).get_loaders()[1]
    config = cflearn_torch.DataConfig()
    config.batch_size = BATCH
    data = cflearn_torch.ImageFolderData.from_folder(folder, config=config, processor_config=TPC(**BLOCKS))
    return data.get_loaders()[1]


@pytest.fixture(scope="module")
def fits(packed):
    root = packed[2]
    return {side: _fit(side, packed, str(root / side)) for side in ("jax", "port")}


def _logs(p):
    return next(c for c in p.trainer.callbacks if isinstance(c, _Record)).logs


def test_image_folder_fit_matches_jax(packed, fits) -> None:
    jp, tp = fits["jax"], fits["port"]
    got, want = _logs(tp), _logs(jp)
    assert [s for s, _ in got] == [s for s, _ in want] and got
    for (_, a), (_, b) in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) <= REL * max(abs(b[k]), 1e-6), k
    mine = tp.predict(_valid_loader(packed[0]))["predictions"]
    ref = np.asarray(jp.predict(_valid_loader(packed[0], "jax"))["predictions"])
    assert mine.shape == ref.shape == (8, 3) and np.abs(mine - ref).max() <= REL * np.abs(ref).max()
    # the callback's grid of each monitor's training batch, as the JAX side wrote it
    grids = {side: sorted(os.path.relpath(os.path.join(r, f), p.trainer.workspace)
                          for r, _, fs in os.walk(os.path.join(p.trainer.workspace, "images")) for f in fs)
             for side, p in fits.items()}
    assert grids["port"] == grids["jax"] and grids["port"]
    for g in grids["port"]:
        a = np.asarray(Image.open(os.path.join(tp.trainer.workspace, g)))
        b = np.asarray(Image.open(os.path.join(jp.trainer.workspace, g)))
        np.testing.assert_array_equal(a, b)


def test_fuse_export_and_evaluate_the_fitted_members(packed, fits, tmp_path) -> None:
    folder = packed[0]
    other = _fit("port", packed, str(tmp_path / "other"), seed=1)
    folders = [cflearn_torch.save(p, str(tmp_path / f"saved_{i}")) for i, p in enumerate((fits["port"], other))]
    loader = _valid_loader(folder)
    members = [cflearn_torch.load_inference(f, device="cpu") for f in folders]
    own = [m.predict(loader)["predictions"] for m in members]
    fused = cflearn_torch.fuse_inference(folders, device="cpu")
    assert np.array_equal(fused.predict(loader)["predictions"], np.mean(own, axis=0))
    # export member 0 at the validation batch: one flash operation a layer, bit for bit its predict
    batch = {"input": next(iter(loader))["input"]}
    exported = cflearn_torch.load_exported(cflearn_torch.export_model(members[0].model, batch, str(tmp_path / "x")))
    assert exported.op_counts() == {"cflearn_torch::flash_attention": 2}
    assert np.array_equal(exported(batch)["predictions"].numpy(), own[0])
    assert np.array_equal(cflearn_torch.aot_compile(members[0].model, batch)(batch)["predictions"].numpy(), own[0])

    class Member(cflearn_torch.IPredictor):
        def predict(self, x):
            return members[0].predict(ArrayLoader(ArrayDataset({"input": x}), batch_size=BATCH))["predictions"]

    third = cflearn_torch.GeneralEvaluationPipeline(cflearn_torch.DLConfig(metric_names=["acc"]), Member())
    got = third.evaluate(loader).metric_values["acc"]
    want = cflearn_torch.load_evaluation(folders[0], device="cpu").evaluate(loader).metric_values["acc"]
    assert got == pytest.approx(want, abs=1e-12)
