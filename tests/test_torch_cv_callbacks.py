"""The port's image callbacks against the JAX package's, on the CPU:
`save_image_grid` writes the same grid (as PNG with PIL, as `.npy` without)
for every value range; the callbacks, run on the same trainer state with a
bridged tiny "vq_vae" (16 px, 32 codes), write the same files: the batches
bit for bit, the code indices exactly, the model's images within one uint8
level (the two f32 forwards agree to 1e-5 of their largest value, which can
straddle a level), the codebook's images from the JAX side's draw of codes.
Every registered name resolves to the class of the same name."""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import cflearn_torch
import cflearn_tpu.callbacks.generator as JG
import cflearn_tpu.models.cv.vae  # noqa: F401  (registers "vq_vae")
from _torch_cv_common import fast_build, stream_draws
from cflearn_torch.callbacks import generator as TG
from cflearn_torch.schema.train_schema import TrainerCallback as TCallback
from cflearn_tpu.schema import DLConfig as JDLConfig
from cflearn_tpu.schema.model import IDLModel as JIDLModel
from cflearn_tpu.schema.train_schema import TrainerCallback as JCallback

NAMES = ["generator", "ldm", "ddpm", "ae_kl", "ae_vq", "vae", "gan", "vq_vae", "image_classification", "sigmoid"]


def _images(kind: str) -> np.ndarray:
    rs = np.random.RandomState(7)
    shape = (5, 6, 7, 1 if kind == "gray" else 3)
    if kind == "uint8":
        return rs.randint(0, 256, shape).astype(np.uint8)
    if kind == "unit":
        return rs.rand(*shape).astype(np.float32)
    if kind == "standard":
        return rs.randn(*shape).astype(np.float32)
    if kind == "large":
        return (rs.rand(*shape) * 300).astype(np.float32)
    return rs.uniform(-1.2, 1.2, shape).astype(np.float32)


@pytest.mark.parametrize("kind,value_range", [("tanh", "tanh"), ("gray", "tanh"), ("uint8", "raw"), ("unit", "raw"),
                                              ("standard", "raw"), ("large", "raw")])
def test_save_image_grid_matches_jax(tmp_path, kind, value_range) -> None:
    images = _images(kind)
    grid = TG.save_image_grid(images, str(tmp_path / "port.png"), value_range=value_range)
    JG.save_image_grid(images, str(tmp_path / "jax.png"), value_range=value_range)
    got, want = (np.asarray(Image.open(tmp_path / f"{s}.png")) for s in ("port", "jax"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(grid[..., 0] if grid.shape[-1] == 1 else grid, got)
    assert grid.shape == (2 * 6, 3 * 7, images.shape[-1])
    # without PIL both write the grid as .npy
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "PIL", None)
        TG.save_image_grid(images, str(tmp_path / "port_np"), value_range=value_range)
        JG.save_image_grid(images, str(tmp_path / "jax_np"), value_range=value_range)
    np.testing.assert_array_equal(np.load(tmp_path / "port_np.npy"), np.load(tmp_path / "jax_np.npy"))


@pytest.mark.parametrize("name", NAMES)
def test_callback_names_resolve_as_in_jax(name) -> None:
    assert TCallback.get(name).__name__ == JCallback.get(name).__name__
    assert cflearn_torch.ImageCallback is cflearn_torch.GeneratorCallback


class _Loader:
    def __init__(self, batch):
        self.batch = batch

    def get_one_batch(self):
        return {k: np.array(v, copy=True) for k, v in self.batch.items()}


class _State:
    step = 4
    should_log_artifacts = True


class _Trainer:
    def __init__(self, model, batch, workspace):
        self.model, self.train_loader, self.valid_loader = model, _Loader(batch), None
        self.state, self.workspace = _State(), workspace


@pytest.fixture(scope="module")
def vq_pair():
    config = dict(model="vq_vae", module_name="vq_vae", module_config={
        "img_size": 16, "in_channels": 3, "code_dimension": 16, "num_codes": 32, "num_downsample": 2})
    jm = fast_build(lambda: JIDLModel.from_config(JDLConfig(**config)))
    tm = cflearn_torch.IDLModel.from_config(cflearn_torch.DLConfig(**config), device="cpu")
    tm.load_state_dict(jm.state_dict())
    x = np.random.RandomState(2).uniform(-1, 1, (6, 16, 16, 3)).astype(np.float32)
    return jm, tm, {"input": x, "labels": np.arange(6)[:, None]}


def _files(folder):
    return sorted(os.path.relpath(os.path.join(r, f), folder) for r, _, fs in os.walk(folder) for f in fs)


def _read(path):
    return np.load(path) if path.endswith(".npy") else np.asarray(Image.open(path)).astype(np.int16)


@pytest.mark.parametrize("name", ["generator", "vq_vae", "image_classification", "sigmoid"])
def test_callback_writes_what_jax_writes(vq_pair, tmp_path, name) -> None:
    jm, tm, batch = vq_pair
    if name == "vq_vae":
        # the codebook's sample: the JAX side's draw of codes, fed to the port
        (key,) = stream_draws(jm, 1)
        tm.m._randint = lambda *a, **k: torch.from_numpy(np.array(jax.random.randint(key, (4,), 0, 32)))
    roots = {}
    for side, model, registry in (("port", tm, TCallback), ("jax", jm, JCallback)):
        roots[side] = str(tmp_path / side)
        registry.make(name, {}).log_artifacts(_Trainer(model, batch, roots[side]))
    files = _files(roots["port"])
    assert files == _files(roots["jax"]) and files
    assert all(f.startswith(os.path.join("images", "4")) for f in files)
    for f in files:
        got, want = _read(os.path.join(roots["port"], f)), _read(os.path.join(roots["jax"], f))
        assert got.shape == want.shape, f
        if f.endswith(("original.png", "batch.png", ".npy")):
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            assert np.abs(got - want).max() <= 1, f
    if name == "generator":
        assert set(map(os.path.basename, files)) == {"original.png", "reconstructed.png"}
    if name == "vq_vae":
        assert {"code_indices.npy", "codes.png", "code_indices.png"} <= set(map(os.path.basename, files))
