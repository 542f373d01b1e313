"""`VQVAEInference` against the JAX package's, on the CPU: one JAX `fit_array`
of a tiny "vq_vae" (16 px, 32 codes of 8), whose workspace both packages
pack and load (the port through the bridge); the code indices each exports
for the same images are equal, exactly; `decode_indices`, `reconstruct` and
the uniform-code `sample` before a prior (numpy's draw from one seed) agree
within 1e-5 of the largest value (f32 against f32); the port then fits a
tiny PixelCNN prior ("ar") on its codes for two steps and samples from it;
each instance registers its own callback, which writes its grids."""

import os

import numpy as np
import pytest
import torch

import cflearn_torch
import cflearn_tpu as jcf
import cflearn_tpu.models.cv.vae  # noqa: F401  (registers "vq_vae", "ar")
from cflearn_torch.api.cv import VQVAEInference
from cflearn_tpu.api.cv import VQVAEInference as JVQVAEInference
from cflearn_tpu.data import ArrayData as JArrayData
from cflearn_tpu.schema import DLConfig as JDLConfig
from cflearn_tpu.schema.data import DataConfig as JDataConfig

REL = 1e-5
VQ = {"img_size": 16, "in_channels": 3, "code_dimension": 8, "num_codes": 32, "num_downsample": 2}
PRIOR = {"num_codes": 32, "img_size": 4, "in_channels": 1, "latent_channels": 8, "num_layers": 2}


def _images():
    rs = np.random.RandomState(8)
    return rs.uniform(-1, 1, (20, 16, 16, 3)).astype(np.float32), rs.randint(0, 3, (20, 1))


def _prior_config(cls, **kw):
    return cls(model="ar", module_name="pixel_cnn", module_config=dict(PRIOR), fixed_steps=2, min_num_sample=0,
               callback_names=[], **kw)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("vq")
    x, _ = _images()
    dc = JDataConfig()
    dc.batch_size = 8
    np.random.seed(0)
    p = jcf.fit_array(x, config=JDLConfig(model="vq_vae", module_name="vq_vae", module_config=dict(VQ),
                                          workspace=str(root / "vq"), fixed_steps=2, min_num_sample=0,
                                          callback_names=[]), data_config=dc)
    return p.trainer.workspace, root


def _data(side):
    x, y = _images()
    if side == "jax":
        config = JDataConfig()
        config.batch_size, config.shuffle_train = 8, False
        return JArrayData.init(config).fit(x[:16], y[:16], x[16:], y[16:])
    config = cflearn_torch.DataConfig()
    config.batch_size, config.shuffle_train = 8, False
    return cflearn_torch.ArrayData.init(config).fit(x[:16], y[:16], x[16:], y[16:])


def test_code_indices_and_decodes_match_jax(workspace) -> None:
    vq_ws, root = workspace
    mine = VQVAEInference(_prior_config(cflearn_torch.DLConfig), workspace=str(root / "t"), vqvae_log_folder=vq_ws,
                          device="cpu")
    ref = JVQVAEInference(_prior_config(JDLConfig), workspace=str(root / "j"), vqvae_log_folder=vq_ws)
    mine.export_code_indices(_data("port"), str(root / "t_codes"))
    ref.export_code_indices(_data("jax"), str(root / "j_codes"))
    for name in ("train", "valid", "train_labels", "valid_labels"):
        got, want = np.load(root / "t_codes" / f"{name}.npy"), np.load(root / "j_codes" / f"{name}.npy")
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert np.load(root / "t_codes" / "train.npy").shape == (16, 4, 4)
    assert os.path.isfile(root / "t_codes" / "__finished__")
    codes = np.load(root / "t_codes" / "valid.npy")
    for got, want in ((mine.decode_indices(codes), ref.decode_indices(codes)),
                      (mine.reconstruct(_images()[0][:4]), ref.reconstruct(_images()[0][:4])),
                      (mine.sample(3), ref.sample(3))):
        assert got.shape == np.asarray(want).shape
        assert np.abs(got - np.asarray(want)).max() <= REL * np.abs(np.asarray(want)).max()
    # one registration an instance: two instances, two callbacks
    other = VQVAEInference(_prior_config(cflearn_torch.DLConfig), workspace=str(root / "t2"), vqvae_log_folder=vq_ws,
                           device="cpu")
    assert other.tmp_callback_name != mine.tmp_callback_name
    assert mine.tmp_callback_name in mine.config.callback_names


def test_prior_fits_on_the_codes_and_samples(workspace) -> None:
    vq_ws, root = workspace
    inference = VQVAEInference(_prior_config(cflearn_torch.DLConfig, workspace=str(root / "prior")),
                               workspace=str(root / "fit"), vqvae_log_folder=vq_ws, device="cpu")
    data_config = cflearn_torch.DataConfig()
    data_config.batch_size = 8
    inference.fit(_data("port"), data_config)
    assert inference.prior is not None and inference.pipeline.trainer.state.step == 2
    images = inference.sample(2)
    assert images.shape == (2, 16, 16, 3) and np.isfinite(images).all()
    # the registered callback, run on the fit's trainer, writes its grids from the prior's validation codes
    trainer = inference.pipeline.trainer
    cflearn_torch.schema.train_schema.TrainerCallback.make(inference.tmp_callback_name, {})._prepare_folder(trainer)
    callback = cflearn_torch.schema.train_schema.TrainerCallback.make(inference.tmp_callback_name, {})
    with torch.no_grad():
        callback.log_artifacts(trainer)
    folder = os.path.join(trainer.workspace, "images", str(trainer.state.step))
    assert {"original.png", "sampled.png"} <= set(os.listdir(folder))
