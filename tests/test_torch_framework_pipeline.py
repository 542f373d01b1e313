"""The port's pipelines and functional API against the JAX package's, on the
CPU: the port loading a pipeline folder the JAX package wrote (its model
through the bridge) and predicting what the JAX pipeline predicts (f32, 1e-5
of the largest logit; classes and probabilities too); `save` ->
`load_inference` -> `predict` bit for bit in the port, and its folder in the
JAX layout; `load_training` / `load_evaluation`; `evaluate` and
`Evaluator.report` against the JAX package's on the same pipelines; `pack`;
the registry views; `fit_array` refusing to run without a card unless given
a device; the SD names of the old `cflearn_torch.pipeline` module. One JAX
fit (a module fixture) writes the JAX folder."""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

import cflearn_torch
import cflearn_tpu as jcf
import cflearn_tpu.models.common  # noqa: F401  (registers "common")
from _torch_cv_common import fast_build
from cflearn_tpu.schema import DLConfig as JDLConfig
from cflearn_tpu.schema.data import DataConfig as JDataConfig
from cflearn_tpu.schema.model import IDLModel as JIDLModel

CLF = dict(model="common", module_name="clf", loss_name="cross_entropy", module_config=dict(
    img_size=16, in_channels=3, num_classes=3, encoder="vit", latent_dim=12,
    encoder_config=dict(patch_size=4, num_layers=2, num_heads=3)))
REL = 1e-5


def _data():
    rs = np.random.RandomState(21)
    x = rs.randn(28, 16, 16, 3).astype(np.float32)
    return x[:20], rs.randint(0, 3, (20, 1)), x[20:], rs.randint(0, 3, (8, 1))


def _config(cls, workspace: str, ckpt: str):
    return cls(**CLF, workspace=workspace, fixed_steps=2, min_num_sample=0, metric_names=["acc", "f1"],
               callback_names=[], finetune_config={"pretrained_ckpt": ckpt})


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """One JAX fit and one port fit from the same JAX-saved start, on the same batches."""
    root = tmp_path_factory.mktemp("pipelines")
    ckpt = str(root / "start.npz")
    fast_build(lambda: JIDLModel.from_config(JDLConfig(**CLF))).save(ckpt)
    x, y, xv, yv = _data()
    jdc, tdc = JDataConfig(), cflearn_torch.DataConfig()
    jdc.batch_size = tdc.batch_size = 4
    np.random.seed(5)
    jp = jcf.fit_array(x, y, xv, yv, config=_config(JDLConfig, str(root / "j"), ckpt), data_config=jdc)
    np.random.seed(5)
    tp = cflearn_torch.fit_array(
        x, y, xv, yv, config=_config(cflearn_torch.DLConfig, str(root / "t"), ckpt), data_config=tdc, device="cpu")
    return jp, tp, root


def _folder(p) -> str:
    return os.path.join(p.trainer.workspace, "pipeline")


def _close(a: np.ndarray, b: np.ndarray) -> None:
    assert a.shape == b.shape and np.abs(a - b).max() <= REL * np.abs(b).max()


def test_port_loads_a_jax_pipeline_folder(fitted) -> None:
    jp, _, _ = fitted
    loaded = cflearn_torch.load_inference(_folder(jp), device="cpu")
    assert isinstance(loaded, cflearn_torch.DLInferencePipeline) and isinstance(loaded.data, cflearn_torch.ArrayData)
    _, _, xv, _ = _data()
    _close(loaded.predict(xv)["predictions"], np.asarray(jp.predict(xv)["predictions"]))
    for kw in (dict(return_classes=True), dict(return_probabilities=True)):
        got, ref = loaded.predict(xv, **kw)["predictions"], np.asarray(jp.predict(xv, **kw)["predictions"])
        if "return_classes" in kw:
            assert np.array_equal(got, ref)
        else:
            _close(got, ref)
    # the loaded model is the JAX pipeline's best checkpoint, carried through the bridge
    ref = cflearn_torch.bridge.state_dict_from_jax(jp.model.state_dict(), loaded.model)
    for name, value in loaded.model.state_dict().items():
        assert torch.equal(value, ref[name].to(value.dtype)), name
    # the other kinds load from the JAX folder too; the evaluation pipelines score alike
    assert isinstance(cflearn_torch.load_training(_folder(jp), device="cpu"), cflearn_torch.DLTrainingPipeline)
    _, _, _, yv = _data()
    got = cflearn_torch.load_evaluation(_folder(jp), device="cpu").evaluate(xv, yv)
    want = jcf.load_evaluation(_folder(jp)).evaluate(xv, yv)
    assert got.metric_values == want.metric_values and got.final_score == want.final_score


def test_save_load_predict_bit_for_bit(fitted, tmp_path) -> None:
    """The port's pipeline saved and loaded predicts what it predicted, bit
    for bit; the folder holds the JAX package's files; every kind loads."""
    jp, tp, _ = fitted
    _, _, xv, yv = _data()
    folder = cflearn_torch.save(tp, str(tmp_path / "saved"))
    assert sorted(os.listdir(folder)) == sorted(os.listdir(_folder(jp))) == [
        "data_module", "model.npz", "optimizers.npz", "pipeline.json"]
    with open(os.path.join(folder, "pipeline.json")) as f, open(os.path.join(_folder(jp), "pipeline.json")) as g:
        mine, theirs = json.load(f), json.load(g)
    assert mine["type"] == theirs["type"] == "dl.training" and mine["info"]["blocks"] == theirs["info"]["blocks"]
    loaded = cflearn_torch.load_inference(folder, device="cpu")
    before = tp.predict(xv)["predictions"]
    assert np.array_equal(loaded.predict(xv)["predictions"], before)
    for name, value in tp.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[name], value), name
    assert isinstance(cflearn_torch.load_training(folder, device="cpu"), cflearn_torch.DLTrainingPipeline)
    evaluation = cflearn_torch.load_evaluation(folder, device="cpu")
    assert isinstance(evaluation, cflearn_torch.DLEvaluationPipeline)
    out = evaluation.evaluate(xv, yv)
    assert set(out.metric_values) == {"acc", "f1"}
    assert out.metric_values["acc"] == float(np.mean(np.argmax(before, -1) == yv[:, 0]))


def test_fits_and_evaluate_match_jax(fitted) -> None:
    """The two fits predict alike (both started from the JAX model and saw the
    same batches); `evaluate` over them and the JAX package's over the JAX
    pipelines give the same metrics, and `Evaluator.report` the same table."""
    jp, tp, _ = fitted
    _, _, xv, yv = _data()
    _close(tp.predict(xv)["predictions"], np.asarray(jp.predict(xv)["predictions"]))
    loaded = cflearn_torch.load_inference(_folder(jp), device="cpu")
    got = cflearn_torch.evaluate({"fit": tp, "jax_folder": loaded}, xv, yv, metrics=["acc", "f1"], verbose=False)
    ref = jcf.evaluate({"fit": jp, "jax_folder": jp}, xv, yv, metrics=["acc", "f1"], verbose=False)
    for name in got:
        assert got[name].metric_values == ref[name].metric_values and got[name].final_score == ref[name].final_score
    assert cflearn_torch.Evaluator.report(got) == jcf.api.Evaluator.report(ref)
    assert tp.trainer.final_results.metric_values == jp.trainer.final_results.metric_values


def test_pack(fitted, tmp_path) -> None:
    _, tp, _ = fitted
    folder = cflearn_torch.pack(tp.trainer.workspace, str(tmp_path / "export"))
    assert sorted(os.listdir(folder)) == sorted(os.listdir(_folder(tp)))
    archive = cflearn_torch.pack(tp.trainer.workspace, str(tmp_path / "zipped"), compress=True)
    assert archive.endswith(".zip") and "model.npz" in zipfile.ZipFile(archive).namelist()
    with pytest.raises(ValueError, match="no serialized pipeline"):
        cflearn_torch.pack(str(tmp_path), str(tmp_path / "none"))


def test_registry_views_match_jax() -> None:
    assert cflearn_torch.supported_metrics() == jcf.supported_metrics()
    assert cflearn_torch.supported_optimizers() == jcf.supported_optimizers()
    assert cflearn_torch.supported_schedulers() == jcf.supported_schedulers()
    basic = {"mae", "sigmoid_mae", "mse", "recon", "bce", "cross_entropy", "label_smooth_cross_entropy", "focal",
             "quantile", "corr", "iou"}
    assert basic <= set(cflearn_torch.supported_losses()) and basic <= set(jcf.supported_losses())
    assert {"clf", "gan", "vae", "vq_vae", "pixel_cnn", "ae_kl", "ae_vq"} <= set(cflearn_torch.supported_modules())
    assert cflearn_torch.make_metric("quantile", q=0.3).q == 0.3
    model = cflearn_torch.make_model("clf", device="meta", module_config=CLF["module_config"],
                                     loss_name="cross_entropy")
    assert isinstance(model, cflearn_torch.IDLModel) and model.m.head.weight.device.type == "meta"


def test_fit_array_and_loads_need_a_card_or_a_device(fitted, monkeypatch) -> None:
    jp, _, _ = fitted
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, _, _ = _data()
    with pytest.raises(RuntimeError, match="CUDA"):
        cflearn_torch.fit_array(x, y, config=cflearn_torch.DLConfig(**CLF))
    with pytest.raises(RuntimeError, match="CUDA"):
        cflearn_torch.load_inference(_folder(jp))


def test_old_pipeline_names_import_unchanged() -> None:
    """`cflearn_torch.pipeline` is a package now; the SD entry points and
    constants of the module it replaced import from it as before."""
    from cflearn_torch import pipeline
    from cflearn_torch.pipeline import (  # noqa: F401
        ACCEL_DC, AE_DEFAULT_LR, CONFIGS, FAITHFUL_DC, GUIDANCE_INTERVAL, TOME_RATIO, configure, default_tokenizer,
        finetune_unet, train_autoencoder, txt2img,
    )
    from cflearn_torch.pipeline import sd

    for name in ("ACCEL_DC", "AE_DEFAULT_LR", "CONFIGS", "FAITHFUL_DC", "GUIDANCE_INTERVAL", "TOME_RATIO", "configure",
                 "finetune_unet", "train_autoencoder", "txt2img"):
        assert getattr(pipeline, name) is getattr(sd, name)
        if name[0].islower():
            assert getattr(cflearn_torch, name) is getattr(sd, name)
    assert AE_DEFAULT_LR == 1e-3 / 3 and CONFIGS == ("lossless", "faithful", "accelerated")
