"""The port's ensembles, third-party evaluation and export against the JAX
package's, on the CPU.

Ensembles: two pipelines the JAX package fitted on one table (an `fcnn` and
a tiny tabular `transformer`), loaded by the port through the bridge and
fused: the fused predictions, classes and probabilities against the JAX
package's fusion of the same folders (1e-5 of the largest value, the
PR 18/19 framework tests' tolerance for f32 against f32), and the fused
evaluation's metrics; two port fits fused: the fused predict is the mean of
the members' own predictions, bit for bit, and the fused evaluation scores
that mean; a JAX folder and a port folder fused together; `num_picked`.

`GeneralEvaluationPipeline` over a duck-typed classifier: the JAX package's
metrics on the same loader.

Export: a tiny ViT classifier (257 tokens, so that its attention takes the
flash route) through `export_model` -> `load_exported`: one
`cflearn_torch::flash_attention` node per layer in the program, its outputs
bit for bit the eager forward's, and within 1e-5 of the JAX package's own
`export_model` -> `load_exported` on the same bridged weights; `fcnn` as the
JAX package's own export test; `aot_compile` on the CPU (eager);
`pack_exported` from a workspace; `torch.library.opcheck` on every
operation that carries a kernel, on CPU inputs."""

import json
import os

import numpy as np
import pytest
import torch

import cflearn_torch
import cflearn_tpu as jcf
import cflearn_tpu.models.common  # noqa: F401  (registers "common")
from _torch_cv_common import fast_build
from cflearn_torch.ops import attention as TA
from cflearn_torch.ops import conv as TC
from cflearn_torch.ops import group_norm as TG
from cflearn_torch.pipeline import export as TX
from cflearn_tpu.data import ArrayData as JArrayData
from cflearn_tpu.pipeline import export as JX
from cflearn_tpu.pipeline.third_party import GeneralEvaluationPipeline as JGeneral
from cflearn_tpu.pipeline.third_party import SKLearnClassifier as JSKLearn
from cflearn_tpu.schema import DLConfig as JDLConfig
from cflearn_tpu.schema import MLConfig as JMLConfig
from cflearn_tpu.schema.data import DataConfig as JDataConfig
from cflearn_tpu.schema.model import IDLModel as JIDLModel

REL = 1e-5
MEMBERS = {"fcnn": {"hidden_units": [16]}, "transformer": {"num_layers": 1, "latent_dim": 8}}


def _table():
    rs = np.random.RandomState(13)
    x = rs.randn(60, 5).astype(np.float32)
    y = np.digitize(x[:, 0] + 0.5 * x[:, 1], [-0.7, 0.7])[:, None]
    return x, y


def _ml_config(cls, module, workspace, **kw):
    return cls(module_name=module, module_config=dict(MEMBERS[module]), workspace=workspace, fixed_steps=3,
               min_num_sample=0, callback_names=[], metric_names=["acc", "auc"], **kw)


def _close(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.abs(a - b).max() <= REL * max(np.abs(b).max(), 1e-12)


def _folder(p) -> str:
    return os.path.join(p.trainer.workspace, "pipeline")


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Two JAX fits and two port fits of the members on one table."""
    root = tmp_path_factory.mktemp("members")
    x, y = _table()
    out = {"jax": [], "port": []}
    for i, module in enumerate(MEMBERS):
        np.random.seed(i)
        dc = JDataConfig()
        dc.batch_size = 16
        out["jax"].append(_folder(jcf.fit_ml(x, y, config=_ml_config(JMLConfig, module, str(root / f"j{i}")),
                                             data_config=dc)))
        np.random.seed(i)
        tdc = cflearn_torch.DataConfig()
        tdc.batch_size = 16
        out["port"].append(_folder(cflearn_torch.fit_ml(
            x, y, config=_ml_config(cflearn_torch.MLConfig, module, str(root / f"t{i}")), data_config=tdc,
            device="cpu")))
    return out


@pytest.mark.parametrize("kw", [{}, {"return_classes": True}, {"return_probabilities": True}],
                         ids=["raw", "classes", "probabilities"])
def test_fuse_inference_of_jax_folders_matches_jax(fits, kw) -> None:
    x, _ = _table()
    got = cflearn_torch.fuse_inference(fits["jax"], device="cpu").predict(x, **kw)["predictions"]
    want = np.asarray(jcf.fuse_inference(fits["jax"]).predict(x, **kw)["predictions"])
    if kw.get("return_classes"):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int64
    else:
        _close(got, want)


def test_fuse_evaluation_of_jax_folders_matches_jax(fits) -> None:
    x, y = _table()
    got = cflearn_torch.fuse_evaluation(fits["jax"], device="cpu").evaluate(x, y)
    want = jcf.fuse_evaluation(fits["jax"]).evaluate(x, y)
    assert set(got.metric_values) == set(want.metric_values) == {"acc", "auc"}
    assert got.metric_values["acc"] == want.metric_values["acc"]
    assert got.metric_values["auc"] == pytest.approx(want.metric_values["auc"], rel=REL)
    assert got.final_score == pytest.approx(want.final_score, rel=REL)


def test_fused_predict_is_the_members_mean_bit_for_bit(fits) -> None:
    """The port's own fits: the fused raw predictions are the mean of what
    each member predicts alone (through its own data processor), bit for
    bit; classes come from that mean, and the fused evaluation scores it."""
    x, y = _table()
    fused = cflearn_torch.fuse_evaluation(fits["port"], device="cpu")
    members = [cflearn_torch.load_inference(f, device="cpu").predict(x)["predictions"] for f in fits["port"]]
    mean = np.mean(members, axis=0)
    assert np.array_equal(fused.predict(x)["predictions"], mean)
    classes = fused.predict(x, return_classes=True)["predictions"]
    np.testing.assert_array_equal(classes, np.argmax(mean, -1)[:, None])
    acc = fused.evaluate(x, y).metric_values["acc"]
    assert acc == float(np.mean(np.argmax(mean, -1) == y[:, 0]))
    # the loader-level fusion: every member on copies of one loader (the first member's processing)
    loader = fused.pipelines[0]._as_loader(x, y, 128)
    same_batches = [p.inference.get_outputs(loader.copy()).forward_results["predictions"] for p in fused.pipelines]
    inference = fused.inference.get_outputs(loader)
    assert np.array_equal(inference.forward_results["predictions"], np.mean(same_batches, axis=0))


def test_fuse_mixes_the_packages_folders(fits) -> None:
    x, _ = _table()
    folders = [fits["jax"][0], fits["port"][1]]
    members = [cflearn_torch.load_inference(f, device="cpu").predict(x)["predictions"] for f in folders]
    got = cflearn_torch.fuse_inference(folders, device="cpu").predict(x)["predictions"]
    assert np.array_equal(got, np.mean(members, axis=0))


def test_pick_folders_matches_jax(tmp_path) -> None:
    """`num_picked` keeps the best folders by their best checkpoint score (an
    int or a fraction), folders without scores last."""
    folders = []
    for i, scores in enumerate([{"a": 0.2}, None, {"a": 0.9, "b": 0.1}, {"a": 0.5}]):
        folder = tmp_path / str(i)
        os.makedirs(folder / "checkpoints")
        if scores is not None:
            with open(folder / ("checkpoints" if i % 2 else "") / "scores.json", "w") as f:
                json.dump(scores, f)
        folders.append(str(folder))
    from cflearn_tpu.pipeline.api import DLPipelineSerializer as JSerializer

    for num_picked in (None, 1, 3, 0.5, 0.34):
        got = cflearn_torch.DLPipelineSerializer._pick_folders(folders, num_picked)
        assert got == JSerializer._pick_folders(folders, num_picked), num_picked
    assert cflearn_torch.DLPipelineSerializer._pick_folders(folders, 2) == [folders[2], folders[3]]


class _LogProba:
    """A fitted classifier as `SKLearnClassifier` sees one: only
    `predict_log_proba`."""

    def __init__(self, w: np.ndarray) -> None:
        self.w = w

    def predict_log_proba(self, x: np.ndarray) -> np.ndarray:
        z = x @ self.w
        return z - np.log(np.exp(z).sum(-1, keepdims=True))


@pytest.mark.parametrize("metrics", [["acc"], ["acc", "auc"], ["acc", "f1"]])
def test_general_evaluation_matches_jax(metrics) -> None:
    x, y = _table()
    predictor = _LogProba(np.random.RandomState(1).randn(5, 3).astype(np.float32))
    got = cflearn_torch.GeneralEvaluationPipeline(cflearn_torch.DLConfig(module_name="fcnn", metric_names=metrics),
                                                  cflearn_torch.SKLearnClassifier(predictor))
    want = JGeneral(JDLConfig(module_name="fcnn", metric_names=metrics), JSKLearn(predictor))
    out = got.evaluate(cflearn_torch.ArrayData.init().fit(x, y).get_loaders()[0])
    ref = want.evaluate(JArrayData.init().fit(x, y).get_loaders()[0])
    assert out.metric_values == ref.metric_values and out.final_score == ref.final_score
    assert out.metric_values["acc"] == float(np.mean(np.argmax(x @ predictor.w, -1) == y[:, 0]))
    with pytest.raises(ValueError, match="metric_names"):
        cflearn_torch.GeneralEvaluationPipeline(cflearn_torch.DLConfig(module_name="fcnn"), predictor)


VIT = dict(model="common", module_name="clf", loss_name="cross_entropy", module_config=dict(
    img_size=64, in_channels=3, num_classes=3, encoder="vit", latent_dim=8,
    encoder_config=dict(patch_size=4, num_layers=2, num_heads=2)))


@pytest.fixture(scope="module")
def vit_pair():
    jm = fast_build(lambda: JIDLModel.from_config(JDLConfig(**VIT)))
    tm = cflearn_torch.IDLModel.from_config(cflearn_torch.DLConfig(**VIT), device="cpu")
    tm.load_state_dict(jm.state_dict())
    x = np.random.RandomState(4).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    return jm, tm, {"input": x}


def test_export_carries_the_flash_operation_and_matches_eager_and_jax(vit_pair, tmp_path) -> None:
    jm, tm, batch = vit_pair
    folder = cflearn_torch.export_model(tm, batch, str(tmp_path / "port"))
    assert sorted(os.listdir(folder)) == ["model.json", "model.npz", "model.pt2"]
    with open(os.path.join(folder, "model.json")) as f:
        meta = json.load(f)
    assert meta["input_spec"] == {"input": [[2, 64, 64, 3], "float32"]} and meta["device"] == "cpu"
    loaded = cflearn_torch.load_exported(folder)
    # one flash node a layer, as the eager forward calls the operation once a layer
    assert loaded.op_counts() == meta["ops"] == {"cflearn_torch::flash_attention": 2}
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TA, "flash_attention", lambda *a, _f=TA.flash_attention, **k: (calls.append(1), _f(*a, **k))[1])
        out = loaded(batch)
        assert len(calls) == 2
        with torch.no_grad():
            eager = tm.run({"input": torch.from_numpy(batch["input"])}, training=False)
        assert len(calls) == 4
    assert set(out) == {"predictions"} and torch.equal(out["predictions"], eager["predictions"])
    # the weights beside the program load into the same model
    again = cflearn_torch.IDLModel.load(os.path.join(folder, "model.npz"), device="cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    JX.export_model(jm, batch, str(tmp_path / "jax"))
    ref = JX.load_exported(str(tmp_path / "jax"))(batch)
    _close(out["predictions"].numpy(), ref["predictions"])
    with pytest.raises(ValueError, match="traced on cpu"):
        cflearn_torch.load_exported(folder, device="cuda")


def test_export_fcnn_matches_jax(tmp_path) -> None:
    """The JAX package's own export test (`tests/test_aux.py`), both sides."""
    config = dict(module_name="fcnn", module_config={"input_dim": 4, "output_dim": 2, "hidden_units": [8]},
                  loss_name="cross_entropy")
    jm = fast_build(lambda: JIDLModel.from_config(JDLConfig(**config)))
    tm = cflearn_torch.IDLModel.from_config(cflearn_torch.DLConfig(**config), device="cpu")
    tm.load_state_dict(jm.state_dict())
    batch = {"input": np.random.RandomState(0).randn(4, 4).astype(np.float32)}
    got = cflearn_torch.load_exported(cflearn_torch.export_model(tm, batch, str(tmp_path / "port")))(batch)
    JX.export_model(jm, batch, str(tmp_path / "jax"))
    _close(got["predictions"].numpy(), JX.load_exported(str(tmp_path / "jax"))(batch)["predictions"])
    assert TX.op_counts(torch.export.load(str(tmp_path / "port" / "model.pt2")).graph) == {}


def test_aot_compile_on_the_cpu_runs_eagerly(vit_pair) -> None:
    _, tm, batch = vit_pair
    x = torch.from_numpy(batch["input"].copy())
    compiled = cflearn_torch.aot_compile(tm, {"input": x})
    assert isinstance(compiled, TX.CapturedForward) and compiled.graph is None
    # the capture's inputs are its own: a caller's tensor is never written into
    assert compiled.static_inputs["input"].data_ptr() != x.data_ptr()
    x2 = {"input": batch["input"][::-1].copy()}
    with torch.no_grad():
        eager = tm.run({"input": torch.from_numpy(x2["input"])}, training=False)["predictions"]
    assert torch.equal(compiled(x2)["predictions"], eager) and torch.equal(x, torch.from_numpy(batch["input"]))
    assert compiled.launches_per_replay == {} and compiled.replays == 0


def test_pack_exported_from_a_workspace(tmp_path) -> None:
    x, y = _table()
    config = _ml_config(cflearn_torch.MLConfig, "fcnn", str(tmp_path / "ws"))
    p = cflearn_torch.fit_ml(x, y, config=config, device="cpu")
    folder = cflearn_torch.pack_stablehlo(p.trainer.workspace, str(tmp_path / "packed"), {"input": x[:8]}, device="cpu")
    assert cflearn_torch.pack_stablehlo is cflearn_torch.pack_exported
    out = cflearn_torch.load_exported(folder)({"input": x[:8]})["predictions"]
    loaded = cflearn_torch.load_inference(_folder(p), device="cpu").model
    with torch.no_grad():
        want = loaded.run({"input": torch.from_numpy(x[:8])}, training=False)["predictions"]
    assert torch.equal(out, want)


def _qkv(lq=40, lk=56, d=16, seed=0):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(2, 3, n, d).astype(np.float32)) for n in (lq, lk, lk)]


OPCHECK_CASES = {
    "flash_attention": lambda: (TA.flash_attention_op, (*_qkv(), False, None)),
    "flash_attention_causal_scaled": lambda: (TA.flash_attention_op, (*_qkv(lq=56), True, 0.3)),
    "flash_fwd_lse": lambda: (TA.flash_fwd_lse_op, (*_qkv(), False, None)),
    "flash_fwd_lse_causal": lambda: (TA.flash_fwd_lse_op, (*_qkv(lq=56), True, None)),
    "conv3x3": lambda: (TC.conv3x3_op, (torch.randn(2, 6, 5, 8), torch.randn(16, 3, 3, 8), torch.randn(16))),
    "conv3x3_no_bias": lambda: (TC.conv3x3_op, (torch.randn(1, 4, 7, 8), torch.randn(8, 3, 3, 8), None)),
    "group_norm_silu": lambda: (TG.group_norm_silu_op, (torch.randn(2, 5, 6, 16), torch.randn(16), torch.randn(16),
                                                        4, 1e-6, True)),
    "group_norm": lambda: (TG.group_norm_silu_op, (torch.randn(2, 9, 32), torch.randn(32), torch.randn(32), 8, 1e-5,
                                                   False)),
}


@pytest.mark.parametrize("case", list(OPCHECK_CASES))
def test_opcheck(case) -> None:
    """Schema, fake implementation (shapes, dtypes, strides), autograd
    registration and AOT dispatch of each operation; on the CPU the
    operation gives its plain version."""
    op, args = OPCHECK_CASES[case]()
    torch.library.opcheck(op, args)
    out = op(*args)
    if op is TC.conv3x3_op:
        assert torch.equal(out, TC.conv3x3_plain(*args))
    elif op is TG.group_norm_silu_op:
        x, w, b, groups, eps, silu = args
        assert torch.equal(out, TG.group_norm_silu_plain(x, w, b, num_groups=groups, eps=eps, apply_silu=silu))
    else:
        q, k, v, causal, scale = args
        want = TA.flash_fwd_with_lse_plain(q, k, v, causal=causal, sm_scale=scale)
        got = out if isinstance(out, tuple) else (out,)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert got[0].stride() == TA._fwd_out(q).stride()


def test_export_of_a_bf16_autoencoder_keeps_the_conv_operation(tmp_path) -> None:
    """A small `ae_kl` in bf16 at 128 px, its posterior's mode: the 64-channel convs at 128^2 take the conv
    route (the operation holds, on the CPU, the plain version) and the 32^2 mid-block attention the flash route;
    the export traces the conv's cached kernel-layout weight without touching storage, holds one operation node
    a routed call, and gives the eager forward bit for bit."""
    m = cflearn_torch.build_ae(dict(img_size=128, inner_channels=64, channel_multipliers=[1, 2, 2], num_res_blocks=1,
                                    use_perceptual=False), device="cpu", dtype=torch.bfloat16)
    batch = {"input": (torch.rand((1, 128, 128, 3), generator=torch.Generator().manual_seed(3)) * 2 - 1).bfloat16()}
    calls = {"conv3x3": 0, "flash_attention": 0}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TC, "conv3x3_plain",
                   lambda *a, _f=TC.conv3x3_plain: calls.update(conv3x3=calls["conv3x3"] + 1) or _f(*a))
        mp.setattr(TA, "flash_attention", lambda *a, _f=TA.flash_attention, **k: (
            calls.update(flash_attention=calls["flash_attention"] + 1), _f(*a, **k))[1])
        with torch.no_grad():
            eager = m.run(batch, training=False, sample=False)["predictions"]
    folder = cflearn_torch.export_model(m, batch, str(tmp_path), forward_kwargs={"sample": False})
    loaded = cflearn_torch.load_exported(folder)
    assert {TX.KERNEL_OPS[k]: v for k, v in loaded.op_counts().items()} == calls
    assert calls["conv3x3"] > 0 and calls["flash_attention"] == 2
    assert torch.equal(loaded(batch)["predictions"], eager)


EAGER_ENTRY_CASES = {
    "flash_attention_trainable": lambda: (TA, "flash_attention_op", TA.flash_attention_trainable, _qkv()),
    "flash_attention_function": lambda: (TA, "flash_attention_op", TA.FlashAttentionTrainable.apply, _qkv()),
    "fused_group_norm": lambda: (TG, "group_norm_silu_op",
                                 lambda x, w, b: TG.fused_group_norm(x, w, b, 4, 1e-6, True),
                                 (torch.randn(2, 5, 6, 16), torch.randn(16), torch.randn(16))),
    "conv3x3": lambda: (TC, "conv3x3_op", TC.conv3x3,
                        (torch.randn(2, 6, 5, 8), torch.randn(16, 3, 3, 8), torch.randn(16))),
}


@pytest.mark.parametrize("case", list(EAGER_ENTRY_CASES))
def test_eager_calls_skip_the_operation_and_traces_keep_it(case, monkeypatch) -> None:
    """An eager call without a gradient goes to the kernel's wrapper without a
    dispatcher round trip; `torch.export` of the same call holds the
    operation, which gives the same values."""
    module, name, entry, args = EAGER_ENTRY_CASES[case]()
    op = getattr(module, name)
    entered = []
    monkeypatch.setattr(module, name, lambda *a: entered.append(1) or op(*a))

    class Call(torch.nn.Module):
        def forward(self, *inputs):  # type: ignore[no-untyped-def]
            return entry(*inputs)

    with torch.no_grad():
        eager = Call()(*args)
    assert not entered
    with torch.no_grad():
        program = torch.export.export(Call(), tuple(args), strict=False)
    assert entered and sum(TX.op_counts(program.graph).values()) == 1
    assert torch.equal(program.module()(*args), eager)
