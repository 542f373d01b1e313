"""The tabular entry points against the JAX package's, on the CPU at tiny
sizes: `fit_ml` a few fixed steps on both sides from one model file the JAX
package saved (`finetune_config={"pretrained_ckpt": ...}`, read through the
bridge) on the same mixed table (string and integer categories, NaN cells,
a redundant column) with the same batches (numpy seeded before each fit, so
the splitter and the loader draw alike): every step's loss items, the
parameters and BatchNorm statistics after the fit, and the predictions
(classes, probabilities, recovered regression labels); a JAX-saved `ml.*`
pipeline folder loaded by the port and predicting the same, and evaluating
the same; `save` -> `load_inference` -> `predict` bit for bit in the port;
`make_toy_ml_model`, the `CI` flag and the model names `fit_ml` resolves;
`integrated_gradients` / `Interpreter` on an `ml.common` model and
`DDRPredictor` on a DDR against the JAX package's; `fit_ml` refusing to
run without a card unless given a device.

The port's "ml.common" trains its categorical encoder's embedding tables
with the net; the JAX package's "all" scope leaves them out (its filter is
`PathContains("m")`), so each JAX model here is held to the port with that
scope widened to the encoder (`jax_trains_the_encoder`), and
`test_fit_ml_trains_the_encoder_tables` shows the tables move.

Tolerances: loss items and the integrated gradients 1e-5 relative;
parameters and predictions 1e-5 of the largest value (f32 against f32,
other summation orders)."""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import cflearn_torch
import cflearn_tpu as jcf
import cflearn_tpu.models.ml  # noqa: F401  (registers the "ml.*" models)
from _torch_bridge_common import rel_err
from _torch_cv_common import fast_build, pair
from cflearn_torch.bridge import state_dict_from_jax
from cflearn_torch.schema.train_schema import TrainerCallback
from cflearn_torch.trainer import read_states
from cflearn_tpu.api.ml import DDRPredictor as JDDRPredictor
from cflearn_tpu.api.ml import integrated_gradients as j_integrated_gradients
from cflearn_tpu.models.ml.common import CommonMLModel as JCommonMLModel
from cflearn_tpu.modules.ml.ddr import DDR as JDDR
from cflearn_tpu.schema import MLConfig as JMLConfig
from cflearn_tpu.schema.data import DataConfig as JDataConfig
from cflearn_tpu.schema.model import IDLModel as JIDLModel
from cflearn_tpu.schema.train_schema import TrainerCallback as JTrainerCallback

REL = 1e-5
BATCH = 16
N = 72


class _Record:
    def __init__(self) -> None:
        self.logs = []

    def after_step(self, step_outputs, state) -> None:
        self.logs.append((state.step, dict(step_outputs.loss_items)))


TrainerCallback.register("tabular_test_record")(type("Record", (_Record, TrainerCallback), {}))
JTrainerCallback.register("tabular_test_record")(type("Record", (_Record, JTrainerCallback), {}))


def table(seed: int = 0, n: int = N) -> np.ndarray:
    rs = np.random.RandomState(seed)
    x = np.empty((n, 6), dtype=object)
    x[:, 0] = rs.randn(n) * 2.0
    col = rs.randn(n) + 1.0
    col[rs.rand(n) < 0.1] = np.nan
    x[:, 1] = col
    x[:, 2] = rs.choice(["north", "south", "east", "west", "centre"], n)
    x[:, 3] = rs.randint(0, 3, n).astype(np.float64)
    x[:, 4] = "same"
    x[:, 5] = rs.rand(n) * 5.0
    return x


def labels(kind: str, x: np.ndarray) -> np.ndarray:
    rs = np.random.RandomState(1)
    score = x[:, 0].astype(float) + (x[:, 2] == "north") - 0.5 * x[:, 3].astype(float)
    if kind == "regression":
        return (score * 3.0 + rs.randn(len(x)) + 10.0)[:, None]
    return np.digitize(score, [-1.0, 1.0])[:, None]


# (module, its config, labels, data kw) -> the encoder settings the recogniser infers: columns 2 and 3
CASES = {
    "fcnn_clf": ("fcnn", {"hidden_units": [16, 16]}, "classes"),
    "fcnn_regression": ("fcnn", {"hidden_units": [16]}, "regression"),
    "transformer_clf": ("transformer", {"num_layers": 1, "latent_dim": 8}, "classes"),
}
ENCODER = {"2": {"dim": 6}, "3": {"dim": 4}}
INPUT_DIM = 5  # six columns, the redundant one dropped


def _output_dim(kind: str) -> int:
    return 1 if kind == "regression" else 3


def _base(case: str, workspace: str, ckpt: str, **overrides) -> dict:
    module, module_config, kind = CASES[case]
    kwargs = dict(module_name=module, module_config=dict(module_config), workspace=workspace, fixed_steps=4,
                  min_num_sample=0, num_snapshot_per_epoch=2, log_steps=1, callback_names=["tabular_test_record"],
                  finetune_config={"pretrained_ckpt": ckpt}, lr=0.05, optimizer_name="sgd", scheduler_name=None)
    kwargs.update(overrides)
    return kwargs


def _fit(side: str, case: str, workspace: str, ckpt: str, seed: int = 4):
    x = table()
    y = labels(CASES[case][2], x)
    kwargs = _base(case, workspace, ckpt)
    np.random.seed(seed)
    if side == "jax":
        dc = JDataConfig()
        dc.batch_size = dc.valid_batch_size = BATCH
        return jcf.fit_ml(x, y, config=JMLConfig(**kwargs), data_config=dc)
    dc = cflearn_torch.DataConfig()
    dc.batch_size = dc.valid_batch_size = BATCH
    return cflearn_torch.fit_ml(x, y, config=cflearn_torch.MLConfig(**kwargs), data_config=dc, device="cpu")


def _start_model(case: str, path: str) -> str:
    """The JAX model both fits start from, as `fit_ml` builds it: "ml.common"
    with the inferred encoder, filled from numpy and saved."""
    module, module_config, kind = CASES[case]
    config = JMLConfig(model="ml.common", module_name=module, encoder_settings=ENCODER,
                       module_config=dict(module_config, input_dim=INPUT_DIM, output_dim=_output_dim(kind)),
                       loss_name="mse" if kind == "regression" else "cross_entropy")
    fast_build(lambda: JIDLModel.from_config(config)).save(path)
    return path


@pytest.fixture(scope="module", autouse=True)
def jax_trains_the_encoder():
    """The JAX "ml.common" family's "all" and "core" scopes with the encoder's
    tables in them, as the port's are."""
    base = JCommonMLModel.params_filter

    def params_filter(self, scope):
        if scope in ("all", "core"):
            return nnx.All(nnx.Param, nnx.Any(nnx.PathContains("m"), nnx.PathContains("encoder")))
        return base(self, scope)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JCommonMLModel, "params_filter", params_filter)
        yield


@pytest.fixture(scope="module")
def fits(tmp_path_factory, jax_trains_the_encoder):
    root = tmp_path_factory.mktemp("tabular")
    out = {}
    for case in CASES:
        ckpt = _start_model(case, str(root / f"{case}.npz"))
        out[case] = (_fit("jax", case, str(root / case / "j"), ckpt), _fit("torch", case, str(root / case / "t"), ckpt))
    return out


def _logs(p):
    return next(c for c in p.trainer.callbacks if hasattr(c, "logs")).logs


def _close(a, b, rel: float = REL) -> None:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-6), np.abs(a - b).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_ml_matches_jax(fits, case) -> None:
    """Four SGD steps at 0.05 from the same start on the same batches: the
    recognised encoder, every step's loss items, every tensor of the model
    after the fit (BatchNorm statistics included), the predictions. SGD, not
    Adam: a Linear's bias before a BatchNorm has a zero gradient in exact
    arithmetic, which Adam would scale up to a move of lr a step in the
    direction of each side's rounding noise."""
    jp, tp = fits[case]
    assert tp.model.config.model == jp.model.config.model == "ml.common"
    assert tp.model.config.encoder_settings == jp.model.config.encoder_settings == ENCODER
    assert tp.model.encoder is not None and sorted(tp.model.encoder.embeds) == ["2", "3"]
    got, ref = _logs(tp), _logs(jp)
    assert [s for s, _ in got] == [s for s, _ in ref] == [1, 2, 3, 4]
    for (step, a), (_, b) in zip(got, ref):
        assert set(a) == set(b)
        for k, v in b.items():
            assert abs(a[k] - v) <= REL * max(1.0, abs(v)), (step, k, a[k], v)
    want = state_dict_from_jax(jp.model.state_dict(), tp.model)
    for name, value in tp.model.state_dict().items():
        _close(value.numpy(), want[name].numpy())
    x = table(seed=9, n=20)
    for kw in ({}, {"return_classes": True}, {"return_probabilities": True}):
        if kw and CASES[case][2] == "regression":
            continue
        a, b = tp.predict(x, **kw)["predictions"], np.asarray(jp.predict(x, **kw)["predictions"])
        if kw.get("return_classes"):
            assert np.array_equal(a, b)
        else:
            _close(a, b)


def test_fit_ml_trains_the_encoder_tables(fits) -> None:
    """Every parameter, the encoder's embedding tables included, is in the
    port's "all" scope, and each table moved in the fit from the start both
    sides read (rows of categories no batch held stay put); the JAX
    package's own "all" scope leaves exactly the encoder out."""
    _, tp = fits["fcnn_clf"]
    trained = [n for n, _ in tp.model.params_filter("all")]
    tables = [f"encoder.{n}" for n, _ in tp.model.encoder.named_parameters()]
    assert len(tables) == 2 and set(tables) <= set(trained)
    assert sorted(trained) == sorted(n for n, _ in tp.model.named_parameters())
    start = copy.deepcopy(tp.model)
    start.load_state_dict(read_states(tp.config.finetune_config["pretrained_ckpt"]), strict=False)
    start, after = start.state_dict(), tp.model.state_dict()
    for n in tables:
        assert not torch.equal(after[n], start[n]), n
    jm = fast_build(lambda: JIDLModel.from_config(JMLConfig(
        model="ml.common", module_name="fcnn", encoder_settings=ENCODER, loss_name="cross_entropy",
        module_config=dict(CASES["fcnn_clf"][1], input_dim=INPUT_DIM, output_dim=3))))
    def paths(flt):
        return {"/".join(map(str, k)) for k, _ in nnx.to_flat_state(nnx.state(jm, flt))}

    widened, netted = paths(jm.params_filter("all")), paths(nnx.All(nnx.Param, nnx.PathContains("m")))
    assert {k.split("/")[0] for k in widened - netted} == {"encoder"}


def test_port_loads_a_jax_ml_pipeline_folder(fits, tmp_path) -> None:
    """The JAX `fit_ml` folder ("ml.training", an `MLData` with its blocks, a
    model with its encoder) loads in the port as inference, evaluation and
    training pipelines; predictions and metrics match the JAX pipeline's."""
    for case in ("fcnn_clf", "fcnn_regression"):
        jp, _ = fits[case]
        folder = os.path.join(jp.trainer.workspace, "pipeline")
        loaded = cflearn_torch.load_inference(folder, device="cpu")
        assert isinstance(loaded, cflearn_torch.MLInferencePipeline) and isinstance(loaded.data, cflearn_torch.MLData)
        x = table(seed=10, n=24)
        _close(loaded.predict(x)["predictions"], np.asarray(jp.predict(x)["predictions"]))
        y = labels(CASES[case][2], x)
        got = cflearn_torch.load_evaluation(folder, device="cpu").evaluate(x, y)
        want = jcf.load_evaluation(folder).evaluate(x, y)
        assert set(got.metric_values) == set(want.metric_values)
        for k, v in want.metric_values.items():
            assert abs(got.metric_values[k] - v) <= 1e-5 * max(1.0, abs(v)), k
        assert isinstance(cflearn_torch.load_training(folder, device="cpu"), cflearn_torch.MLTrainingPipeline)


def test_save_load_predict_bit_for_bit(fits, tmp_path) -> None:
    _, tp = fits["fcnn_clf"]
    folder = cflearn_torch.save(tp, str(tmp_path / "saved"))
    assert sorted(os.listdir(folder)) == ["data_module", "model.npz", "optimizers.npz", "pipeline.json"]
    loaded = cflearn_torch.load_inference(folder, device="cpu")
    x = table(seed=11, n=30)
    assert np.array_equal(loaded.predict(x)["predictions"], tp.predict(x)["predictions"])
    for name, value in tp.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[name], value), name
    out = cflearn_torch.evaluate(loaded, x, labels("classes", x), metrics=["acc"], verbose=False)["pipeline"]
    pred = tp.predict(x, return_classes=True)["predictions"]
    assert out.metric_values["acc"] == float(np.mean(pred[:, 0] == labels("classes", x)[:, 0]))


def test_fit_ml_defaults_names_and_ci(tmp_path, monkeypatch) -> None:
    """`fit_ml` copies its config; "ml.<module>" where registered (DDR), else
    "ml.common"; `make_toy_ml_model` runs its two steps on both sides; the
    `CI` flag makes a one-step run; without a card and without a device it
    raises."""
    config = cflearn_torch.MLConfig(module_name="fcnn", module_config={"hidden_units": [4]}, fixed_steps=1,
                                    workspace=str(tmp_path / "a"), callback_names=[])
    x = np.random.RandomState(0).randn(40, 3).astype(np.float32)
    y = x[:, :1] * 2.0
    p = cflearn_torch.fit_ml(x, y, config=config, device="cpu")
    assert config.model == "common" and p.model.config.model == "ml.common"
    assert p.config.loss_name == "mse" and p.config.metric_names == ["mae", "mse"]
    assert p.model.m.input_dim == 3 and p.model.m.output_dim == 1 and p.model.encoder is None
    ddr = cflearn_torch.fit_ml(x, y, config=cflearn_torch.MLConfig(
        module_name="ddr", module_config={"hidden_units": [4], "num_anchors": 4}, fixed_steps=1,
        workspace=str(tmp_path / "b"), callback_names=[]), device="cpu")
    assert ddr.model.config.model == "ml.ddr" and ddr.config.loss_name == "ddr"
    np.random.seed(0)
    toy = cflearn_torch.make_toy_ml_model(cflearn_torch.MLConfig(
        module_name="fcnn", module_config={"hidden_units": [8]}, workspace=str(tmp_path / "toy"), callback_names=[]),
        device="cpu")
    np.random.seed(0)
    jtoy = jcf.make_toy_ml_model(JMLConfig(module_name="fcnn", module_config={"hidden_units": [8]},
                                           workspace=str(tmp_path / "jtoy"), callback_names=[]))
    assert toy.trainer.state.step == jtoy.trainer.state.step == 2
    monkeypatch.setenv("CI", "1")
    ci = cflearn_torch.fit_ml(x, y, config=config, device="cpu")
    assert ci.trainer.state.step == 1 and ci.config.fixed_steps == 1 and config.fixed_steps == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cflearn_torch.fit_ml(x, y, config=config)


def test_integrated_gradients_match_jax(fits) -> None:
    """On the fitted `ml.common` FCNN (with its encoder): the predicted
    class's attribution, a target column's, and `Interpreter`'s average
    importances: 1e-5 relative."""
    jp, tp = fits["fcnn_clf"]
    x = table(seed=12, n=12)
    feats = np.asarray(tp.data.build_loader(x).get_full_batch()["input"], np.float32)
    # the categorical columns stay integral along the path only at the ends: attribute the numerical ones
    base = feats.copy()
    base[:, [0, 1, 4]] = 0.0
    from cflearn_torch.api.ml import Interpreter, integrated_gradients
    from cflearn_tpu.api.ml import Interpreter as JInterpreter

    tfn = lambda xi: tp.model.run({"input": xi}, training=False)["predictions"]  # noqa: E731
    gd, state = nnx.split(jp.model)
    jfn = lambda xi: nnx.merge(gd, state).run({"input": xi}, training=False)["predictions"]  # noqa: E731
    for target in (None, 2):
        got = integrated_gradients(tfn, torch.from_numpy(feats), baseline=torch.from_numpy(base), steps=8,
                                   target=target)
        ref = j_integrated_gradients(jfn, jnp.asarray(feats), baseline=jnp.asarray(base), steps=8, target=target)
        assert rel_err(got.numpy(), ref) < REL, target
    got = Interpreter(tp.data, tp.model).importances(x, steps=8)
    ref = JInterpreter(jp.data, jp.model).importances(x, steps=8)
    assert rel_err(got, ref) < REL


def test_ddr_predictor_matches_jax() -> None:
    """`DDRPredictor` on a DDR bridged from the JAX one: median, the
    quantiles nearest to three levels, and cdf / pdf at a y (pdf through
    autograd against `jax.grad`): 1e-5."""
    jm = fast_build(lambda: JDDR(2, 1, [8], num_anchors=8, rngs=nnx.Rngs(0)))
    tm = pair(jm, cflearn_torch.DDR(2, 1, [8], num_anchors=8)).eval()
    jpred, tpred = JDDRPredictor(jm), cflearn_torch.DDRPredictor(tm)
    x = np.random.RandomState(3).randn(9, 2).astype(np.float32)
    _close(tpred.median(x), jpred.median(x))
    _close(tpred.quantile(x, [0.1, 0.5, 0.93]), jpred.quantile(x, [0.1, 0.5, 0.93]))
    for a, b in zip(tpred.cdf_pdf(x, 0.3), jpred.cdf_pdf(x, 0.3)):
        _close(a, b)


ML_MODELS = {
    "ml.common": dict(module_name="fcnn", module_config=dict(input_dim=4, output_dim=3, hidden_units=[8]),
                      encoder_settings={"1": {"dim": 5, "methods": "one_hot"}, "3": {"dim": 4}}, loss_name="cross_entropy"),
    "ml.wnd": dict(module_name="wnd", module_config=dict(input_dim=4, output_dim=3, hidden_units=[8]),
                   encoder_settings={"3": {"dim": 4}}, loss_name="cross_entropy"),
    "ml.temporal": dict(module_name="rnn", module_config=dict(input_dim=4, output_dim=1, hidden_dim=6),
                        loss_name="mse"),
    "ml.ddr": dict(module_name="ddr", module_config=dict(input_dim=4, output_dim=1, hidden_units=[8],
                                                         num_anchors=4)),
}


@pytest.mark.parametrize("name", sorted(ML_MODELS))
def test_ml_models_match_jax(name) -> None:
    """Each "ml.*" model through `IDLModel.from_config` on both sides, the JAX
    state bridged (`load_state_dict` of the JAX `state_dict()`): the
    forward's outputs in eval mode (F32) and one train step's loss items and
    gradients (1e-5 of the largest gradient of any tensor: a Linear's bias
    before a BatchNorm has a gradient of rounding noise, zero in exact
    arithmetic; DDR's CDF head, unused by the loss, none)."""
    from _torch_cv_common import jax_train_steps, jrun

    kw = ML_MODELS[name]
    jm = fast_build(lambda: JIDLModel.from_config(JMLConfig(model=name, **kw)))
    tm = cflearn_torch.IDLModel.from_config(cflearn_torch.MLConfig(model=name, **kw), device="cpu")
    tm.load_state_dict(jm.state_dict())
    rs = np.random.RandomState(5)
    x = rs.randn(6, 5, 4) if name == "ml.temporal" else rs.randn(6, 4)
    if name in ("ml.common", "ml.wnd"):
        x[:, 1] = rs.randint(0, 5, 6)
        x[:, 3] = rs.randint(0, 4, 6)
    y = rs.randint(0, 3, (6, 1)) if kw.get("loss_name") == "cross_entropy" else rs.randn(6, 1)
    batch = {"input": x.astype(np.float32), "labels": y.astype(np.int64 if y.dtype.kind == "i" else np.float32)}
    ref = jrun(jm, batch)
    tm.eval()
    with torch.no_grad():
        got = tm.run({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ref:
        _close(got[k].numpy(), np.asarray(ref[k]))
    (jlosses, jgrads), = jax_train_steps(jm, batch, 0.0).values()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tm.train()
    step = tm.train_steps[0]
    losses = step.loss_fn(tm, tbatch, tm.run(tbatch, training=True))
    names = [n for n, _ in tm.params_filter(step.scope)]
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad(losses["loss"], [params[n] for n in names], allow_unused=True)
    for k, v in jlosses.items():
        assert abs(losses[k].item() - v) <= REL * max(1.0, abs(v)), k
    want = cflearn_torch.bridge.tree_from_nnx(jgrads, tm, names=names)
    scale = max(w.abs().max().item() for w in want.values())
    for n, g in zip(names, grads):
        g = torch.zeros_like(params[n]) if g is None else g
        assert (g - want[n]).abs().max().item() <= REL * scale, n


def test_ml_config_matches_jax() -> None:
    """`MLConfig`: the JAX package's fields and defaults; encoder-setting
    dataclasses accepted as dicts; `to_info` / `copy` / `inherit_from`; the
    "ml" entry of `config_registry`."""
    from cflearn_torch.schema.config import config_registry
    from cflearn_tpu.schema.config import MLEncoderSettings as JSettings

    t, j = cflearn_torch.MLConfig(), JMLConfig()
    assert t.to_info() == j.to_info()
    settings = {"2": cflearn_torch.schema.MLEncoderSettings(dim=7, methods=["one_hot", "embedding"])}
    t = cflearn_torch.MLConfig(module_name="fcnn", encoder_settings=settings,
                               global_encoder_settings=cflearn_torch.schema.MLGlobalEncoderSettings(embedding_dim=3))
    j = JMLConfig(module_name="fcnn", encoder_settings={"2": JSettings(dim=7, methods=["one_hot", "embedding"])})
    assert t.encoder_settings == j.encoder_settings == {"2": {"dim": 7, "methods": ["one_hot", "embedding"],
                                                             "method_configs": None}}
    assert t.global_encoder_settings == {"embedding_dim": 3, "embedding_dropout": None}
    assert settings["2"].use_one_hot and settings["2"].use_embedding
    assert t.copy().to_info() == t.to_info() and config_registry["ml"] is cflearn_torch.MLConfig
    inherited = cflearn_torch.MLConfig.inherit_from(cflearn_torch.DLConfig(module_name="fcnn", lr=0.5))
    assert isinstance(inherited, cflearn_torch.MLConfig) and inherited.lr == 0.5


def test_ddr_visualizer_writes_figures(tmp_path) -> None:
    """`DDRVisualizer` (matplotlib, imported only here) draws the quantile
    bands and the cdf / pdf curves of a port DDR into files."""
    tm = cflearn_torch.DDR(1, 1, [8], num_anchors=4)
    from cflearn_torch.modules.common import init_parameters

    init_parameters(tm, seed=0)
    x = np.linspace(-1, 1, 20, dtype=np.float32)[:, None]
    vis = cflearn_torch.DDRVisualizer(tm.eval(), dpi=20)
    for path in (vis.visualize_quantiles(x, x * 2, str(tmp_path / "q.png")),
                 vis.visualize_cdf(x, x * 2, 0.5, str(tmp_path / "c.png"))):
        assert os.path.getsize(path) > 0
