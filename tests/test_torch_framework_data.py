"""The framework's host-side pieces against the JAX package's, on the CPU:
`ArrayLoader` batches and `BATCH_INDICES_KEY` under the same numpy seed
(shuffle, `drop_last`, sample weights, `split_validation`), the data
folders either package writes, `DeviceBatcher`, every metric (exact),
`MultipleMetrics` and `weighted_loss_score`, every monitor's snapshot and
terminate decisions on one score sequence, `TrainerState`'s cadences,
every loss of `losses/basic.py` (f32, 1e-6 of the largest value: one
summation order against another), and the toolkit the `Trainer` uses (the
mode contexts, `summary`, `Initializer`). No JAX model is built here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cflearn_torch  # noqa: F401  (registers the metrics, monitors and callbacks)
import cflearn_tpu.data as jdata
import cflearn_tpu.losses.basic  # noqa: F401  (registers the JAX losses)
import cflearn_tpu.metrics as jmetrics
import cflearn_tpu.monitors as jmonitors
from cflearn_torch import metrics as tmetrics
from cflearn_torch import monitors as tmonitors
from cflearn_torch.constants import BATCH_INDICES_KEY, INPUT_KEY, LABEL_KEY, PREDICTIONS_KEY
from cflearn_torch.data import ArrayData, ArrayDictData, DeviceBatcher
from cflearn_torch.data.utils import convert
from cflearn_torch.schema.data import DataConfig, IData
from cflearn_torch.schema.losses_schema import ILoss as TILoss
from cflearn_torch.schema.metrics_schema import IMetric as TIMetric
from cflearn_torch.schema.metrics_schema import weighted_loss_score
from cflearn_torch.schema.train_schema import TrainerState
from cflearn_torch.toolkit.serialization import Serializer
from cflearn_tpu.schema.data import DataConfig as JDataConfig
from cflearn_tpu.schema.data import IData as JIData
from cflearn_tpu.schema.losses_schema import ILoss as JILoss
from cflearn_tpu.schema.metrics_schema import IMetric as JIMetric
from cflearn_tpu.schema.metrics_schema import weighted_loss_score as j_weighted_loss_score
from cflearn_tpu.schema.train_schema import TrainerState as JTrainerState
from cflearn_tpu.toolkit.serialization import Serializer as JSerializer

N, VALID = 23, 7


def _arrays(seed: int = 0):
    rs = np.random.RandomState(seed)
    return rs.randn(N, 4, 3).astype(np.float32), rs.randint(0, 3, (N, 1)), rs.randn(VALID, 4, 3), rs.randint(0, 3, (VALID, 1))


def _config(cls, **kwargs):
    config = cls()
    for k, v in kwargs.items():
        setattr(config, k, v)
    return config


def _epochs(data, n: int = 2):
    """Two epochs of the train loader and one pass of the valid loader, numpy seeded."""
    np.random.seed(7)
    train, valid = data.get_loaders()
    out = [list(train) for _ in range(n)]
    return out, (list(valid) if valid is not None else None)


def _same_batches(a, b) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert np.array_equal(x[k], y[k]) and x[k].dtype == y[k].dtype, k


CASES = {
    "shuffle": dict(batch_size=5),
    "no_shuffle": dict(batch_size=5, shuffle_train=False),
    "drop_last": dict(batch_size=5, drop_last=True),
    "valid_batch": dict(batch_size=4, valid_batch_size=3, shuffle_valid=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_array_loader_batches_match_jax(case) -> None:
    """The same batches and batch indices from both packages under one numpy seed."""
    x, y, xv, yv = _arrays()
    j = jdata.ArrayData.init(_config(JDataConfig, **CASES[case])).fit(x, y, xv, yv)
    t = ArrayData.init(_config(DataConfig, **CASES[case])).fit(x, y, xv, yv)
    (jt, jv), (tt, tv) = _epochs(j), _epochs(t)
    for a, b in zip(jt, tt):
        _same_batches(a, b)
    _same_batches(jv, tv)
    assert all(BATCH_INDICES_KEY in b for b in tt[0])
    if case == "drop_last":
        assert sum(len(b[INPUT_KEY]) for b in tt[0]) == N // 5 * 5
    if case == "shuffle":
        assert not np.array_equal(tt[0][0][BATCH_INDICES_KEY], tt[1][0][BATCH_INDICES_KEY])


def test_sample_weights_resample_as_in_jax() -> None:
    x, y, xv, yv = _arrays()
    weights = np.random.RandomState(3).rand(N + VALID)
    j = jdata.ArrayData.init(_config(JDataConfig, batch_size=6)).fit(x, y, xv, yv).set_sample_weights(weights)
    t = ArrayData.init(_config(DataConfig, batch_size=6)).fit(x, y, xv, yv).set_sample_weights(weights)
    assert np.array_equal(j.train_weights, t.train_weights) and np.array_equal(j.valid_weights, t.valid_weights)
    (jt, jv), (tt, tv) = _epochs(j), _epochs(t)
    for a, b in zip(jt, tt):
        _same_batches(a, b)
    _same_batches(jv, tv)
    indices = np.concatenate([b[BATCH_INDICES_KEY] for b in tt[0]])
    assert len(indices) == N and len(np.unique(indices)) < N  # resampled with repeats


@pytest.mark.parametrize("split", [0.25, 5])
def test_split_validation_carves_the_same_rows(split) -> None:
    x, y, _, _ = _arrays()
    others = {"extra": np.arange(N) * 2.0}
    j = jdata.ArrayData.init().fit(x, y, train_others=others).split_validation(split, seed=3)
    t = ArrayData.init().fit(x, y, train_others=others).split_validation(split, seed=3)
    for field in ("x_train", "y_train", "x_valid", "y_valid"):
        assert np.array_equal(getattr(j.bundle, field), getattr(t.bundle, field)), field
    assert np.array_equal(j.bundle.valid_others["extra"], t.bundle.valid_others["extra"])
    assert t.num_valid == (round(N * split) if split < 1 else split) and t.num_train + t.num_valid == N


def test_array_dict_data_and_build_loader() -> None:
    x = {"a": np.arange(10.0), "b": np.arange(10)[:, None]}
    t = ArrayDictData.init(_config(DataConfig, batch_size=4, shuffle_train=False)).fit(x, np.arange(10))
    j = jdata.ArrayDictData.init(_config(JDataConfig, batch_size=4, shuffle_train=False)).fit(x, np.arange(10))
    _same_batches(list(j.get_loaders()[0]), list(t.get_loaders()[0]))
    xa, ya, _, _ = _arrays()
    loaders = [ArrayData.init().fit(xa, ya).build_loader(xa[:9], ya[:9], batch_size=4),
               jdata.ArrayData.init().fit(xa, ya).build_loader(xa[:9], ya[:9], batch_size=4)]
    _same_batches(*[list(loader) for loader in loaders])


def test_data_folders_cross_packages(tmp_path) -> None:
    """A data folder (`info.json`, `data.npz`) the JAX package saves loads as
    the port's `ArrayData` with the same loaders, and the other way round."""
    x, y, xv, yv = _arrays()
    JSerializer.save(str(tmp_path / "j"), jdata.ArrayData.init(_config(JDataConfig, batch_size=6)).fit(x, y, xv, yv))
    Serializer.save(str(tmp_path / "t"), ArrayData.init(_config(DataConfig, batch_size=6)).fit(x, y, xv, yv))
    t = Serializer.load(str(tmp_path / "j"), IData)
    j = JSerializer.load(str(tmp_path / "t"), JIData)
    assert isinstance(t, ArrayData) and isinstance(j, jdata.ArrayData) and t.config.batch_size == 6
    (jt, jv), (tt, tv) = _epochs(j, 1), _epochs(t, 1)
    _same_batches(jt[0], tt[0])
    _same_batches(jv, tv)


def test_device_batcher() -> None:
    """Tensors on the device in the loader's order, f64 as f32, integers as
    they are, the short last batch as it is, object arrays untouched."""
    x = np.arange(10 * 2, dtype=np.float64).reshape(10, 2)
    data = ArrayData.init(_config(DataConfig, batch_size=4, shuffle_train=False)).fit(x, np.arange(10)[:, None])
    loader = data.get_loaders()[0]
    batches = list(DeviceBatcher(loader, device="cpu"))
    assert len(batches) == 3 and all(torch.is_tensor(v) for b in batches for v in b.values())
    assert batches[0][INPUT_KEY].dtype == torch.float32 and batches[0][LABEL_KEY].dtype == torch.int64
    assert batches[2][INPUT_KEY].shape == (2, 2)
    assert torch.equal(torch.cat([b[INPUT_KEY] for b in batches]), torch.from_numpy(x).float())
    mixed = convert({"names": np.array(["a", None], dtype=object), "n": np.arange(2)}, torch.device("cpu"))
    assert mixed["names"].dtype == object and torch.equal(mixed["n"], torch.arange(2))


# ---------------------------------------------------------------- metrics


def _metric_inputs():
    rs = np.random.RandomState(5)
    logits = rs.randn(40, 3).astype(np.float32)
    labels = rs.randint(0, 3, (40, 1))
    binary = rs.randn(40, 1).astype(np.float32)
    binary_labels = (rs.rand(40, 1) > 0.5).astype(np.int64)
    regression = rs.randn(40, 1).astype(np.float32)
    masks = (rs.rand(6, 5, 5, 1) > 0.5).astype(np.float32)
    return {
        "acc": [(logits, labels), (binary, binary_labels)],
        "mae": [(regression, binary.astype(np.float32))],
        "mse": [(regression, binary.astype(np.float32))],
        "quantile": [(regression, binary), (np.concatenate([regression, binary], 1), regression)],
        "r2": [(regression, binary)],
        "corr": [(regression, binary)],
        "ber": [(logits, labels), (binary, binary_labels)],
        "f1": [(logits, labels), (binary, binary_labels)],
        "auc": [(logits, labels), (np.concatenate([binary, -binary], 1), binary_labels), (binary, binary_labels)],
        "iou": [(rs.randn(6, 5, 5, 1).astype(np.float32), masks)],
    }


METRIC_CONFIGS = {"acc": {}, "quantile": {"q": [0.1, 0.9]}, "f1": {"average": "macro"}}


@pytest.mark.parametrize("name", sorted(_metric_inputs()))
def test_metric_matches_jax_exactly(name) -> None:
    assert sorted(TIMetric.d) == sorted(JIMetric.d)
    for i, (predictions, labels) in enumerate(_metric_inputs()[name]):
        config = METRIC_CONFIGS.get(name, {}) if i == 1 and name == "quantile" else {}
        batch, outputs = {LABEL_KEY: labels}, {PREDICTIONS_KEY: predictions}
        got = TIMetric.make(name, config).evaluate(batch, outputs)
        ref = JIMetric.make(name, config).evaluate(batch, outputs)
        assert got.final_score == ref.final_score and got.metric_values == ref.metric_values, (name, i)
        assert got.is_positive == ref.is_positive
    for f1_average in ("micro", "weighted"):
        args = _metric_inputs()["f1"][0]
        assert tmetrics.F1Score(f1_average).forward(*args) == jmetrics.F1Score(f1_average).forward(*args)


def test_multiple_metrics_and_weighted_loss_score_match_jax() -> None:
    (logits, labels), _ = _metric_inputs()["acc"]
    batch, outputs = {LABEL_KEY: labels}, {PREDICTIONS_KEY: logits}
    for weights in (None, {"acc": 2.0, "ber": 0.5}):
        got = TIMetric.fuse(["acc", "ber", "f1"], metric_weights=weights)
        ref = JIMetric.fuse(["acc", "ber", "f1"], metric_weights=weights)
        assert got.requires_all and type(TIMetric.fuse("acc")).__name__ == "Accuracy"
        a, b = got.evaluate(batch, outputs), ref.evaluate(batch, outputs)
        assert (a.final_score, a.metric_values, a.is_positive) == (b.final_score, b.metric_values, b.is_positive)
    items = {"loss": 0.75, "aux": 0.25, "other": 2.0}
    for weights in (None, {"aux": 2.0, "other": 1.0, "missing": 3.0}):
        for loss_items in (items, {"aux": 0.5, "other": 1.5}, {}):
            assert weighted_loss_score(loss_items, weights) == j_weighted_loss_score(loss_items, weights)


# ---------------------------------------------------------------- monitors and the state

SCORES = [0.1, 0.3, 0.2, 0.2, 0.25, 0.4, 0.1, 0.05, 0.05, 0.3] * 4 + [0.3 + 1e-9 * i for i in range(40)]


@pytest.mark.parametrize("name", ["basic", "mean_std", "plateau", "conservative", "lazy"])
def test_monitor_decisions_match_jax(name) -> None:
    config = {"basic": {"patience": 3}, "mean_std": {"patience": 2, "window_size": 5},
              "plateau": {"patience": 2.0, "window_size": 5}}.get(name, {})
    got = tmonitors.TrainerMonitor.make(name, config)
    ref = jmonitors.TrainerMonitor.make(name, config)
    decisions = [(got.should_snapshot(s), got.should_terminate(s)) for s in SCORES]
    assert decisions == [(ref.should_snapshot(s), ref.should_terminate(s)) for s in SCORES]
    assert any(d[0] for d in decisions) or name == "lazy"
    state, jstate = TrainerState(num_step_per_epoch=4, batch_size=8), JTrainerState(num_step_per_epoch=4, batch_size=8)
    state.epoch = jstate.epoch = state.num_epoch = jstate.num_epoch = 40
    got.handle_extension(state)
    ref.handle_extension(jstate)
    assert state.num_epoch == jstate.num_epoch == 45 and vars(got).keys() == vars(ref).keys()


@pytest.mark.parametrize("kwargs", [
    dict(num_step_per_epoch=10, batch_size=8),
    dict(num_step_per_epoch=7, batch_size=32, min_num_sample=0, num_snapshot_per_epoch=2.0, num_step_per_log=3),
    dict(num_step_per_epoch=3000, batch_size=4, fixed_steps=20, max_step_per_snapshot=50, min_snapshot_epoch_gap=2),
])
def test_trainer_state_cadences_match_jax(kwargs) -> None:
    state, ref = TrainerState(**kwargs), JTrainerState(**kwargs)
    props = ("should_train", "should_monitor", "should_log_losses", "should_log_metrics_msg", "should_log_artifacts",
             "can_snapshot", "should_start_snapshot", "should_extend_epoch", "reached_max_epoch")
    for step in range(0, 60):
        state.step = ref.step = step
        state.epoch = ref.epoch = step // kwargs["num_step_per_epoch"] + 1
        assert [getattr(state, p) for p in props] == [getattr(ref, p) for p in props], step
    with state.disable_logging:
        assert not state.should_log_losses
    assert state.should_log_losses == ref.should_log_losses


# ---------------------------------------------------------------- losses

LOSS_CONFIGS = {
    "recon": [{}, {"base_loss": "mse"}], "label_smooth_cross_entropy": [{}, {"eps": 0.3}],
    "focal": [{}, {"gamma": 1.5, "alpha": [0.2, 0.3, 0.5]}, {"input_logits": False}], "quantile": [{}, {"q": 0.9}],
}
BASIC_LOSSES = ("mae", "sigmoid_mae", "mse", "recon", "bce", "cross_entropy", "label_smooth_cross_entropy", "focal",
                "quantile", "corr", "iou")


@pytest.mark.parametrize("name", BASIC_LOSSES)
def test_basic_loss_matches_jax(name) -> None:
    rs = np.random.RandomState(9)
    if name in ("cross_entropy", "label_smooth_cross_entropy", "focal"):
        predictions, labels = rs.randn(12, 3).astype(np.float32), rs.randint(0, 3, (12, 1))
        if name == "focal":
            predictions = np.abs(predictions) / np.abs(predictions).sum(-1, keepdims=True) + 0.0
    elif name == "iou":
        predictions, labels = rs.randn(4, 5, 5, 1).astype(np.float32), (rs.rand(4, 5, 5, 1) > 0.5).astype(np.float32)
    else:
        predictions, labels = rs.randn(12, 2).astype(np.float32), rs.randn(12, 2).astype(np.float32)
    batch = {INPUT_KEY: rs.randn(*predictions.shape).astype(np.float32), LABEL_KEY: labels}
    for config in LOSS_CONFIGS.get(name, [{}]):
        if name == "focal" and config.get("input_logits", True):
            preds = rs.randn(12, 3).astype(np.float32)
        else:
            preds = predictions
        for reduction in ("mean", "none"):
            ref = JILoss.d[name](reduction, **config)({PREDICTIONS_KEY: jnp.asarray(preds)}, {
                k: jnp.asarray(v) for k, v in batch.items()})
            got = TILoss.d[name](reduction, **config)({PREDICTIONS_KEY: torch.from_numpy(preds)}, {
                k: torch.from_numpy(v) for k, v in batch.items()})
            assert set(got) == set(ref) == {"loss"}
            r, g = np.asarray(ref["loss"]), got["loss"].numpy()
            assert g.shape == r.shape and np.abs(g - r).max() <= 1e-6 * max(1.0, np.abs(r).max()), (name, config)


# ---------------------------------------------------------------- the toolkit the Trainer uses


def test_contexts_summary_and_initializer() -> None:
    """The mode contexts switch an `IDLModel` (through `set_mode`) or a
    module and switch it back; `summary` totals the model's parameters and
    sizes, as `summary.txt` holds them; `Initializer` redraws every
    parameter by its method (1-D ones to zeros) from its seed."""
    from cflearn_torch.toolkit.contexts import auto_num_layers, eval_context, mode_context, train_context
    from cflearn_torch.toolkit.init_summary import Initializer, summary

    config = cflearn_torch.DLConfig(model="common", module_name="clf", loss_name="cross_entropy", module_config=dict(
        img_size=16, in_channels=3, num_classes=3, encoder="vit", latent_dim=12,
        encoder_config=dict(patch_size=4, num_layers=1, num_heads=3)))
    model = cflearn_torch.IDLModel.from_config(config, device="cpu")
    model.set_mode(True)
    with eval_context(model):
        assert not model.m.training
    assert model.m.training
    with mode_context(model.m.head, to_train=True):
        assert model.m.head.training
    with train_context(model):
        assert model.m.training
    assert not model.m.training
    text = summary(model, return_only=True)
    total = sum(p.numel() for p in model.parameters())
    assert f"{total:,}" in text.splitlines()[-2] and "encoder" in text
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for method in sorted(Initializer.defined_initialization):
        Initializer({"seed": 3}).initialize(model, method)
        for name, p in model.named_parameters():
            assert p.shape == before[name].shape and torch.isfinite(p).all(), (method, name)
            if p.ndim == 1 or method == "zeros":
                assert not p.any(), (method, name)
    Initializer({"seed": 3}).initialize(model, "orthogonal")
    again = {n: p.detach().clone() for n, p in model.named_parameters()}
    Initializer({"seed": 3}).initialize(model, "orthogonal")
    assert all(torch.equal(p, again[n]) for n, p in model.named_parameters())
    assert [auto_num_layers(s) for s in (8, 32, 64)] == [1, 3, 4]
