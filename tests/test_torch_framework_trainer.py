"""The port's `Trainer` through `fit_array` against the JAX package's, on the
CPU at tiny sizes. Both sides start from one model file the JAX package
saved (`finetune_config={"pretrained_ckpt": ...}`; the port reads it
through the bridge) and see the same batches (numpy seeded before each
fit). Compared: the loss items of every step (a callback logs them at
`log_steps=1`), the parameters after the fit (after the rollback to the
best checkpoint), `scores.json` and the final metrics.

Cases: the ViT "clf" at the default optimizer settings (Adam behind the
warm-up, the plateau), a two-scope `ae_vq` whose discriminator starts at
step 2, `grad_accumulate=2` with a clip, `update_scheduler_per_epoch`,
`freeze` / `freeze_except` by the JAX parameter paths, and a preemption
dump and its resume (the flag set by a callback, no signal sent). Port
only: `steps_per_dispatch=3` against 1 (bit for bit), the options that
raise, `debug_nans`, async checkpoints and their thread.

Tolerances: loss items 1e-5 relative; parameters 1e-5 of each tensor's
largest value (f32 against f32, other summation orders), except where a
case says: Adam divides each gradient by its own running size, so a
parameter whose exact gradient is zero (the keys' bias of the attention's
in_proj: softmax ignores a constant added to every key) moves by up to lr a
step in the direction of its rounding noise, on either side."""

import json
import os
import threading

import numpy as np
import pytest
import torch

import cflearn_torch
import cflearn_tpu as jcf
import cflearn_tpu.models.common  # noqa: F401  (registers "common")
import cflearn_tpu.models.cv.ae  # noqa: F401  (registers "ae_vq")
from _torch_cv_common import fast_build
from cflearn_torch.bridge import jax_param_names, state_dict_from_jax
from cflearn_torch.schema.train_schema import TrainerCallback
from cflearn_torch.trainer import Trainer, TrainerState, read_states
from cflearn_tpu.schema import DLConfig as JDLConfig
from cflearn_tpu.schema.data import DataConfig as JDataConfig
from cflearn_tpu.schema.model import IDLModel as JIDLModel
from cflearn_tpu.schema.train_schema import TrainerCallback as JTrainerCallback
from cflearn_tpu.toolkit.tree import tree_to_npd

CLF = dict(model="common", module_name="clf", loss_name="cross_entropy", module_config=dict(
    img_size=16, in_channels=3, num_classes=3, encoder="vit", latent_dim=12,
    encoder_config=dict(patch_size=4, num_layers=2, num_heads=3)))
AE_VQ = dict(model="ae_vq", module_name="ae_vq", module_config=dict(
    img_size=8, in_channels=3, inner_channels=32, z_channels=4, embedding_channels=4, channel_multipliers=[1, 2],
    num_res_blocks=1, use_perceptual=False, num_code=16, d_loss_start_step=2))
BATCH = 8
LOSS_REL = PARAM_REL = 1e-5
LR = 1e-3  # the default optimizer's peak rate


class _Record:
    """Logs every drained loss window (every step at `log_steps=1`), and
    raises the preemption flag after the step `preempt_after`."""

    def __init__(self, preempt_after: int = 0) -> None:
        self.logs = []
        self.preempt_after = preempt_after
        self.trainer = None

    def before_loop(self, trainer) -> None:
        self.trainer = trainer

    def after_step(self, step_outputs, state) -> None:
        self.logs.append((state.step, dict(step_outputs.loss_items)))
        if self.preempt_after and state.step == self.preempt_after:
            self.trainer._preempted = True


TrainerCallback.register("framework_test_record")(type("Record", (_Record, TrainerCallback), {}))
JTrainerCallback.register("framework_test_record")(type("Record", (_Record, JTrainerCallback), {}))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The model files both sides start from: the JAX models filled from numpy and saved by the JAX package."""
    folder = tmp_path_factory.mktemp("pretrained")
    out = {}
    for name, config in (("clf", CLF), ("ae_vq", AE_VQ)):
        jm = fast_build(lambda config=config: JIDLModel.from_config(JDLConfig(**config)))
        out[name] = str(folder / f"{name}.npz")
        jm.save(out[name])
    return out


def _data(kind: str, n: int = 32, valid: int = 8):
    rs = np.random.RandomState(11)
    if kind == "ae_vq":
        return (rs.rand(n, 8, 8, 3).astype(np.float32) * 2 - 1, None), None
    x = rs.randn(n + valid, 16, 16, 3).astype(np.float32)
    y = rs.randint(0, 3, (n + valid, 1))
    return (x[:n], y[:n]), (x[n:], y[n:])


def _fit(side: str, kind: str, workspace: str, ckpt: str, *, seed: int = 3, data=None, skip_final_evaluation=False,
         **overrides):
    """`fit_array` of one side; returns the pipeline."""
    base = CLF if kind == "clf" else AE_VQ
    kwargs = dict(
        base, workspace=workspace, fixed_steps=4, min_num_sample=0, num_snapshot_per_epoch=2, log_steps=1,
        callback_names=["framework_test_record"], finetune_config={"pretrained_ckpt": ckpt} if ckpt else None,
    )
    if kind == "clf":
        kwargs["metric_names"] = "acc"
    finetune = overrides.pop("finetune", None)
    if finetune:
        kwargs["finetune_config"] = dict(kwargs["finetune_config"] or {}, **finetune)
    kwargs.update(overrides)
    (x, y), valid = data or _data(kind)
    xv, yv = valid if valid is not None else (None, None)
    np.random.seed(seed)
    if side == "jax":
        dc = JDataConfig()
        dc.batch_size = dc.valid_batch_size = BATCH
        return jcf.fit_array(x, y, xv, yv, config=JDLConfig(**kwargs), data_config=dc,
                             skip_final_evaluation=skip_final_evaluation)
    dc = cflearn_torch.DataConfig()
    dc.batch_size = dc.valid_batch_size = BATCH
    return cflearn_torch.fit_array(x, y, xv, yv, config=cflearn_torch.DLConfig(**kwargs), data_config=dc, device="cpu",
                                   skip_final_evaluation=skip_final_evaluation)


def _logs(p):
    return next(c for c in p.trainer.callbacks if hasattr(c, "logs")).logs


def _check_logs(got, ref) -> None:
    assert [s for s, _ in got] == [s for s, _ in ref] and got
    for (step, a), (_, b) in zip(got, ref):
        assert set(a) == set(b), step
        for k, v in b.items():
            assert abs(a[k] - v) <= LOSS_REL * max(1.0, abs(v)), (step, k, a[k], v)


def _check_params(tp, jp, *, noise_rows=None, lr_steps: float = 0.0) -> None:
    """Every tensor of the port's model against the JAX model's state after
    the fit; `noise_rows(name)` selects the rows moved by Adam's normalised
    rounding noise, held within `lr_steps`."""
    ref = state_dict_from_jax(jp.model.state_dict(), tp.model)
    got = tp.model.state_dict()
    assert set(ref) <= set(got)
    for name, r in ref.items():
        g = got[name].double()
        r = r.double()
        scale = max(r.abs().max().item(), 1e-3)
        rows = noise_rows(name) if noise_rows else None
        if rows is not None:
            assert (g[rows] - r[rows]).abs().max().item() <= lr_steps, name
            keep = torch.ones(g.shape[0], dtype=torch.bool)
            keep[rows] = False
            g, r = g[keep], r[keep]
        assert (g - r).abs().max().item() <= PARAM_REL * scale, (name, (g - r).abs().max().item(), scale)


def _key_bias_rows(name: str):
    """The keys' rows of an attention's fused q / k / v bias."""
    if name.endswith("in_proj.bias"):
        width = CLF["module_config"]["latent_dim"] * 4
        return slice(width, 2 * width)
    return None


def _scores(p):
    with open(os.path.join(p.trainer.checkpoint_folder, "scores.json")) as f:
        return json.load(f)


def test_clf_fit_matches_jax(tmp_path, ckpts) -> None:
    """Four steps at the default optimizer settings, a monitor every two
    steps on the validation set ("acc"), top-k checkpoints, the rollback,
    the final evaluation."""
    jp = _fit("jax", "clf", str(tmp_path / "j"), ckpts["clf"])
    tp = _fit("torch", "clf", str(tmp_path / "t"), ckpts["clf"])
    _check_logs(_logs(tp), _logs(jp))
    assert [s for s, _ in _logs(tp)] == [1, 2, 3, 4]
    scores, ref_scores = _scores(tp), _scores(jp)
    assert scores.keys() == ref_scores.keys() and scores
    assert all(abs(scores[k] - v) <= 1e-6 for k, v in ref_scores.items())
    for file in scores:
        assert os.path.isfile(os.path.join(tp.trainer.checkpoint_folder, file))
    assert tp.trainer.final_results.metric_values == jp.trainer.final_results.metric_values
    # Adam's warm-up reaches LR: a zero-gradient row moves at most LR a step (times two sides)
    _check_params(tp, jp, noise_rows=_key_bias_rows, lr_steps=2 * LR * 4)
    # the workspace holds what the JAX package's holds
    names = {"trainer_config.json", "summary.txt", "model.txt", "report.txt", "num_samples.json", "checkpoints",
             "pipeline"}
    assert set(os.listdir(tp.trainer.workspace)) == set(os.listdir(jp.trainer.workspace)) == names
    assert set(os.listdir(os.path.join(tp.trainer.workspace, "pipeline"))) == set(
        os.listdir(os.path.join(jp.trainer.workspace, "pipeline")))


def test_two_scope_fit_matches_jax(tmp_path, ckpts) -> None:
    """`ae_vq`: the autoencoder ("core") and its discriminator, which
    starts at step 2 in both (the `Trainer`'s state counts the step it
    runs); no validation set, so the monitor scores the train losses; no
    snapshot and no final evaluation, so the fit ends with one checkpoint of
    the last state."""
    kw = dict(optimizer_name="sgd", lr=0.05, scheduler_name="none", fixed_steps=2, min_num_sample=10**6)
    jp = _fit("jax", "ae_vq", str(tmp_path / "j"), ckpts["ae_vq"], skip_final_evaluation=True, **kw)
    tp = _fit("torch", "ae_vq", str(tmp_path / "t"), ckpts["ae_vq"], skip_final_evaluation=True, **kw)
    logs, ref = _logs(tp), _logs(jp)
    _check_logs(logs, ref)
    assert not any(k.startswith("discriminator") for k in logs[0][1])
    assert any(k.startswith("discriminator") for k in logs[1][1])
    _check_params(tp, jp)
    assert _scores(tp) == _scores(jp) == {"model_2.npz": 0.0}


SGD = dict(optimizer_name="sgd", lr=0.05, scheduler_name="none")
OPTION_CASES = {
    # the mean of two steps' gradients, clipped, one update every two steps
    "grad_accumulate": dict(SGD, grad_accumulate=2, clip_norm=0.5),
    # the schedule fed the epoch (two steps an epoch here): the rate steps down once, at step 3
    "update_scheduler_per_epoch": dict(
        optimizer_name="sgd", lr=0.05, scheduler_name="step", scheduler_config={"step_size": 1, "gamma": 0.5},
        update_scheduler_per_epoch=True),
    "freeze": dict(SGD, finetune={"freeze": "encoder/encoder/blocks/0|head_token"}),
    "freeze_except": dict(SGD, finetune={"freeze_except": "m/head/"}),
}


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_trainer_options_match_jax(tmp_path, ckpts, case) -> None:
    kw = dict(OPTION_CASES[case])
    data = _data("clf", n=16)
    jp = _fit("jax", "clf", str(tmp_path / "j"), ckpts["clf"], data=data, **kw)
    tp = _fit("torch", "clf", str(tmp_path / "t"), ckpts["clf"], data=data, **kw)
    _check_logs(_logs(tp), _logs(jp))
    _check_params(tp, jp)
    start = state_dict_from_jax(read_states(ckpts["clf"]), tp.model)
    moved = {n for n, p in tp.model.state_dict().items() if not torch.equal(p, start[n])}
    if case.startswith("freeze"):
        frozen = tp.trainer.frozen
        keys = jax_param_names(tp.model)
        pattern = kw["finetune"].get("freeze") or kw["finetune"]["freeze_except"]
        import re

        hit = {n for n, k in keys.items() if re.search(pattern, k)}
        assert frozen == (hit if case == "freeze" else set(keys) - hit) and frozen
        assert not moved & frozen and moved
    if case == "update_scheduler_per_epoch":
        assert tp.trainer.optimizers["all"].lr_at(1) == 0.05 and tp.trainer.optimizers["all"].lr_at(2) == 0.025


def test_jax_param_names_are_the_jax_keys(ckpts) -> None:
    """`bridge.jax_param_names` gives, for every port parameter, the key of
    the JAX model's parameter `tree_to_npd` writes (the regexes' subject)."""
    from flax import nnx

    for name, config in (("clf", CLF), ("ae_vq", AE_VQ)):
        jm = nnx.eval_shape(lambda config=config: JIDLModel.from_config(JDLConfig(**config)))
        tm = cflearn_torch.IDLModel.from_config(cflearn_torch.DLConfig(**config), device="meta")
        keys = jax_param_names(tm)
        assert len(keys) == len(set(keys.values())) == len(list(tm.parameters()))
        assert set(keys.values()) == set(tree_to_npd(nnx.state(jm, nnx.Param))), name


def test_preemption_dump_and_resume_match_jax(tmp_path, ckpts) -> None:
    """A callback raises the flag after step 1: the step in flight (2)
    finishes, the dump holds the model, the optimizers and the counters, and
    a second fit against the same root resumes at step 2 and runs to 4; the
    dump is removed once a fit ends normally. Both packages alike. The
    second fit names no `pretrained_ckpt`: the JAX trainer loads that after
    the dump, over the resumed weights, and the port does the same
    (`test_pretrained_ckpt_wins_over_a_resumed_dump_as_in_jax`)."""
    kw = dict(create_sub_workspace=False, optimizer_name="sgd", lr=0.05, scheduler_name="none",
              optimizer_config={"momentum": 0.9}, callback_configs={"framework_test_record": {"preempt_after": 1}})
    runs = {}
    for side in ("jax", "torch"):
        root = str(tmp_path / side)
        first = _fit(side, "clf", root, ckpts["clf"], **kw)
        assert first.trainer.state.step == 2 and os.path.isfile(os.path.join(root, "preemption", "meta.json"))
        with open(os.path.join(root, "preemption", "meta.json")) as f:
            assert json.load(f) == {"step": 2, "epoch": 1}
        second = _fit(side, "clf", root, None, seed=4, **dict(kw, callback_configs={}))
        assert second.trainer.state.step == 4 and not os.path.exists(os.path.join(root, "preemption"))
        runs[side] = (first, second)
    _check_logs(_logs(runs["torch"][0]), _logs(runs["jax"][0]))
    _check_logs(_logs(runs["torch"][1]), _logs(runs["jax"][1]))
    assert [s for s, _ in _logs(runs["torch"][1])] == [3, 4]
    _check_params(runs["torch"][1], runs["jax"][1])
    # the momentum traces came back from the dump: a fresh optimizer would have taken other steps
    assert runs["torch"][1].trainer.optimizers["all"].count == 4


def test_steps_per_dispatch_equals_one_step_at_a_time(tmp_path, ckpts) -> None:
    """`steps_per_dispatch=3` is accepted and changes nothing: the losses
    logged, the checkpoints and the parameters are bit for bit those of
    k = 1."""
    data = _data("clf", n=64)
    kw = dict(SGD, fixed_steps=10, log_steps=4, num_snapshot_per_epoch=2)
    fused = _fit("torch", "clf", str(tmp_path / "k3"), ckpts["clf"], data=data, steps_per_dispatch=3, **kw)
    single = _fit("torch", "clf", str(tmp_path / "k1"), ckpts["clf"], data=data, **kw)
    assert _logs(fused) == _logs(single) and [s for s, _ in _logs(single)] == [4, 8]
    assert _scores(fused) == _scores(single)
    for name, p in single.model.state_dict().items():
        assert torch.equal(fused.model.state_dict()[name], p), name


def test_options_without_meaning_and_the_ones_that_raise(tmp_path, ckpts) -> None:
    """`donate_buffers`, `transfer_guard` and a one-device mesh change
    nothing; `remat` recomputes the same fit; a mesh of two devices in one
    process raises; `debug_nans` raises at the first non-finite loss; no
    checkpoint thread outlives `fit`."""
    data = _data("clf", n=16)
    before = set(threading.enumerate())
    base = _fit("torch", "clf", str(tmp_path / "a"), ckpts["clf"], data=data, fixed_steps=2, **SGD)
    same = _fit("torch", "clf", str(tmp_path / "b"), ckpts["clf"], data=data, fixed_steps=2, donate_buffers=False,
                transfer_guard="disallow", mesh={"data": 1}, async_checkpointing=False, **SGD)
    assert _logs(base) == _logs(same)
    assert base.trainer._ckpt_executor is None and not _new_pool_threads(before)
    remat = _fit("torch", "clf", str(tmp_path / "r"), ckpts["clf"], data=data, fixed_steps=2, remat=True, **SGD)
    assert _logs(base) == _logs(remat)
    with pytest.raises(ValueError, match="do not divide 1 devices"):
        _fit("torch", "clf", str(tmp_path / "c"), ckpts["clf"], data=data, fixed_steps=1, mesh={"data": 2})
    (x, y), valid = data
    x = x.copy()
    x[:] = np.nan
    with pytest.raises(FloatingPointError, match="step 1"):
        _fit("torch", "clf", str(tmp_path / "d"), ckpts["clf"], data=((x, y), valid), fixed_steps=2, debug_nans=True)
    assert not _new_pool_threads(before)


def _new_pool_threads(before) -> list:
    """Executor threads started since `before` and still alive (the JAX trainer's outlive its fits)."""
    return [t for t in set(threading.enumerate()) - before if t.name.startswith("ThreadPoolExecutor")]


def test_profile_steps_write_a_trace(tmp_path, ckpts) -> None:
    p = _fit("torch", "clf", str(tmp_path / "p"), ckpts["clf"], data=_data("clf", n=16), fixed_steps=3,
             profile_steps=[2], **SGD)
    assert os.listdir(os.path.join(p.trainer.workspace, "traces")) == ["step_2.json"]


def test_pretrained_ckpt_wins_over_a_resumed_dump_as_in_jax(tmp_path, ckpts) -> None:
    """Inside the reference: the JAX trainer loads a preemption dump and then
    `finetune_config["pretrained_ckpt"]` over it (`cflearn_tpu/trainer.py:547-549`
    before `:600-601`), so a resumed fit that names one starts from the
    pretrained weights with the dump's optimizer states and counters. The
    port does the same."""
    kw = dict(create_sub_workspace=False, callback_configs={"framework_test_record": {"preempt_after": 1}}, **SGD)
    root = str(tmp_path / "root")
    data = _data("clf", n=16)
    _fit("torch", "clf", root, ckpts["clf"], data=data, **kw)
    seen = {}
    original = Trainer._build_optimizers

    def spy(self, model):
        seen.update({k: v.clone() for k, v in model.state_dict().items()})
        return original(self, model)

    Trainer._build_optimizers = spy
    try:
        resumed = _fit("torch", "clf", root, ckpts["clf"], data=data, **dict(kw, callback_configs={}))
    finally:
        Trainer._build_optimizers = original
    start = state_dict_from_jax(read_states(ckpts["clf"]), resumed.model)
    assert resumed.trainer.state.step == 4 and all(torch.equal(seen[k], v) for k, v in start.items())


def test_multi_scope_step_counts_the_step_it_runs() -> None:
    """Alone, `MultiScopeStep` hands `should_skip` the number of the step it
    runs, as the JAX `Trainer`'s state does: a discriminator that starts at
    step 2 joins at the second step (it joined at the third before)."""
    from cflearn_torch.optimizers import build_optimizer
    from cflearn_torch.trainer import MultiScopeStep

    model = cflearn_torch.IDLModel.from_config(cflearn_torch.DLConfig(**AE_VQ), device="cpu")
    step = MultiScopeStep(model, {s: build_optimizer("sgd", 1e-3) for s in ("core", "discriminator")})
    x = torch.from_numpy(_data("ae_vq", n=2)[0][0])
    scopes = [{k.split("_")[0] for k in step.step({"input": x})} for _ in range(3)]
    assert scopes == [{"core"}, {"core", "discriminator"}, {"core", "discriminator"}] and step.state.step == 3
