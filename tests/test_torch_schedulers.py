"""The port's schedulers, its optimizers driven by a schedule, and the JAX
`Trainer`'s default optimizer settings, against the JAX package.

Every schedule is a pure function of the update count: the JAX one is an
optax schedule evaluated in f32, the port's a Python float, so they agree to
f32 rounding: 1e-5 relative (the cosine's f32 argument pi * count / steps is
off by an ulp, which the cosine's slope turns into up to 4e-6 of its value). The optimizer runs are f32 on both sides, the
same arrays, five or more steps: 5e-6 relative, 1e-6 absolute, as the fixed-lr
optimizers are held in `tests/test_torch_train_slice.py`."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cflearn_torch
from cflearn_torch import optimizers as TO
from cflearn_torch import schedulers as TS
from cflearn_torch.pipeline import AE_DEFAULT_LR
from cflearn_torch.trainer import build_optimizers, default_optimizer_settings
from cflearn_tpu import schedulers as JS
from cflearn_tpu.optimizers import OptimizerPack as JPack
from cflearn_tpu.optimizers import build_optimizer as j_build_optimizer
from cflearn_tpu.schema import DLConfig
from cflearn_tpu.trainer import Trainer

COUNTS = range(41)

SCHEDULER_CASES = [
    ("linear", dict(start_epoch=2, end_epoch=10, num_step_per_epoch=3)),
    ("linear", dict()),
    ("linear_inverse", dict(decay=0.1, floor_ratio=0.3)),
    ("step", dict(step_size=4, gamma=0.5, floor_ratio=0.1)),
    ("exponential", dict(gamma=0.8, floor_ratio=0.05)),
    ("cosine", dict(decay_steps=20, alpha=0.1)),
    ("cosine_warmup", dict(warmup_steps=5, decay_steps=15, init_ratio=0.1, alpha=0.05)),
    ("cosine_warmup", dict(warmup_steps=0, decay_steps=30)),
    ("linear_warmup", dict(warmup_steps=8, init_ratio=0.2)),
    ("warmup", dict(multiplier=3, warmup_step=10, afterwards="cosine", afterwards_config=dict(decay_steps=10))),
    ("warmup", dict(multiplier=3, warmup_step=10, afterwards="plateau")),
    ("warmup", dict(multiplier=2, warmup_step=7)),
    ("constant", dict()),
    ("plateau", dict()),
]


def _values(schedule, counts=COUNTS):
    return np.array([float(schedule(jnp.asarray(c, jnp.int32))) for c in counts])


@pytest.mark.parametrize("name,config", SCHEDULER_CASES, ids=lambda v: str(v))
def test_schedulers_match_the_jax_package(name, config) -> None:
    ref = _values(JS.build_scheduler(name, 0.3, **config))
    got = np.array([TS.build_scheduler(name, 0.3, **config)(c) for c in COUNTS])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9)
    assert len(set(np.round(got, 8))) > 1 or name in ("constant", "plateau")  # the case moves where it should


def test_scheduler_registry_and_aliases() -> None:
    assert set(TS.scheduler_dict) == set(JS.scheduler_dict)
    assert TS.scheduler_requires_metric == JS.scheduler_requires_metric == {"plateau"}
    assert set(TS.scheduler_ops) == set(JS.scheduler_ops) == {"linear", "cosine"}
    for alias in ("WarmupScheduler", "StepLRWithFloor", "ExponentialLRWithFloor", "LinearInverseScheduler",
                  "ReduceLROnPlateauWithGet", "LinearWarmupOp", "CosineWarmupOp"):
        assert callable(getattr(TS, alias)), alias
    with pytest.raises(ValueError, match="not registered"):
        TS.build_scheduler("noam", 1.0)
    with pytest.raises(ValueError, match="decay_steps"):
        TS.build_scheduler("cosine", 1.0, decay_steps=0)


@pytest.mark.parametrize("mode", ["max", "min"])
def test_plateau_state_sequence_matches(mode) -> None:
    rng = np.random.RandomState(0)
    metrics = np.concatenate([np.linspace(0.0, 1.0, 5), np.full(12, 1.0) + rng.randn(12) * 1e-5, rng.rand(20)])
    if mode == "min":
        metrics = -metrics
    kw = dict(mode=mode, factor=0.5, patience=3, threshold=1e-3, min_scale=0.05)
    js, ts = JS.PlateauState(**kw), TS.PlateauState(**kw)
    seq_j = [js.update(float(m)) for m in metrics]
    seq_t = [ts.update(float(m)) for m in metrics]
    assert seq_t == seq_j
    assert min(seq_t) == 0.05 and len(set(seq_t)) > 2  # it cut, several times, down to the floor


OPT_SCHEDULE_CASES = [
    ("adam", dict(weight_decay=1e-2)),
    ("adamw", dict()),
    ("sgd", dict(momentum=0.9)),
    ("rmsprop", dict(momentum=0.9)),  # the trace accumulates lr-scaled updates
    ("nadam", dict()),
]


@pytest.mark.parametrize("name,config", OPT_SCHEDULE_CASES, ids=lambda v: str(v))
def test_optimizers_follow_a_schedule_as_optax(name, config) -> None:
    """Eight steps at the learning rates of a warm-up into a cosine."""
    sched = dict(multiplier=3, warmup_step=3, afterwards="cosine", afterwards_config=dict(decay_steps=4))
    rng = np.random.RandomState(1)
    shapes = [(4, 3), (5,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    tx = j_build_optimizer(name, JS.build_scheduler("warmup", 1e-2, **sched), **config)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    opt = TO.build_optimizer(name, TS.build_scheduler("warmup", 1e-2, **sched), **config)
    tp = [torch.from_numpy(p.copy()) for p in params]
    lrs = []
    for _ in range(8):
        g = [(rng.randn(*s) * 3).astype(np.float32) for s in shapes]
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step(tp, [torch.from_numpy(x) for x in g])
        lrs.append(opt.last_lr)
    assert opt.count == 8 and lrs[0] == pytest.approx(1e-2) and lrs[3] == pytest.approx(3e-2)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-6, atol=1e-6)


def test_lr_scale_multiplies_the_whole_update() -> None:
    """The JAX trainer multiplies a scope's updates by its plateau scale:
    half the scale, half the step, whatever the optimizer's state."""
    p0 = [torch.ones(3, 2), torch.zeros(4)]
    g = [torch.full((3, 2), 0.5), torch.full((4,), -2.0)]
    moved = []
    for scale in (1.0, 0.5):
        opt = TO.build_optimizer("rmsprop", 1e-2, momentum=0.9)
        opt.lr_scale = scale
        p = [t.clone() for t in p0]
        opt.step(p, g)
        moved.append([a - b for a, b in zip(p, p0)])
    for full, half in zip(*moved):
        torch.testing.assert_close(half * 2.0, full)


def _jax_trainer(**config):
    """A JAX `Trainer` whose `_build_optimizers` has run for two scopes, as
    `fit` runs it on a model with a `core` and a `discriminator` step."""
    batch_size = config.pop("batch_size")
    num_step_per_epoch = config.pop("num_step_per_epoch")
    trainer = Trainer(DLConfig(workspace="/nonexistent", **config))
    trainer.state = SimpleNamespace(batch_size=batch_size, num_step_per_epoch=num_step_per_epoch)
    trainer._num_step_per_epoch = num_step_per_epoch
    steps = [SimpleNamespace(scope=s, grad_accumulate=None) for s in ("core", "discriminator")]
    trainer._build_optimizers(SimpleNamespace(train_steps=steps))
    return trainer


SETTINGS_CASES = [
    dict(),
    dict(batch_size=2, num_step_per_epoch=3, lr=2e-3),
    dict(batch_size=300000, num_step_per_epoch=5),  # the 3e5 / batch bound wins
    dict(scheduler_name="none", optimizer_name="sgd", optimizer_config=dict(momentum=0.9)),
    dict(scheduler_name="cosine", scheduler_config=dict(decay_steps=12), optimizer_name="adamw"),
    dict(optimizer_settings={
        "core": {"optimizer": "rmsprop", "lr": 5e-4, "scheduler": "none"},
        "discriminator": JPack("discriminator", "nadam", "step", dict(lr=1e-3), dict(step_size=3, gamma=0.5)),
    }),
    dict(
        optimizer_settings={"core": {"optimizer": "adamp", "lr": 5e-4}},
        optimizer_packs=[{"scope": "core", "optimizer_name": "sgd", "scheduler_name": "linear_warmup",
                          "scheduler_config": {"warmup_steps": 4}},
                         JPack("discriminator", "adam", "none")],
    ),
]


def _port_kwargs(config: dict) -> dict:
    """The same config for the port: its `OptimizerPack` in place of the JAX one."""
    out = dict(config)

    def port_pack(p):
        return TO.OptimizerPack(*p) if isinstance(p, JPack) else p

    if "optimizer_settings" in out:
        out["optimizer_settings"] = {k: port_pack(v) for k, v in out["optimizer_settings"].items()}
    if "optimizer_packs" in out:
        out["optimizer_packs"] = [port_pack(p) for p in out["optimizer_packs"]]
    return out


@pytest.mark.parametrize("config", SETTINGS_CASES, ids=range(len(SETTINGS_CASES)))
def test_default_optimizer_settings_match_the_jax_trainer(config) -> None:
    """Dict settings, then list packs (a pack wins for its scope), "none",
    and the default warm-up: the settings, each scope's optimizer and the
    learning rate of each of its first 21 steps, against the JAX trainer's
    `_default_optimizer_settings` and `schedules[scope](count)`."""
    config = dict(dict(batch_size=8, num_step_per_epoch=1), **config)
    trainer = _jax_trainer(**dict(config))
    settings = default_optimizer_settings(**_port_kwargs(config))
    assert settings == trainer._default_optimizer_settings()
    optimizers, lr_scales = build_optimizers(["core", "discriminator"], settings)
    assert set(lr_scales) == set(trainer.lr_scales)
    for scope, opt in optimizers.items():
        want = settings.get(scope, settings["all"])["optimizer"]
        assert type(opt) is type(TO.build_optimizer(want, 1.0)), scope
        schedule = trainer.schedules[scope]
        ref = _values(schedule, range(21)) if callable(schedule) else np.full(21, schedule)
        got = np.array([opt.lr_at(c) for c in range(21)])
        np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=scope)


def test_train_autoencoder_follows_the_default_schedule() -> None:
    """`train_autoencoder` with no settings: Adam behind the warm-up that
    starts at `AE_DEFAULT_LR` and climbs to 3x over min(3e5 / 2, 10) = 10
    steps: the second step runs at 1.2x the first (the JAX trainer's own
    schedule, held above), and the plateau scale is 1."""
    config = dict(img_size=16, inner_channels=32, channel_multipliers=[1, 2], num_res_blocks=1, use_perceptual=False)
    model = cflearn_torch.build_ae(config, device="cpu")
    images = np.random.RandomState(0).randn(2, 16, 16, 3).astype(np.float32).clip(-1, 1)
    out = cflearn_torch.train_autoencoder(model, images, num_steps=2, device="cpu")
    assert set(out["optimizers"]) == set(out["lr_scales"]) == {"core", "discriminator"}
    for scope, opt in out["optimizers"].items():
        assert isinstance(opt, TO.Adam) and opt.count == 2
        assert opt.last_lr == pytest.approx(1.2 * AE_DEFAULT_LR, rel=1e-12), scope
        assert opt.lr_at(0) == pytest.approx(AE_DEFAULT_LR) and opt.lr_at(10) == pytest.approx(3 * AE_DEFAULT_LR)
        assert out["lr_scales"][scope].scale == 1.0 and opt.lr_scale == 1.0
    # per scope: another optimizer without the scheduler, at the default's starting lr (as in the JAX trainer)
    fixed = cflearn_torch.train_autoencoder(
        model, images, device="cpu", optimizer_settings={"discriminator": {"optimizer": "sgd", "scheduler": "none"}},
    )
    sgd = fixed["optimizers"]["discriminator"]
    assert isinstance(sgd, TO.SGD) and sgd.last_lr == AE_DEFAULT_LR and not callable(sgd.lr)
    assert isinstance(fixed["optimizers"]["core"], TO.Adam) and set(fixed["lr_scales"]) == {"core"}
