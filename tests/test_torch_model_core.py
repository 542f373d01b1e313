"""The port's model core against the JAX package's, on the CPU: `Registry` /
`WithRegister`, `DLConfig`, `ILoss` with its reductions, `MultiTaskLoss`,
`MultiStageLoss`, `CommonDLModel` with a registered loss and an auxiliary
objective, `DLEnsembleModel`, and `IDLModel.from_config` for "ddpm" (the
tiny SD v2 v-model of `_torch_sd_v2_common.py`, with an EMA), "ae_kl" and
"ae_vq" (tiny autoencoders, LPIPS off: the JAX model would try to download
its weights). Each port model takes the JAX model's `state_dict()` through
the bridge (`IDLModel.load_state_dict`), then `run` and every train step's
`loss_fn` are held to JAX with the JAX side's draws; f32, tolerances stated
at each test. A small module and two losses are registered on both sides
for the purpose ("port_test_*")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from flax import nnx

import cflearn_torch
import cflearn_tpu.models.common  # noqa: F401  (registers "common", "ensemble")
import cflearn_tpu.models.cv.ae  # noqa: F401  (registers "ae_kl", "ae_vq")
import cflearn_tpu.models.cv.diffusion  # noqa: F401  (registers "ddpm")
from _torch_bridge_common import dezero, rel_err
from _torch_sd_v2_common import CLIP, FIRST_STAGE, SD_SCHEDULE, T, UNET
from cflearn_torch.bridge import state_dict_from_jax
from cflearn_torch.losses.common import MultiStageLoss, MultiTaskLoss
from cflearn_torch.models.common import DLEnsembleModel
from cflearn_torch.modules.common import init_parameters
from cflearn_torch.modules.common import register_module as t_register_module
from cflearn_torch.modules.layers import Linear
from cflearn_torch.schema import config as TC
from cflearn_torch.schema import losses_schema as TLS
from cflearn_torch.schema import model as TM
from cflearn_torch.toolkit import registry as TR
from cflearn_tpu.losses import common as JLC
from cflearn_tpu.models.common import DLEnsembleModel as JEnsemble
from cflearn_tpu.modules.common import register_module as j_register_module
from cflearn_tpu.schema import config as JC
from cflearn_tpu.schema import losses_schema as JLS
from cflearn_tpu.schema import model as JM
from cflearn_tpu.toolkit import registry as JR

B = 2


# the losses and the module registered on both sides


@JLS.register_loss("port_test_se", allow_duplicate=True)
class JSquaredError(JLS.ILoss):
    def forward(self, pred, label):
        return jnp.mean(jnp.square(pred - label).reshape(pred.shape[0], -1), axis=1)


@TLS.register_loss("port_test_se", allow_duplicate=True)
class TSquaredError(TLS.ILoss):
    def forward(self, pred, label):
        return (pred - label).square().reshape(pred.shape[0], -1).mean(dim=1)


@JLS.register_loss("port_test_ae", allow_duplicate=True)
class JAbsError(JLS.ILoss):
    def forward(self, pred, label):
        return {"loss": jnp.abs(pred - label).reshape(pred.shape[0], -1).sum(axis=1), "max": jnp.max(pred)}


@TLS.register_loss("port_test_ae", allow_duplicate=True)
class TAbsError(TLS.ILoss):
    def forward(self, pred, label):
        return {"loss": (pred - label).abs().reshape(pred.shape[0], -1).sum(dim=1), "max": pred.max()}


@j_register_module("port_test_aux_mlp", allow_duplicate=True)
class JAuxMLP(nnx.Module):
    """A linear layer that records 0.1 x the mean square of its outputs, per
    output channel, as an auxiliary objective."""

    def __init__(self, *, in_dim: int = 4, out_dim: int = 3, rngs: nnx.Rngs) -> None:
        self.fc = nnx.Linear(in_dim, out_dim, rngs=rngs)

    def __call__(self, x):
        y = self.fc(x)
        self.aux = JM.AuxLossVariable(0.1 * jnp.mean(jnp.square(y), axis=0))
        return y


@t_register_module("port_test_aux_mlp", allow_duplicate=True)
class TAuxMLP(nn.Module):
    def __init__(self, *, in_dim: int = 4, out_dim: int = 3) -> None:
        super().__init__()
        self.fc = Linear(in_dim, out_dim)

    def forward(self, x):
        y = self.fc(x)
        self.aux = TM.AuxLossVariable(0.1 * y.square().mean(dim=0))
        return y


def _pair_from_config(config_kw, *, dezero_seed=None):
    """The JAX `IDLModel.from_config` model and the port's from the same
    config, the JAX `state_dict()` loaded into the port's through the bridge."""
    jm = JM.IDLModel.from_config(JC.DLConfig(**config_kw))
    if dezero_seed is not None:
        dezero(jm.m, seed=dezero_seed)
    tm = TM.IDLModel.from_config(TC.DLConfig(**config_kw), device="cpu")
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def _close(got, ref, tol):
    assert rel_err(np.asarray(got.detach() if torch.is_tensor(got) else got), np.asarray(ref)) < tol


def _losses_close(got, ref, tol=1e-5):
    assert set(got) == set(ref)
    for key, value in ref.items():
        assert abs(got[key].item() - float(value)) <= tol * max(abs(float(value)), 1e-6), key


# registries and configs


@pytest.mark.parametrize("side", ["port", "jax"])
def test_registry_semantics(side):
    """Both packages' registries behave alike: a second class under a name
    raises unless `allow_duplicate`; the same class again is fine; `make`
    merges its config with keyword arguments; `make_multiple` takes one
    name or a list."""
    R = TR if side == "port" else JR
    reg = R.Registry("things")

    class A:
        def __init__(self, x=1):
            self.x = x

    class Other:
        pass

    reg.register("a")(A)
    reg.register("a")(A)
    with pytest.raises(ValueError, match="already registered"):
        reg.register("a")(Other)
    reg.register("a", allow_duplicate=True)(Other)
    assert reg.get("a") is Other and "a" in reg and reg.keys() == ["a"] and Other.__identifier__ == "a"
    with pytest.raises(ValueError, match="not registered"):
        reg.build("b")

    class Base(R.WithRegister):
        d = {}

    Base.register("a")(A)
    with pytest.raises(ValueError, match="already registered"):
        Base.register("a")(Other)
    Base.register("b")(A)
    assert Base.has("a") and Base.make("a", {"x": 2}, x=3).x == 3 and Base.make("b", {"x": 2}).x == 2
    assert [m.x for m in Base.make_multiple(["a", "b"], {"b": {"x": 5}})] == [1, 5]
    assert [m.x for m in Base.make_multiple("b")] == [1]
    assert Base.remove("b") is A and not Base.has("b")
    with pytest.raises(ValueError, match="not registered"):
        Base.get("b")


def test_dl_config():
    """The port's `DLConfig` has the JAX package's fields and defaults, the
    same `sanity_check`, `to_debug`, `compute_dtype`, and takes the JAX
    config's `to_info()`."""
    assert TC.DLConfig().to_info() == JC.DLConfig().to_info()
    assert TC.Config().to_info() == JC.Config().to_info()
    for side in (TC, JC):
        with pytest.raises(ValueError, match="module_name"):
            side.DLConfig().sanity_check()
        with pytest.raises(ValueError, match="fixed_steps"):
            side.DLConfig(module_name="m", fixed_steps=0).sanity_check()
        side.DLConfig(module_name="m").sanity_check()
    jc = JC.DLConfig(module_name="sd", module_config={"version": "v2_v"}, mixed_precision="bf16", seed=3)
    tc = TC.DLConfig()
    tc.from_info(dict(jc.to_info(), unknown_field=1))
    assert tc.to_info() == jc.to_info() and tc.model_name == "common" and tc.compute_dtype == "bfloat16"
    assert tc.copy().to_info() == tc.to_info() and tc.to_debug().is_debug and tc.valid_portion == 1e-4


# losses


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_loss_reductions(reduction):
    """A registered per-sample loss under each reduction, and a dict loss
    (its scalar items kept as they are): 1e-6."""
    rng = np.random.RandomState(0)
    pred, label = rng.randn(3, 5).astype(np.float32), rng.randn(3, 5).astype(np.float32)
    for name in ("port_test_se", "port_test_ae"):
        ref = JLS.build_loss(name, {"reduction": reduction}).run({"predictions": pred}, {"labels": label})
        got = TLS.build_loss(name, reduction=reduction)({"predictions": torch.from_numpy(pred)},
                                                       {"labels": torch.from_numpy(label)})
        assert set(got) == set(ref)
        for key in ref:
            assert got[key].shape == ref[key].shape
            _close(got[key], ref[key], 1e-6)
    with pytest.raises(ValueError, match="reduction"):
        TLS.build_loss("port_test_se", reduction="max").run({"predictions": torch.ones(2, 2)}, {"labels": torch.ones(2, 2)})
    with pytest.raises(ValueError, match="not registered"):
        TLS.build_loss("no_such_loss")


def test_multi_task_and_multi_stage_losses():
    """`MultiTaskLoss` (weights 1 and 0.5) and `MultiStageLoss` over three
    stages' predictions: every item 1e-6."""
    rng = np.random.RandomState(1)
    label = rng.randn(2, 6).astype(np.float32)
    preds = [rng.randn(2, 6).astype(np.float32) for _ in range(3)]
    config = {"loss_names": ["port_test_se", "port_test_ae"], "loss_weights": {"port_test_ae": 0.5}}
    jt, tt = JLS.build_loss("multi_task", config), TLS.build_loss("multi_task", config)
    assert isinstance(tt, MultiTaskLoss) and isinstance(jt, JLC.MultiTaskLoss)
    ref = jt.run({"predictions": preds[0]}, {"labels": label})
    got = tt.run({"predictions": torch.from_numpy(preds[0])}, {"labels": torch.from_numpy(label)})
    _losses_close(got, ref, 1e-6)
    js, ts = JLS.build_loss("multi_stage", config), TLS.build_loss("multi_stage", config)
    assert isinstance(ts, MultiStageLoss)
    ref = js.run({"predictions": preds}, {"labels": label})
    got = ts.run({"predictions": [torch.from_numpy(p) for p in preds]}, {"labels": torch.from_numpy(label)})
    assert set(got) == {"loss"} | {f"{i}_{n}" for i in range(3) for n in config["loss_names"]}
    _losses_close(got, ref, 1e-6)


# common and ensemble models


def test_common_model_with_aux_loss():
    """`CommonDLModel`: a registered module and loss from one config, the
    JAX parameters through `load_state_dict`; `run(training=True)` sums the
    recorded auxiliary objectives under `AUX_LOSS_KEY`, which the train
    step adds to the loss: predictions, the aux sum and the loss items 1e-6;
    `run` in eval mode records none into its results."""
    config = dict(model="common", module_name="port_test_aux_mlp", module_config={"in_dim": 4, "out_dim": 3},
                  loss_name="port_test_se", seed=1)
    jm, tm = _pair_from_config(config)
    assert isinstance(tm, cflearn_torch.CommonDLModel) and tm.num_params == jm.num_params == 15
    rng = np.random.RandomState(2)
    x, y = rng.randn(5, 4).astype(np.float32), rng.randn(5, 3).astype(np.float32)
    jb, tb = {"input": jnp.asarray(x), "labels": jnp.asarray(y)}, {"input": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    ref = jm.run(jb, training=True)
    got = tm.run(tb, training=True)
    assert set(got) == set(ref) == {"predictions", "aux_loss"}
    _close(got["predictions"], ref["predictions"], 1e-6)
    _close(got["aux_loss"], ref["aux_loss"], 1e-6)
    ref_l = jm.train_steps[0].loss_fn(jm, jb, ref)
    got_l = tm.train_steps[0].loss_fn(tm, tb, got)
    assert set(got_l) == {"loss", "aux_loss"}
    _losses_close(got_l, ref_l, 1e-6)
    assert "aux_loss" not in tm.run(tb)
    assert [n for n, _ in tm.params_filter("all")] == ["m.fc.weight", "m.fc.bias"]


def test_ensemble_model():
    """`DLEnsembleModel`: three copies from seeds 5, 6, 7, averaged; `reduce`
    on tensors and on dicts of them, against JAX: 1e-6."""
    config = dict(model="ensemble", module_name="port_test_aux_mlp", num_repeat=3, seed=5, loss_name="port_test_se")
    jm, tm = _pair_from_config(config)
    assert isinstance(tm, DLEnsembleModel) and len(tm.m) == 3
    assert not torch.equal(tm.m[0].fc.weight, tm.m[1].fc.weight)
    x = np.random.RandomState(3).randn(4, 4).astype(np.float32)
    _close(tm.run({"input": torch.from_numpy(x)})["predictions"], jm.run({"input": jnp.asarray(x)})["predictions"], 1e-6)
    outs = [np.random.RandomState(i).randn(2, 3).astype(np.float32) for i in range(3)]
    ref = jm.reduce([jnp.asarray(o) for o in outs])
    _close(tm.reduce([torch.from_numpy(o) for o in outs]), ref, 1e-6)
    ref = JEnsemble.reduce(jm, [{"a": jnp.asarray(o), "b": jnp.asarray(2 * o)} for o in outs])
    got = tm.reduce([{"a": torch.from_numpy(o), "b": torch.from_numpy(2 * o)} for o in outs])
    for key in ("a", "b"):
        _close(got[key], ref[key], 1e-6)


# the training models from their configs


DDPM_CONFIG = dict(
    model="ddpm", module_name="ldm", seed=0, loss_config={"original_elbo_weight": 0.5},
    module_config=dict(img_size=8, in_channels=4, out_channels=4, num_timesteps=T, parameterization="v",
                       unet_config=UNET, first_stage_config=FIRST_STAGE, condition_model="clip_text",
                       condition_config=CLIP, ema_decay=0.9, **SD_SCHEDULE),
)


@pytest.fixture(scope="module")
def ddpm_pair():
    return _pair_from_config(DDPM_CONFIG, dezero_seed=4)


def _ddpm_batch():
    rng = np.random.RandomState(6)
    images = rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32)
    ids = rng.randint(1, 49000, (B, 77))
    return ({"input": jnp.asarray(images), "cond": jnp.asarray(ids, jnp.int32)},
            {"input": torch.from_numpy(images), "cond": torch.from_numpy(ids)})


def test_ddpm_from_config_matches_jax(ddpm_pair):
    """`IDLModel.from_config(DLConfig(model="ddpm", ...))`: the registered
    LDM, an EMA and the loss weights from the config; the JAX state
    through the bridge (parameters, EMA shadows and count). The monitoring
    `run` and the p-loss (v target, VLB at 0.5) with the JAX draws: 1e-5;
    after `post_step_update` every EMA shadow 1e-6 of the JAX one.
    `num_params` counts the EMA's shadows too, as the JAX package does
    (its shadows are `nnx.Param` copies): twice the model's parameters."""
    jm, tm = ddpm_pair
    assert isinstance(tm, cflearn_torch.DDPMModel) and tm.m.parameterization == "v" and tm.ema is not None
    assert tm.num_params == jm.num_params == 2 * sum(p.numel() for p in tm.m.parameters())
    jb, tb = _ddpm_batch()
    rngs = nnx.clone(jm.m.rngs)
    noise = np.array(jax.random.normal(rngs.default(), (B, 8, 8, 4), jnp.float32))
    ref = jm.run(jb)
    got = tm.run(tb, noise=torch.from_numpy(noise))
    _close(got["predictions"], ref["predictions"], 1e-5)
    rngs = nnx.clone(jm.m.rngs)
    t = np.array(jax.random.randint(rngs.default(), (B,), 0, T))
    noise = np.array(jax.random.normal(rngs.default(), (B, 8, 8, 4), jnp.float32))
    (jstep,), (tstep,) = jm.train_steps, tm.train_steps
    assert (tstep.original_elbo_weight, tstep.scope, tstep.uses_forward_results) == (0.5, "all", False)
    ref_l = jstep.loss_fn(jm, jb, {})
    got_l = tstep.loss_fn(tm, tb, {}, t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    assert set(got_l) == {"loss", "simple", "vlb"}
    _losses_close(got_l, ref_l)
    jm.post_step_update()
    tm.post_step_update()
    ema = {k: v for k, v in state_dict_from_jax(jm.state_dict(), tm).items() if k.startswith("ema.")}
    mine = dict(tm.ema.named_buffers(prefix="ema"))
    assert set(ema) == set(mine) and int(mine["ema.num_updates"]) == 1
    for key, value in ema.items():
        _close(mine[key].float(), value.float(), 1e-6)


def test_ddpm_from_config_is_the_wrapped_build():
    """`from_config` draws what `DDPMModel(build(LDM, seed=...))` draws, bit
    for bit; the trained scope leaves out the first stage, the EMA and the
    frozen text tower."""
    mc = dict(DDPM_CONFIG["module_config"])
    mc.pop("ema_decay")
    tm = TM.IDLModel.from_config(TC.DLConfig(model="ddpm", module_name="ldm", module_config=mc, seed=3), device="cpu")
    old = cflearn_torch.DDPMModel(cflearn_torch.build(cflearn_torch.LDM, device="cpu", seed=3, **mc))
    mine, theirs = dict(tm.named_parameters()), dict(old.named_parameters())
    assert list(mine) == list(theirs) and all(torch.equal(mine[k], theirs[k]) for k in mine)
    assert all(n.startswith("m.unet.") for n, _ in tm.params_filter("all"))


def test_save_load_round_trip(ddpm_pair, tmp_path):
    """`save` then `IDLModel.load`: the same parameters and EMA, and the same
    outputs, bit for bit."""
    _, tm = ddpm_pair
    path = str(tmp_path / "ddpm.npz")
    tm.save(path)
    loaded = TM.IDLModel.load(path, device="cpu")
    assert type(loaded) is type(tm) and loaded.config.to_info() == tm.config.to_info()
    mine, theirs = tm.state_dict(), loaded.state_dict()
    assert set(mine) == set(theirs) and all(torch.equal(mine[k], theirs[k]) for k in mine)
    _, tb = _ddpm_batch()
    noise = torch.randn(B, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = tm.run(tb, noise=noise)["predictions"]
        b = loaded.run(tb, noise=noise)["predictions"]
    assert torch.equal(a, b)


AE_CONFIG = dict(img_size=32, in_channels=3, inner_channels=32, z_channels=4, embedding_channels=4,
                 channel_multipliers=[1, 2], num_res_blocks=1, use_perceptual=False)


@pytest.mark.parametrize("name", ["ae_kl", "ae_vq"])
def test_ae_from_config_matches_jax(name):
    """`from_config` of "ae_kl" (with a learned reconstruction log-variance)
    and "ae_vq" (16 codes): the JAX state through the bridge (BatchNorm's
    statistics too); the forward with the JAX posterior draw, the generator
    step's and the discriminator step's losses: 1e-5; with the
    discriminator's step off (`step_actives`) the generator adds no
    adversarial term."""
    mc = dict(AE_CONFIG, log_var_init=0.3) if name == "ae_kl" else dict(AE_CONFIG, num_code=16)
    jm, tm = _pair_from_config(dict(model=name, module_config=mc, seed=2))
    assert type(tm) is (cflearn_torch.AEModel if name == "ae_kl" else cflearn_torch.AEVQModel)
    assert tm.num_params == jm.num_params and [s.scope for s in tm.train_steps] == ["core", "discriminator"]
    x = np.random.RandomState(7).uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    jb, tb = {"input": jnp.asarray(x)}, {"input": torch.from_numpy(x)}
    kw = {}
    if name == "ae_kl":
        key = nnx.clone(jm.m.rngs).default()
        kw["noise"] = torch.from_numpy(np.array(jax.random.normal(key, (B, 16, 16, 4), jnp.float32)))
    ref = jm.run(jb, training=True)
    got = tm.run(tb, training=True, **kw)
    _close(got["predictions"], ref["predictions"], 1e-5)
    for jstep, tstep in zip(jm.train_steps, tm.train_steps):
        assert (tstep.requires_new_forward, tstep.requires_grad_in_forward) == (
            jstep.requires_new_forward, jstep.requires_grad_in_forward)
        _losses_close(tstep.loss_fn(tm, tb, got), jstep.loss_fn(jm, jb, ref))
    jg, tg = jm.train_steps[0], tm.train_steps[0]
    jg.step_actives = tg.step_actives = {"core": True, "discriminator": False}
    got_off = tg.loss_fn(tm, tb, got)
    assert "g" not in got_off
    _losses_close(got_off, jg.loss_fn(jm, jb, ref))


def test_build_ae_is_from_config():
    """`build_ae` is `from_config` of its model: the parameters
    `init_parameters` draws over `AEModel(config)` at the seed, `log_var`
    keeping its initial value, bit for bit."""
    mc = dict(AE_CONFIG, log_var_init=0.3)
    built = cflearn_torch.build_ae(mc, device="cpu", seed=4)
    old = cflearn_torch.AEModel(dict(mc))
    init_parameters(old, 4)
    with torch.no_grad():
        old.log_var.fill_(0.3)
    mine, theirs = dict(built.named_parameters()), dict(old.named_parameters())
    assert list(mine) == list(theirs) and all(torch.equal(mine[k], theirs[k]) for k in mine)
    assert built.config.model == "ae_kl" and built.config.seed == 4
    vq = cflearn_torch.build_ae(dict(AE_CONFIG, num_code=16), model="ae_vq", device="cpu")
    assert type(vq.m).__name__ == "AutoEncoderVQ" and vq.config.module_name == "ae_vq"


def test_from_config_runs_on_the_card_unless_asked(monkeypatch):
    """`from_config` and `build_ae` build on the CUDA card and raise without
    one; "meta" builds the modules and draws nothing."""
    config = TC.DLConfig(model="ddpm", module_name="sd", module_config={"version": "v2_v", "with_first_stage": False})
    meta = TM.IDLModel.from_config(config, device="meta")
    assert meta.m.unet.conv_in.weight.is_meta and meta.m.parameterization == "v"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.IDLModel.from_config(config)
    with pytest.raises(RuntimeError, match="CUDA"):
        cflearn_torch.build_ae(dict(AE_CONFIG))
