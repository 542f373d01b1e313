"""The autoencoder-training slice of the port against the JAX package, on the
CPU at a tiny size (32px, 32 channels, multipliers [1, 2], one res block).

Inputs, parameters and the posterior noise come from numpy or from the JAX
side and go through both; the JAX model draws its posterior noise from its
own key stream, so the tests draw the same keys and hand the port the noise.
f32 tolerances cover another summation order only; the bf16 ones are stated
where they are used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

from _torch_bridge_common import bridged, flat_params, rel_err
from cflearn_torch.bridge import load_nnx_batch_stats, load_nnx_params, tree_from_nnx
from cflearn_torch.models.cv.ae import AEModel
from cflearn_torch.models.cv.gan import gan_loss as t_gan_loss
from cflearn_torch.modules.cv.ae import AutoEncoderKL as TAutoEncoderKL
from cflearn_torch.modules.cv.common import GaussianDistribution as TGaussian
from cflearn_torch.modules.cv.gan import LEAKY_SLOPE
from cflearn_torch.modules.cv.gan import NLayerDiscriminator as TDiscriminator
from cflearn_torch.modules.layers import BatchNorm as TBatchNorm
from cflearn_torch.optimizers import build_optimizer
from cflearn_torch.pipeline import AE_DEFAULT_LR
from cflearn_torch.trainer import MultiScopeStep
from cflearn_tpu.models.cv.gan import gan_loss as j_gan_loss
from cflearn_tpu.modules.cv.ae import AutoEncoderKL as JAutoEncoderKL
from cflearn_tpu.modules.cv.common import GaussianDistribution as JGaussian
from cflearn_tpu.modules.cv.gan import NLayerDiscriminator as JDiscriminator

SIZE, BATCH = 32, 2
AE_CONFIG = dict(
    img_size=SIZE, in_channels=3, inner_channels=32, z_channels=4, embedding_channels=4,
    channel_multipliers=[1, 2], num_res_blocks=1,
)
MODEL_CONFIG = dict(AE_CONFIG, use_perceptual=False, d_loss_start_step=0)
LATENT = (BATCH, SIZE // 2, SIZE // 2, 4)
LOSS_NAMES = {"core_loss", "core_l1", "core_kl", "core_g", "discriminator_loss", "discriminator_d"}


def _flat(module: nnx.Module, kind) -> dict:
    return {
        ".".join(map(str, path)): np.asarray(var[...])
        for path, var in nnx.to_flat_state(nnx.state(module, kind))
    }


# ---------------------------------------------------------------- modules


def test_gaussian_distribution_matches_jax() -> None:
    rng = np.random.RandomState(0)
    params = (rng.randn(2, 4, 4, 8) * 3.0).astype(np.float32)
    params[0, 0, 0, 4:] = [-50.0, 50.0, -30.0, 20.0]  # beyond the log-variance clip
    other = (rng.randn(2, 4, 4, 8)).astype(np.float32)
    sample = rng.randn(2, 4, 4, 4).astype(np.float32)
    jd, jo = JGaussian(jnp.asarray(params)), JGaussian(jnp.asarray(other))
    td, to = TGaussian(torch.from_numpy(params)), TGaussian(torch.from_numpy(other))
    assert float(td.logvar.min()) == -30.0 and float(td.logvar.max()) == 20.0
    assert rel_err(td.kl().numpy(), jd.kl()) < 1e-6
    assert rel_err(td.kl(to).numpy(), jd.kl(jo)) < 1e-6
    assert rel_err(td.nll(torch.from_numpy(sample)).numpy(), jd.nll(jnp.asarray(sample))) < 1e-6
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, jd.mean.shape, jd.mean.dtype))
    assert rel_err(td.sample(noise=torch.from_numpy(noise)).numpy(), jd.sample(key)) < 1e-6
    np.testing.assert_array_equal(td.mode().numpy(), np.asarray(jd.mode()))
    # a generator draws noise of the mean's shape and dtype; deterministic returns the mean
    gen = torch.Generator().manual_seed(0)
    drawn = td.sample(gen)
    assert drawn.shape == td.mean.shape and not torch.equal(drawn, td.mean)
    fixed = TGaussian(torch.from_numpy(params), deterministic=True)
    assert torch.equal(fixed.sample(gen), fixed.mean) and float(fixed.kl()) == 0.0


@pytest.fixture(scope="module")
def ae_pair():
    jm = JAutoEncoderKL(**AE_CONFIG, rngs=nnx.Rngs(0))
    tm = bridged(jm, TAutoEncoderKL(**AE_CONFIG))
    return jm, tm


def test_autoencoder_encode_matches_jax(ae_pair) -> None:
    jm, tm = ae_pair
    x = np.random.RandomState(1).randn(BATCH, SIZE, SIZE, 3).astype(np.float32).clip(-1, 1)
    jd = jm.encode(jnp.asarray(x))
    with torch.no_grad():
        td = tm.encode(torch.from_numpy(x))
    assert tuple(td.mean.shape) == LATENT
    assert rel_err(td.mean.numpy(), jd.mean) < 1e-5
    assert rel_err(td.logvar.numpy(), jd.logvar) < 1e-5


@pytest.mark.parametrize("sample", [True, False])
def test_autoencoder_forward_matches_jax(ae_pair, sample) -> None:
    jm, tm = ae_pair
    x = np.random.RandomState(2).randn(BATCH, SIZE, SIZE, 3).astype(np.float32).clip(-1, 1)
    # the key the JAX module will draw next, taken from a copy of its stream
    key = nnx.clone(jm.rngs).default()
    noise = np.array(jax.random.normal(key, LATENT, jnp.float32))
    ref = jm(jnp.asarray(x), sample=sample)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), sample=sample, noise=torch.from_numpy(noise))
    assert set(got) == {"predictions", "distribution", "z"}
    assert rel_err(got["z"].numpy(), ref["z"]) < 1e-5
    assert rel_err(got["predictions"].numpy(), ref["predictions"]) < 1e-5
    assert rel_err(got["distribution"].kl().numpy(), ref["distribution"].kl()) < 1e-5


@pytest.mark.parametrize("training", [True, False])
def test_discriminator_matches_jax(training) -> None:
    jd = JDiscriminator(in_channels=3, num_layers=3, start_channels=16, rngs=nnx.Rngs(1))
    td = TDiscriminator(in_channels=3, num_layers=3, start_channels=16)
    load_nnx_params(td, flat_params(jd))
    # running statistics away from their initial (0, 1), so that eval mode reads them
    rng = np.random.RandomState(3)
    for path, var in nnx.to_flat_state(nnx.state(jd, nnx.BatchStat)):
        shape = var[...].shape
        var[...] = jnp.asarray(rng.rand(*shape) + 0.5 if path[-1] == "var" else rng.randn(*shape) * 0.1, jnp.float32)
    load_nnx_batch_stats(td, _flat(jd, nnx.BatchStat))
    x = rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    (jd.train if training else jd.eval)()
    td.train(training)
    ref = jd(jnp.asarray(x))
    with torch.no_grad():
        got = td(torch.from_numpy(x))
    assert got.shape == ref.shape == (BATCH, 6, 6, 1)
    assert rel_err(got.numpy(), ref) < 1e-5
    stats = _flat(jd, nnx.BatchStat)
    buffers = dict(td.named_buffers())
    assert set(stats) == set(buffers) and len(stats) == 4
    for name, value in stats.items():
        assert rel_err(buffers[name].numpy(), value) < 1e-6, name


def test_batch_norm_is_flax_not_torch_default() -> None:
    """Where the reference and PyTorch differ by default: flax moves the
    running statistics by 0.99 towards the old value and averages the biased
    variance; `torch.nn.BatchNorm2d` moves by 0.1 towards the new value and
    averages the unbiased one. The port's layer follows flax; PyTorch's, given
    flax's momentum and eps, still misses the running variance by n / (n - 1)."""
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 3, 3, 5) * 2.0 + 1.0).astype(np.float32)
    jb = nnx.BatchNorm(5, rngs=nnx.Rngs(0))
    jb.train()
    ref = jb(jnp.asarray(x))
    tb = TBatchNorm(5).train()
    got = tb(torch.from_numpy(x))
    assert rel_err(got.detach().numpy(), ref) < 1e-6
    assert rel_err(tb.mean.numpy(), jb.mean[...]) < 1e-6 and rel_err(tb.var.numpy(), jb.var[...]) < 1e-6
    n = x.size // 5
    assert rel_err(tb.var.numpy(), 0.99 + 0.01 * x.reshape(-1, 5).var(axis=0)) < 1e-5
    theirs = torch.nn.BatchNorm2d(5, eps=1e-5, momentum=0.01).train()
    theirs(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert rel_err(theirs.running_mean.numpy(), jb.mean[...]) < 1e-5  # the mean agrees
    assert rel_err(theirs.running_var.numpy(), jb.var[...]) > 1e-4  # the unbiased variance does not
    assert rel_err(theirs.running_var.numpy(), 0.99 + 0.01 * x.reshape(-1, 5).var(axis=0) * n / (n - 1)) < 1e-5
    # eval mode reads the running statistics
    jb.eval()
    tb.eval()
    assert rel_err(tb(torch.from_numpy(x)).detach().numpy(), jb(jnp.asarray(x))) < 1e-6
    # flax promotes with the f32 statistics: a bf16 input leaves as f32
    assert tb(torch.from_numpy(x).bfloat16()).dtype == torch.float32


def test_leaky_relu_slope_is_the_reference_one() -> None:
    x = np.linspace(-3, 3, 13).astype(np.float32)
    ref = np.asarray(jax.nn.leaky_relu(jnp.asarray(x), 0.2))
    np.testing.assert_allclose(F.leaky_relu(torch.from_numpy(x), LEAKY_SLOPE).numpy(), ref, rtol=1e-7)
    assert np.abs(F.leaky_relu(torch.from_numpy(x)).numpy() - ref).max() > 0.5  # PyTorch's default 0.01
    # and the discriminator uses it: a negative pre-activation keeps 0.2 of itself
    td = TDiscriminator(in_channels=1, num_layers=1, start_channels=1)
    with torch.no_grad():
        for p in td.parameters():
            p.zero_()
        td.blocks[0].bias.fill_(-1.0)
    assert torch.allclose(td.features(torch.zeros(1, 4, 4, 1)), torch.tensor(-0.2))


@pytest.mark.parametrize("target_real", [True, False])
@pytest.mark.parametrize("mode", ["hinge", "lsgan", "wgangp", "vanilla"])
def test_gan_loss_matches_jax(mode, target_real) -> None:
    logits = (np.random.RandomState(5).randn(2, 6, 6, 1) * 2.0).astype(np.float32)
    ref = j_gan_loss(jnp.asarray(logits), target_real, mode=mode)
    got = t_gan_loss(torch.from_numpy(logits), target_real, mode=mode)
    assert abs(float(got) - float(ref)) <= 1e-6 * max(1.0, abs(float(ref)))
    pair = [torch.from_numpy(logits), torch.from_numpy(logits[:, :3])]
    ref2 = j_gan_loss([jnp.asarray(logits), jnp.asarray(logits[:, :3])], target_real, mode=mode)
    assert abs(float(t_gan_loss(pair, target_real, mode=mode)) - float(ref2)) <= 1e-6 * max(1.0, abs(float(ref2)))


def test_ae_model_options() -> None:
    model = AEModel(dict(MODEL_CONFIG))
    assert [ts.scope for ts in model.train_steps] == ["core", "discriminator"]
    core = {n for n, _ in model.params_filter("core")}
    disc = {n for n, _ in model.params_filter("discriminator")}
    assert core and disc and not core & disc
    assert core | disc == {n for n, _ in model.named_parameters()}
    assert all(n.startswith("discriminator.") for n in disc) and all(n.startswith("m.") for n in core)
    # the PatchGAN depth cap by image size: 8px leaves one layer, 32px and up three
    assert len(AEModel(dict(MODEL_CONFIG, img_size=8)).discriminator.blocks) == 1
    assert len(model.discriminator.blocks) == 3
    with_var = AEModel(dict(MODEL_CONFIG, log_var_init=0.5, use_discriminator=False))
    assert with_var.discriminator is None and [ts.scope for ts in with_var.train_steps] == ["core"]
    assert "log_var" in {n for n, _ in with_var.params_filter("core")} and float(with_var.log_var.detach()) == 0.5
    with pytest.raises(NotImplementedError, match="LPIPS"):
        AEModel(dict(AE_CONFIG))
    step = AEModel(dict(MODEL_CONFIG, use_adaptive_weight=True)).train_steps[0]
    with pytest.raises(NotImplementedError, match="adaptive"):
        step._adaptive_weight(model, torch.zeros(1))
    # the discriminator waits for its start step; the generator term waits with it
    late = AEModel(dict(MODEL_CONFIG, d_loss_start_step=2))
    x = torch.from_numpy(np.random.RandomState(6).randn(1, SIZE, SIZE, 3).astype(np.float32))
    ms = MultiScopeStep(late, {s: build_optimizer("sgd", 1e-3) for s in ("core", "discriminator")})
    assert set(ms.step({"input": x})) == {"core_loss", "core_l1", "core_kl"}
    ms.step({"input": x})
    assert set(ms.step({"input": x})) == LOSS_NAMES


# ---------------------------------------------------------------- the two-scope step


def _jax_step(tmp_path, precision: str, optimizer: dict):
    """One step of the JAX `Trainer`'s own compiled step function with both
    scopes active, from a freshly built model: the state before, the batch,
    the two posterior noises it draws, and what it returns."""
    from cflearn_tpu.data import ArrayData
    from cflearn_tpu.monitors import LazyMonitor
    from cflearn_tpu.schema import DLConfig
    from cflearn_tpu.schema.data import DataConfig
    from cflearn_tpu.schema.model import IDLModel
    from cflearn_tpu.trainer import Trainer

    images = np.random.default_rng(0).normal(size=(4 * BATCH, SIZE, SIZE, 3)).astype(np.float32).clip(-1, 1)
    config = DLConfig(
        model="ae_kl", module_name="ae_kl", module_config=dict(MODEL_CONFIG), workspace=str(tmp_path),
        mixed_precision=precision, fixed_steps=1, callback_names=[], donate_buffers=False, **optimizer,
    )
    dc = DataConfig()
    dc.batch_size = BATCH
    trainer = Trainer(config, monitors=[LazyMonitor()])
    trainer.fit(ArrayData.init(dc).fit(images), IDLModel.from_config(config), skip_final_evaluation=True)
    fn = trainer.get_step_fn((True, True))
    # `fit` has taken a step of its own: start again from a new model's state
    fresh = IDLModel.from_config(config)
    fresh.set_mode(True)
    graphdef = trainer._graphdef_train
    _, state0 = nnx.split(fresh)
    opt_states = {}
    for scope, tx in trainer.txs.items():
        merged = nnx.merge(graphdef, state0)
        _, diff, _ = nnx.split(merged, merged.params_filter(scope), ...)
        opt_states[scope] = tx.init(diff)
    # the keys the two scopes' forwards will draw, in order: an `nnx.Rngs` stream
    # hands out fold_in(key, count) and counts up. Read, not drawn: a merged
    # model shares its variables with the state it was merged from.
    stream = nnx.merge(graphdef, state0).m.rngs.default
    key, count = stream.key[...], int(stream.count[...])
    noise_dtype = jnp.bfloat16 if precision == "bf16" else jnp.float32
    noises = [
        np.array(jax.random.normal(jax.random.fold_in(key, count + i), LATENT, noise_dtype).astype(jnp.float32))
        for i in range(2)
    ]
    batch = images[:BATCH]
    lr_scales = {s: jnp.asarray(1.0, jnp.float32) for s in trainer.lr_scales}
    state1, _, losses = fn(state0, opt_states, lr_scales, {"input": jnp.asarray(batch)})
    before = nnx.merge(graphdef, state0)
    after = nnx.merge(graphdef, state1)
    return dict(
        batch=batch, noises={"core": noises[0], "discriminator": noises[1]},
        params0=flat_params(before), stats0=_flat(before, nnx.BatchStat),
        params1=flat_params(after), stats1=_flat(after, nnx.BatchStat),
        losses={k: float(v) for k, v in losses.items()},
    )


def _port_step(ref, optimizer: str, lr: float, compute_dtype):
    model = AEModel(dict(MODEL_CONFIG))
    load_nnx_params(model, ref["params0"])
    load_nnx_batch_stats(model, ref["stats0"])
    step = MultiScopeStep(
        model, {s: build_optimizer(optimizer, lr) for s in ("core", "discriminator")}, compute_dtype=compute_dtype
    )
    kwargs = {scope: {"noise": torch.from_numpy(noise)} for scope, noise in ref["noises"].items()}
    losses = step.step({"input": torch.from_numpy(ref["batch"])}, forward_kwargs=kwargs)
    return model, step, {k: float(v) for k, v in losses.items()}


SGD = dict(optimizer_name="sgd", lr=1.0, scheduler_name="none")


def _sgd_grads(ref, model) -> dict:
    """With plain SGD at lr = 1 the step function's update is its gradient:
    g = p_before - p_after, exact up to the f32 rounding of the subtraction
    (about 6e-8 of the parameter)."""
    delta = {k: ref["params0"][k].astype(np.float64) - ref["params1"][k].astype(np.float64) for k in ref["params0"]}
    return tree_from_nnx(delta, model)


def test_two_scope_step_matches_the_jax_trainer_f32(tmp_path) -> None:
    """Every loss item, every gradient leaf of both scopes (1e-4 of the
    leaf's largest gradient, plus 2e-7 for the rounding of the JAX update it
    is read from), every updated parameter and every BatchStat."""
    sgd_f32 = _jax_step(tmp_path, "no", SGD)
    model, step, losses = _port_step(sgd_f32, "sgd", 1.0, None)
    assert set(losses) == set(sgd_f32["losses"]) == LOSS_NAMES
    for name, value in sgd_f32["losses"].items():
        assert abs(losses[name] - value) <= 1e-5 * max(1.0, abs(value)), name
    ref_grads = _sgd_grads(sgd_f32, model)
    got_grads = {**step.steps["core"].grads, **step.steps["discriminator"].grads}
    assert set(got_grads) == set(ref_grads) == {n for n, _ in model.named_parameters()}
    for name, ref in ref_grads.items():
        assert ref.abs().max() > 0, name
        err = (got_grads[name] - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item() + 2e-7, (name, err, ref.abs().max().item())
    for name, ref in tree_from_nnx(sgd_f32["params1"], model).items():
        err = (model.get_parameter(name).detach() - ref).abs().max().item()
        assert err <= 1e-4 * ref_grads[name].abs().max().item() + 2e-7, name
    buffers = dict(model.named_buffers())
    assert set(buffers) == set(sgd_f32["stats1"])
    for name, value in sgd_f32["stats1"].items():
        assert rel_err(buffers[name].numpy(), value) < 1e-5, name
        assert rel_err(sgd_f32["stats0"][name], value) > 1e-4, name  # three forwards moved them


def test_default_optimizer_step_matches_the_jax_trainer(tmp_path) -> None:
    """The JAX trainer's defaults for this config (Adam, lr 1e-3 behind the
    warm-up that starts at a third of it) against `train_autoencoder`'s (Adam
    at `AE_DEFAULT_LR` for both scopes), on the trainer's own noise. Adam's
    first update is lr * g / (|g| + eps): where |g| is below the f32 noise of
    the two frameworks its sign is free, so all but 0.5% of the elements are
    held to 1% of lr (0.12% exceed it here) and the rest to 2 lr."""
    ref = _jax_step(tmp_path, "no", {})
    model, step, losses = _port_step(ref, "adam", AE_DEFAULT_LR, None)
    assert set(step.steps) == {"core", "discriminator"} and set(losses) == LOSS_NAMES
    for name, value in ref["losses"].items():
        assert abs(losses[name] - value) <= 1e-5 * max(1.0, abs(value)), name
    lr = AE_DEFAULT_LR
    loose = total = 0
    before = tree_from_nnx(ref["params0"], model)
    for name, want in tree_from_nnx(ref["params1"], model).items():
        got = model.get_parameter(name).detach()
        assert (want - before[name]).abs().max().item() <= 1.001 * lr, name  # the JAX side stepped by lr
        diff = (got - want).abs()
        assert diff.max().item() <= 2.001 * lr, name
        loose += int((diff > 0.01 * lr).sum())
        total += diff.numel()
    assert loose <= 5e-3 * total, (loose, total)
    for name, value in ref["stats1"].items():
        assert rel_err(dict(model.named_buffers())[name].numpy(), value) < 1e-5, name


def test_two_scope_step_matches_the_jax_trainer_bf16(tmp_path) -> None:
    """bf16 compute over f32 masters, both sides. The two frameworks round to
    bf16 at other places (XLA fuses elementwise chains in f32; eager PyTorch
    rounds after every op), and in this small random model bf16 alone moves
    the gradients by 15-40% of their norm (L1 and hinge have sign gradients).
    So the step is held to what bf16 itself costs: the yardstick is the f32
    step on the same parameters, batch and noise (the port's, which the f32
    test holds to the JAX trainer's), `drift` is the JAX bf16 step's distance
    from it, and the port's bf16 step may lie twice as far from the
    yardstick, and from the JAX bf16 step, as that."""
    ref = _jax_step(tmp_path, "bf16", SGD)
    assert all(v.dtype == np.float32 for v in ref["params1"].values())  # the masters stay f32
    model, step, losses = _port_step(ref, "sgd", 1.0, torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    model32, step32, losses32 = _port_step(ref, "sgd", 1.0, None)
    for name, value in ref["losses"].items():
        drift = abs(value - losses32[name])
        assert abs(losses[name] - value) <= max(2.0 * drift, 2.0**-7 * max(1.0, abs(value))), name

    def global_rel(a, b, names) -> float:
        num = sum((a[n].double() - b[n].double()).square().sum().item() for n in names)
        return (num / sum(b[n].double().square().sum().item() for n in names)) ** 0.5

    jax_grads = _sgd_grads(ref, model)
    for scope in ("core", "discriminator"):
        names = step.steps[scope].names
        got, yard = step.steps[scope].grads, step32.steps[scope].grads
        assert all(g.dtype == torch.float32 for g in got.values())
        drift = global_rel(jax_grads, yard, names)
        assert 0 < drift < 0.6, (scope, drift)
        allowed = min(2.0 * drift, 0.9)  # an all-zero gradient reads 1.0
        assert global_rel(got, yard, names) <= allowed, scope
        assert global_rel(got, jax_grads, names) <= allowed, scope
    buffers, buffers32 = dict(model.named_buffers()), dict(model32.named_buffers())
    for name, value in ref["stats1"].items():
        drift = rel_err(value, buffers32[name].numpy())
        assert rel_err(buffers[name].numpy(), value) <= max(2.0 * drift, 2.0**-7), name
