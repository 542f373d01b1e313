"""The port's CV models against the JAX package's, on the CPU at tiny sizes:
"gan" (vanilla, lsgan, wgangp with the gradient penalty, class-conditional
with the PatchGAN's class head), "vae" and its conditional form, "vq_vae"
(`get_code` in both index layouts, `reconstruct_from(use_one_hot=True)`,
`sample_codebook`) and "ar" (PixelCNN, with `sample` at 4 x 4), each built
by `IDLModel.from_config` with the JAX model's state through the bridge:
`run`, and one train step of every scope (the loss items, every gradient,
the parameters and BatchNorm statistics after plain SGD). The JAX side's
draws (z, the penalty's eps, labels, the posterior noise, the categorical
samples' Gumbel noise) are computed from its streams and fed to the port
through `IConditional`'s `_randn` / `_uniform` / `_randint` / `_gumbel`.
Also the conditional PatchGAN head (`forward_with_cond`) and the parameter
counts of the five models at the JAX defaults.

f32 throughout; the tolerances are stated at each test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import cflearn_torch
import cflearn_tpu.models.common  # noqa: F401  (registers "common")
import cflearn_tpu.models.cv.gan  # noqa: F401  (registers "gan")
import cflearn_tpu.models.cv.vae  # noqa: F401  (registers "vae", "vq_vae", "ar")
from _torch_bridge_common import rel_err
from _torch_cv_common import F32, both, fast_build, jax_state, jax_train_steps, jcall, jrun, pair, rand, stream_draws
from cflearn_torch.bridge import tree_from_nnx
from cflearn_torch.modules.cv.gan import NLayerDiscriminator as TDiscriminator
from cflearn_torch.optimizers import build_optimizer
from cflearn_torch.trainer import MultiScopeStep
from cflearn_tpu.modules.cv.gan import NLayerDiscriminator as JDiscriminator
from cflearn_tpu.schema import DLConfig as JDLConfig
from cflearn_tpu.schema.model import IDLModel as JIDLModel

B, LR = 4, 0.1
GRAD_REL = 1e-4  # a gradient leaf against JAX's, relative to the scope's largest gradient


def pixel_cnn_mask(path: tuple) -> np.ndarray:
    """The JAX `_MaskedConv` mask of the PixelCNN layer at `path`
    (`m.convs.<i>.mask`): the 7x7 taps above the centre and left of it, and
    the centre itself past the first layer ("B")."""
    mask = np.zeros((7, 7, 1, 1), np.float32)
    mask[:3] = 1.0
    mask[3, :3] = 1.0
    mask[3, 3] = float(int(path[-2]) > 0)
    return mask


def build_pair(config: dict, *, constants=None):
    """The JAX model (filled from numpy; fixed variables by `constants`) and
    the port's `IDLModel.from_config` on the CPU with its state; the same
    parameter count."""
    jm = fast_build(lambda: JIDLModel.from_config(JDLConfig(**config)), constants=constants)
    tm = cflearn_torch.IDLModel.from_config(cflearn_torch.DLConfig(**config), device="cpu")
    assert tm.num_params == jm.num_params
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def feed(values):
    """A stand-in for a draw method: returns the given numpy draws in order."""
    it = iter(values)
    return lambda *args, **kwargs: torch.from_numpy(np.asarray(next(it)))


def check_step(jm, tm, batch: dict) -> None:
    """One step of every scope on both sides (plain SGD at LR): the loss
    items (1e-5), each gradient leaf (GRAD_REL of its scope's largest), the
    parameters after the update and the BatchNorm statistics (1e-5 of each
    tensor's largest value, or of 1e-3 where that is smaller)."""
    ref = jax_train_steps(jm, batch, LR)
    scopes = [ts.scope for ts in tm.train_steps]
    step = MultiScopeStep(tm, {s: build_optimizer("sgd", LR) for s in scopes})
    got = {k: float(v) for k, v in step.step({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}).items()}
    ref_items = {(f"{s}_{k}" if len(scopes) > 1 else k): v for s, (items, _) in ref.items() for k, v in items.items()}
    assert set(got) == set(ref_items)
    for name, value in ref_items.items():
        assert abs(got[name] - value) <= 1e-5 * max(1.0, abs(value)), (name, got[name], value)
    for scope, (_, flat) in ref.items():
        grads = tree_from_nnx(flat, tm, names=step.steps[scope].names)
        scale = max(g.abs().max().item() for g in grads.values())
        assert scale > 0 and set(grads) == set(step.steps[scope].grads)
        for name, g in grads.items():
            err = (step.steps[scope].grads[name] - g).abs().max().item()
            assert err <= GRAD_REL * scale, (scope, name, err, scale)
    after = cflearn_torch.bridge.state_dict_from_jax(jm.state_dict(), tm)
    for name, value in tm.state_dict().items():
        if name.endswith(".weight") and name.rsplit(".", 2)[0] + ".mask" in after:
            continue  # PixelCNN's masked convs: see test_ar_step_and_sample_match_jax
        ref_value = after[name].numpy()
        # relative to the tensor's largest value, or to 1e-3 where that is smaller: a conv bias ahead of a
        # BatchNorm has a zero gradient in exact arithmetic, and after the step holds rounding noise of ~1e-9
        err = np.abs(value.numpy().astype(np.float64) - ref_value).max()
        assert err <= 1e-5 * max(np.abs(ref_value).max(), 1e-3), (name, err)


# ---------------------------------------------------------------- the conditional PatchGAN (repair)


@pytest.mark.parametrize("training", [False, True])
def test_conditional_patchgan_matches_jax(training) -> None:
    """The PatchGAN with `num_classes`: `forward_with_cond` gives the patch
    logits and the class logits (a 4x4 conv on the features, averaged over
    the pixels) from one pass; `forward` the patch logits alone; without
    `num_classes` the class logits are None. F32, BatchNorm statistics after
    a training call 1e-6."""
    kw = dict(in_channels=3, num_layers=3, start_channels=8, num_classes=5)
    jd = fast_build(lambda: JDiscriminator(**kw, rngs=nnx.Rngs(0)))
    td = pair(jd, TDiscriminator(**kw))
    x = rand(1, 2, 32, 32, 3)
    (logits, cond), (ref_logits, ref_cond) = both(jd, td, x, training=training, method="forward_with_cond")
    assert logits.shape == ref_logits.shape == (2, 6, 6, 1) and cond.shape == ref_cond.shape == (2, 5)
    assert rel_err(logits.numpy(), ref_logits) < F32 and rel_err(cond.numpy(), ref_cond) < F32
    plain, ref_plain = both(jd, td, x, training=training)
    assert rel_err(plain.numpy(), ref_plain) < F32
    if training:
        stats = jax_state(jd)
        for name, value in td.state_dict().items():
            if name.endswith(("mean", "var")):
                assert rel_err(value.numpy(), stats[name.replace(".", "/")]) < 1e-6, name
    assert TDiscriminator(in_channels=3, num_layers=2).forward_with_cond(torch.zeros(1, 16, 16, 3))[1] is None


# ---------------------------------------------------------------- GAN


GAN_MODULE = {"img_size": 16, "latent_dim": 16, "latent_resolution": 4,
              "discriminator_config": {"num_layers": 2, "start_channels": 16}}
GAN_CASES = {
    "vanilla": ({}, {}),
    "lsgan": ({}, {"gan_mode": "lsgan"}),
    "wgangp": ({}, {"gan_mode": "wgangp", "lambda_gp": 5.0}),
    "conditional": ({"num_classes": 3}, {}),
}


@pytest.mark.parametrize("case", sorted(GAN_CASES))
def test_gan_step_matches_jax(case) -> None:
    """"gan" by `from_config`: the generator's two z draws (the core step's
    forward and the discriminator step's new one) and wgangp's eps, in the
    JAX model's order; both scopes' losses (with "g_cond" / "d_cond" when
    conditional, "d_gp" with the penalty, whose gradient runs through the
    discriminator in eval mode), gradients and updated state (`check_step`)."""
    module_extra, loss_config = GAN_CASES[case]
    config = dict(model="gan", module_name="gan", module_config=dict(GAN_MODULE, **module_extra), loss_config=loss_config)
    jm, tm = build_pair(config)
    assert tm.loss_mode == jm.loss_mode and tm.lambda_gp == jm.lambda_gp
    assert (tm.discriminator.cond is not None) == (case == "conditional")
    keys = stream_draws(jm, 3)
    tm.m._randn = feed([jax.random.normal(k, (B, 16)) for k in keys[:2]])
    tm.m._uniform = feed([jax.random.uniform(keys[2], ())])
    batch = {"input": np.random.RandomState(2).uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)}
    if case == "conditional":
        batch["labels"] = np.array([[0], [2], [1], [2]], np.int64)
    check_step(jm, tm, batch)
    assert [ts.scope for ts in tm.train_steps] == ["core", "discriminator"]
    assert tm.train_steps[1].requires_new_forward and not tm.train_steps[1].requires_grad_in_forward


# ---------------------------------------------------------------- VAE


@pytest.mark.parametrize("conditional", [False, True])
def test_vae_run_and_step_match_jax(conditional) -> None:
    """"vae" (16 px, latent 8, two downsamples; conditional: 4 classes,
    tanh): `run` in eval mode with the JAX posterior noise (every output,
    F32), one train step (`check_step`), then a conditional decode without
    labels (the labels drawn from the stream, fed) and `sample` with a class
    index (z fed)."""
    module_config = {"img_size": 16, "latent_dim": 8, "num_downsample": 2}
    if conditional:
        module_config.update(num_classes=4, apply_tanh=True, in_channels=1)
    jm, tm = build_pair(dict(model="vae", module_name="vae", module_config=module_config))
    c = 1 if conditional else 3
    x = np.random.RandomState(3).uniform(-1, 1, (B, 16, 16, c)).astype(np.float32)
    batch = {"input": x}
    if conditional:
        batch["labels"] = np.array([[1], [0], [3], [2]], np.int64)
    (key,) = stream_draws(jm, 1)
    tm.m._randn = feed([jax.random.normal(key, (B, 8))])
    ref = jrun(jm, batch)
    with torch.no_grad():
        got = tm.run({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(ref) == {"predictions", "mu", "log_var", "kl", "z"}
    for k in got:
        assert rel_err(got[k].numpy(), ref[k]) < F32, k
    keys = stream_draws(jm, 1)
    tm.m._randn = feed([jax.random.normal(k, (B, 8)) for k in keys])
    check_step(jm, tm, batch)
    if conditional:
        z = rand(4, 3, 8)
        keys = stream_draws(jm, 1)
        tm.m._randint = feed([jax.random.randint(keys[0], (3,), 0, 4)])
        jm.set_mode(False)
        tm.set_mode(False)
        ref = jcall(jm.m, z, method="decode")
        with torch.no_grad():
            got = tm.m.decode(torch.from_numpy(z))
        assert rel_err(got.numpy(), ref) < F32 and float(got.abs().max()) <= 1.0
        keys = stream_draws(jm, 1)
        tm.m._randn = feed([jax.random.normal(keys[0], (3, 8))])
        ref = jcall(jm.m, method="sample", num_samples=3, class_idx=2)
        with torch.no_grad():
            got = tm.m.sample(3, class_idx=2)
        assert rel_err(got.numpy(), ref) < F32


# ---------------------------------------------------------------- VQ-VAE


def test_vq_vae_matches_jax() -> None:
    """"vq_vae" (16 px, 32 codes of 16, two downsamples, 4 classes, tanh):
    one train step (`check_step`: recon, codebook, commit); then, in eval
    mode, the code indices (exact), `get_code` from (B, H, W), (B, H, W, 1)
    and (B, 1, H, W) indices (its own codebook's rows exactly, JAX's at
    F32: the updated codebooks differ by rounding), `reconstruct_from(use_one_hot=True)`
    with labels, and `sample_codebook(num_samples=3, class_idx=2)` with its
    code draw fed (F32)."""
    module_config = {"img_size": 16, "in_channels": 1, "code_dimension": 16, "num_codes": 32, "num_downsample": 2,
                     "num_classes": 4, "apply_tanh": True}
    jm, tm = build_pair(dict(model="vq_vae", module_name="vq_vae", module_config=module_config))
    x = np.random.RandomState(5).uniform(-1, 1, (B, 16, 16, 1)).astype(np.float32)
    check_step(jm, tm, {"input": x, "labels": np.array([[3], [1], [0], [1]], np.int64)})
    jm.set_mode(False)
    tm.set_mode(False)
    idx = jcall(jm.m, x, method="get_code_indices")
    with torch.no_grad():
        t_idx = tm.m.get_code_indices(torch.from_numpy(x))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    ref_code = np.asarray(jcall(jm.m, idx, method="get_code"))
    own = tm.m.codebook.embedding.detach()[t_idx]
    for layout in (t_idx, t_idx[..., None], t_idx[:, None]):
        code = tm.m.get_code(layout).detach()
        assert torch.equal(code, own) and rel_err(code.numpy(), ref_code) < F32  # the codebooks after the step: F32
    with pytest.raises(ValueError, match="singleton"):
        tm.m.get_code(torch.zeros(2, 2, 4, 4, dtype=torch.long))
    labels = np.array([2, 0, 1, 3], np.int32)
    ref = jcall(jm.m, idx, method="reconstruct_from", labels=jnp.asarray(labels), use_one_hot=True)
    with torch.no_grad():
        got = tm.m.reconstruct_from(t_idx, labels=torch.from_numpy(labels), use_one_hot=True)
    assert got.shape == (B, 16, 16, 1) and rel_err(got.numpy(), ref) < F32
    (key,) = stream_draws(jm, 1)
    tm.m._randint = feed([jax.random.randint(key, (3,), 0, 32)])
    ref_img, ref_codes = jcall(jm.m, method="sample_codebook", num_samples=3, class_idx=2)
    with torch.no_grad():
        img, codes = tm.m.sample_codebook(num_samples=3, class_idx=2)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    assert img.shape == (3, 16, 16, 1) and rel_err(img.numpy(), ref_img) < F32


# ---------------------------------------------------------------- PixelCNN


def test_ar_step_and_sample_match_jax() -> None:
    """"ar" (PixelCNN over 8 codes at 4 x 4, 2 masked layers of 16, 4
    classes): one train step (`check_step`), the masked kernels after it
    (weight x mask against JAX's, 1e-5: the JAX module writes the masked
    kernel back on every call and the port re-masks in place; the JAX
    trainer's step keeps the update of the unmasked taps only, which is what
    both hold), then `sample(2, img_size=4)` in eval mode: the key and then
    the labels drawn from the stream, one Gumbel draw a pixel (exact codes)."""
    module_config = {"num_codes": 8, "img_size": 4, "in_channels": 1, "latent_channels": 16, "num_layers": 2,
                     "num_classes": 4}
    jm, tm = build_pair(dict(model="ar", module_name="pixel_cnn", module_config=module_config), constants=pixel_cnn_mask)
    assert all(torch.equal(c.mask, torch.from_numpy(pixel_cnn_mask(("m", "convs", str(i), "mask"))))
               for i, c in enumerate(tm.m.convs))  # the port's own masks are the JAX formula
    codes = np.random.RandomState(6).randint(0, 8, (B, 4, 4, 1)).astype(np.int64)
    check_step(jm, tm, {"input": codes, "labels": np.array([[0], [3], [3], [1]], np.int64)})
    state = jm.state_dict()
    for i in range(2):
        mask = state[f"m/convs/{i}/mask/value"]
        ref_w = np.transpose(state[f"m/convs/{i}/conv/kernel/value"] * mask, (3, 2, 0, 1))
        got_w = tm.m.convs[i].conv.weight.detach() * tm.m.convs[i].mask.permute(3, 2, 0, 1)
        assert rel_err(got_w.numpy(), ref_w) < 1e-5
    jm.set_mode(False)
    tm.set_mode(False)
    key, label_key = stream_draws(jm, 2)
    labels = jax.random.randint(label_key, (2,), 0, 4)
    gumbels = []
    for _ in range(16):
        key, sub = jax.random.split(key)
        gumbels.append(jax.random.gumbel(sub, (2, 8)))
    tm.m._randint = feed([labels])
    tm.m._gumbel = feed(gumbels)
    ref = jcall(jm.m, method="sample", num_samples=2, img_size=4)
    got = tm.m.sample(2, img_size=4)
    assert got.shape == (2, 4, 4, 1) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------- the models at the JAX defaults


@pytest.mark.parametrize("name", ["gan", "vae", "vq_vae", "ar", "clf_vanilla", "clf_vit"])
def test_from_config_parameter_counts_at_the_defaults(name) -> None:
    """`IDLModel.from_config` of each model at the JAX modules' defaults
    (the ViT classifier: ViT-S/16 at 224 px, 1000 classes): the JAX model's
    parameter count and every parameter's shape through the bridge's names.
    The port builds on "meta", the JAX side abstractly."""
    config = {
        "gan": dict(model="gan", module_name="gan"),
        "vae": dict(model="vae", module_name="vae"),
        "vq_vae": dict(model="vq_vae", module_name="vq_vae"),
        "ar": dict(model="ar", module_name="pixel_cnn"),
        "clf_vanilla": dict(model="common", module_name="clf", loss_name="cross_entropy"),
        "clf_vit": dict(model="common", module_name="clf", loss_name="cross_entropy", module_config=dict(
            img_size=224, in_channels=3, num_classes=1000, encoder="vit", latent_dim=384)),
    }[name]
    jm = nnx.eval_shape(lambda: JIDLModel.from_config(JDLConfig(**config)))
    shapes = {".".join(map(str, p)): tuple(v.get_value().shape) for p, v in nnx.to_flat_state(nnx.state(jm, nnx.Param))}
    tm = cflearn_torch.IDLModel.from_config(cflearn_torch.DLConfig(**config), device="meta")
    assert tm.num_params == sum(int(np.prod(s)) for s in shapes.values())
    mapping = cflearn_torch.bridge.map_names(shapes, tm)
    assert len(mapping) == len(list(tm.parameters()))
    if name == "clf_vit":
        attn = tm.m.encoder.encoder.blocks[0].token_mixer.net
        assert (attn.num_heads, attn.head_dim, tm.m.head.weight.shape) == (6, 256, (1000, 384))
