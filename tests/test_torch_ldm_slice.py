"""Latent-diffusion training on images: the port's LDM against the JAX
package on the CPU at a tiny size (32px images, a `AutoEncoderKL` first stage
of 32 channels, multipliers [1, 2] and one res block, so 16x16x4 latents; a
UNet of 32 channels whose attention sits at 8x8, off the flash route).

The JAX step draws t and the noise from the model's `nnx.Rngs` after the
encode; a clone of those Rngs gives the same draws, which the port's step
takes as arguments. Parameters go across by the strict bridge. f32 sums in
another order only; each tolerance is stated where it is used."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import cflearn_torch
from _torch_bridge_common import dezero, flat_params, rel_err
from cflearn_torch.bridge import load_nnx_params, tree_from_nnx
from cflearn_torch.models.cv.diffusion import DDPMModel as TDDPMModel
from cflearn_torch.models.cv.diffusion import DDPMStep as TDDPMStep
from cflearn_torch.models.cv.diffusion import _to_diffusion_space
from cflearn_torch.modules.cv.ae import AutoEncoderVQ as TAutoEncoderVQ
from cflearn_torch.modules.multimodal.diffusion.ddpm import DDPM as TDDPM
from cflearn_torch.modules.multimodal.diffusion.ldm import LDM as TLDM
from cflearn_tpu.models.cv.diffusion import DDPMModel, DDPMStep
from cflearn_tpu.modules.multimodal.diffusion.ddpm import DDPM
from cflearn_tpu.modules.multimodal.diffusion.ldm import LDM

B, IMG, LATENT, T = 2, 32, 16, 50
FIRST_STAGE = dict(img_size=IMG, in_channels=3, inner_channels=32, z_channels=4, embedding_channels=4,
                   channel_multipliers=[1, 2], num_res_blocks=1)
UNET = dict(start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2), attention_downsample_rates=(2,),
            num_heads=4, context_dim=32)


def _pair(jcls, tcls, unet=None, **kw):
    """A JAX model and its bridged port counterpart (f32, CPU)."""
    kw = dict(img_size=LATENT, num_timesteps=T, unet_config=dict(UNET, **(unet or {})), **kw)
    jm = jcls(rngs=nnx.Rngs(0), **kw)
    dezero(jm)
    tm = cflearn_torch.build(tcls, device="cpu", **kw)
    return jm, load_nnx_params(tm, flat_params(jm)).eval()


def _images(seed: int) -> np.ndarray:
    return np.random.RandomState(seed).uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)


def _draws(jm, shape):
    """The t and the noise the JAX step will draw next (from a copy of its stream)."""
    rngs = nnx.clone(jm.rngs)
    t = np.array(jax.random.randint(rngs.default(), (B,), 0, T))
    return t, np.array(jax.random.normal(rngs.default(), shape, jnp.float32))


def _jax_loss_and_grads(jm, batch):
    """`jax.value_and_grad` of the JAX `DDPMStep.loss_fn` over the parameters
    its model trains (the UNet: `DDPMModel.params_filter` leaves the first
    stage out)."""
    trained = nnx.All(nnx.Param, nnx.Not(nnx.PathContains("first_stage")), nnx.Not(nnx.PathContains("ema")))
    gd, params, rest = nnx.split(jm, trained, ...)

    def loss_fn(p):
        m = nnx.merge(gd, p, nnx.clone(rest))  # the draws mutate the merged copy's Rngs
        losses = DDPMStep("all").loss_fn(SimpleNamespace(m=m), batch, {})
        return losses["loss"], losses

    (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    flat = {".".join(map(str, path)): np.asarray(v[...]) for path, v in nnx.to_flat_state(grads)}
    return {k: float(v) for k, v in losses.items()}, flat


@pytest.fixture(scope="module")
def ldm_pair():
    return _pair(LDM, TLDM, first_stage_config=FIRST_STAGE)


def test_ldm_step_on_images_matches_jax(ldm_pair) -> None:
    """The p-loss of an LDM given images: the frozen first stage encodes them
    (the posterior's mode, times the latent scale), then q-sample, denoise,
    MSE. Loss items 1e-5 relative; every UNet gradient 1e-4 of the leaf's
    largest value, floored at 1% of the largest gradient (f32 sums in
    another order through the encoder and the UNet, forward and backward)."""
    jm, tm = ldm_pair
    x = _images(0)
    cond = np.random.RandomState(1).randn(B, 7, 32).astype(np.float32)
    t, noise = _draws(jm, (B, LATENT, LATENT, 4))
    ref, ref_grads = _jax_loss_and_grads(jm, {"input": jnp.asarray(x), "cond": jnp.asarray(cond)})
    model = TDDPMModel(tm)
    named = model.params_filter("all")
    assert named and all(n.startswith("m.unet.") for n, _ in named)
    got = TDDPMStep("all").loss_fn(
        model, {"input": torch.from_numpy(x), "cond": torch.from_numpy(cond)},
        t=torch.from_numpy(t), noise=torch.from_numpy(noise),
    )
    assert set(got) == set(ref) == {"simple", "loss"}
    for key, value in ref.items():
        assert abs(float(got[key]) - value) <= 1e-5 * abs(value), key
    grads = torch.autograd.grad(got["loss"], [p for _, p in named])
    want = tree_from_nnx(ref_grads, tm, [n[len("m."):] for n, _ in named])
    floor = 1e-2 * max(float(w.abs().max()) for w in want.values())
    for (name, _), g in zip(named, grads):
        ref_g = want[name[len("m."):]]
        assert float((g - ref_g).abs().max()) / max(float(ref_g.abs().max()), floor) < 1e-4, name


def test_encode_is_off_the_tape(ldm_pair) -> None:
    """The first stage's parameters require a gradient, yet the latents do not
    (the JAX `stop_gradient`): no encoder activation is kept for a backward."""
    _, tm = ldm_pair
    assert all(p.requires_grad for p in tm.first_stage.parameters())
    z = _to_diffusion_space(tm, torch.from_numpy(_images(2)))
    assert z.shape == (B, LATENT, LATENT, 4) and not z.requires_grad and z.grad_fn is None
    x0 = torch.randn(B, LATENT, LATENT, 4, requires_grad=True)
    assert _to_diffusion_space(cflearn_torch.build(TDDPM, device="meta", unet_config=UNET), x0) is x0


def test_encode_first_stage_matches_jax(ldm_pair) -> None:
    """The mode times the latent scale (1e-5 of the largest value); a sample
    from a generator is mode + std * noise, reproducible, and another draw
    than the mode. `first_stage_scale_factor` wins over `latent_scale`."""
    jm, tm = ldm_pair
    x = _images(3)
    ref = jm.encode_first_stage(jnp.asarray(x))
    with torch.no_grad():
        mode = tm.encode_first_stage(torch.from_numpy(x))
        a = tm.encode_first_stage(torch.from_numpy(x), deterministic=False, generator=torch.Generator().manual_seed(1))
        b = tm.encode_first_stage(torch.from_numpy(x), deterministic=False, generator=torch.Generator().manual_seed(1))
        dist = tm.first_stage.encode(torch.from_numpy(x))
    assert rel_err(mode.numpy(), ref) < 1e-5
    assert torch.equal(a, b) and not torch.equal(a, mode)
    noise = torch.randn(dist.mean.shape, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, (dist.mean + dist.std * noise) * tm.latent_scale)
    other = cflearn_torch.build(TLDM, device="meta", img_size=LATENT, unet_config=UNET, first_stage_scale_factor=0.5,
                                latent_scale=0.1)
    assert other.latent_scale == 0.5


class _Identity(torch.nn.Module):
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., :4] * 2.0


def test_first_stage_by_registry_name_and_kind() -> None:
    """A `generators` name builds the first stage ("ae_vq": its z_q is the
    latent, against the JAX package's); any other name is a zoo preset
    ("ae/kl.f8" builds the preset's `AutoEncoderKL`, an unknown one raises);
    any other module's `encode` output is taken as it is."""
    vq = dict(FIRST_STAGE, num_code=16)
    jm, tm = _pair(LDM, TLDM, first_stage="ae_vq", first_stage_config=dict(vq, pretrained=False))
    assert isinstance(tm.first_stage, TAutoEncoderVQ)
    x = _images(4)
    with torch.no_grad():
        got = tm.encode_first_stage(torch.from_numpy(x))
        z_q = tm.first_stage.encode(torch.from_numpy(x)).z_q
    torch.testing.assert_close(got, z_q * tm.latent_scale)
    assert rel_err(got.numpy(), jm.encode_first_stage(jnp.asarray(x))) < 1e-5
    kl = cflearn_torch.build(TLDM, device="meta", img_size=LATENT, unet_config=UNET, first_stage="ae/kl.f8")
    assert type(kl.first_stage).__name__ == "AutoEncoderKL" and kl.first_stage.from_embedding.weight.shape[1] == 4
    with pytest.raises(ValueError, match="zoo"):
        cflearn_torch.build(TLDM, device="meta", img_size=LATENT, unet_config=UNET, first_stage="ae/missing")
    plain = cflearn_torch.build(TLDM, device="cpu", img_size=LATENT, unet_config=UNET, first_stage=_Identity())
    y = torch.randn(B, LATENT, LATENT, 6)
    torch.testing.assert_close(plain.encode_first_stage(y), y[..., :4] * 2.0 * plain.latent_scale)


def test_monitoring_forward_matches_jax(ldm_pair) -> None:
    """`DDPMModel.run`: one denoise at t = T // 2 of the encoded images with
    the JAX model's next noise draw; 1e-5 of the largest value."""
    jm, tm = ldm_pair
    x = _images(5)
    cond = np.random.RandomState(6).randn(B, 7, 32).astype(np.float32)
    noise = np.array(jax.random.normal(nnx.clone(jm.rngs).default(), (B, LATENT, LATENT, 4), jnp.float32))
    jmodel = SimpleNamespace(m=jm, set_mode=lambda training: None)
    ref = DDPMModel.run(jmodel, {"input": jnp.asarray(x), "cond": jnp.asarray(cond)})
    with torch.no_grad():
        got = TDDPMModel(tm).run({"input": torch.from_numpy(x), "cond": torch.from_numpy(cond)},
                                 noise=torch.from_numpy(noise))
    assert set(got) == set(ref) == {"predictions", "noise", "timesteps"}
    np.testing.assert_array_equal(got["timesteps"].numpy(), np.asarray(ref["timesteps"]))
    assert rel_err(got["predictions"].numpy(), ref["predictions"]) < 1e-5
    assert TDDPMStep.uses_forward_results is False  # the train step does not run it


def test_finetune_unet_on_images_keeps_the_first_stage() -> None:
    """Two steps of `finetune_unet` given images: every UNet parameter moves,
    the first stage comes out bit for bit unchanged, the UNet saw latents."""
    _, tm = _pair(LDM, TLDM, first_stage_config=FIRST_STAGE)
    frozen = {n: p.detach().clone() for n, p in tm.first_stage.named_parameters()}
    unet = {n: p.detach().clone() for n, p in tm.unet.named_parameters()}
    seen = []
    hook = tm.unet.register_forward_pre_hook(lambda mod, args: seen.append(tuple(args[0].shape)))
    try:
        out = cflearn_torch.finetune_unet(
            tm, _images(7), np.random.RandomState(8).randn(B, 7, 32).astype(np.float32), num_steps=2, lr=1e-3,
            compute_dtype=None, device="cpu",
        )
    finally:
        hook.remove()
    assert seen == [(B, LATENT, LATENT, 4)] * 2 and torch.isfinite(out["losses"]).all()
    assert all(torch.equal(p.detach(), frozen[n]) for n, p in tm.first_stage.named_parameters())
    assert not [n for n, p in tm.unet.named_parameters() if torch.equal(p.detach(), unet[n])]
    assert out["step"].optimizer.last_lr == 1e-3 and type(out["step"].optimizer).__name__ == "Adam"
    assert out["step"].optimizer.decoupled  # AdamW


# ---------------------------------------------------------------- condition types


def _loss_pair(jm, tm, x, cond, shape):
    t, noise = _draws(jm, shape)
    ref, _ = _jax_loss_and_grads(jm, {"input": jnp.asarray(x), "cond": cond[0]})
    with torch.no_grad():
        got = TDDPMStep("all").loss_fn(TDDPMModel(tm), {"input": torch.from_numpy(x), "cond": cond[1]},
                                       t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    return ref, got


def test_first_stage_as_concat_condition_matches_jax() -> None:
    """A super-resolution style LDM: the condition images go through the
    frozen first stage (no gradient) and join the noisy latents on the
    channel axis. The loss against the JAX step: 1e-5 relative."""
    with pytest.raises(ValueError, match="condition_learnable"):
        cflearn_torch.build(TLDM, device="meta", img_size=LATENT, unet_config=UNET, first_stage_config=FIRST_STAGE,
                            use_first_stage_as_condition=True, condition_learnable=True)
    jm, tm = _pair(LDM, TLDM, unet=dict(in_channels=8, context_dim=None), first_stage_config=FIRST_STAGE,
                   condition_type="concat", use_first_stage_as_condition=True)
    x, c = _images(9), _images(10)
    with torch.no_grad():
        enc = tm.get_cond(torch.from_numpy(c))
    assert enc.shape == (B, LATENT, LATENT, 4) and not enc.requires_grad
    assert rel_err(enc.numpy(), jm.get_cond(jnp.asarray(c))) < 1e-5
    ref, got = _loss_pair(jm, tm, x, (jnp.asarray(c), torch.from_numpy(c)), (B, LATENT, LATENT, 4))
    assert abs(float(got["loss"]) - ref["loss"]) <= 1e-5 * ref["loss"]


def test_hybrid_condition_matches_jax() -> None:
    """`hybrid`: channels joined to the input and a cross-attention context,
    from one dict; no first stage, so x0 is the batch itself."""
    jm, tm = _pair(DDPM, TDDPM, unet=dict(in_channels=6), condition_type="hybrid")
    rng = np.random.RandomState(11)
    x0 = rng.randn(B, LATENT, LATENT, 4).astype(np.float32)
    concat, ctx = rng.randn(B, LATENT, LATENT, 2).astype(np.float32), rng.randn(B, 7, 32).astype(np.float32)
    cond = ({"concat": jnp.asarray(concat), "cross_attn": jnp.asarray(ctx)},
            {"concat": torch.from_numpy(concat), "cross_attn": torch.from_numpy(ctx)})
    ref, got = _loss_pair(jm, tm, x0, cond, x0.shape)
    assert abs(float(got["loss"]) - ref["loss"]) <= 1e-5 * ref["loss"]
    t = torch.tensor([3, 7])
    with torch.no_grad():
        out = tm.denoise(torch.from_numpy(x0), t, cond[1])
        other = tm.denoise(torch.from_numpy(x0), t, dict(cond[1], concat=cond[1]["concat"] + 1.0))
    assert out.shape == x0.shape and not torch.equal(out, other)


def test_adm_condition_with_labels_matches_jax() -> None:
    """`adm`: class labels through the UNet's label embedding, added to the
    time embedding (the bridge maps `label_embed.embedding` to its weight)."""
    jm, tm = _pair(DDPM, TDDPM, unet=dict(num_classes=5, context_dim=None), condition_type="adm")
    assert tuple(tm.unet.label_embed.weight.shape) == (5, 4 * UNET["start_channels"])
    x0 = np.random.RandomState(12).randn(B, LATENT, LATENT, 4).astype(np.float32)
    labels = np.array([1, 4])
    ref, got = _loss_pair(jm, tm, x0, (jnp.asarray(labels), torch.from_numpy(labels)), x0.shape)
    assert abs(float(got["loss"]) - ref["loss"]) <= 1e-5 * ref["loss"]
    t = torch.tensor([3, 3])
    with torch.no_grad():
        a = tm.denoise(torch.from_numpy(x0), t, torch.tensor([1, 1]))
        b = tm.denoise(torch.from_numpy(x0), t, torch.tensor([2, 2]))
    assert not torch.equal(a, b)
    out = cflearn_torch.finetune_unet(tm, x0, labels, num_steps=1, compute_dtype=None, device="cpu")
    assert torch.isfinite(out["losses"]).all() and out["step"].grads["m.unet.label_embed.weight"].any()
    with pytest.raises(ValueError, match="condition type"):
        cflearn_torch.build(TDDPM, device="meta", unet_config=UNET, condition_type="film")
