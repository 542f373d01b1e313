"""The port's SD txt2img slice as a whole against the JAX package, and the
full-width parameter bridge.

txt2img: a tiny SD-shaped LDM with 16x16 latents, so that the UNet's
self-attention and the VAE mid-block attention reach L = 256 and take the
flash route (Pallas in interpret mode on the JAX side, the plain version on
the port's CPU path). 3 DDIM steps with CFG 7.5 in f32. Tolerances: f32
summation order differs per layer; CFG multiplies eps differences by 7.5
every step, and the decoder amplifies latent differences into pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from _torch_bridge_common import bridged, dezero, flat_shapes, rel_err
import cflearn_torch
from cflearn_torch.bridge import map_names
from cflearn_torch.modules.multimodal.diffusion.cond_models import (
    CLIPTextConditionModel as TCLIPText,
)
from cflearn_tpu.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel
from cflearn_tpu.modules.multimodal.diffusion.ldm import LDM, StableDiffusion
from cflearn_tpu.modules.multimodal.diffusion.samplers import ISampler
from cflearn_tpu.ops import attention as A

UNET = dict(
    start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2),
    attention_downsample_rates=(1,), num_heads=4, context_dim=32,
)
FIRST_STAGE = dict(
    img_size=64, inner_channels=32, z_channels=4, embedding_channels=4,
    channel_multipliers=[1, 2, 2, 2], num_res_blocks=1,
)
CLIP = dict(latent_dim=32, num_layers=1, num_heads=2)


def _jax_txt2img(m, tokens, uncond, z, steps):
    both = m.get_cond(jnp.concatenate([tokens, uncond], axis=0))
    cond, unc = jnp.split(both, 2, axis=0)
    sampler = ISampler.make("ddim", {"model": m})
    latents = sampler.sample(z, cond=cond, uncond=unc, guidance_scale=7.5, num_steps=steps)
    images = m.decode(latents)
    return ((jnp.clip(images, -1.0, 1.0) + 1.0) * 127.5).astype(jnp.uint8), latents


@pytest.fixture(scope="module")
def tiny_pair():
    A._INTERPRET, saved = True, A._INTERPRET
    try:
        rngs = nnx.Rngs(0)
        jm = LDM(
            img_size=16, in_channels=4, out_channels=4, num_timesteps=50,
            condition_model=CLIPTextConditionModel(rngs=rngs, **CLIP),
            unet_config=UNET, first_stage_config=FIRST_STAGE, rngs=rngs,
        )
        dezero(jm)
        assert np.any(np.asarray(jm.unet.conv_out.kernel[...]))
        tm = cflearn_torch.build(
            cflearn_torch.LDM, device="cpu", img_size=16, in_channels=4, out_channels=4,
            num_timesteps=50, condition_model=TCLIPText(**CLIP), unet_config=UNET,
            first_stage_config=FIRST_STAGE,
        )
        tm = bridged(jm, tm)
        rng = np.random.RandomState(0)
        tokens = rng.randint(1, 49000, (1, 77))
        uncond = np.zeros((1, 77), np.int64)
        z = rng.randn(1, 16, 16, 4).astype(np.float32)
        ref_img, ref_lat = _jax_txt2img(
            jm, jnp.asarray(tokens, jnp.int32), jnp.asarray(uncond, jnp.int32), jnp.asarray(z), 3
        )
        ref = (np.asarray(ref_img), np.asarray(ref_lat))
    finally:
        A._INTERPRET = saved
    img, lat = cflearn_torch.txt2img(tm, tokens, uncond, num_steps=3, guidance_scale=7.5, z=z, return_latents=True)
    return ref, (img.numpy(), lat.numpy()), jm, tm


def test_schedule_buffers_match(tiny_pair) -> None:
    _, _, jm, tm = tiny_pair
    for name in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)[...]), err_msg=name)


def test_txt2img_latents_match(tiny_pair) -> None:
    (_, ref_lat), (_, lat), _, _ = tiny_pair
    assert lat.shape == (1, 16, 16, 4) and np.isfinite(lat).all()
    # f32 order differences (~1e-6 relative per layer) times CFG's 7.5 per step
    assert rel_err(lat, ref_lat) < 1e-4


def test_txt2img_images_match(tiny_pair) -> None:
    (ref_img, _), (img, _), _, _ = tiny_pair
    assert img.shape == (1, 128, 128, 3) and img.dtype == np.uint8
    diff = np.abs(img.astype(np.int16) - ref_img.astype(np.int16))
    # uint8 truncation can flip by one level where a pixel sits on a boundary
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01
    assert img.std() > 0  # not a constant image


def test_denoise_conditioning_reaches_eps(tiny_pair) -> None:
    """With the zero-initialised convs redrawn, eps depends on the context."""
    _, _, _, tm = tiny_pair
    x = torch.randn(1, 16, 16, 4, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([10])
    with torch.no_grad():
        c1 = tm.get_cond(torch.randint(1, 49000, (1, 77), generator=torch.Generator().manual_seed(1)))
        c0 = tm.get_cond(torch.zeros((1, 77), dtype=torch.long))
        e1, e0 = tm.denoise(x, t, c1), tm.denoise(x, t, c0)
    assert (e1 - e0).abs().max() > 1e-4


def test_bridge_full_width_maps_one_to_one() -> None:
    """Every parameter of full-width SD maps one to one with equal shapes;
    neither side allocates (JAX eval_shape, the port on "meta")."""
    jm = nnx.eval_shape(lambda: StableDiffusion(version="v1", rngs=nnx.Rngs(0)))
    shapes = flat_shapes(jm)
    tm = cflearn_torch.build_sd("v1", device="meta")
    mapping = map_names(shapes, tm)
    assert len(mapping) == len(shapes) == len(list(tm.parameters()))
    n_jax = sum(int(np.prod(s)) for s in shapes.values())
    assert n_jax == sum(p.numel() for p in tm.parameters())
