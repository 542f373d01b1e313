"""Helpers for the port's `DiffusionAPI` parity tests: the tiny LDM of
`__graft_entry__.py` on both sides, the draws fed to the port's noise seams,
the latents caught at each side's decode, and the comparison of images.

Tolerances: the latents entering the decode to 1e-4 of max|JAX| (f32
summation order through the UNet, a few steps); the uint8 images to one
level, on at most 2% of the values (the JAX package truncates to uint8, so
an f32 rounding difference flips a level where a value sits next to an
integer)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from _torch_bridge_common import bridged, dezero, rel_err
import cflearn_torch
from cflearn_torch.api.multimodal import diffusion as TA
from cflearn_torch.modules.multimodal.diffusion import samplers as TS
from cflearn_torch.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel as TCLIPText
from cflearn_tpu.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel
from cflearn_tpu.modules.multimodal.diffusion.ldm import LDM

LAT_TOL = 1e-4
MAX_SHARE = 0.02
UNET = dict(
    start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2), attention_downsample_rates=(1,), num_heads=4,
    context_dim=32,
)
FIRST_STAGE = dict(
    img_size=64, inner_channels=32, z_channels=4, embedding_channels=4, channel_multipliers=[1, 2, 2, 2],
    num_res_blocks=1,
)
CLIP = dict(latent_dim=32, num_layers=2, num_heads=2)  # two layers: clip skip 1 taps the first


def ldm_pair(in_channels, seed):
    """The JAX LDM (zero-initialised kernels redrawn) and the port's, bridged."""
    jm = LDM(
        img_size=8, in_channels=in_channels, out_channels=4, num_timesteps=50,
        condition_model=CLIPTextConditionModel(rngs=nnx.Rngs(seed), **CLIP), unet_config=UNET,
        first_stage_config=FIRST_STAGE, rngs=nnx.Rngs(seed),
    )
    dezero(jm, seed=seed + 10)
    tm = cflearn_torch.build(
        cflearn_torch.LDM, device="cpu", img_size=8, in_channels=in_channels, out_channels=4, num_timesteps=50,
        condition_model=TCLIPText(**CLIP), unet_config=UNET, first_stage_config=FIRST_STAGE,
    )
    return jm, bridged(jm, tm)


def catch_latents(monkeypatch):
    """{"jax": [...], "port": [...]}: the latents each side's decode gets,
    the JAX ones by a host callback inside the jitted program."""
    got = {"jax": [], "port": []}
    orig = LDM.decode

    def jax_decode(self, z, **kw):
        jax.debug.callback(lambda v: got["jax"].append(np.asarray(v)), z)
        return orig(self, z, **kw)

    orig_t = cflearn_torch.LDM.decode

    def port_decode(self, z, **kw):
        got["port"].append(z.detach().numpy().copy())
        return orig_t(self, z, **kw)

    monkeypatch.setattr(LDM, "decode", jax_decode)
    monkeypatch.setattr(cflearn_torch.LDM, "decode", port_decode)
    return got


def feed(monkeypatch, api_draws=(), sampler_draws=()):
    """The port's draws, in order: the API's (`DiffusionAPI._randn`) and the
    samplers' (`ISampler._randn`). Returns both iterators."""
    api_it, sampler_it = iter(api_draws), iter(sampler_draws)

    def api_randn(self, shape, generator, dtype=torch.float32):
        value = next(api_it)
        assert tuple(value.shape) == tuple(shape)
        return torch.tensor(np.array(value), dtype=dtype, device=self.device)

    def sampler_randn(self, shape, like, generator):
        value = next(sampler_it)
        assert tuple(value.shape) == tuple(shape)
        return torch.tensor(np.array(value), dtype=like.dtype, device=like.device)

    monkeypatch.setattr(TA.DiffusionAPI, "_randn", api_randn)
    monkeypatch.setattr(TS.ISampler, "_randn", sampler_randn)
    return api_it, sampler_it


def normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def check(got, ref, caught, n_latents=1):
    jax.effects_barrier()
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    assert len(caught["jax"]) == len(caught["port"]) == n_latents
    for lj, lt in zip(caught["jax"], caught["port"]):
        assert rel_err(lt, lj) < LAT_TOL
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= MAX_SHARE, (diff.max(), (diff > 0).mean())


def image(seed, size=64):
    """A smooth uint8 test image."""
    rng = np.random.RandomState(seed)
    low = rng.uniform(0, 255, (1, 8, 8, 3)).astype(np.float32)
    return np.clip(np.kron(low, np.ones((1, size // 8, size // 8, 1))) + rng.uniform(-20, 20, (1, size, size, 3)),
                   0, 255).astype(np.uint8)


def mask(size=64):
    m = np.zeros((size, size), np.float32)
    m[20:44, 12:40] = 1.0
    return m
