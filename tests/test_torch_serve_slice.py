"""The port's serving configurations as a whole against the JAX package: a
tiny SD-shaped LDM through `txt2img` with string prompts, in the lossless,
faithful and accelerated configurations of `bench.py`, and the faithful
one with the guidance interval and a DeepCache refresh center.

48x48 latents, so that ToMe engages at the UNet's top level (2304 tokens >=
2048), 8 DDIM steps with CFG 7.5, so that DeepCache refreshes inside the
loop (N=3: steps 0, 3, 6; N=5: 0, 5) and the guidance interval (0.25, 0.70)
splits it into 2 / 4 / 2 steps, the middle segment refreshing twice. f32
throughout; the attention takes XLA's route on the JAX side (the flash
kernel's parity is `tests/test_torch_ops.py`'s). The JAX side is driven as
`bench.py` drives it: the levers set on the module, one jitted program per
configuration, the sampler given the guidance interval. Tolerance: f32
summation order per layer, times CFG's 7.5 per step, as in
`tests/test_torch_slice.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from _torch_bridge_common import bridged, default_threads, dezero, rel_err
import cflearn_torch
from cflearn_torch.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel as TCLIPText
from cflearn_torch.pipeline import ACCEL_DC, FAITHFUL_DC, GUIDANCE_INTERVAL, TOME_RATIO, configure
from cflearn_torch.toolkit.quality import compare_outputs
from cflearn_tpu.modules.core.mixed_stacks import SpatialTransformer
from cflearn_tpu.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel
from cflearn_tpu.modules.multimodal.diffusion.ldm import LDM
from cflearn_tpu.modules.multimodal.diffusion.samplers import ISampler
from cflearn_tpu.modules.nlp.tokenizers import CLIPTokenizer
from cflearn_tpu.toolkit import quality as JQ

UNET = dict(
    start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2),
    attention_downsample_rates=(1,), num_heads=1, context_dim=32,
)
# no downsampling: the decoder works at the latents' 48x48
FIRST_STAGE = dict(
    img_size=48, inner_channels=32, z_channels=4, embedding_channels=4, channel_multipliers=[1], num_res_blocks=1,
)
CLIP = dict(latent_dim=32, num_layers=1, num_heads=2)
STEPS = 8
LATENT = 48
PROMPT = "a photo of a café at dusk, 35mm — &amp; a 2nd prompt's words"
# (config, guidance interval, DeepCache center)
RUNS = {
    "lossless": ("lossless", None, None),
    "faithful": ("faithful", None, None),
    "accelerated": ("accelerated", None, None),
    "faithful_gi_center": ("faithful", GUIDANCE_INTERVAL, 0.3),
}


def _jax_configure(m, config: str) -> None:
    """`bench.py`'s `configure` with the port's constants (which are its)."""
    lossless = config == "lossless"
    for _, module in nnx.iter_graph(m):
        if isinstance(module, SpatialTransformer):
            module.set_tome_ratio(0.0 if lossless else TOME_RATIO)
    interval, cut = ACCEL_DC if config == "accelerated" else FAITHFUL_DC
    m.deepcache_interval = None if lossless else interval
    m.deepcache_cut = cut
    m.deepcache_center = None


def _jax_txt2img(m, tokens, uncond, z, guidance_interval):
    """`bench.py`'s closure: one jitted program per configuration (the levers
    are static attributes of the module graph)."""
    graph, state = nnx.split(m)

    @jax.jit
    def run(st, tokens, uncond, z):
        model = nnx.merge(graph, st)
        both = model.get_cond(jnp.concatenate([tokens, uncond], axis=0))
        cond, unc = jnp.split(both, 2, axis=0)
        sampler_config = {"model": model}
        if guidance_interval is not None:
            sampler_config["guidance_interval"] = guidance_interval
        sampler = ISampler.make("ddim", sampler_config)
        latents = sampler.sample(z, cond=cond, uncond=unc, guidance_scale=7.5, num_steps=STEPS)
        return latents, model.decode(latents)

    latents, images = run(state, tokens, uncond, z)
    return np.asarray(latents), np.asarray(images)


@pytest.fixture(scope="module")
def runs():
    rngs = nnx.Rngs(0)
    jm = LDM(
        img_size=LATENT, in_channels=4, out_channels=4, num_timesteps=100,
        condition_model=CLIPTextConditionModel(rngs=rngs, **CLIP),
        unet_config=UNET, first_stage_config=FIRST_STAGE, rngs=rngs,
    )
    dezero(jm)
    tm = cflearn_torch.build(
        cflearn_torch.LDM, device="cpu", img_size=LATENT, in_channels=4, out_channels=4, num_timesteps=100,
        condition_model=TCLIPText(**CLIP), unet_config=UNET, first_stage_config=FIRST_STAGE,
    )
    tm = bridged(jm, tm)
    tok = CLIPTokenizer()
    tokens = jnp.asarray(tok.tokenize([PROMPT]))
    uncond = jnp.asarray(tok.tokenize([""]))
    z = np.random.RandomState(0).randn(1, LATENT, LATENT, 4).astype(np.float32)
    out = {}
    for name, (config, gi, center) in RUNS.items():
        _jax_configure(jm, config)
        jm.deepcache_center = center
        ref = _jax_txt2img(jm, tokens, uncond, jnp.asarray(z), gi)
        configure(tm, config)
        tm.deepcache_center = center
        # the accelerated configuration meets a near-tie in ToMe's matching: under one, two or four intra-op
        # threads the port's own summation order flips a merge and its latents move 1.5e-3 from the JAX
        # package's (2e-6 at the default count)
        with default_threads():
            images, latents = cflearn_torch.txt2img(
                tm, PROMPT, num_steps=STEPS, guidance_scale=7.5, z=z, guidance_interval=gi, return_latents=True,
            )
            with torch.no_grad():
                decoded = tm.decode(latents).numpy()
        out[name] = (ref, (latents.numpy(), decoded, images.numpy()))
    return out, tm


@pytest.mark.parametrize("name", list(RUNS))
def test_serving_latents_match(runs, name) -> None:
    (ref_lat, _), (lat, _, images) = runs[0][name]
    assert lat.shape == (1, LATENT, LATENT, 4) and np.isfinite(lat).all()
    assert images.shape == (1, LATENT, LATENT, 3) and images.dtype == np.uint8
    assert rel_err(lat, ref_lat) < 1e-4


def test_levers_change_the_output(runs) -> None:
    """Each lossy configuration moves the latents away from the lossless
    ones by far more than the port-vs-JAX tolerance, in both packages, and
    the port's quality report equals the JAX package's on the same arrays."""
    out, _ = runs
    (ref_lossless, ref_img), (lossless, img, _) = out["lossless"]
    for name in ("faithful", "accelerated", "faithful_gi_center"):
        (ref_lat, ref_dec), (lat, dec, _) = out[name]
        assert rel_err(lat, lossless) > 1e-2 and rel_err(ref_lat, ref_lossless) > 1e-2, name
        got = compare_outputs(lossless, img, lat, dec)
        want = JQ.compare_outputs(ref_lossless, ref_img, ref_lat, ref_dec)
        for key, value in got.to_dict().items():
            assert value == pytest.approx(want.to_dict()[key], rel=1e-3, abs=1e-6), (name, key)


def test_configure_sets_bench_levers(runs) -> None:
    _, tm = runs
    from cflearn_torch.modules.core.mixed_stacks import SpatialTransformer as TST

    configure(tm, "accelerated")
    assert (tm.deepcache_interval, tm.deepcache_cut, tm.deepcache_center) == (5, 1, None)
    assert all(m.tome_ratio == 0.5 for m in tm.modules() if isinstance(m, TST))
    configure(tm, "faithful")
    assert tm.deepcache_interval == 3
    configure(tm, "lossless")
    assert tm.deepcache_interval is None
    assert all(m.tome_ratio == 0.0 for m in tm.modules() if isinstance(m, TST))
    with pytest.raises(ValueError):
        configure(tm, "fast")
