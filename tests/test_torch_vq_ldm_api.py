"""The VQ latent-diffusion family served through the port's `DiffusionAPI`
against the JAX package's, on tiny versions of the zoo's presets (64px
images through an f4 `AutoEncoderVQ` of 32 channels, 16x16x3 latents, a
UNet of 32 channels with multi-head attention at 8x8), the weights bridged:
`from_inpainting(...).inpainting` (the concat-only condition), `outpainting`
in its pad and RGBA conventions, `from_semantic(...).semantic2img` from a
one-hot and from an index map (through the `Rescaler`) and on a
rescaler-less concat model (the nearest resize to h // 8), and `sr` (the
bicubic x4 condition) on `ldm_vq(latent_in_channels=6,
condition_type="concat")`. Each JAX call is the API's own jitted program.

The starting latents come from the JAX side (its `jax.random.normal` with
the call's key, or `k1` of its split) through `DiffusionAPI._randn`; DDIM
at eta 0 draws nothing else. f32 throughout. Tolerances:
`_torch_api_common.py`."""

import jax
import numpy as np
import pytest

from _torch_api_common import catch_latents, check, feed, image, mask, normal
from _torch_bridge_common import dezero, empty_cache, flat_params
from cflearn_torch import zoo as tzoo
from cflearn_torch.api.multimodal import diffusion as TA
from cflearn_torch.bridge import load_nnx_params
from cflearn_tpu import zoo as jzoo
from cflearn_tpu.api.multimodal import diffusion as JA

FIRST_STAGE = dict(img_size=64, inner_channels=32, num_res_blocks=1)
UNET = dict(start_channels=32, num_res_blocks=1, channel_multipliers=[1, 2], attention_downsample_rates=[2],
            num_heads=4, use_spatial_transformer=False)
INPAINTING = dict(latent_size=16, first_stage_config=dict(FIRST_STAGE, attention_type="none"),
                  unet_config=dict(UNET, resample_with_resblock=True))
SEMANTIC = dict(latent_size=16, latent_in_channels=6, condition_config=dict(num_stages=2, in_channels=8, out_channels=3),
                first_stage_config=FIRST_STAGE, unet_config=UNET)
SR = dict(latent_size=16, latent_in_channels=6, condition_type="concat", first_stage_config=FIRST_STAGE,
          unet_config=dict(UNET, num_head_channels=16))


def _bridge(japi, tapi, seed):
    dezero(japi.m, seed=seed)
    load_nnx_params(tapi.m, flat_params(japi.m))
    return japi, tapi


@pytest.fixture(scope="module")
def inpainting():
    return _bridge(JA.DiffusionAPI.from_inpainting(use_bf16=False, ldm_kwargs=INPAINTING),
                   TA.DiffusionAPI.from_inpainting(use_bf16=False, device="cpu", ldm_kwargs=INPAINTING), 11)


@pytest.fixture(scope="module")
def semantic():
    return _bridge(JA.DiffusionAPI.from_semantic(use_bf16=False, ldm_kwargs=SEMANTIC),
                   TA.DiffusionAPI.from_semantic(use_bf16=False, device="cpu", ldm_kwargs=SEMANTIC), 12)


@pytest.fixture(scope="module")
def super_resolution():
    return _bridge(JA.DiffusionAPI(jzoo.ldm_vq(**SR)), TA.DiffusionAPI(tzoo.ldm_vq(device="cpu", **SR), device="cpu"),
                   13)


@pytest.fixture()
def caught(monkeypatch, request):
    # a cached JAX program would report its latents to the test that traced it
    for name in ("inpainting", "semantic", "super_resolution"):
        if name in request.fixturenames:
            request.getfixturevalue(name)[0]._jit_cache.clear()
    return catch_latents(monkeypatch)


def _split_k1(seed):
    return jax.random.split(jax.random.PRNGKey(seed))[0]


def test_from_inpainting_inpainting(inpainting, caught, monkeypatch):
    """7 UNet input channels: the latents, the masked image's (filled with
    -1) and the mask in [-1, 1]; no text, no CFG; the unmasked pixels come
    from the input."""
    japi, tapi = inpainting
    assert tapi.m.condition_type == "concat" and tapi.m.unet.in_channels == 7 and tapi.m.out_channels == 3
    img, msk = image(1), mask()
    ref = japi.inpainting(img, msk, num_steps=2, seed=1)
    api_it, _ = feed(monkeypatch, [normal(_split_k1(1), (1, 16, 16, 3))])
    got = tapi.inpainting(img, msk, num_steps=2, seed=1)
    assert next(api_it, None) is None
    check(got, ref, caught)
    kept = msk == 0
    assert np.abs(got[0][kept].astype(np.int16) - img[0][kept].astype(np.int16)).max() <= 1


@pytest.mark.parametrize("convention", ["pad", "rgba"])
def test_outpainting(inpainting, caught, monkeypatch, convention):
    """Pad mode: the 64px image centred on a 96px canvas, its border
    generated. RGBA: `outpainting(txt, rgba)`, the transparent pixels
    generated."""
    japi, tapi = inpainting
    img = image(2)
    if convention == "pad":
        args, size = (img,), 96
    else:
        alpha = np.full((64, 64, 1), 255, np.uint8)
        alpha[:, 40:] = 0
        args, size = ("a cat", np.concatenate([img[0], alpha], axis=-1)), 64
    ref = japi.outpainting(*args, num_steps=2, seed=2)
    api_it, _ = feed(monkeypatch, [normal(_split_k1(2), (1, size // 4, size // 4, 3))])
    got = tapi.outpainting(*args, num_steps=2, seed=2)
    assert next(api_it, None) is None
    assert got.shape == (1, size, size, 3)
    check(got, ref, caught)


@pytest.mark.parametrize("form", ["one_hot", "index_map"])
def test_from_semantic_semantic2img(semantic, caught, monkeypatch, form):
    """A 64px map of 8 classes: the `Rescaler` halves it twice to the 16x16
    latents and maps its channels to 3. An integer (H, W) map is one-hot to
    the condition model's 8 channels."""
    japi, tapi = semantic
    labels = np.random.RandomState(3).randint(0, 8, size=(64, 64))
    sem = np.eye(8, dtype=np.float32)[labels][None] if form == "one_hot" else labels
    ref = japi.semantic2img(sem, num_steps=2, seed=0)
    api_it, _ = feed(monkeypatch, [normal(jax.random.PRNGKey(0), (1, 16, 16, 3))])
    got = tapi.semantic2img(sem, num_steps=2, seed=0)
    assert next(api_it, None) is None
    check(got, ref, caught)


def test_semantic2img_without_condition_model(super_resolution, caught, monkeypatch):
    """A concat LDM with no condition model: the map is resized (nearest) to
    h // 8 whatever the first stage's factor, so an f4 model answers a 64px
    map with a 32px image, as the JAX package does."""
    japi, tapi = super_resolution
    labels = np.random.RandomState(4).randint(0, 3, size=(64, 64))
    sem = np.eye(3, dtype=np.float32)[labels][None]
    ref = japi.semantic2img(sem, num_steps=2, seed=5)
    api_it, _ = feed(monkeypatch, [normal(jax.random.PRNGKey(5), (1, 8, 8, 3))])
    got = tapi.semantic2img(sem, num_steps=2, seed=5)
    assert next(api_it, None) is None and got.shape == (1, 32, 32, 3)
    check(got, ref, caught)


def test_sr(super_resolution, caught, monkeypatch):
    """An 8px image upsampled x4 (bicubic) is the condition of 32x32
    latents, decoded to 128px."""
    japi, tapi = super_resolution
    img = image(6, size=8)
    ref = japi.sr(img, num_steps=2, seed=6)
    api_it, _ = feed(monkeypatch, [normal(jax.random.PRNGKey(6), (1, 32, 32, 3))])
    got = tapi.sr(img, num_steps=2, seed=6)
    assert next(api_it, None) is None and got.shape == (1, 128, 128, 3)
    check(got, ref, caught)


def test_concat_only_entry_points_and_pretrained_raise(inpainting, tmp_path, monkeypatch) -> None:
    # pretrained weights come from the local cache: from an empty one the load raises, naming where the file goes
    with empty_cache(tmp_path, monkeypatch) as folder:
        with pytest.raises(OSError, match=f"put the file at {folder / 'ldm_inpainting.pt'}"):
            TA.DiffusionAPI.from_inpainting(pretrained=True, device="cpu")
        with pytest.raises(OSError, match=f"put the file at {folder / 'ldm_semantic.pt'}"):
            TA.DiffusionAPI.from_semantic(pretrained=True, device="cpu")
    _, tapi = inpainting
    backup, tapi.m.condition_type = tapi.m.condition_type, "cross_attn"
    try:
        with pytest.raises(ValueError, match="concat"):
            tapi.sr(image(0, size=8))
        with pytest.raises(ValueError, match="concat"):
            tapi.semantic2img(np.zeros((8, 8), np.int64))
    finally:
        tapi.m.condition_type = backup
