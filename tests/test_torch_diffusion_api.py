"""The port's `DiffusionAPI` against the JAX package's, on the tiny LDM of
`__graft_entry__.py` (64px images, 8x8 latents, a two-layer CLIP 32 wide, 50
timesteps), the weights bridged: `txt2img` with a k-sampler, an injected z
and two batches; the seeded starting latents with slerped variations;
`img2img` at fidelity 0.5; `txt2img` with clip skip, a callback and the
high-resolution second pass; the host-side crop / blur / resize helpers of
MASKED inpainting; the switches, the SD weight pool and the constructors.
Each JAX call is the API's own jitted program, run once per kind.

The random draws come from the JAX side, through the port's noise seams
(`DiffusionAPI._randn`, `ISampler._randn`), each made with the JAX API's
own `jax.random` calls in their order. f32 throughout; the attention takes
XLA's route on the JAX side. Tolerances: `_torch_api_common.py`."""

import jax
import numpy as np
import pytest
import torch

from _torch_api_common import LAT_TOL, MAX_SHARE, catch_latents, check, feed, image, ldm_pair, mask, normal
from _torch_bridge_common import rel_err
import cflearn_torch
from cflearn_torch.api.multimodal import diffusion as TA
from cflearn_torch.modules.layers import resize_bilinear
from cflearn_tpu.api.multimodal import diffusion as JA


@pytest.fixture(scope="module")
def plain():
    return ldm_pair(4, 0)


@pytest.fixture()
def caught(monkeypatch):
    return catch_latents(monkeypatch)


def test_txt2img_k_sampler(plain, caught, monkeypatch):
    """Two prompts in batches of one, from an injected z, k_euler, CFG 5."""
    jm, tm = plain
    z = np.random.RandomState(3).randn(2, 8, 8, 4).astype(np.float32)
    kw = dict(size=(64, 64), num_steps=4, guidance_scale=5.0, seed=5, z=z, batch_size=1, negative_prompt="blurry")
    japi, tapi = JA.DiffusionAPI(jm), cflearn_torch.DiffusionAPI(tm, device="cpu")
    japi.switch_sampler("k_euler")
    tapi.switch_sampler("k_euler")
    ref = japi.txt2img(["a red cube", "a blue ball"], **kw)
    feed(monkeypatch)  # nothing is drawn
    got = tapi.txt2img(["a red cube", "a blue ball"], **kw)
    check(got, ref, caught, n_latents=2)


def test_make_noise_variations(plain, monkeypatch):
    """The seeded starting latents, slerped with two variation seeds."""
    jm, tm = plain
    variations = [(7, 0.3), (8, 0.6)]
    ref = np.asarray(JA.DiffusionAPI(jm)._make_noise(2, (64, 64), 5, variations))
    shape = (2, 8, 8, 4)
    api_it, _ = feed(monkeypatch, [normal(jax.random.PRNGKey(s), shape) for s in (5, 7, 8)])
    got = cflearn_torch.DiffusionAPI(tm, device="cpu")._make_noise(2, (64, 64), 5, variations).numpy()
    assert next(api_it, None) is None
    assert rel_err(got, ref) < 1e-6


def test_img2img(plain, caught, monkeypatch):
    jm, tm = plain
    img = image(0)
    kw = dict(cond="a watercolor", fidelity=0.5, num_steps=4, guidance_scale=3.0, seed=2)
    ref = JA.DiffusionAPI(jm).img2img(img, **kw)
    k1, _ = jax.random.split(jax.random.PRNGKey(2))
    _, sampler_it = feed(monkeypatch, sampler_draws=[normal(k1, (1, 8, 8, 4))])
    got = cflearn_torch.DiffusionAPI(tm, device="cpu").img2img(img, **kw)
    assert next(sampler_it, None) is None
    check(got, ref, caught)


def test_txt2img_clip_skip_callback_highres(plain, caught, monkeypatch):
    """Clip skip 1 for the call, a callback on the decoded images, and the
    high-resolution second pass: the images upscaled x2 (bilinear) to
    uint8, then img2img at fidelity 0.5 on 16x16 latents. The uint8 cast
    between the passes turns f32 rounding into whole levels on a few values
    (their latents then differ by ~1e-3), so the first pass is held to JAX
    as a whole, the second from the JAX side's own uint8 images, and the
    port's second pass to its img2img of its own."""
    jm, tm = plain
    z = np.random.RandomState(4).randn(1, 8, 8, 4).astype(np.float32)
    decoded = {"jax": [], "port": []}

    def callback(side):
        return lambda x: (decoded[side].append(x.copy()), x * 0.8 + 0.1)[1]

    kw = dict(size=(64, 64), num_steps=4, guidance_scale=3.0, seed=3, z=z, clip_skip=1,
              highres_info={"upscale_factor": 2.0, "fidelity": 0.5})
    ref = JA.DiffusionAPI(jm).txt2img("a lighthouse", callback=callback("jax"), **kw)
    k1, _ = jax.random.split(jax.random.PRNGKey(3))
    draws = [normal(k1, (1, 16, 16, 4))]
    _, sampler_it = feed(monkeypatch, sampler_draws=draws)
    tapi = cflearn_torch.DiffusionAPI(tm, device="cpu")
    got = tapi.txt2img("a lighthouse", callback=callback("port"), **kw)
    assert next(sampler_it, None) is None and got.shape == ref.shape == (1, 128, 128, 3)
    assert tm.condition_model.clip_skip == 0
    jax.effects_barrier()
    assert rel_err(caught["port"][0], caught["jax"][0]) < LAT_TOL
    assert rel_err(decoded["port"][0], decoded["jax"][0]) < LAT_TOL
    # the second pass from the JAX side's uint8 images
    big = JA._to_uint8(jax.image.resize(decoded["jax"][0] * 0.8 + 0.1, (1, 128, 128, 3), "bilinear"))
    feed(monkeypatch, sampler_draws=draws)
    second = tapi.img2img(big, cond=["a lighthouse"], fidelity=0.5, num_steps=4, guidance_scale=3.0, seed=3)
    check(second, ref, {"jax": caught["jax"][1:], "port": caught["port"][2:]})
    # and the port's own second pass is img2img of its own uint8 images, bit for bit
    own = TA._to_uint8(resize_bilinear(torch.from_numpy(decoded["port"][0] * 0.8 + 0.1), 128, 128))
    feed(monkeypatch, sampler_draws=draws)
    again = tapi.img2img(own, cond=["a lighthouse"], fidelity=0.5, num_steps=4, guidance_scale=3.0, seed=3)
    np.testing.assert_array_equal(again, got)


def test_host_helpers():
    """The crop / blur / resize helpers, on the host, against the JAX ones."""
    msk = mask(96)[None, :, :, None]
    img = TA._from_uint8(image(4, 96))
    settings = dict(mode="masked", mask_padding=(5, 9), target_wh=(100, 60), mask_blur=3)
    jc = JA.crop_masked_area(img, msk, JA.InpaintingSettings(**settings))
    tc = TA.crop_masked_area(img, msk, TA.InpaintingSettings(**settings))
    assert tuple(tc.box) == tuple(jc.box) and tc.wh == jc.wh
    np.testing.assert_array_equal(tc.mask, jc.mask)
    np.testing.assert_array_equal(tc.cropped_mask, jc.cropped_mask)
    assert rel_err(tc.image, jc.image) < 1e-5
    np.testing.assert_array_equal(TA._box_blur(msk[0, :, :, 0], (5, 3)), JA._box_blur(msk[0, :, :, 0], (5, 3)))
    ramp = np.arange(16, dtype=np.float32)[:, None].repeat(16, 1)
    for wh, method in (((2, 2), "nearest"), ((12, 5), "nearest"), ((40, 24), "nearest"), ((5, 11), "bilinear"),
                       ((40, 24), "bilinear")):
        assert rel_err(TA._resize_np(ramp, wh, method), JA._resize_np(ramp, wh, method)) < 1e-6, (wh, method)
    for box in ((10, 10, 20, 60), (0, 40, 90, 50), (80, 0, 96, 10)):
        for pad in (None, 4, (3, 7)):
            assert TA.adjust_lt_rb(TA.ImageBox(*box), 96, 72, pad) == JA.adjust_lt_rb(JA.ImageBox(*box), 96, 72, pad)
    for f, n in ((0.2, 20), (1.0, 20), (0.0, 4), (0.49, 7)):
        assert TA.fidelity_start_step(f, n) == JA.fidelity_start_step(f, n)
    sampled = np.random.RandomState(0).uniform(-1, 1, (1,) + tuple(tc.image.shape[1:])).astype(np.float32)
    settings_t, settings_j = TA.InpaintingSettings(**settings), JA.InpaintingSettings(**settings)
    got = TA.recover_masked_area(sampled, tc, settings_t)
    ref = JA.recover_masked_area(sampled, jc, settings_j)
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= MAX_SHARE


def test_api_switches_and_constructors(plain, monkeypatch):
    """Samplers by name, ToMe and DeepCache settings, the SD weight pool, and
    the constructors: `from_sd` builds on the card unless asked for another
    device, never pretrained."""
    _, tm = plain
    api = cflearn_torch.DiffusionAPI(tm, device="cpu")
    with pytest.raises(ValueError, match="unknown sampler"):
        api.switch_sampler("euler")
    api.switch_sampler("solver", order=3)
    assert api.sampler_name == "solver" and api._sampler().order == 3
    api.set_deepcache(1)
    assert tm.deepcache_interval is None
    api.set_deepcache(3, cut=1, center=0.4)
    assert (tm.deepcache_interval, tm.deepcache_cut, tm.deepcache_center) == (3, 1, 0.4)
    api.set_deepcache(None)
    api.set_tome_ratio(0.5)
    assert all(m.tome_ratio == 0.5 for m in tm.modules() if hasattr(m, "tome_ratio"))
    api.set_tome_ratio(0.0)
    name = "unet.conv_in.bias"
    original = dict(tm.named_parameters())[name].detach().clone()
    api.prepare_sd({"alt": {name: np.full(original.shape, 0.5, np.float32)}, "base": {name: original.numpy()}})
    api.switch_sd("alt")
    assert torch.all(dict(tm.named_parameters())[name] == 0.5)
    api.switch_sd("base")
    assert torch.equal(dict(tm.named_parameters())[name], original)
    with pytest.raises(ValueError, match="not prepared"):
        api.switch_sd("missing")
    with pytest.raises(ValueError, match="never downloaded"):
        cflearn_torch.DiffusionAPI.from_sd(pretrained=True, device="meta")
    inpainting = cflearn_torch.DiffusionAPI.from_sd_inpainting(device="meta")
    assert isinstance(inpainting.m, cflearn_torch.StableDiffusionInpainting) and inpainting.use_bf16
    assert tuple(inpainting.m.unet.conv_in.weight.shape) == (320, 9, 3, 3) and inpainting.m.out_channels == 4
    community = cflearn_torch.DiffusionAPI.from_sd("v1.5", device="meta", use_bf16=False)
    assert community.m.version == "v1" and community.m.unet.conv_in.weight.dtype == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cflearn_torch.DiffusionAPI.from_sd_inpainting()
    with pytest.raises(RuntimeError, match="CUDA"):
        cflearn_torch.DiffusionAPI(tm)
