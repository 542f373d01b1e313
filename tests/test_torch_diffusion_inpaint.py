"""The port's inpainting and ControlNet sampling through `DiffusionAPI` /
`ControlledDiffusionAPI` against the JAX package's, on the tiny LDM of
`__graft_entry__.py` and its 9-channel inpainting twin (the mask and the
masked image's latents joined to the UNet's input), the weights bridged:
9-channel `inpainting` in NORMAL (with `keep_original`) and MASKED
(cropped, blurred) mode; repaint on the 4-channel model from the q-sampled
original; and `sample_with_control` with a hint's start and end gating.
Each JAX call is the API's own jitted program, run once per kind.

The random draws come from the JAX side, through the port's noise seams,
each made with the JAX API's own `jax.random` calls in their order. f32
throughout. Tolerances: `_torch_api_common.py`."""

import jax
import numpy as np
import pytest
from flax import nnx

from _torch_api_common import UNET, catch_latents, check, feed, image, ldm_pair, mask, normal
from _torch_bridge_common import dezero, flat_params
import cflearn_torch
from cflearn_torch.api.multimodal import diffusion as TA
from cflearn_torch.bridge import control_net_params, load_nnx_params
from cflearn_tpu.api.multimodal import diffusion as JA
from cflearn_tpu.modules.multimodal.diffusion.unet import ControlNet


@pytest.fixture(scope="module")
def plain():
    return ldm_pair(4, 0)


@pytest.fixture(scope="module")
def inpainting_pair():
    return ldm_pair(9, 1)


@pytest.fixture()
def caught(monkeypatch):
    return catch_latents(monkeypatch)


@pytest.mark.parametrize("mode", ["normal", "masked"])
def test_inpainting_9_channels(inpainting_pair, caught, monkeypatch, mode):
    """The hybrid condition under CFG (the mask and the masked image's
    latents joined to the UNet's input); NORMAL with `keep_original`,
    MASKED cropped to the padded mask box with a blurred mask."""
    jm, tm = inpainting_pair
    img, msk = image(1), mask()
    kw = dict(cond="a cat", num_steps=3, guidance_scale=4.0, seed=3)
    if mode == "masked":
        kw["inpainting_settings"] = JA.InpaintingSettings(mode=JA.InpaintingMode.MASKED, mask_padding=6, mask_blur=3)
        tkw = dict(kw, inpainting_settings=TA.InpaintingSettings(mode=TA.InpaintingMode.MASKED, mask_padding=6,
                                                                 mask_blur=3))
    else:
        kw.update(keep_original=True, keep_original_fade=8)
        tkw = kw
    ref = JA.DiffusionAPI(jm).inpainting(img, msk, **kw)
    k1, _ = jax.random.split(jax.random.PRNGKey(3))
    api_it, _ = feed(monkeypatch, [normal(k1, (1, 8, 8, 4))])
    got = cflearn_torch.DiffusionAPI(tm, device="cpu").inpainting(img, msk, **tkw)
    assert next(api_it, None) is None
    check(got, ref, caught)


def test_repaint_with_background_guidance(plain, caught, monkeypatch):
    """A plain UNet: the latents sampled from the q-sampled original, the
    original latents kept outside the mask."""
    jm, tm = plain
    img, msk = image(2), mask()
    kw = dict(num_steps=4, guidance_scale=2.0, seed=4, use_background_guidance=True, reference_fidelity=0.25)
    ref = JA.DiffusionAPI(jm).txt2img_inpainting("a dog", img, msk, **kw)
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    api_it, sampler_it = feed(
        monkeypatch, [normal(k1, (1, 8, 8, 4))], [normal(jax.random.split(k2)[0], (1, 8, 8, 4))]
    )
    got = cflearn_torch.DiffusionAPI(tm, device="cpu").txt2img_inpainting("a dog", img, msk, **kw)
    assert next(api_it, None) is None and next(sampler_it, None) is None
    check(got, ref, caught)


def test_sample_with_control_gated(plain, caught, monkeypatch):
    """One ControlNet on a 64px hint at scale 0.8, on from 25% to 50% of
    the loop (steps 1 and 2 of 4); disabled, the API samples without it."""
    jm, tm = plain
    jc = dezero(ControlNet(hint_channels=3, in_channels=4, rngs=nnx.Rngs(9), **UNET), seed=19)
    tc = cflearn_torch.build(cflearn_torch.ControlNet, device="cpu", hint_channels=3, in_channels=4, **UNET)
    load_nnx_params(tc, control_net_params(flat_params(jc)))
    japi, tapi = JA.ControlledDiffusionAPI(jm), cflearn_torch.ControlledDiffusionAPI(tm, device="cpu")
    for api, cn in ((japi, jc), (tapi, tc)):
        api.prepare_control("depth", cn)
        api.control_scales["depth"] = 0.8
    hint = image(3)
    kw = dict(cond="a house", size=(64, 64), num_steps=4, guidance_scale=3.0, seed=6,
              hint_starts={"depth": 0.25}, hint_ends={"depth": 0.5})
    ref = japi.sample_with_control(1, {"depth": hint}, **kw)
    api_it, _ = feed(monkeypatch, [normal(jax.random.PRNGKey(6), (1, 8, 8, 4))])
    got = tapi.sample_with_control(1, {"depth": hint}, **kw)
    assert next(api_it, None) is None
    check(got, ref, caught)
    tapi.disable_control()
    feed(monkeypatch, [normal(jax.random.PRNGKey(6), (1, 8, 8, 4))])
    unguided = tapi.sample_with_control(1, {"depth": hint}, **kw)
    assert np.abs(unguided.astype(np.int16) - got.astype(np.int16)).max() > 1
    tapi.switch_control()
    tapi.enable_control()
    with pytest.raises(ValueError, match="not prepared"):
        tapi.sample_with_control(1, {"depth": hint}, **kw)


