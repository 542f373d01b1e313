"""Style reference ("reference-only" txt2img) in the port against the JAX
package, on the tiny LDM of `__graft_entry__.py` (`_torch_api_common.py`:
64px images, 8x8 latents, transformer blocks 32 and 64 wide), the weights
bridged:
- `walk_transformer_blocks`' order and `style_reference_write_gates` at
  reference weights 0, 0.5 and 1;
- one WRITE + READ `denoise` call on a CFG batch, fed the JAX side's
  reference noise;
- `DiffusionAPI.setup_hooks(style_reference_image=...)` then `txt2img`, at
  fidelity 0 and 0.3, and with a guidance interval (the steps outside the
  band run at batch 1, with no uncond rows to mix); the reference image
  rounded to the 64px grid as the JAX API rounds it;
- `setup_hooks()` clearing the style reference;
- the JAX module's order of branches: with ToMe on, a block takes ToMe and
  skips style reference, so txt2img with both equals txt2img with ToMe
  alone;
- every registered sampler handing `hooks` on to each `denoise` call, with
  and without a guidance interval (on `test_torch_samplers.py`'s stub).

The reference's noise comes from the JAX side (`fold_in(key, t)` at each
step) through the port's seam, `SpatialTransformerHooks._randn`. f32
throughout; tolerances are `_torch_api_common.py`'s (latents to 1e-4 of
max|JAX|, uint8 images to one level on at most 2% of the values)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_api_common import LAT_TOL, catch_latents, check, image, ldm_pair, normal
from _torch_bridge_common import rel_err
import cflearn_torch
from cflearn_torch.modules.core import mixed_stacks as TM
from cflearn_torch.modules.multimodal.diffusion import unet as TU
from cflearn_tpu.api.multimodal import diffusion as JA
from cflearn_tpu.modules.core import mixed_stacks as JM
from cflearn_tpu.modules.multimodal.diffusion import unet as JU

STATES = {"style_fidelity": 0.3, "reference_weight": 0.5}


@pytest.fixture(scope="module")
def plain():
    return ldm_pair(4, 0)


@pytest.fixture()
def caught(monkeypatch):
    return catch_latents(monkeypatch)


def feed_reference_noise(monkeypatch, key):
    """The port's reference noise: at each denoise step the JAX draw
    `normal(fold_in(key, t[0]))` of the step's shape. Returns the list of
    steps fed."""
    fed, last_t = [], []
    orig = cflearn_torch.LDM.denoise

    def denoise(self, net, timesteps, *args, **kw):
        last_t.append(int(timesteps[0]))
        return orig(self, net, timesteps, *args, **kw)

    def randn(self, shape, like):
        fed.append(last_t[-1])
        draw = normal(jax.random.fold_in(key, last_t[-1]), tuple(shape))
        return torch.tensor(draw, dtype=like.dtype, device=like.device)

    monkeypatch.setattr(cflearn_torch.LDM, "denoise", denoise)
    monkeypatch.setattr(TM.SpatialTransformerHooks, "_randn", randn)
    return fed


def test_block_walk_and_write_gates(plain):
    jm, tm = plain
    jblocks, tblocks = JU.walk_transformer_blocks(jm.unet), TU.walk_transformer_blocks(tm.unet)
    widths = [b.norm1.weight.shape[0] for b in tblocks]
    assert widths == [b.norm1.num_features for b in jblocks] == [32, 64, 32, 32]
    for weight in (0.0, 0.25, 0.5, 1.0):
        got = TU.style_reference_write_gates(tm.unet, weight)
        assert got == JU.style_reference_write_gates(jm.unet, weight), weight
    # widest first, ties in call order: the mid block's, then the first
    assert TU.style_reference_write_gates(tm.unet, 0.5) == [True, True, False, False]
    assert TU.style_reference_write_gates(tm.unet, 0.0) == [False] * 4


def test_write_read_denoise_call(plain, monkeypatch):
    """One denoise call of a CFG batch (2 x 1 rows) with the reference's
    WRITE pass and the READ pass, fidelity 0.3 on the uncond row."""
    jm, tm = plain
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    ref = rng.randn(1, 8, 8, 4).astype(np.float32)
    cond = rng.randn(2, 7, 32).astype(np.float32)
    t = np.array([30, 30])
    gates = JU.style_reference_write_gates(jm.unet, 0.5)
    mask = np.arange(2)[:, None, None] >= 1
    key = jax.random.PRNGKey(7)
    jhooks = JM.SpatialTransformerHooks(
        style=JM.StyleReferenceStates(**STATES), write_gates=gates, uncond_mask=jnp.asarray(mask),
        ref_latent=jnp.asarray(ref), key=key,
    )
    want = np.asarray(jm.denoise(jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond), hooks=jhooks))
    fed = feed_reference_noise(monkeypatch, key)
    thooks = TM.SpatialTransformerHooks(
        style=TM.StyleReferenceStates(**STATES), write_gates=gates, uncond_mask=torch.from_numpy(mask),
        ref_latent=torch.from_numpy(ref),
    )
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond), hooks=thooks).numpy()
    assert fed == [30] and thooks.mode is None and sorted(thooks.bank) == [0, 1]
    assert rel_err(got, want) < LAT_TOL
    # the reference changes the output, on the cond row too
    with torch.no_grad():
        bare = tm.denoise(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond)).numpy()
    assert rel_err(got[:1], bare[:1]) > 1e-3


@pytest.mark.parametrize("fidelity,interval", [(0.0, None), (0.3, None), (0.3, (0.25, 0.75))],
                         ids=["fidelity0", "fidelity0.3", "guidance_interval"])
def test_txt2img_with_a_style_reference(plain, caught, monkeypatch, fidelity, interval):
    jm, tm = plain
    z = np.random.RandomState(5).randn(1, 8, 8, 4).astype(np.float32)
    ref_image = image(2, 96)[:, :80]  # 80x96: rounded to 64x128 by both APIs
    states = {"style_fidelity": fidelity, "reference_weight": 0.5}
    kw = dict(size=(64, 64), num_steps=4, guidance_scale=5.0, seed=3, z=z)
    japi, tapi = JA.DiffusionAPI(jm), cflearn_torch.DiffusionAPI(tm, device="cpu")
    config = {} if interval is None else {"guidance_interval": interval}
    japi.switch_sampler("ddim", **config)
    tapi.switch_sampler("ddim", **config)
    for api in (japi, tapi):
        api.setup_hooks(style_reference_image=ref_image, style_reference_states=states)
    assert tapi._style_sig() == japi._style_sig()
    assert tapi._style_ref["image"].shape == (1, 64, 128, 3)
    assert rel_err(tapi._style_ref["image"], japi._style_ref["image"]) < 1e-5
    ref = japi.txt2img("a red cube", **kw)
    k1, _ = jax.random.split(jax.random.PRNGKey(3))
    fed = feed_reference_noise(monkeypatch, k1)
    got = tapi.txt2img("a red cube", **kw)
    assert len(fed) == 4
    check(got, ref, caught)
    # and the reference moved the latents away from the plain txt2img's
    tapi.setup_hooks()
    tapi.txt2img("a red cube", **kw)
    assert rel_err(caught["port"][0], caught["port"][1]) > 1e-3


def test_setup_hooks_clears(plain, caught):
    jm, tm = plain
    z = np.random.RandomState(6).randn(1, 8, 8, 4).astype(np.float32)
    kw = dict(size=(64, 64), num_steps=3, guidance_scale=4.0, seed=1, z=z)
    tapi, japi = cflearn_torch.DiffusionAPI(tm, device="cpu"), JA.DiffusionAPI(jm)
    before = tapi.txt2img("a blue ball", **kw)
    for api in (tapi, japi):
        api.setup_hooks(style_reference_image=image(3), style_reference_states=STATES)
        assert api._style_sig() is not None
        api.setup_hooks()
        assert api._style_sig() is None and api._style_ref is None
    np.testing.assert_array_equal(tapi.txt2img("a blue ball", **kw), before)


def test_tome_bypasses_style_reference(plain, caught, monkeypatch):
    """The JAX module checks ToMe before style reference: with ToMe on, the
    WRITE pass banks nothing and the READ pass attends as plain ToMe. The
    port mirrors it: txt2img with both equals txt2img with ToMe alone, bit
    for bit, and the JAX API's txt2img with both."""
    jm, tm = plain
    z = np.random.RandomState(7).randn(1, 8, 8, 4).astype(np.float32)
    kw = dict(size=(64, 64), num_steps=3, guidance_scale=5.0, seed=2, z=z)
    japi, tapi = JA.DiffusionAPI(jm), cflearn_torch.DiffusionAPI(tm, device="cpu")
    try:
        for api in (japi, tapi):
            api.setup_hooks(tome_info={"ratio": 0.5}, style_reference_image=image(4), style_reference_states=STATES)
        ref = japi.txt2img("a lighthouse", **kw)
        k1, _ = jax.random.split(jax.random.PRNGKey(2))
        fed = feed_reference_noise(monkeypatch, k1)
        banks = []
        orig_begin = TM.SpatialTransformerHooks.begin
        monkeypatch.setattr(TM.SpatialTransformerHooks, "begin",
                            lambda self, mode: (banks.append(len(self.bank)), orig_begin(self, mode))[1])
        both = tapi.txt2img("a lighthouse", **kw)
        assert len(fed) == 3 and set(banks) == {0}
        check(both, ref, caught)
        tapi.setup_hooks()
        np.testing.assert_array_equal(tapi.txt2img("a lighthouse", **kw), both)
    finally:
        for api in (japi, tapi):
            api.set_tome_ratio(0.0)


@pytest.mark.parametrize("interval", [None, (0.25, 0.7)], ids=["cfg", "guidance_interval"])
def test_every_sampler_passes_the_hooks_to_denoise(interval):
    """Every registered sampler (the JAX package registers the same names)
    hands `hooks` on to each `denoise` call, in every guidance-interval
    segment, as the JAX samplers do through their `**kwargs`."""
    from cflearn_tpu.modules.multimodal.diffusion import samplers as JS
    from test_torch_samplers import SHAPE, _Stub

    from cflearn_torch.modules.multimodal.diffusion import samplers as TS

    assert sorted(TS.ISampler.d) == sorted(JS.ISampler.d)
    sentinel = object()

    class Recording(_Stub):
        def denoise(self, x, t, cond, *, hooks=None, **kw):
            seen.append(hooks)
            return super().denoise(x, t, cond, **kw)

    rng = np.random.RandomState(8)
    z = torch.from_numpy(rng.randn(*SHAPE).astype(np.float32))
    cond, uncond = (torch.from_numpy(rng.randn(SHAPE[0], 5, 4).astype(np.float32)) for _ in range(2))
    for name in sorted(TS.ISampler.d):
        seen = []
        config = {} if interval is None else {"guidance_interval": interval}
        sampler = TS.ISampler.make(name, dict(config, model=Recording(torch)))
        out = sampler.sample(z, cond=cond, uncond=uncond, guidance_scale=5.0, num_steps=4 if name == "lcm" else 6,
                             hooks=sentinel)
        assert torch.isfinite(out).all(), name
        assert seen and all(h is sentinel for h in seen), name
