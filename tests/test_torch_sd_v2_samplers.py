"""Every registered sampler on the tiny SD v2 v-model
(`_torch_sd_v2_common.py`) through the port's `DiffusionAPI` and the JAX
package's, three steps each: txt2img from an injected z, CFG 4, a negative
prompt. The samplers reach the model through `predict_eps_from`, so a
shortcut that is right for eps models only shows here. The draws of the
stochastic samplers come from the JAX side through the port's noise seam
(`_torch_api_common.feed`). Each JAX call is the API's own jitted program,
one per sampler. Tolerances: `_torch_api_common.py` (latents 1e-4 of the
largest, uint8 images within one level on at most 2% of values)."""

import jax
import numpy as np
import pytest

import cflearn_torch
from _torch_api_common import catch_latents, check, feed, normal
from _torch_sd_v2_common import v_pair
from cflearn_tpu.api.multimodal import diffusion as JA
from cflearn_tpu.modules.multimodal.diffusion import samplers as JS


@pytest.fixture(scope="module")
def pair():
    return v_pair()


def _draws(name, n):
    """The JAX sampler's draws for a plain `sample` at seed 7 with z given
    (`test_torch_samplers._stochastic_draws`): basic and k_euler_a one a
    step, lcm one a step but the last; ddim at eta 0 and the rest none."""
    key = jax.random.PRNGKey(7)
    k = {"basic": n, "k_euler_a": n, "lcm": n - 1}.get(name, 0)
    return [normal(sub, (1, 8, 8, 4)) for sub in jax.random.split(key, n)][:k]


@pytest.mark.parametrize("name", sorted(JS.ISampler.d))
def test_samplers_through_the_api(pair, name, monkeypatch):
    """One sampler, three steps, through both APIs; the model is a v-model."""
    jm, tm = pair
    assert tm.parameterization == "v"
    caught = catch_latents(monkeypatch)
    z = np.random.RandomState(6).randn(1, 8, 8, 4).astype(np.float32)
    kw = dict(size=(64, 64), num_steps=3, guidance_scale=4.0, seed=7, z=z, negative_prompt="blurry")
    japi, tapi = JA.DiffusionAPI(jm), cflearn_torch.DiffusionAPI(tm, device="cpu")
    japi.switch_sampler(name)
    tapi.switch_sampler(name)
    ref = japi.txt2img("a lighthouse at dusk", **kw)
    _, sampler_it = feed(monkeypatch, sampler_draws=_draws(name, 3))
    got = tapi.txt2img("a lighthouse at dusk", **kw)
    assert next(sampler_it, None) is None, "the port drew fewer samples than the JAX sampler"
    check(got, ref, caught)
