"""The full `Conv2d`, the norms and `make_txt2img_with_latents` in the port
against the JAX package, and the tiling mode of the diffusion API:
- `Conv2d` with each option (padding forms, stride, dilation, groups,
  `weight_scale`, `transform_kernel`, circular padding, on a non-square
  input): f32, the weights bridged, to 1e-5 of max|JAX| (f32 sums in
  another order); `gain` sets only the initial weights (xavier-normal, std
  within 10% of gain x sqrt(2 / (fan_in + fan_out)));
- `DiffusionAPI.switch_circular(True)` then `txt2img` on the tiny LDM of
  `__graft_entry__.py` (`_torch_api_common.py`'s tolerances), and
  `switch_circular(False)` giving back, bit for bit, the image of a model
  that never switched; only the `Conv2d`s switch (the upsample convs), as
  in the JAX package;
- every `NormFactory` type, `PixelNorm` and `AdaptiveInstanceNorm2d` to
  1e-5 (statistics in f32 on both sides);
- `make_txt2img_with_latents`: latents and float images of one DDIM run
  against the JAX function's, to 1e-4 of max|JAX|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from _torch_api_common import LAT_TOL, catch_latents, check, ldm_pair
from _torch_bridge_common import bridged, flat_params, rel_err
import cflearn_torch
from cflearn_torch.modules.core import convs as TC
from cflearn_torch.modules.core import norms as TN
from cflearn_torch.modules.common import init_parameters
from cflearn_torch.toolkit.quality import make_txt2img_with_latents as t_make
from cflearn_tpu.api.multimodal import diffusion as JA
from cflearn_tpu.modules.core import convs as JC
from cflearn_tpu.modules.core import norms as JN
from cflearn_tpu.toolkit.quality import make_txt2img_with_latents as j_make

CONV_CASES = {
    "same": dict(),
    "valid": dict(padding="valid"),
    "int_pad": dict(padding=2, kernel_size=5),
    "pair_pad_stride2": dict(padding=(0, 1), stride=2),
    "dilation2": dict(dilation=2),
    "groups2_no_bias": dict(groups=2, bias=False),
    "weight_scale": dict(weight_scale=0.5),
    "transform_kernel": dict(transform_kernel=True),
    "gain": dict(gain=2.0),
    "circular": dict(circular=True),
    "circular_stride2": dict(circular=True, stride=2),
    "circular_transform_kernel": dict(circular=True, transform_kernel=True, weight_scale=2.0),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_options(case):
    kw = dict(CONV_CASES[case])
    circular = kw.pop("circular", False)
    jconv = JC.Conv2d(8, 6, rngs=nnx.Rngs(0), **kw)
    tconv = bridged(jconv, TC.Conv2d(8, 6, **kw))
    for conv in (jconv, tconv):
        conv.set_circular(circular)
    x = np.random.RandomState(1).randn(2, 9, 13, 8).astype(np.float32)  # H != W
    want = np.asarray(jconv(jnp.asarray(x)))
    with torch.no_grad():
        got = tconv(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) < 1e-5


def test_conv2d_gain_is_an_init_gain():
    conv = init_parameters(TC.Conv2d(64, 96, kernel_size=3, gain=2.0), seed=0)
    want = 2.0 * (2.0 / (64 * 9 + 96 * 9)) ** 0.5
    assert abs(float(conv.conv.weight.detach().std()) / want - 1.0) < 0.1
    plain = init_parameters(TC.Conv2d(64, 96, kernel_size=3), seed=0)
    assert abs(float(plain.conv.weight.detach().std()) * (64 * 9) ** 0.5 - 1.0) < 0.1


@pytest.fixture(scope="module")
def plain():
    return ldm_pair(4, 0)


@pytest.fixture()
def caught(monkeypatch):
    return catch_latents(monkeypatch)


def test_switch_circular_txt2img(plain, caught):
    jm, tm = plain
    z = np.random.RandomState(2).randn(1, 8, 8, 4).astype(np.float32)
    kw = dict(size=(64, 64), num_steps=3, guidance_scale=5.0, seed=4, z=z)
    japi, tapi = JA.DiffusionAPI(jm), cflearn_torch.DiffusionAPI(tm, device="cpu")
    never = tapi.txt2img("a tiled floor", **kw)
    caught["port"].clear()
    try:
        for api in (japi, tapi):
            api.switch_circular(True)
        switched = [m for m in tm.modules() if isinstance(m, TC.Conv2d)]
        # the UNet's upsample conv and the decoder's three: every `Conv2d`, and nothing else
        assert len(switched) == 4 and all(m.padding_mode == "circular" for m in switched)
        ref = japi.txt2img("a tiled floor", **kw)
        got = tapi.txt2img("a tiled floor", **kw)
        check(got, ref, caught)
        assert not np.array_equal(got, never)
    finally:
        for api in (japi, tapi):
            api.switch_circular(False)
    np.testing.assert_array_equal(tapi.txt2img("a tiled floor", **kw), never)


NORM_CASES = {
    "none": (None, {}),
    "batch_norm": ("batch_norm", {}),
    "batch": ("batch", {"epsilon": 1e-3}),
    "layer_norm": ("layer_norm", {}),
    "layer": ("layer", {"epsilon": 1e-5}),
    "rms_norm": ("rms_norm", {}),
    "group_norm": ("group_norm", {"num_groups": 8}),
    "group_norm_default": ("group_norm", {}),
    "pixel_norm": ("pixel_norm", {}),
    "instance_norm": ("instance_norm", {"epsilon": 1e-5}),
}


@pytest.mark.parametrize("case", list(NORM_CASES))
def test_norm_factory(case):
    norm_type, kw = NORM_CASES[case]
    jnorm = JN.NormFactory(norm_type).make(64, rngs=nnx.Rngs(0), **kw)
    tnorm = TN.NormFactory(norm_type).make(64, **kw)
    rng = np.random.RandomState(3)
    if flat_params(jnorm):
        # non-trivial scales and shifts on both sides
        state = nnx.state(jnorm, nnx.Param)
        for _, var in nnx.to_flat_state(state):
            var[...] = jnp.asarray(rng.uniform(0.5, 1.5, var[...].shape), jnp.float32)
        tnorm = bridged(jnorm, tnorm).train()  # `nnx.BatchNorm` normalises by the batch's statistics by default
    x = (rng.randn(2, 5, 7, 64) * 3.0 + 1.0).astype(np.float32)
    want = np.asarray(jnorm(jnp.asarray(x)))
    with torch.no_grad():
        got = tnorm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) < 1e-5
    if norm_type in ("group_norm", "instance_norm"):
        assert isinstance(tnorm, cflearn_torch.modules.layers.GroupNorm)  # the kernel's module on the card


def test_norm_factory_rejects_an_unknown_type():
    with pytest.raises(ValueError, match="unrecognized norm type"):
        TN.NormFactory("spectral").make(8)


def test_adaptive_instance_norm():
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 6, 5, 16) * 2.0 + 0.5).astype(np.float32)
    scale, bias = rng.randn(2, 16).astype(np.float32), rng.randn(2, 16).astype(np.float32)
    want = np.asarray(JN.AdaptiveInstanceNorm2d(16)(*(jnp.asarray(a) for a in (x, scale, bias))))
    got = TN.AdaptiveInstanceNorm2d(16)(*(torch.from_numpy(a) for a in (x, scale, bias))).numpy()
    assert rel_err(got, want) < 1e-5
    want = np.asarray(JN.PixelNorm()(jnp.asarray(x)))
    assert rel_err(TN.PixelNorm()(torch.from_numpy(x)).numpy(), want) < 1e-5


def test_make_txt2img_with_latents(plain):
    jm, tm = plain
    tok = cflearn_torch.CLIPTokenizer()
    tokens = np.asarray(tok.tokenize(["a cat on a mat"]))
    uncond = np.asarray(tok.tokenize([""]))
    z = np.random.RandomState(5).randn(1, 8, 8, 4).astype(np.float32)
    fn, state = j_make(jm, num_steps=4, guidance_scale=3.0)
    j_lat, j_img = fn(state, jnp.asarray(tokens), jnp.asarray(uncond), jnp.asarray(z), jax.random.PRNGKey(0))
    t_lat, t_img = t_make(tm, num_steps=4, guidance_scale=3.0)(
        torch.as_tensor(tokens), torch.as_tensor(uncond), torch.from_numpy(z)
    )
    assert t_lat.grad_fn is None and t_img.shape == (1, 64, 64, 3)
    assert rel_err(t_lat.numpy(), np.asarray(j_lat)) < LAT_TOL
    assert rel_err(t_img.numpy(), np.asarray(j_img)) < LAT_TOL
