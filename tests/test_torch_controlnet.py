"""The port's `ControlNet` and the ControlNet injection of `DDPM.denoise` /
`UNetDiffuser.forward(control=...)` against the JAX package, at the tiny
widths of `__graft_entry__.py`'s LDM (start 32, one res block a level,
multipliers (1, 2), attention at the top level, 4 heads, context 32):
the residual list, `DDPM.denoise` with one control and with two (per-level
scales, gates), a DeepCache shallow pass (`max_levels`), the 4-channel
control on a 9-channel (hybrid) UNet, and the strict bridge, which takes
the JAX `ControlNet` only without its unused decoder half.

The all-zero kernels (the zero convs, `hint_out`, the UNet's `conv_out`)
are redrawn, so that every residual carries signal. f32 throughout; the
attention takes XLA's route on the JAX side. Tolerance: 1e-4 of max|JAX|
(f32 summation order through a dozen layers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from _torch_bridge_common import bridged, dezero, flat_params, rel_err
import cflearn_torch
from cflearn_torch.bridge import CONTROL_NET_UNUSED, control_net_params, load_nnx_params
from cflearn_tpu.modules.multimodal.diffusion.ddpm import DDPM
from cflearn_tpu.modules.multimodal.diffusion.unet import ControlNet

TOL = 1e-4
UNET = dict(
    start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2), attention_downsample_rates=(1,), num_heads=4,
    context_dim=32,
)
LATENT = 8


def _pair(cls_j, cls_t, seed, **kw):
    jm = dezero(cls_j(rngs=nnx.Rngs(seed), **kw), seed=seed + 10)
    tm = cflearn_torch.build(cls_t, device="cpu", **kw)
    return jm, tm


def _control_pair(seed, in_channels=4):
    jc = dezero(ControlNet(hint_channels=3, in_channels=in_channels, rngs=nnx.Rngs(seed), **UNET), seed=seed + 10)
    tc = cflearn_torch.build(cflearn_torch.ControlNet, device="cpu", hint_channels=3, in_channels=in_channels, **UNET)
    return jc, load_nnx_params(tc, control_net_params(flat_params(jc))).eval()


def _inputs(seed, b=2, channels=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, LATENT, LATENT, channels).astype(np.float32)
    hint = rng.uniform(-1, 1, (b, 8 * LATENT, 8 * LATENT, 3)).astype(np.float32)
    context = rng.randn(b, 5, 32).astype(np.float32)
    t = np.array([37, 981][:b])
    return x, hint, context, t


@pytest.fixture(scope="module")
def control():
    return _control_pair(1)


def test_bridge_keeps_strict(control):
    """The JAX module's decoder half is left out by name; fed whole, the
    strict bridge refuses it."""
    jc, _ = control
    flat = flat_params(jc)
    dropped = sorted(set(flat) - set(control_net_params(flat)))
    assert dropped and all(k.startswith(CONTROL_NET_UNUSED) for k in dropped)
    with pytest.raises(ValueError, match="no such port parameter"):
        load_nnx_params(cflearn_torch.build(cflearn_torch.ControlNet, device="meta", **UNET), flat)


@pytest.mark.parametrize("max_levels", [None, 2])
def test_residuals(control, max_levels):
    jc, tc = control
    x, hint, context, t = _inputs(2)
    ref = jc(jnp.asarray(x), jnp.asarray(hint), jnp.asarray(t), jnp.asarray(context), max_levels=max_levels)
    with torch.no_grad():
        got = tc(torch.as_tensor(x), torch.as_tensor(hint), torch.as_tensor(t), torch.as_tensor(context),
                 max_levels=max_levels)
    assert len(got) == len(ref) == (max_levels or len(jc.unet.input_chans) + 1)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert rel_err(g.numpy(), np.asarray(r)) < TOL


@pytest.fixture(scope="module")
def ddpm():
    jm, tm = _pair(DDPM, cflearn_torch.DDPM, 3, img_size=LATENT, num_timesteps=50, unet_config=UNET)
    return jm, bridged(jm, tm)


def _port_denoise(tm, x, t, cond, **kw):
    with torch.no_grad():
        cond = {k: torch.as_tensor(v) for k, v in cond.items()} if isinstance(cond, dict) else torch.as_tensor(cond)
        return tm.denoise(torch.as_tensor(x), torch.as_tensor(t), cond, **kw).numpy()


def test_denoise_one_control(ddpm, control):
    (jm, tm), (jc, tc) = ddpm, control
    x, hint, context, t = _inputs(4)
    base = np.asarray(jm.denoise(jnp.asarray(x), jnp.asarray(t), jnp.asarray(context)))
    ref = jm.denoise(jnp.asarray(x), jnp.asarray(t), jnp.asarray(context), control_net=jc, control_hint=jnp.asarray(hint))
    got = _port_denoise(tm, x, t, context, control_net=tc, control_hint=torch.as_tensor(hint))
    assert rel_err(got, np.asarray(ref)) < TOL
    assert rel_err(np.asarray(ref), base) > 1e-2  # the control moves the output


def test_denoise_two_controls_scales_gates(ddpm, control):
    """Two controls summed, each at its per-level scales and its gate; the
    same call with one gate closed equals the other control alone."""
    (jm, tm), (jc1, tc1) = ddpm, control
    jc2, tc2 = _control_pair(5)
    x, hint1, context, t = _inputs(6)
    hint2 = _inputs(7)[1]
    n = len(jc1.unet.input_chans) + 1
    scales = [[0.5 + 0.1 * i for i in range(n)], [1.5] * n]
    for gates in ([1.0, 1.0], [0.0, 1.0]):
        ref = jm.denoise(
            jnp.asarray(x), jnp.asarray(t), jnp.asarray(context), control_net=[jc1, jc2],
            control_hint=[jnp.asarray(hint1), jnp.asarray(hint2)], control_scales=scales, control_gates=gates,
        )
        got = _port_denoise(tm, x, t, context, control_net=[tc1, tc2],
                            control_hint=[torch.as_tensor(hint1), torch.as_tensor(hint2)], control_scales=scales,
                            control_gates=gates)
        assert rel_err(got, np.asarray(ref)) < TOL, gates
    alone = _port_denoise(tm, x, t, context, control_net=[tc2], control_hint=[torch.as_tensor(hint2)],
                          control_scales=[scales[1]])
    assert rel_err(got, alone) < TOL


def test_deepcache_shallow_pass(ddpm, control):
    """A full pass that returns the cache, then a shallow pass on it: the
    control computes only the cut + 1 residuals it takes."""
    (jm, tm), (jc, tc) = ddpm, control
    x, hint, context, t = _inputs(8)
    jm.deepcache_cut = tm.deepcache_cut = 1
    try:
        _, jcache = jm.denoise(jnp.asarray(x), jnp.asarray(t), jnp.asarray(context), control_net=jc,
                               control_hint=jnp.asarray(hint), return_cache=True)
        ref, _ = jm.denoise(jnp.asarray(x) * 0.9, jnp.asarray(t), jnp.asarray(context), control_net=jc,
                            control_hint=jnp.asarray(hint), deep_cache=jcache, return_cache=True)
        with torch.no_grad():
            _, tcache = tm.denoise(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(context), control_net=tc,
                                   control_hint=torch.as_tensor(hint), return_cache=True)
            assert rel_err(tcache.numpy(), np.asarray(jcache)) < TOL
            calls = []
            hook = tc.register_forward_hook(lambda mod, args, kwargs, out: calls.append(len(out)), with_kwargs=True)
            got, _ = tm.denoise(torch.as_tensor(x) * 0.9, torch.as_tensor(t), torch.as_tensor(context), control_net=tc,
                                control_hint=torch.as_tensor(hint), deep_cache=tcache, return_cache=True)
            hook.remove()
    finally:
        jm.deepcache_cut = tm.deepcache_cut = 3
    assert calls == [2]
    assert rel_err(got.numpy(), np.asarray(ref)) < TOL


def test_four_channel_control_on_inpainting_unet():
    """A 9-channel UNet on the hybrid condition (mask and masked latents
    joined to the latents): the 4-channel control sees the leading 4."""
    unet9 = dict(UNET, in_channels=9)
    jm, tm = _pair(DDPM, cflearn_torch.DDPM, 9, img_size=LATENT, num_timesteps=50, in_channels=9, out_channels=4,
                   condition_type="hybrid", unet_config=unet9)
    bridged(jm, tm)
    jc, tc = _control_pair(11)
    x, hint, context, t = _inputs(12)
    concat = np.random.RandomState(13).randn(2, LATENT, LATENT, 5).astype(np.float32)
    cond = {"concat": concat, "cross_attn": context}
    ref = jm.denoise(jnp.asarray(x), jnp.asarray(t), {k: jnp.asarray(v) for k, v in cond.items()}, control_net=jc,
                     control_hint=jnp.asarray(hint))
    got = _port_denoise(tm, x, t, cond, control_net=tc, control_hint=torch.as_tensor(hint))
    assert got.shape == (2, LATENT, LATENT, 4)
    assert rel_err(got, np.asarray(ref)) < TOL
