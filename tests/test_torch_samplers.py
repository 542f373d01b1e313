"""Every registered sampler of the port against the JAX package's, on a
stub model written once in jnp and once in torch (`denoise`,
`predict_eps_from`, `q_sample`, `schedule_info`, the DeepCache settings),
so that the sampler math runs alone: CFG, the hybrid dict condition, the
guidance interval, `start_step` / `sample_from`, the control-gate segments,
DeepCache, and the v-parameterization (the k-samplers' fractional t). The
stochastic samplers (ddim at eta 0.5, `basic`, `k_euler_a`, `lcm`, every
`sample_from`) take the JAX package's own draws through the port's noise
seam, `ISampler._randn`: the test makes them with the JAX samplers'
`jax.random.split` / `fold_in` calls, in their order. f32 throughout; the
JAX samplers run as the package runs them (a `lax.scan` per segment).
Tolerance: 1e-5 of max|JAX| (f32 rounding of a few dozen operations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge_common import rel_err
from cflearn_torch.modules.multimodal.diffusion import samplers as TS
from cflearn_tpu.modules.multimodal.diffusion import samplers as JS
from cflearn_tpu.modules.multimodal.diffusion.ddpm import make_beta_schedule

TOL = 1e-5
SHAPE = (2, 6, 6, 4)
INFO = {"schedule": "linear", "num_timesteps": 1000, "linear_start": 0.00085, "linear_end": 0.012}
ACP = np.cumprod(1.0 - make_beta_schedule("linear", 1000, linear_start=0.00085, linear_end=0.012))


class _Stub:
    """A closed-form denoiser: tanh of the input, the condition's mean, t,
    the control hints' means (gated) and the DeepCache feature."""

    def __init__(self, xp, parameterization="eps", deepcache_interval=None):
        self.xp = xp
        self.parameterization = parameterization
        self.schedule_info = dict(INFO)
        self.deepcache_interval = deepcache_interval
        self.deepcache_cut = 1
        self.deepcache_center = None
        self.sa = self._buf(np.sqrt(ACP))
        self.so = self._buf(np.sqrt(1.0 - ACP))

    def _buf(self, v):
        return jnp.asarray(v, jnp.float32) if self.xp is jnp else torch.tensor(v, dtype=torch.float32)

    def _coef(self, buf, t):
        return buf[t].reshape(-1, 1, 1, 1)

    def _mean(self, a, axes):
        return a.mean(axis=axes) if self.xp is jnp else a.mean(dim=axes)

    def denoise(self, x, t, cond, *, control_hint=None, control_gates=None, deep_cache=None, return_cache=False):
        xp = self.xp
        if isinstance(cond, dict):
            c = self._mean(cond["cross_attn"], 1) + self._mean(cond["concat"], (1, 2))
        else:
            c = self._mean(cond, 1)
        tf = t.astype(jnp.float32) if xp is jnp else t.float()
        h = 0.5 * x + 0.3 * c[:, None, None, :] + 1e-3 * tf[:, None, None, None]
        if control_hint is not None:
            hints = control_hint if isinstance(control_hint, (list, tuple)) else [control_hint]
            for i, hint in enumerate(hints):
                g = 1.0 if control_gates is None else control_gates[i]
                h = h + (0.2 + 0.1 * i) * g * self._mean(hint, (1, 2, 3))[:, None, None, None]
        if deep_cache is not None:
            h = h + 0.2 * deep_cache
        out = xp.tanh(h)
        if return_cache:
            return out, (0.5 * x if deep_cache is None else deep_cache)
        return out

    def predict_eps_from(self, x_t, t, out):
        if self.parameterization == "eps":
            return out
        return self._coef(self.sa, t) * out + self._coef(self.so, t) * x_t

    def q_sample(self, x0, t, noise):
        return self._coef(self.sa, t) * x0 + self._coef(self.so, t) * noise


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    z = rng.randn(*SHAPE).astype(np.float32)
    cond = rng.randn(2, 3, 4).astype(np.float32)
    uncond = rng.randn(2, 3, 4).astype(np.float32)
    hints = [rng.randn(2, 12, 12, 3).astype(np.float32) for _ in range(2)]
    return z, cond, uncond, hints


def _normal(key, shape=SHAPE):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _fed(monkeypatch, draws):
    """Route the port's draws to `draws`, in order; returns the iterator."""
    it = iter(draws)

    def randn(self, shape, like, generator):
        value = next(it)
        assert tuple(value.shape) == tuple(shape)
        return torch.tensor(np.array(value), dtype=like.dtype, device=like.device)

    monkeypatch.setattr(TS.ISampler, "_randn", randn)
    return it


def _split_draws(key, n, shape=SHAPE):
    return [_normal(k, shape) for k in jax.random.split(key, n)]


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return None if tree is None else torch.as_tensor(np.asarray(tree))


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return None if tree is None else jnp.asarray(tree)


_STATIC = ("num_steps", "guidance_scale", "start_step", "control_hint_start", "control_hint_end")


def _args(kwargs, convert):
    return {k: (v if k in _STATIC else convert(v)) for k, v in kwargs.items()}


def _run_both(name, config, call, kwargs, *, parameterization="eps", monkeypatch=None, draws=None):
    """Run `call` ("sample" / "sample_from") of sampler `name` on both
    sides; `draws(key)` lists the JAX sampler's draws, fed to the port."""
    js = JS.ISampler.make(name, dict(config, model=_Stub(jnp, parameterization)))
    ts = TS.ISampler.make(name, dict(config, model=_Stub(torch, parameterization)))
    first = "z" if call == "sample" else "x0"
    key = jax.random.PRNGKey(3)
    jargs, targs = _args(kwargs, _to_jax), _args(kwargs, _to_torch)
    ref = np.asarray(getattr(js, call)(jargs.pop(first), key=key, **jargs))
    it = None if draws is None else _fed(monkeypatch, draws(key))
    got = getattr(ts, call)(targs.pop(first), **targs).numpy()
    if it is not None:
        assert next(it, None) is None, "the port drew fewer samples than the JAX sampler used"
    assert got.shape == ref.shape and np.isfinite(got).all()
    return got, ref


ALL = sorted(JS.ISampler.d)


def test_same_registry():
    assert sorted(TS.ISampler.d) == ALL == [
        "basic", "ddim", "k_dpmpp_2m", "k_euler", "k_euler_a", "k_heun", "klms", "lcm", "plms", "solver",
    ]


def _stochastic_draws(name, n, start_step=0):
    """The JAX sampler's draws for a plain (unsegmented) `sample`."""
    if name in ("ddim", "basic"):
        return lambda key: _split_draws(key, n - start_step)
    if name == "k_euler_a":
        return lambda key: _split_draws(key, n - start_step)
    if name == "lcm":
        return lambda key: _split_draws(key, n - start_step)[:-1]  # the last step's is unused
    return None


@pytest.mark.parametrize("name", ALL)
def test_sample_cfg(name, monkeypatch):
    z, cond, uncond, _ = _inputs()
    config = {"eta": 0.5} if name == "ddim" else {}
    steps = 4 if name == "lcm" else 5
    got, ref = _run_both(
        name, config, "sample", dict(z=z, cond=cond, uncond=uncond, guidance_scale=4.0, num_steps=steps),
        monkeypatch=monkeypatch, draws=_stochastic_draws(name, steps),
    )
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("name", ["ddim", "basic", "plms", "k_euler", "k_euler_a", "k_heun", "klms", "k_dpmpp_2m"])
def test_guidance_interval(name, monkeypatch):
    """CFG only on steps [round(0.25 n), round(0.7 n)): three segments, the
    multistep histories and the k-samplers' per-segment keys threaded."""
    z, cond, uncond, _ = _inputs(1)
    n = 6
    draws = None
    if name in ("ddim", "basic"):
        draws = lambda key: _split_draws(key, n)  # noqa: E731
    elif name == "k_euler_a":
        # segments [0, 2), [2, 4), [4, 6): the first takes the key, the others fold_in(key, start)
        draws = lambda key: sum(  # noqa: E731
            (_split_draws(key if a == 0 else jax.random.fold_in(key, a), b - a) for a, b in ((0, 2), (2, 4), (4, 6))), []
        )
    config = {"guidance_interval": (0.25, 0.7), **({"eta": 0.5} if name == "ddim" else {})}
    got, ref = _run_both(
        name, config, "sample",
        dict(z=z, cond=cond, uncond=uncond, guidance_scale=5.0, num_steps=n), monkeypatch=monkeypatch, draws=draws,
    )
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("name", ["ddim", "plms", "k_euler", "k_euler_a", "lcm", "solver"])
def test_sample_from(name, monkeypatch):
    """img2img: q-sample (or sigma-scale) x0 to the start step on the
    sampler's own grid, then sample from there; the first draw is the
    q-sample's (the first key of a split), the sampler's from the second."""
    x0, cond, uncond, _ = _inputs(2)
    n = 4 if name == "lcm" else 6
    start = 2 if name != "lcm" else 1

    def draws(key):
        k1, k2 = jax.random.split(key)
        rest = {"k_euler_a": lambda: _split_draws(k2, n - start), "lcm": lambda: _split_draws(k2, n - start)[:-1]}
        return [_normal(k1)] + rest.get(name, lambda: [])()

    got, ref = _run_both(
        name, {}, "sample_from",
        dict(x0=x0, cond=cond, uncond=uncond, guidance_scale=3.0, num_steps=n, start_step=start),
        monkeypatch=monkeypatch, draws=draws,
    )
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("name", ["ddim", "plms", "k_euler", "k_heun", "klms", "k_dpmpp_2m", "lcm", "solver"])
def test_control_gates(name, monkeypatch):
    """Two hints, batched under CFG, each gated on between its start and end
    fractions: the gate matrix segments plms and the k-samplers (histories
    threaded), and rides each step of ddim / lcm / the solver."""
    z, cond, uncond, hints = _inputs(3)
    n = 4 if name == "lcm" else 6
    got, ref = _run_both(
        name, {}, "sample",
        dict(z=z, cond=cond, uncond=uncond, guidance_scale=2.5, num_steps=n, control_hint=hints,
             control_hint_start=[0.2, None], control_hint_end=[None, 0.6]),
        monkeypatch=monkeypatch, draws=(lambda key: _split_draws(key, n)[:-1]) if name == "lcm" else None,
    )
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("name", ["k_euler", "k_heun", "k_dpmpp_2m", "solver", "plms"])
def test_v_parameterization(name):
    """v-prediction: `predict_eps_from` indexes the schedule with t, which
    the k-samplers and the solver give as a float and `_denoise` truncates."""
    z, cond, uncond, _ = _inputs(4)
    got, ref = _run_both(
        name, {}, "sample", dict(z=z, cond=cond, uncond=uncond, guidance_scale=3.0, num_steps=5), parameterization="v",
    )
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize(
    "config",
    [dict(order=3), dict(order=3, thresholding=True, threshold_max_val=0.5), dict(order=1, predict_x0=False),
     dict(order=2, skip_type="logSNR"), dict(order=3, skip_type="time_quadratic", predict_x0=False),
     dict(order=2, schedule="cosine")],
    ids=["order3", "thresholding", "order1_eps", "logSNR", "quadratic_eps", "cosine"],
)
def test_solver_options(config):
    z, cond, uncond, _ = _inputs(5)
    got, ref = _run_both("solver", config, "sample", dict(z=z, cond=cond, uncond=uncond, guidance_scale=2.0, num_steps=6))
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("center", [None, 0.4])
def test_ddim_deepcache_with_guidance_interval(center):
    """DeepCache on the ddim loop: full and shallow passes by the refresh
    mask, restarted in each guidance-interval segment."""
    z, cond, uncond, _ = _inputs(6)
    jm, tm = _Stub(jnp, deepcache_interval=2), _Stub(torch, deepcache_interval=2)
    jm.deepcache_center = tm.deepcache_center = center
    config = {"guidance_interval": (0.2, 0.8)}
    ref = JS.ISampler.make("ddim", dict(config, model=jm)).sample(
        jnp.asarray(z), cond=jnp.asarray(cond), uncond=jnp.asarray(uncond), guidance_scale=3.0, num_steps=10
    )
    got = TS.ISampler.make("ddim", dict(config, model=tm)).sample(
        torch.as_tensor(z), cond=torch.as_tensor(cond), uncond=torch.as_tensor(uncond), guidance_scale=3.0, num_steps=10
    )
    assert rel_err(got.numpy(), np.asarray(ref)) < TOL


def _hybrid(cond, seed):
    rng = np.random.RandomState(seed)
    return {"cross_attn": cond, "concat": rng.randn(2, 6, 6, 4).astype(np.float32)}


def test_denoise_hybrid_cfg_with_hints():
    """`_denoise` under CFG with the hybrid dict condition (each entry
    batched) and a list of control hints (each batched), as the 9-channel
    inpainting path calls it: a `torch.cat` of the two dicts would raise."""
    z, cond, uncond, hints = _inputs(7)
    c, u = _hybrid(cond, 1), _hybrid(uncond, 2)
    t = np.array([500, 500])
    jm, tm = _Stub(jnp), _Stub(torch)
    ref = JS.ISampler(jm)._denoise(
        jnp.asarray(z), jnp.asarray(t), _to_jax(c), _to_jax(u), 7.5, control_hint=_to_jax(hints),
        control_gates=[1.0, 0.0],
    )
    got = TS.ISampler(tm)._denoise(
        torch.as_tensor(z), torch.as_tensor(t), _to_torch(c), _to_torch(u), 7.5, control_hint=_to_torch(hints),
        control_gates=[1.0, 0.0],
    )
    assert rel_err(got.numpy(), np.asarray(ref)) < TOL
    # one hint tensor, not a list, is batched too
    ref1 = JS.ISampler(jm)._denoise(jnp.asarray(z), jnp.asarray(t), _to_jax(c), _to_jax(u), 7.5,
                                    control_hint=jnp.asarray(hints[0]))
    got1 = TS.ISampler(tm)._denoise(torch.as_tensor(z), torch.as_tensor(t), _to_torch(c), _to_torch(u), 7.5,
                                    control_hint=torch.as_tensor(hints[0]))
    assert rel_err(got1.numpy(), np.asarray(ref1)) < TOL


@pytest.mark.parametrize("name", ["ddim", "k_euler", "plms"])
def test_sample_hybrid_cfg(name):
    """A whole loop on the hybrid condition under CFG (the 9-channel
    inpainting path's condition)."""
    z, cond, uncond, _ = _inputs(8)
    got, ref = _run_both(
        name, {}, "sample",
        dict(z=z, cond=_hybrid(cond, 3), uncond=_hybrid(uncond, 4), guidance_scale=7.5, num_steps=4),
    )
    assert rel_err(got, ref) < TOL


def test_schedule_helpers():
    """The host-side pieces: `_start_timestep` on each grid, the k-samplers'
    sigmas and sigma -> t map, the gate matrix, and `DDPMQSampler`."""
    jm, tm = _Stub(jnp), _Stub(torch)
    for name in ALL:
        js, ts = JS.ISampler.make(name, {"model": jm}), TS.ISampler.make(name, {"model": tm})
        for n, s in ((20, 0), (20, 4), (7, 6), (4, 1)):
            assert ts._start_timestep(n, s) == js._start_timestep(n, s), (name, n, s)
        np.testing.assert_array_equal(ts._np_acp(), js._np_acp())
        if isinstance(js, JS.IKSampler):
            for a, b in zip(ts._sigmas(9, 2), js._sigmas(9, 2)):
                np.testing.assert_array_equal(a, b)
            sig = np.array([14.0, 3.0, 0.5, 0.0])
            np.testing.assert_array_equal(ts._t_at(sig), js._t_at(sig))
        kw = {"control_hint": [1, 2], "control_hint_start": [0.25, None], "control_hint_end": 0.5}
        tkw, tg = ts._pop_control_gate_schedule(dict(kw), 8)
        jkw, jg = js._pop_control_gate_schedule(dict(kw), 8)
        np.testing.assert_array_equal(tg, jg)
        assert sorted(tkw) == sorted(jkw) == ["control_hint"]
    x0 = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
    noise = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)
    t = np.array([10, 900])
    got = TS.DDPMQSampler(tm).q_sample(torch.as_tensor(x0), torch.as_tensor(t), torch.as_tensor(noise))
    ref = JS.DDPMQSampler(jm).q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    assert rel_err(got.numpy(), np.asarray(ref)) < TOL
