"""Helpers for the CV parity tests (`test_torch_cv_*.py`): JAX modules built
abstractly and filled from numpy, so that no random initialiser is
compiled; their state carried into the port through the bridge; JAX calls
compiled once as one program rather than op by op."""

from typing import Any, Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from cflearn_torch.bridge import state_dict_from_jax

F32 = 1e-5  # f32 against f32: another summation order, relative to the largest output


def fast_build(ctor: Callable[[], Any], seed: int = 0, constants: Callable[[tuple], np.ndarray] = None) -> Any:
    """`ctor()` traced by `nnx.eval_shape`, then every variable filled:
    parameters ~ N(0, 1 / fan_in) (1-D ones N(0, 1)), BatchNorm means ~
    N(0, 0.1^2) and variances in [0.5, 1.5) (so that eval mode reads
    statistics away from (0, 1)), random streams at key `seed`, count 0,
    and other variables (fixed kernels, masks) by `constants(path)`."""
    m = nnx.eval_shape(ctor)
    rng = np.random.RandomState(seed)
    for path, var in nnx.to_flat_state(nnx.state(m)):
        v = var.get_value()
        shape, dtype = v.shape, v.dtype
        if isinstance(var, nnx.RngKey):
            var.set_value(jax.random.key(seed))
        elif isinstance(var, nnx.RngCount):
            var.set_value(jnp.zeros(shape, dtype))
        elif isinstance(var, nnx.BatchStat):
            value = rng.rand(*shape) + 0.5 if path[-1] == "var" else rng.randn(*shape) * 0.1
            var.set_value(jnp.asarray(value.astype(np.float32)))
        elif isinstance(var, nnx.Param):
            fan = max(1, int(np.prod(shape[:-1])))
            var.set_value(jnp.asarray((rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)))
        elif constants is not None:
            var.set_value(jnp.asarray(constants(path)))
        else:
            raise TypeError(f"{path}: {type(var).__name__} has no filler; pass `constants`")
    return m


def jax_state(m: nnx.Module) -> Dict[str, np.ndarray]:
    """Every variable of `m` but the random streams, by "/"-joined path."""
    return {
        "/".join(map(str, path)): np.asarray(var[...])
        for path, var in nnx.to_flat_state(nnx.state(m))
        if not isinstance(var, nnx.RngState)
    }


def pair(jm: nnx.Module, tm: torch.nn.Module) -> torch.nn.Module:
    """`tm` with `jm`'s state, strict both ways (`load_state_dict` of the bridged dict)."""
    tm.load_state_dict(state_dict_from_jax(jax_state(jm), tm))
    return tm


def rand(seed: int, *shape: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# XLA:CPU at its lowest optimisation level: these programs run once, on tiny inputs, and compile in
# about half the time (the arithmetic is the same f32 operations)
FAST_COMPILE = {"xla_backend_optimization_level": "0"}


def _refresh(state: Any) -> Any:
    return jax.tree_util.tree_map(lambda a: a, state)


def jcall(jm: nnx.Module, *arrays: Any, method: str = "__call__", **kwargs: Any) -> Any:
    """`jm.<method>(*arrays, **kwargs)` as one compiled program, a pure
    function of the module's state; the state after it (BatchNorm's
    statistics, the streams) written back."""
    gd, state = nnx.split(jm)

    def fn(state: Any, *args: Any) -> Any:
        m = nnx.merge(gd, _refresh(state))
        out = getattr(m, method)(*args, **kwargs)
        return out, nnx.split(m)[1]

    out, new_state = jax.jit(fn, compiler_options=FAST_COMPILE)(state, *(jnp.asarray(a) for a in arrays))
    nnx.update(jm, new_state)
    return out


def both(
    jm: nnx.Module, tm: torch.nn.Module, *arrays: Any, training: bool = False, method: str = "__call__", **kwargs: Any
) -> Any:
    """The JAX (compiled) and the port module's `method` on the same numpy inputs, in one mode."""
    (jm.train if training else jm.eval)()
    tm.train(training)
    ref = jcall(jm, *arrays, method=method, **kwargs)
    with torch.no_grad():
        got = (tm if method == "__call__" else getattr(tm, method))(
            *(torch.from_numpy(np.asarray(a)) for a in arrays), **kwargs)
    return got, ref


def jax_train_steps(jm: Any, batch: Dict[str, Any], lr: float) -> Any:
    """One step of the JAX model's train steps in order, as its `Trainer`'s
    step function runs them (one compiled program a scope here): the
    scope's forward (`run(training=True)`) and loss under `jax.grad` over
    `params_filter(scope)`, the model's other state taken over from the
    forward, then plain SGD at `lr`. Returns {scope: (loss items, flat
    gradients by dotted path)}; `jm` holds the state after the step."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm.set_mode(True)
    out = {}
    for ts in jm.train_steps:
        flt = jm.params_filter(ts.scope)
        gd, diff, rest = nnx.split(jm, flt, ...)

        def loss_fn(diff, rest, _gd=gd, _ts=ts, _flt=flt):
            m = nnx.merge(_gd, _refresh(diff), _refresh(rest))
            losses = _ts.loss_fn(m, jbatch, m.run(jbatch, training=True))
            _, _, new_rest = nnx.split(m, _flt, ...)
            return losses["loss"], (losses, new_rest)

        grads, (losses, new_rest) = jax.jit(jax.grad(loss_fn, has_aux=True), compiler_options=FAST_COMPILE)(diff, rest)
        new_diff = jax.tree_util.tree_map(lambda p, g: p - lr * g, diff, grads)
        nnx.update(jm, new_diff, _refresh(new_rest))
        flat = {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(grads)}
        out[ts.scope] = ({k: float(v) for k, v in losses.items()}, flat)
    return out


def stream_draws(jm: Any, n: int) -> list:
    """The next `n` keys the JAX model's generator module draws from its
    "default" stream (an `nnx.Rngs` stream hands out fold_in(key, count)
    and counts up; "gp", which no stream is named, falls back to it)."""
    stream = jm.m.rngs.default
    key, count = stream.key[...], int(stream.count[...])
    return [jax.random.fold_in(key, count + i) for i in range(n)]


def jrun(jm: Any, batch: Dict[str, Any], training: bool = False) -> Dict[str, Any]:
    """`jm.run(batch, training=...)` compiled, as a pure function of the
    model's state; the state after it (statistics, streams) written back."""
    jm.set_mode(training)
    gd, state = nnx.split(jm)

    def fn(state):
        m = nnx.merge(gd, _refresh(state))
        out = m.run({k: jnp.asarray(v) for k, v in batch.items()}, training=training)
        return out, nnx.split(m)[1]

    out, new_state = jax.jit(fn, compiler_options=FAST_COMPILE)(state)
    nnx.update(jm, new_state)
    return out
