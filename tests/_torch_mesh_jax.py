"""The JAX side of the mesh tests: the JAX model of a port config, its
placement on the 8 virtual devices of `tests/conftest.py`, the initial
states carried into the port, and the draws the JAX DDPM step makes."""

from typing import Any, Dict, List, Tuple

import jax
import numpy as np
from flax import nnx

from cflearn_torch.schema import IDLModel
from cflearn_tpu.schema import DLConfig as JDLConfig
from cflearn_tpu.schema.config import MeshConfig as JMeshConfig
from cflearn_tpu.schema.model import IDLModel as JIDLModel
from cflearn_tpu.toolkit.tree import _key_entry_to_str


def jax_model(config: Any) -> Any:
    """The JAX `IDLModel` of a port `DLConfig` (its optimizer settings left out)."""
    jc = JDLConfig()
    jc.from_info({k: v for k, v in config.to_info().items() if k != "optimizer_settings"})
    return JIDLModel.from_config(jc)


def port_init(config: Any, path: str) -> Any:
    """The port model of `config` holding the JAX model's initial states
    (through the bridge), written to the npz file `path`; returns the JAX model."""
    jm = jax_model(config)
    pm = IDLModel.from_config(config, device="cpu")
    pm.load_state_dict(jm.state_dict())
    np.savez(path, **{k: v.numpy() for k, v in pm.state_dict().items()})
    return jm


def jax_mesh(**axes: int) -> Any:
    from cflearn_tpu.parallel.mesh import make_mesh

    mc = JMeshConfig()
    mc.from_info(axes)
    return make_mesh(mc)


def jax_placement(jm: Any, mesh: Any, **kwargs: Any) -> Dict[str, Tuple[Any, ...]]:
    """{JAX parameter key ("m/.../kernel/value"): its spec after
    `cflearn_tpu.parallel.tp.place_params`, one entry per dimension}."""
    from cflearn_tpu.parallel.tp import place_params

    placed = place_params(nnx.state(jm, nnx.Param), mesh, **kwargs)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        key = "/".join(_key_entry_to_str(p) for p in path)
        spec = tuple(leaf.sharding.spec) + (None,) * (leaf.ndim - len(tuple(leaf.sharding.spec)))
        out[key if key.endswith("/value") else key + "/value"] = spec
    return out


def ddpm_draws(jm: Any, steps: int, batch: int, shape: Tuple[int, ...]) -> List[np.ndarray]:
    """The t and noise draws of the JAX DDPM train steps, in order: each
    step draws once in its monitoring forward, then t and noise in the loss
    (`cflearn_tpu/models/cv/diffusion.py`), from the "default" stream."""
    stream = jm.m.rngs.default
    key, count = stream.key[...], int(stream.count[...])
    out = []
    for s in range(steps):
        base = count + 3 * s + 1
        out.append(np.asarray(jax.random.randint(jax.random.fold_in(key, base), (batch,), 0, jm.m.num_timesteps)))
        out.append(np.asarray(jax.random.normal(jax.random.fold_in(key, base + 1), shape, np.float32)))
    return out


def port_params(jflat: Dict[str, np.ndarray], module: Any) -> Dict[str, np.ndarray]:
    """`_parity_common.run_workload`'s flat JAX parameters of `model.m` in the
    port's names ("m." + name) and layouts."""
    from cflearn_torch.bridge import tree_from_nnx

    flat = {(k[: -len("/value")] if k.endswith("/value") else k).replace("/", "."): v for k, v in jflat.items()}
    return {f"m.{k}": v.numpy() for k, v in tree_from_nnx(flat, module).items()}
