"""Helpers for the port's parity tests: carry a JAX module's parameters into
its `cflearn_torch` counterpart and feed both the same numpy inputs."""

import contextlib
import urllib.request
from pathlib import Path
from typing import Dict

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from cflearn_torch.bridge import load_nnx_params

# The CPU parity tests run several processes to a machine (pytest-xdist). PyTorch's intra-op pool, one thread
# per core in each process, then oversubscribes the cores, and a tiny model's many small ops wait on descheduled
# threads: one CPU training test took 54 s in a six-worker run and 0.8 s alone. One intra-op thread per test
# process. An xdist worker imports every test module when it collects, so this holds for every file it runs.
DEFAULT_THREADS = torch.get_num_threads()
torch.set_num_threads(1)

# The tests run without a network and must never reach for one: both packages' `download` fetches a checkpoint
# that is missing from its cache or fails its sha through `urllib.request.urlretrieve`. Every URL but a local
# `file://` one is refused in every process that imports this module (an xdist worker imports them all).
_urlretrieve = urllib.request.urlretrieve


def _local_only(url, *args, **kwargs):
    if not str(url).startswith("file://"):
        raise OSError(f"the tests fetch nothing from the network: {url}")
    return _urlretrieve(url, *args, **kwargs)


urllib.request.urlretrieve = _local_only


@contextlib.contextmanager
def empty_cache(root, monkeypatch):
    """The port's `OPT.cache_dir` at `root`, empty, inside the block, and the download retries not slept: a
    pretrained load there finds no file, its fetch is refused, and the error names the path."""
    import time

    from cflearn_torch.parameters import OPT

    monkeypatch.setattr(time, "sleep", lambda s: None)
    with OPT.opt_context({"cache_dir": str(root)}):
        yield Path(root) / "download"


@contextlib.contextmanager
def default_threads():
    """PyTorch's own intra-op thread count (one per core) inside the block: for a comparison that holds only
    under the summation order of that count (see `tests/test_torch_serve_slice.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def flat_params(module: nnx.Module) -> Dict[str, np.ndarray]:
    """`nnx.state(module, nnx.Param)` as {dotted path: numpy array}."""
    return {
        ".".join(map(str, path)): np.asarray(var[...])
        for path, var in nnx.to_flat_state(nnx.state(module, nnx.Param))
    }


def flat_shapes(module: nnx.Module) -> Dict[str, tuple]:
    return {
        ".".join(map(str, path)): tuple(var.get_value().shape)
        for path, var in nnx.to_flat_state(nnx.state(module, nnx.Param))
    }


def dezero(module: nnx.Module, seed: int = 7, std: float = 0.05) -> nnx.Module:
    """Redraw the all-zero kernels (UNet conv_out, resblock conv2) with small
    seeded noise, so that every branch carries signal into the output."""
    rng = np.random.RandomState(seed)
    for path, var in nnx.to_flat_state(nnx.state(module, nnx.Param)):
        value = var[...]
        if path[-1] == "kernel" and not np.any(np.asarray(value)):
            var[...] = jnp.asarray(rng.randn(*value.shape) * std, value.dtype)
    return module


def bridged(jax_module: nnx.Module, port_module: torch.nn.Module) -> torch.nn.Module:
    return load_nnx_params(port_module, flat_params(jax_module)).eval()


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
