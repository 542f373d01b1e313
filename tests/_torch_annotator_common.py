"""Helpers for the port's annotator tests (`test_torch_annotators.py`,
`test_torch_annotator_nets.py`, `test_torch_annotator_mlsd.py`,
`test_torch_annotator_openpose.py`, `..._openpose_hand.py`): the
JAX nets are built by `nnx.eval_shape` and filled from numpy
(`_torch_cv_common.fast_build`), run under `nnx.jit`, and carried across by
the bridge into port nets built on "meta" (`load_state_dict(assign=True)`,
strict).

Tolerances: a net's f32 output, 1e-4 x max|JAX| (summation order through up
to 30 layers); a uint8 hint, one level on at most 0.1% of the values."""

import numpy as np
import pytest
import torch
from flax import nnx

import _torch_bridge_common  # noqa: F401  (one intra-op thread a test process)
from cflearn_tpu.toolkit.tree import tree_to_npd

TOL = 1e-4
MAX_SHARE = 1e-3


def rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


_FORWARD = nnx.jit(lambda m, x: m(x))  # one jitted function: a second net of the same structure reuses its program


def jitted(jn):
    """`jn`'s forward under `nnx.jit`, as a plain callable (what a JAX annotator calls its net with)."""
    return lambda x: _FORWARD(jn, x)


def npd(jn, batch_stats=False):
    return tree_to_npd(nnx.state(jn, (nnx.Param, nnx.BatchStat) if batch_stats else nnx.Param))


def as_numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def save(tmp_path, name, sd):
    path = str(tmp_path / name)
    torch.save({k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    return path


def port(ctor, sd):
    """`ctor()` built on "meta" and given `sd` (strict)."""
    with torch.device("meta"):
        net = ctor()
    net.load_state_dict(sd, strict=True, assign=True)
    return net.eval()


def run(net, x):
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


def uint8_close(got, ref, max_share=MAX_SHARE, max_level=1):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= max_level and (diff > 0).mean() <= max_share, (diff.max(), (diff > 0).mean())


def image(seed, h, w):
    """A smooth uint8 test image."""
    rng = np.random.RandomState(seed)
    low = rng.uniform(0, 255, (h // 8, w // 8, 3)).astype(np.float32)
    return np.clip(np.kron(low, np.ones((8, 8, 1))) + rng.uniform(-20, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def same_state(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)


def openpose_matches_jax(pair, convert, load, tmp_path, file_route) -> None:
    """An OpenPose net's bridge (`convert` gives the JAX parameters back), forward (1e-4), flat caffe names
    (from a file or a state dict) and a stray key raising."""
    jn, params, tn = pair
    sd = as_numpy(tn.state_dict())
    back = convert(sd)
    assert set(back) == set(params) and all(np.array_equal(back[k], params[k]) for k in params)
    x = np.random.RandomState(14).uniform(-0.5, 0.5, (1, 64, 64, 3)).astype(np.float32)
    ref = jitted(jn)(x)
    got = run(tn, x)
    for r, g in zip(ref if isinstance(ref, tuple) else (ref,), got if isinstance(got, tuple) else (got,)):
        assert g.shape == np.asarray(r).shape and rel(g, r) < TOL
    # the hosted checkpoints' flat caffe names (`conv1_1.weight`), from a file or a state dict
    flat = {k.split(".", 1)[1]: torch.from_numpy(v) for k, v in sd.items()}
    assert len(flat) == len(sd)
    assert same_state(load(save(tmp_path, "flat.pth", flat), device="cpu") if file_route else
                      load(state_dict=flat, device="cpu"), tn)
    with pytest.raises(KeyError, match="map to no parameter"):
        load(state_dict=dict(flat, stray=torch.zeros(1)), device="cpu")
