"""The toolkit helpers and constants of the JAX package's surface in the
port (`cflearn_torch/toolkit/misc.py`), each held to its JAX counterpart
(`cflearn_tpu/toolkit/misc.py`) on the same inputs, made from a seed with
numpy, on the CPU.

Tolerances: AdaIN and the spatial statistics within 1e-6 of max|JAX| (f32
sums in another order); everything else exactly (the same numpy arithmetic,
copies, names, hashes). The JAX-only names and their PyTorch names
(`tests/test_torch_surface.py`'s rename table): `new_rng_key` ->
`new_generator` (both seeded from `get_seed()`), `np_batch_to_jax` /
`jax_batch_to_np` -> `np_batch_to_tensor` / `tensor_batch_to_np`,
`to_jax_dtype` -> `to_device_dtype`: the JAX function narrows f64 to f32
and i64 to i32, the port's f64 to f32 only (PyTorch indexes with i64)."""

import os

import jax
import numpy as np
import pytest
import torch
from flax import nnx

import _torch_bridge_common  # noqa: F401  (one thread a process, no network)
from cflearn_torch import constants as TK
from cflearn_torch.toolkit import misc as TM
from cflearn_tpu import constants as JK
from cflearn_tpu.toolkit import misc as JM


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_constants_are_the_jax_packages():
    for name in ("INPUT_KEY", "LABEL_KEY", "PREDICTIONS_KEY", "LOSS_KEY", "LATENT_KEY", "AUX_LOSS_KEY", "MU_KEY",
                 "LOG_VAR_KEY", "BATCH_INDICES_KEY", "ORIGINAL_LABEL_KEY", "CKPT_PREFIX", "SCORES_FILE",
                 "CHECKPOINTS_FOLDER"):
        assert getattr(TK, name) == getattr(JK, name), name


def test_seeds_and_generators():
    TM.seed_everything(123)
    JM.seed_everything(123)
    assert TM.get_seed() == JM.get_seed() == 123
    assert np.array_equal(np.asarray(JM.new_rng_key()), np.asarray(jax.random.PRNGKey(123)))
    assert TM.new_generator().initial_seed() == 123 and TM.new_generator(5).initial_seed() == 5
    want = torch.randn(4, generator=torch.Generator().manual_seed(123))
    assert torch.equal(torch.randn(4, generator=TM.new_generator()), want)


def test_mean_std_and_adain():
    src, tgt = _rand(0, 2, 5, 6, 3), _rand(1, 2, 7, 4, 3) * 3 + 1
    tm, ts = TM.mean_std(torch.from_numpy(src))
    jm, js = JM.mean_std(src)
    for got, ref in ((tm, jm), (ts, js)):
        assert got.shape == ref.shape and np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-6 * np.abs(ref).max()
    got = TM.adain_with_tgt(torch.from_numpy(src), torch.from_numpy(tgt)).numpy()
    ref = np.asarray(JM.adain_with_tgt(src, tgt))
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    mean, std = _rand(2, 2, 1, 1, 3), np.abs(_rand(3, 2, 1, 1, 3)) + 0.5
    got = TM.adain_with_params(*(torch.from_numpy(a) for a in (src, mean, std))).numpy()
    ref = np.asarray(JM.adain_with_params(src, mean, std))
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("strategy", [None, "linear_decay", "radius_decay", "log_decay", "sigmoid_decay"])
def test_weights_strategy(strategy):
    got, ref = TM.WeightsStrategy(strategy)(17), JM.WeightsStrategy(strategy)(17)
    assert (got is None and ref is None) or np.array_equal(got, ref)


def test_scalar_ema_prod_hash_and_denormals():
    t, j = TM.ScalarEMA(0.8), JM.ScalarEMA(0.8)
    assert t.value is None and j.value is None
    for v in (3.0, -1.0, 2.5, 7.0):
        assert t.update(v) == j.update(v)
    assert TM.prod([2, 3, 4]) == JM.prod([2, 3, 4]) == 24
    assert TM.hash_code("a prompt") == JM.hash_code("a prompt")
    states = {"w": np.array([1e-40, 1.0, -1e-35, 2e-30], np.float32), "i": np.array([0, 1], np.int64)}
    ref = JM.fix_denormal_states(states)
    got = TM.fix_denormal_states(states)
    assert all(np.array_equal(got[k], ref[k]) and got[k].dtype == ref[k].dtype for k in ref)
    got_t = TM.fix_denormal_states({k: torch.from_numpy(v) for k, v in states.items()})
    assert all(np.array_equal(got_t[k].numpy(), ref[k]) for k in ref)


def test_files_and_workspaces(tmp_path):
    path = tmp_path / "file.bin"
    path.write_bytes(np.random.RandomState(0).bytes(1000))
    assert TM.get_file_info(path) == JM.get_file_info(path)
    assert TM.get_file_info(path).st_size == 1000
    assert TM.get_latest_workspace(tmp_path / "none") is None and JM.get_latest_workspace(tmp_path / "none") is None
    for name, mtime in (("a", 1000), ("b", 1010), ("c", 1002)):
        (tmp_path / "ws" / name).mkdir(parents=True)
        os.utime(tmp_path / "ws" / name, (mtime, mtime))
    assert TM.get_latest_workspace(tmp_path / "ws") == JM.get_latest_workspace(tmp_path / "ws") == tmp_path / "ws" / "b"


@pytest.mark.parametrize("value", [None, "text", [1, 2, 3], [[1], [2]], np.arange(4), np.ones((2, 3))],
                         ids=["none", "str", "flat_list", "nested_list", "1d", "2d"])
def test_to_2d(value):
    got, ref = TM.to_2d(value), JM.to_2d(value)
    if ref is None:
        assert got is None
    else:
        assert np.array_equal(np.asarray(got), np.asarray(ref)) and type(got) is type(ref)
    if isinstance(value, np.ndarray):
        assert torch.equal(TM.to_2d(torch.from_numpy(value)), torch.from_numpy(np.asarray(ref)))


def test_batch_converters_and_the_dtypes_they_narrow():
    batch = {"x": np.random.RandomState(0).randn(3, 2), "i": np.arange(3, dtype=np.int64),
             "b": np.array([True, False, True]), "o": np.array(["a", "b", "c"], dtype=object), "n": 4}
    got, ref = TM.np_batch_to_tensor(batch), JM.np_batch_to_jax(batch)
    assert got["o"] is batch["o"] and ref["o"] is batch["o"] and got["n"] == ref["n"] == 4
    # the tensors keep numpy's dtypes; JAX (x64 off) narrows on the way
    assert (got["x"].dtype, got["i"].dtype, got["b"].dtype) == (torch.float64, torch.int64, torch.bool)
    assert (ref["x"].dtype, ref["i"].dtype) == (np.float32, np.int32)
    back, jback = TM.tensor_batch_to_np(got), JM.jax_batch_to_np(ref)
    for k in ("x", "i", "b"):
        assert np.array_equal(back[k], batch[k]) and back[k].dtype == batch[k].dtype
        assert np.array_equal(jback[k], batch[k].astype(jback[k].dtype))
    # what each narrows before a device move: f64 -> f32 in both; i64 -> i32 in JAX only
    for arr, port_dtype, jax_dtype in ((batch["x"], np.float32, np.float32), (batch["i"], np.int64, np.int32),
                                       (batch["b"], np.bool_, np.bool_), (batch["x"].astype(np.float16), np.float16,
                                                                          np.float16)):
        assert TM.to_device_dtype(arr).dtype == port_dtype and JM.to_jax_dtype(arr).dtype == jax_dtype


def _linear_pair(seed):
    jm = nnx.Linear(4, 3, rngs=nnx.Rngs(seed))
    tm = torch.nn.Linear(4, 3)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.array(jm.kernel[...]).T))
        tm.bias.copy_(torch.from_numpy(np.array(jm.bias[...])))
    return jm, tm


def test_num_params_diffs_and_inject():
    (j1, t1), (j2, t2) = _linear_pair(0), _linear_pair(1)
    assert TM.get_num_params(t1) == JM.get_num_params(nnx.state(j1, nnx.Param)) == 15
    assert TM.get_num_params(dict(t1.named_parameters())) == 15
    got, ref = TM.sorted_param_diffs(t1, t2), JM.sorted_param_diffs(j1, j2)
    assert np.allclose(got.diffs, ref.diffs, rtol=0, atol=0)
    assert [{"weight": "kernel/value", "bias": "bias/value"}[n] for n in got.names] == ref.names
    TM.inject_parameters(t1, t2)
    JM.inject_parameters(j1, j2)
    assert TM.sorted_param_diffs(t1, t2).diffs == JM.sorted_param_diffs(j1, j2).diffs == [0.0, 0.0]
    # a filtered source leaves a target parameter unfilled: both strict injections raise
    with pytest.raises(KeyError, match="bias"):
        TM.inject_parameters(t1, t2, src_filter_fn=lambda name: name != "bias")
    with pytest.raises(Exception):
        JM.inject_parameters(j1, j2, src_filter_fn=lambda name: "bias" not in name)
    TM.inject_parameters(t1, t2, strict=False, src_filter_fn=lambda name: name != "bias")


def test_batch_norms_and_tensors(tmp_path):
    assert TM.has_batch_norms(torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.BatchNorm1d(2)))
    assert not TM.has_batch_norms(torch.nn.Linear(2, 2))
    assert JM.has_batch_norms(nnx.BatchNorm(2, rngs=nnx.Rngs(0)))
    assert not JM.has_batch_norms(nnx.Linear(2, 2, rngs=nnx.Rngs(0)))
    sd = {"a.weight": torch.from_numpy(_rand(0, 3, 2)), "b": torch.arange(4)}
    path = tmp_path / "sd.pt"
    torch.save({"state_dict": sd}, path)
    for inp in (str(path), {"state_dict": sd}, sd):
        got, ref = TM.get_tensors(inp), JM.get_tensors(inp)
        assert sorted(got) == sorted(ref) and all(np.array_equal(got[k], ref[k]) for k in ref)


def test_show_or_return():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    canvases = []
    for fn in (TM.show_or_return, JM.show_or_return):
        plt.figure(figsize=(2, 2))
        plt.plot([0, 1], [1, 0])
        canvases.append(fn(True))
    assert canvases[0].shape == canvases[1].shape and canvases[0].shape[-1] == 4
    assert np.array_equal(canvases[0], canvases[1])
