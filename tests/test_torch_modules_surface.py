"""The framework's names of the JAX package's surface that carry behaviour,
in the port against the JAX package on the CPU, on the same inputs made
from a seed with numpy: `Lambda`, `Residual` and `avg_pool_nd` (1-, 2- and
3-D) of `modules/common.py`; `get_input_sample` of `trainer.py`;
`split_sw`, `DataArgs` and `TqdmSettings` of the schema; `TryLoadBlock`'s
build and save; `parse_config_info` and the `diffusion/ddpm` preset (the
port's copy of the JSON file, the full width's parameter count, and one
UNet call of the preset at a narrow width under its shape rules: the
channel multipliers, the attention at a quarter of the image side, four
heads; the JAX parameters carried across by `cflearn_torch.bridge`), with
`DDPM.sample` against the DDIM sampler it drives.

Tolerances: the UNet within 1e-5 of max|JAX| and `Residual` within 1e-6
(f32 summation order); pooling within 1e-6; everything else exactly."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from _torch_bridge_common import bridged, dezero, rel_err
from cflearn_torch import zoo as tzoo
from cflearn_torch.modules import common as TC
from cflearn_torch.modules.multimodal.diffusion.samplers import ISampler
from cflearn_torch.pipeline.blocks import TryLoadBlock as TTryLoadBlock
from cflearn_torch.schema import config as TS
from cflearn_torch.schema import data as TD
from cflearn_torch.trainer import get_input_sample as t_get_input_sample
from cflearn_tpu import zoo as jzoo
from cflearn_tpu.modules import common as JC
from cflearn_tpu.pipeline.blocks import TryLoadBlock as JTryLoadBlock
from cflearn_tpu.schema import config as JS
from cflearn_tpu.schema import data as JD
from cflearn_tpu.trainer import get_input_sample as j_get_input_sample

# the `diffusion/ddpm` preset at a narrow width: its multipliers, attention rate and heads, 32 start channels,
# one res block a level
NARROW_DDPM = dict(img_size=32, unet_config=dict(start_channels=32, num_res_blocks=1, channel_multipliers=[1, 2, 2, 4],
                                                 attention_downsample_rates=[4], num_heads=4, context_dim=None,
                                                 use_spatial_transformer=False))


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_lambda_and_residual():
    x = _rand(0, 3, 5)
    assert np.array_equal(TC.Lambda(lambda a, b: a * 2 + b)(torch.from_numpy(x), 1).numpy(),
                          np.asarray(JC.Lambda(lambda a, b: a * 2 + b)(jnp.asarray(x), 1)))
    jm = JC.Residual(nnx.Linear(5, 5, rngs=nnx.Rngs(0)))
    tm = bridged(jm, TC.Residual(torch.nn.Linear(5, 5)))
    assert rel_err(tm(torch.from_numpy(x)).detach().numpy(), jm(jnp.asarray(x))) < 1e-6


@pytest.mark.parametrize("dims,shape,kernel,stride", [
    (1, (2, 12, 3), 2, None), (1, (2, 11, 3), 3, 2), (2, (2, 8, 6, 4), 2, None), (2, (1, 9, 7, 3), 3, 2),
    (3, (2, 4, 6, 8, 2), 2, None), (3, (1, 5, 5, 7, 3), 3, 2),
], ids=["1d_k2", "1d_k3s2", "2d_k2", "2d_k3s2", "3d_k2", "3d_k3s2"])
def test_avg_pool_nd(dims, shape, kernel, stride):
    x = _rand(dims, *shape)
    got = TC.avg_pool_nd(dims, torch.from_numpy(x), kernel=kernel, stride=stride).numpy()
    ref = np.asarray(JC.avg_pool_nd(dims, jnp.asarray(x), kernel=kernel, stride=stride))
    assert got.shape == ref.shape and np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_get_input_sample():
    batch = {"x": np.arange(12.0).reshape(4, 3), "pair": [np.ones((4, 2)), "tag"], "n": 7}
    ref = j_get_input_sample([batch])
    for loader in ([batch], [{"x": torch.from_numpy(batch["x"]), "pair": batch["pair"], "n": 7}]):
        got = t_get_input_sample(loader)
        assert np.array_equal(np.asarray(got["x"]), ref["x"]) and got["x"].shape == (1, 3)
        assert np.array_equal(got["pair"][0], ref["pair"][0]) and got["pair"][1] == ref["pair"][1] == "tag"
        assert got["n"] == ref["n"] == 7


@pytest.mark.parametrize("weights", [None, "one", "pair"])
def test_split_sw(weights):
    w = {None: None, "one": np.arange(1.0, 5.0), "pair": (np.arange(1.0, 5.0), np.array([2.0, 2.0]))}[weights]
    for got, ref in zip(TD.split_sw(w), JD.split_sw(w)):
        assert (got is None and ref is None) or np.array_equal(got, ref)


def test_data_args_tqdm_settings_and_aliases():
    args, jargs = TD.DataArgs(1, 2, {"k": 3}), JD.DataArgs(1, 2, {"k": 3})
    assert tuple(args) == tuple(jargs) and args.xy == jargs.xy == (1, 2) and TD.DataArgs._fields == JD.DataArgs._fields
    assert dataclasses.asdict(TS.TqdmSettings()) == dataclasses.asdict(JS.TqdmSettings())
    custom = dict(use_tqdm=True, position=2, desc="step")
    assert dataclasses.asdict(TS.TqdmSettings(**custom)) == dataclasses.asdict(JS.TqdmSettings(**custom))
    assert TS.TqdmSettings().to_info() == JS.TqdmSettings().to_info()
    for name in ("texts_type", "configs_type", "general_config_type", "sample_weights_type", "states_callback_type"):
        assert str(getattr(TD, name)).replace("numpy.ndarray", "np") == str(getattr(JD, name)).replace(
            "numpy.ndarray", "np"), name


def _try_load_block(base, calls):
    class Probe(base):
        def try_load(self, folder):
            calls.append(("try_load", Path(folder).name))
            return Path(folder, "state.txt").is_file()

        def from_scratch(self, config):
            calls.append(("from_scratch", config))

        def dump_to(self, folder):
            calls.append(("dump_to", Path(folder).name))
            Path(folder, "state.txt").write_text("state")

    return Probe()


def test_try_load_block(tmp_path):
    logs = []
    for side, base in (("port", TTryLoadBlock), ("jax", JTryLoadBlock)):
        calls = []
        block = _try_load_block(base, calls)
        block.build("config")  # no serialize folder: from scratch
        block.serialize_folder = str(tmp_path / side)
        block.build("config")  # nothing saved yet
        block.save_extra(str(tmp_path / side / block.name))
        block.build("config")  # loads what it saved
        logs.append(calls)
    assert logs[0] == logs[1] == [("from_scratch", "config"), ("try_load", "Probe"), ("from_scratch", "config"),
                                  ("dump_to", "Probe"), ("try_load", "Probe")]


def test_parse_config_info_and_the_preset_file():
    assert tzoo.parse_config_info("diffusion/ddpm") == jzoo.common.parse_config_info("diffusion/ddpm")
    port, ref = tzoo.CONFIGS_DIR / "diffusion/ddpm.json", Path(jzoo.common.CONFIGS_DIR) / "diffusion/ddpm.json"
    assert "cflearn_torch" in port.parts and port.read_bytes() == ref.read_bytes()
    assert tzoo.parse_json(port) == jzoo.common.parse_json(ref)


def test_ddpm_preset_full_width_count():
    """The preset at its published width: the port's count (built on "meta") is the JAX constructor's
    (`nnx.eval_shape`)."""
    m = tzoo.load_module("diffusion/ddpm", device="meta")
    jm = nnx.eval_shape(lambda: jzoo.load_module("diffusion/ddpm"))
    count = sum(int(np.prod(v.shape)) for _, v in nnx.to_flat_state(nnx.state(jm, nnx.Param)))
    assert sum(p.numel() for p in m.parameters()) == count == 68_793_091


@pytest.fixture(scope="module")
def ddpm_pair():
    jm = dezero(jzoo.load_module("diffusion/ddpm", **NARROW_DDPM))
    tm = tzoo.load_module("diffusion/ddpm", device="cpu", **NARROW_DDPM)
    return jm, bridged(jm, tm)


def test_ddpm_preset_unet_call(ddpm_pair):
    jm, tm = ddpm_pair
    x, t = _rand(5, 2, 32, 32, 3), np.array([7, 930])
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    ref = np.asarray(nnx.jit(lambda m, x, t: m.denoise(x, t))(jm, jnp.asarray(x), jnp.asarray(t, jnp.int32)))
    assert got.shape == ref.shape == (2, 32, 32, 3) and rel_err(got, ref) < 1e-5


def test_ddpm_sample_drives_ddim(ddpm_pair):
    _, tm = ddpm_pair
    with torch.no_grad():
        out = tm.sample(2, num_steps=3, generator=torch.Generator().manual_seed(4))
        gen = torch.Generator().manual_seed(4)
        z = torch.randn((2, 32, 32, 3), generator=gen)
        ref = ISampler.make("ddim", {"model": tm}).sample(z, num_steps=3, generator=gen)
    assert out.shape == (2, 32, 32, 3) and torch.equal(out, ref)
