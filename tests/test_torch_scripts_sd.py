"""`cflearn_torch/scripts/sd.py` against the JAX package's
`cflearn_tpu/scripts/sd.py` on the CPU.

`convert`: a seeded SD-1.5 checkpoint in the upstream layout, every tensor
of the real file's keys at a tiny shape of its rank (the converters care
about names and ranks, not widths), with the keys the real file holds and
no parameter takes (the noise schedule, the EMA's counters, CLIP's position
ids). Both packages' conversions carry the same tensors, bit for bit, the
JAX one's names and layouts translated by `bridge.port_name`. An upstream
key that nothing takes is dropped by the JAX converter and raised on by the
port's (its loaders' strictness). `main` writes the conversion, and it reads
back bit for bit.

`inject`: the port's is strict (`zoo.common.load_into`), the JAX package's
loads with `strict=False`. Given every parameter, both load the same
values; given all but one, JAX leaves that leaf as it was and the port
raises, naming it."""

import numpy as np
import pytest
import torch
from flax import nnx

import _torch_bridge_common  # noqa: F401  (one thread a process, no network)
import cflearn_torch
from cflearn_torch.bridge import port_name, state_dict_from_jax
from cflearn_torch.modules.common import Residual
from cflearn_torch.scripts import sd as TS
from cflearn_torch.zoo import convert as TC
from cflearn_tpu.modules.common import Residual as JResidual
from cflearn_tpu.scripts import sd as JS
from cflearn_tpu.toolkit.tree import tree_to_npd

# keys of the real SD-1.5 file that no parameter takes
EXTRA = {"model_ema.decay": torch.tensor(0.9999), "model_ema.num_updates": torch.tensor(1000, dtype=torch.int32),
         "cond_stage_model.transformer.text_model.embeddings.position_ids": torch.arange(77)[None],
         **{k: torch.rand(1000, generator=torch.Generator().manual_seed(1)) for k in TC.SD_SCHEDULE_KEYS}}


@pytest.fixture(scope="module")
def sd_file(tmp_path_factory):
    model = cflearn_torch.zoo.load_sd("v1", device="meta")
    gen = torch.Generator().manual_seed(0)
    port = {k: torch.randn(tuple(min(d, 3) for d in p.shape), generator=gen) for k, p in model.named_parameters()}
    upstream = dict(TC.invert(TC.build_sd_mapping("v1"), port), **EXTRA)
    path = tmp_path_factory.mktemp("sd") / "v1-5-pruned-emaonly.safetensors"
    TC.write_safetensors(path, upstream)
    return path, upstream, len(port)


def test_convert_matches_jax(sd_file):
    path, _, n_params = sd_file
    got, ref = TS.convert(str(path)), JS.convert(str(path))
    assert len(got) == len(ref) == n_params
    for key, value in ref.items():
        name, perm = port_name(key[: -len("/value")].replace("/", "."), np.ndim(value))
        want = np.transpose(value, perm) if perm else np.asarray(value)
        assert np.array_equal(got[name].numpy(), want), key


def test_unknown_keys_and_the_cli(sd_file, tmp_path):
    path, upstream, _ = sd_file
    odd = tmp_path / "odd.safetensors"
    TC.write_safetensors(odd, dict(upstream, **{"model.diffusion_model.extra.weight": torch.ones(2)}))
    assert len(JS.convert(str(odd))) == len(JS.convert(str(path)))  # dropped without a word
    with pytest.raises(ValueError, match="model.diffusion_model.extra.weight"):
        TS.convert(str(odd))
    out = tmp_path / "converted.safetensors"
    TS.main([str(path), "--out", str(out)])
    back, want = TC.load_torch_state_dict(out), TS.convert(str(path))
    assert sorted(back) == sorted(want) and all(torch.equal(back[k], want[k]) for k in want)


class _API:
    """What `inject` reads of a `DiffusionAPI`: its model, `m`."""

    def __init__(self, m):
        self.m = m


def test_inject_is_strict_where_jax_is_not():
    src = JResidual(nnx.Linear(6, 6, rngs=nnx.Rngs(1)))
    src.module.bias[...] = np.arange(1.0, 7.0, dtype=np.float32)  # not the zeros a new Linear starts from
    npd = tree_to_npd(nnx.state(src, nnx.Param))
    jm = JResidual(nnx.Linear(6, 6, rngs=nnx.Rngs(2)))
    tm = Residual(torch.nn.Linear(6, 6))
    states = state_dict_from_jax(npd, tm)
    JS.inject(_API(jm), npd)
    TS.inject(_API(tm), states)
    assert np.array_equal(tm.module.weight.detach().numpy(), np.asarray(jm.module.kernel[...]).T)
    assert np.array_equal(tm.module.bias.detach().numpy(), np.asarray(jm.module.bias[...]))
    # all but the bias: JAX keeps the bias it had, the port names what is left unfilled
    jm2 = JResidual(nnx.Linear(6, 6, rngs=nnx.Rngs(2)))
    before = np.array(jm2.module.bias[...])
    JS.inject(_API(jm2), {k: v for k, v in npd.items() if "bias" not in k})
    assert np.array_equal(np.asarray(jm2.module.bias[...]), before) and not before.any()
    assert np.array_equal(np.asarray(jm2.module.kernel[...]), np.asarray(jm.module.kernel[...]))
    with pytest.raises(ValueError, match="leaves unfilled.*module.bias"):
        TS.inject(_API(Residual(torch.nn.Linear(6, 6))), {k: v for k, v in states.items() if k != "module.bias"})
    with pytest.raises(ValueError, match="shapes differ"):
        TS.inject(_API(Residual(torch.nn.Linear(6, 6))), dict(states, **{"module.bias": torch.zeros(5)}))
