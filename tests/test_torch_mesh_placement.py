"""The port's mesh without processes: the names of the JAX package's
`parallel`, `dist` and `schema` packages, `MeshConfig`'s sizes, the fsdp
split, the placement (`parallel.tp.plan_placement`) held parameter by
parameter to `cflearn_tpu.parallel.tp.place_params` on the 8 virtual
devices of `tests/conftest.py` (layouts translated: a port Linear weight
is (out, in)), the pipeline layout's checkpoints, and `remat` against the
JAX `Trainer`'s `remat` step.

Where the port's plan differs from the JAX one it says so, and these tests
hold it to that: a column-parallel Linear's bias splits with its weight
(GSPMD leaves the 1-D bias whole and splits the sum), and a column split of
an attention projection whose heads do not divide the axis stays whole (the
port runs the flash kernel on whole local heads), with a note.

Tolerances: placements exact; the `remat` runs' parameters after 3 SGD
steps at JAX's `atol=1e-4, rtol=0` (`tests/test_parallel.py`) against the
JAX run and bit for bit against the port's run without `remat`."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _torch_bridge_common  # noqa: F401,E402  (one thread a process, no network)
import _torch_mesh_common as C  # noqa: E402
import _torch_mesh_jax as J  # noqa: E402
from cflearn_torch.bridge import jax_param_names  # noqa: E402
from cflearn_torch.parallel import tp as TP  # noqa: E402
from cflearn_torch.schema import IDLModel  # noqa: E402


@pytest.mark.parametrize("package", ["parallel", "dist", "schema"])
def test_the_jax_packages_names_exist(package):
    import importlib

    jax_pkg = importlib.import_module(f"cflearn_tpu.{package}")
    port_pkg = importlib.import_module(f"cflearn_torch.{package}")
    src = open(jax_pkg.__file__).read()
    import ast

    names = set()
    for node in ast.parse(src).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    assert names and not [n for n in sorted(names) if not hasattr(port_pkg, n)]


def test_mesh_config_sizes_and_one_process_mesh():
    from cflearn_torch.parallel.mesh import make_mesh
    from cflearn_torch.schema.config import MeshConfig

    from cflearn_tpu.schema.config import MeshConfig as JMeshConfig

    for axes in ({"data": -1, "fsdp": 2}, {"model": 2, "context": 2}, {"data": 2, "pipe": -1}):
        mine, ref = MeshConfig(), JMeshConfig()
        mine.from_info(axes)
        ref.from_info(axes)
        assert mine.axis_sizes(8) == ref.axis_sizes(8)
    with pytest.raises(ValueError):
        MeshConfig(data=3, fsdp=3).axis_sizes(8)
    mesh = make_mesh()
    assert mesh.size == 1 and mesh.group("data", "fsdp") is None and mesh.coord["model"] == 0
    with pytest.raises(ValueError):
        make_mesh(MeshConfig(data=2))


def test_fsdp_split_matches_jax():
    from cflearn_torch.parallel.mesh import fsdp_param_sharding, shard_params_fsdp

    from cflearn_tpu.parallel.mesh import fsdp_param_sharding as jax_fsdp

    mesh = J.jax_mesh(data=4, fsdp=2)
    for shape in ((16, 8), (7,), (8, 8), (3, 5, 6), (32, 32, 3, 3)):
        want = tuple(jax_fsdp(mesh, shape).spec) + (None,) * (len(shape) - len(tuple(jax_fsdp(mesh, shape).spec)))
        assert fsdp_param_sharding({"fsdp": 2}, shape) == want
    params = {"w": torch.ones(16, 8), "b": torch.ones(7)}
    one = shard_params_fsdp(params, __import__("cflearn_torch.parallel.mesh", fromlist=["x"]).make_mesh())
    assert one["w"].shape == (16, 8) and one["b"].shape == (7,)


def _axes(spec):
    return tuple(None if a is None else a for a in spec)


CASES = {
    "unet_fsdp2_model2": ("ddpm_attn", dict(data=2, fsdp=2, model=2), True),
    "unet_model2_context2": ("ddpm_attn", dict(data=2, model=2, context=2), False),
    "transformer_moe_model2_pipe2": ("transformer_moe", dict(data=2, model=2, pipe=2), False),
    "transformer_fsdp2_model2_pipe2": ("transformer_pp", dict(fsdp=2, model=2, pipe=2), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_placement_matches_jax(case):
    workload, axes, use_fsdp = CASES[case]
    config = C.build_config(workload, None, "unused")
    jm = J.jax_model(config)
    want = J.jax_placement(jm, J.jax_mesh(**axes), use_fsdp=use_fsdp)
    pm = IDLModel.from_config(config, device="meta")
    shape = dict(dict.fromkeys(("data", "fsdp", "model", "context", "pipe"), 1), **axes)
    plan = TP.plan_placement(pm, shape, use_fsdp=use_fsdp)
    names = jax_param_names(pm)
    assert set(names.values()) == set(want)
    params = dict(pm.named_parameters())
    split = {"model": 0, "fsdp": 0, "pipe": 0}
    for name, pl in plan.items():
        if name not in names:  # not a parameter: an EMA's shadow, placed as its parameter
            continue
        jspec = want[names[name]]
        perm = TP._port_perm(names[name], params[name].ndim)
        expected = tuple(jspec[i] for i in perm)
        if pl.kind == "col" and name.endswith(".bias"):
            # the port splits a column-parallel bias with its weight; GSPMD leaves it whole
            assert "model" not in expected and pl.spec.count("model") == 1, name
            continue
        if pl.note:
            assert "model" in expected and "heads do not divide" in pl.note, (name, pl.note)
            expected = tuple(None if a == "model" else a for a in expected)
        assert _axes(pl.spec) == _axes(expected), (name, pl.spec, expected)
        for a in pl.spec:
            if a in split:
                split[a] += 1
    assert split["model"] > 0
    assert split["fsdp"] > 0 if use_fsdp and axes.get("fsdp", 1) > 1 else split["fsdp"] == 0
    assert split["pipe"] > 0 if axes.get("pipe", 1) > 1 else split["pipe"] == 0
    # the fused projections' parts: GEGLU's halves, in_proj's thirds
    parts = {".".join(n.split(".")[-3:-1]): pl.parts for n, pl in plan.items() if pl.kind == "col"}
    if workload == "ddpm_attn":
        assert parts["net1.net"] == 2 and parts["attn1.to_q"] == 1
    else:
        assert parts["net.in_proj"] == 3
    described = dict(TP.describe_placement(pm, shape, use_fsdp=use_fsdp))
    assert {n for n, pl in plan.items() if pl.note or any(a is not None for a in pl.spec)} == set(described)


def test_heads_that_do_not_divide_stay_whole():
    from cflearn_torch.modules.core.attentions import Attention, SpatialAttention

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = Attention(24, 3, is_self_attention=True)
            self.vae = SpatialAttention(32, num_groups=8)

    plan = TP.plan_placement(Net(), {"model": 2})
    assert "3 heads do not divide" in plan["attn.in_proj.weight"].note and plan["attn.in_proj.weight"].spec == (None, None)
    assert plan["attn.out_proj.weight"].spec == (None, "model")  # a row split takes a whole input too
    assert "1 heads do not divide" in plan["vae.to_q.weight"].note
    assert plan["vae.to_out.weight"].spec == (None, "model")


def _pp_model(pp, seed, moe=False):
    config = C.transformer_config(pp=pp, moe=moe)
    config.seed = seed
    return IDLModel.from_config(config, device="cpu")


def test_pp_checkpoint_layout_portability():
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 8).astype(np.float32))
    plain = _pp_model(False, 0)
    ref = plain.m(x)
    pp = _pp_model(True, 7)
    assert not torch.allclose(pp.m(x), ref)
    pp.load_state_dict(plain.state_dict())
    torch.testing.assert_close(pp.m(x), ref, atol=2e-5, rtol=0)
    plain2 = _pp_model(False, 7)
    plain2.load_state_dict(pp.state_dict())
    torch.testing.assert_close(plain2.m(x), ref, atol=2e-5, rtol=0)


def test_pp_block_tp_fallback_on_pipeless_mesh():
    pm = IDLModel.from_config(C.transformer_config(moe=True), device="meta")
    plan = TP.plan_placement(pm, {"data": 2, "model": 4})
    stacked = plan["m.encoder.pp_block.channel_mixer.experts_w1"]
    assert stacked.spec == (None, "model", None, None) and stacked.kind == "expert"
    plan = TP.plan_placement(pm, {"model": 2, "pipe": 2})
    assert plan["m.encoder.pp_block.channel_mixer.experts_w1"].spec == ("pipe", "model", None, None)
    assert plan["m.encoder.pp_block.token_mixer.net.in_proj.weight"].spec == ("pipe", "model", None)


def test_remat_matches_jax_and_no_remat(tmp_path):
    from _parity_common import run_workload

    config = C.build_config("transformer_pp", None, str(tmp_path / "p"))
    jm = J.port_init(config, str(tmp_path / "init.npz"))
    jflat = run_workload("transformer_pp", None, str(tmp_path / "jax"), extra_config={"remat": True})
    pm = IDLModel.from_config(config, device="cpu")
    want = J.port_params(jflat, pm.m)
    runs = {
        str(remat): C.run_port("transformer_pp", None, str(tmp_path / f"w{i}"), str(tmp_path / "init.npz"), remat=remat)
        for i, remat in enumerate((False, True, "dots_saveable"))
    }
    for remat, got in runs.items():
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, atol=1e-4, rtol=0, err_msg=f"remat={remat} {k}")
        for k, v in runs["False"].items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"remat={remat} {k}")
    del jm


def test_remat_replays_the_models_draws(tmp_path):
    """DDPM draws t and noise inside the checkpointed loss: the recomputation
    must draw the same (the model's generators are rewound)."""
    config = C.build_config("ddpm_attn", None, str(tmp_path / "p"))
    pm = IDLModel.from_config(config, device="cpu")
    np.savez(tmp_path / "init.npz", **{k: v.numpy() for k, v in pm.state_dict().items()})
    base = C.run_port("ddpm_attn", None, str(tmp_path / "w0"), str(tmp_path / "init.npz"))
    for i, remat in enumerate((True, "dots_saveable")):
        got = C.run_port("ddpm_attn", None, str(tmp_path / f"w{i + 1}"), str(tmp_path / "init.npz"), remat=remat)
        for k, v in base.items():
            np.testing.assert_allclose(got[k], v, atol=1e-6, rtol=0, err_msg=f"remat={remat} {k}")
    with pytest.raises(ValueError):
        C.run_port("ddpm_attn", None, str(tmp_path / "w9"), str(tmp_path / "init.npz"), remat="no_such_policy")
