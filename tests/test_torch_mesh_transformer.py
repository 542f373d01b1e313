"""`dryrun_multichip`'s 4-layer transformer (`__graft_entry__.py:139-156`)
and the global-batch statistics, trained through the port's `Trainer` on
4 gloo ranks, 3 SGD steps each from one start, held to the port's
single-device run at JAX's `atol=1e-4, rtol=0` (`tests/test_parallel.py`):

- contract program 3: `pipeline_parallel` with the "moe" mixer on
  {"model": 2, "pipe": 2} (GPipe over pipe, the experts and the attention
  split over model), with one microbatch: under GPipe a MoE router's
  capacity and balance statistic are those of its microbatch (as in the JAX
  pipeline), so only one microbatch computes the single-device model;
- the same stack with the "ff" mixer at the default S = 2 microbatches
  (`_parity_common`'s "transformer_pp"), whose single-device run is held to
  the JAX `run_workload("transformer_pp", None, ...)` through the bridge;
- MoE on {"data": 2, "model": 2} at `capacity_factor` 0.5, where the
  capacity binds: the router's capacity and overflow order are taken over
  the global batch (a capacity per rank's slice would be another model);
- `fcnn`'s BatchNorm on {"data": 4}: statistics (and running statistics)
  of the global batch;
- ZeRO on {"fsdp": 2, "model": 2} with momentum (optimizer state kept per
  part), and a clip by the global norm on {"model": 2, "pipe": 2};
- AdamP on {"model": 2, "pipe": 2} and under ZeRO on {"fsdp": 2, "model":
  2}: each row's sums span the ranks that hold its parts, whether any row
  was projected those that hold other rows, and the threshold takes the
  whole row's width. Its eps is 1e-3: the attention's k bias has a zero
  gradient, whose f32 rounding noise Adam's g / (|g| + eps) would blow up
  to a step of lr at eps 1e-8 under any other summation order;
- gradient accumulation (2) with a clip of the accumulated gradient by its
  global norm, SGD at lr 1.0, on {"model": 2, "pipe": 2} and under ZeRO:
  the norm sums the squares of every rank's shards and parts, and the
  one-device run is held to the JAX `run_workload` with the same settings."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _torch_bridge_common  # noqa: F401,E402
import _torch_mesh_common as C  # noqa: E402
import _torch_mesh_jax as J  # noqa: E402
from cflearn_torch.schema import IDLModel  # noqa: E402
from cflearn_tpu.optimizers import OptimizerPack  # noqa: E402

ADAMP_CONFIG = {"lr": 0.05, "delta": 0.5, "weight_decay": 1e-2, "eps": 1e-3}
ADAMP = {"all": {"optimizer": "adamp", "optimizer_config": ADAMP_CONFIG}}
ADAMP_NO_PROJECTION = {"all": {"optimizer": "adamp", "optimizer_config": dict(ADAMP_CONFIG, delta=0.0)}}
SGD_1 = {"all": {"optimizer": "sgd", "optimizer_config": {"lr": 1.0}}}
ACCUMULATE_CLIP = {"grad_accumulate": 2, "clip_norm": 0.05, "optimizer_settings": SGD_1}
JOBS = [
    ("moe_model2_pipe2", "transformer_moe", {"model": 2, "pipe": 2}, {}),
    ("ff_model2_pipe2", "transformer_pp", {"model": 2, "pipe": 2}, {}),
    ("moe_capacity_data2_model2", "moe_capacity", {"data": 2, "model": 2}, {}),
    ("fcnn_data4", "fcnn", {"data": 4}, {}),
    # ZeRO with optimizer state (momentum) split over fsdp, and a clip by the whole gradient's norm, whose
    # squares sum over the model and pipe splits
    ("momentum_zero_fsdp2_model2", "transformer_pp", {"fsdp": 2, "model": 2},
     {"shard_optimizer_states": True, "optimizer_settings": {"all": {"optimizer": "sgd", "optimizer_config": {
         "lr": 0.05, "momentum": 0.9}}}}),
    ("clip_model2_pipe2", "transformer_pp", {"model": 2, "pipe": 2}, {"clip_norm": 0.05}),
    ("adamp_model2_pipe2", "transformer_pp", {"model": 2, "pipe": 2}, {"optimizer_settings": ADAMP}),
    ("adamp_zero_fsdp2_model2", "transformer_pp", {"fsdp": 2, "model": 2},
     {"shard_optimizer_states": True, "optimizer_settings": ADAMP}),
    ("accumulate_clip_model2_pipe2", "transformer_pp", {"model": 2, "pipe": 2}, ACCUMULATE_CLIP),
    ("accumulate_clip_zero_fsdp2_model2", "transformer_pp", {"fsdp": 2, "model": 2},
     dict(ACCUMULATE_CLIP, shard_optimizer_states=True)),
]
# each case's run on one device without what it tests: the projection (delta 0), the clip
WITHOUT = {
    "adamp_model2_pipe2": {"optimizer_settings": ADAMP_NO_PROJECTION},
    "adamp_zero_fsdp2_model2": {"shard_optimizer_states": True, "optimizer_settings": ADAMP_NO_PROJECTION},
    "accumulate_clip_model2_pipe2": {"grad_accumulate": 2, "optimizer_settings": SGD_1},
    "accumulate_clip_zero_fsdp2_model2": {"grad_accumulate": 2, "optimizer_settings": SGD_1, "shard_optimizer_states": True},
}
WORKLOADS = {w for _, w, *_ in JOBS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from _parity_common import run_workload

    tmp = tmp_path_factory.mktemp("transformer")
    for workload in sorted(WORKLOADS - {"transformer_pp"}):
        m = IDLModel.from_config(C.build_config(workload, None, str(tmp / "p")), device="cpu")
        np.savez(tmp / f"init_{workload}.npz", **{k: v.numpy() for k, v in m.state_dict().items()})
    config = C.build_config("transformer_pp", None, str(tmp / "p"))
    J.port_init(config, str(tmp / "init_transformer_pp.npz"))
    mesh = C.run_programs(JOBS, tmp)
    single = {
        key: C.run_port(w, None, str(tmp / f"single_{key}"), str(tmp / f"init_{w}.npz"), **extra)
        for key, w, _, extra in JOBS
    }
    without = {
        key: C.run_port("transformer_pp", None, str(tmp / f"without_{key}"), str(tmp / "init_transformer_pp.npz"), **extra)
        for key, extra in WITHOUT.items()
    }
    module = IDLModel.from_config(config, device="meta").m
    want = J.port_params(run_workload("transformer_pp", None, str(tmp / "jax")), module)
    jax_settings = {"all": OptimizerPack("all", "sgd", optimizer_config={"lr": 1.0})}
    jax_extra = dict(ACCUMULATE_CLIP, optimizer_settings=jax_settings)
    want_clip = J.port_params(run_workload("transformer_pp", None, str(tmp / "jax_clip"), jax_extra), module)
    return {"mesh": mesh, "single": single, "without": without, "jax": want, "jax_clip": want_clip, "tmp": tmp}


def test_single_device_run_matches_jax(runs):
    C.assert_params_close(runs["jax"], runs["single"]["ff_model2_pipe2"], atol=1e-4, what="port vs JAX")
    # the clip binds and the momentum moves the run: those cases test what they name
    for key in ("momentum_zero_fsdp2_model2", "clip_model2_pipe2"):
        moved = max(np.abs(runs["single"][key][k] - v).max() for k, v in runs["single"]["ff_model2_pipe2"].items())
        assert moved > 1e-3, key
    # AdamP projects rows and the accumulated gradient's clip binds: the run differs from the one without it
    for key, base in runs["without"].items():
        moved = max(np.abs(runs["single"][key][k] - v).max() for k, v in base.items())
        assert moved > 1e-3, key


def test_single_device_accumulated_clip_matches_jax(runs):
    """Accumulation over 2 steps with the clip inside it, as the JAX trainer chains `clip_by_global_norm` inside
    `optax.MultiSteps`."""
    got = runs["single"]["accumulate_clip_model2_pipe2"]
    C.assert_params_close(runs["jax_clip"], got, atol=1e-4, what="accumulated clip, port vs JAX")


@pytest.mark.parametrize("key", [k for k, *_ in JOBS])
def test_mesh_program_matches_single_device(runs, key):
    C.assert_params_close(runs["single"][key], runs["mesh"][key], atol=1e-4, what=key)


def test_the_capacity_binds_on_the_global_batch(runs):
    """The MoE case drops tokens over the whole batch: its slices alone would keep other tokens."""
    from cflearn_torch.modules.core.mixed_stacks import MoEChannelMixer

    m = IDLModel.from_config(C.build_config("moe_capacity", None, str(runs["tmp"] / "p")), device="cpu")
    mixer = next(mod for mod in m.modules() if isinstance(mod, MoEChannelMixer))
    seen = []
    mixer.register_forward_pre_hook(lambda mod, args: seen.append(args[0].detach()))
    x, _, _ = C.workload_data("moe_capacity")
    with torch.no_grad():
        m.m(torch.from_numpy(x))
    x = seen[0]
    d = x.shape[-1]

    def kept(xs):
        with torch.no_grad():
            probs = torch.softmax(mixer.router(xs.reshape(-1, d)), dim=-1)
        n, e = probs.shape
        cap = min(n, int(np.ceil(n * 0.5 * 2 / e)))
        first = probs.argmax(-1)
        return [int(min(cap, int((first == i).sum()))) for i in range(e)], cap

    whole, cap = kept(x)
    assert max(whole) == cap  # an expert is full
    with torch.no_grad():
        per_rank = torch.cat([mixer(x[:16]), mixer(x[16:])])  # each rank's slice routed alone
        assert not torch.allclose(per_rank, mixer(x), atol=1e-3)  # another model


def test_batch_norm_statistics_of_the_global_batch(runs):
    got = runs["mesh"]["fcnn_data4"]
    stats = [k for k in got if k.endswith((".mean", ".var"))]
    assert stats and all(np.abs(got[k]).max() > 0 for k in stats)
