"""`dryrun_multichip`'s DDPM UNet (`__graft_entry__.py:86-109`) trained
through the port's `Trainer` on 4 gloo ranks: contract program 1 on
{"fsdp": 2, "model": 2} with `shard_optimizer_states=True` (ZeRO over fsdp,
tensor parallelism over model) and program 2 on {"model": 2, "context": 2}
(self-attention split over the sequence: Ulysses, as "auto" picks for 4
heads on 2 ranks). Each runs 3 SGD steps from one start and is held to the
port's single-device run at JAX's `atol=1e-4, rtol=0`
(`tests/test_parallel.py`); that single-device run, fed the JAX step's t and
noise, is held to `_parity_common.run_workload("ddpm_attn", None, ...)`
through the bridge at the same tolerance (the JAX run is a data = 8 mesh on
the virtual devices; its global-batch math is one device's up to psum
order, which is what the JAX package's own parity test asserts)."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _torch_bridge_common  # noqa: F401,E402
import _torch_mesh_common as C  # noqa: E402
import _torch_mesh_jax as J  # noqa: E402

JOBS = [
    ("fsdp2_model2", "ddpm_attn", {"fsdp": 2, "model": 2}, {"shard_optimizer_states": True}),
    ("model2_context2", "ddpm_attn", {"model": 2, "context": 2}, {}),
    # an EMA's shadows split and gather as their parameters do
    ("ema_data2_model2", "ddpm_ema", {"data": 2, "model": 2}, {}),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from _parity_common import run_workload

    tmp = tmp_path_factory.mktemp("ddpm")
    config = C.build_config("ddpm_attn", None, str(tmp / "p"))
    jm = J.port_init(config, str(tmp / "init_ddpm_attn.npz"))
    draws = J.ddpm_draws(jm, 3, 32, (32, 8, 8, 3))
    from cflearn_torch.schema import IDLModel

    ema = IDLModel.from_config(C.build_config("ddpm_ema", None, str(tmp / "p")), device="cpu")
    np.savez(tmp / "init_ddpm_ema.npz", **{k: v.numpy() for k, v in ema.state_dict().items()})
    mesh = C.run_programs(JOBS, tmp)
    single = C.run_port("ddpm_attn", None, str(tmp / "single"), str(tmp / "init_ddpm_attn.npz"))
    single_ema = C.run_port("ddpm_ema", None, str(tmp / "single_ema"), str(tmp / "init_ddpm_ema.npz"))
    # the port's step fed the JAX step's draws, against the JAX run
    import cflearn_torch.models.cv.diffusion as D

    it = iter(draws)
    orig = D.global_randint, D.global_randn
    D.global_randint = lambda *a, **k: torch.from_numpy(np.array(next(it))).long()
    D.global_randn = lambda *a, **k: torch.from_numpy(np.array(next(it)))
    try:
        fed = C.run_port("ddpm_attn", None, str(tmp / "fed"), str(tmp / "init_ddpm_attn.npz"))
    finally:
        D.global_randint, D.global_randn = orig
    jflat = run_workload("ddpm_attn", None, str(tmp / "jax"))
    want = J.port_params(jflat, IDLModel.from_config(config, device="meta").m)
    with np.load(tmp / "init_ddpm_attn.npz") as z:
        init = {k: z[k] for k in z.files}
    return {"mesh": mesh, "single": {"ddpm_attn": single, "ddpm_ema": single_ema}, "fed": fed, "jax": want,
            "init": init}


def test_single_device_run_matches_jax(runs):
    fed = {k: v for k, v in runs["fed"].items() if k in runs["jax"]}
    C.assert_params_close(runs["jax"], fed, atol=1e-4, what="port vs JAX")
    moved = max(np.abs(runs["single"]["ddpm_attn"][k] - runs["init"][k]).max() for k in runs["single"]["ddpm_attn"])
    assert moved > 1e-3  # the steps move the parameters well past the tolerance


@pytest.mark.parametrize("key", [k for k, *_ in JOBS])
def test_mesh_program_matches_single_device(runs, key):
    workload = dict((k, w) for k, w, *_ in JOBS)[key]
    C.assert_params_close(runs["single"][workload], runs["mesh"][key], atol=1e-4, what=key)
