"""Gloo ranks for the mesh tests: `spawn(fn, world, tmp_path, *args)` runs
`fn(rank, *args)` in `world` fresh processes (one PyTorch thread each)
joined into one gloo group through a `file://` store under `tmp_path`, and
raises with a rank's traceback if one fails or if they outlast `timeout`.
`fn` must be importable by the new processes: a function of a module on
the test directory's path (this one, or one that imports no JAX)."""

import os
import time
from typing import Any, Callable, Optional

import torch.multiprocessing as mp


def _entry(rank: int, fn: Callable[..., Any], world: int, store: str, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.setdefault("CFLEARN_TORCH_FORCE_CPU", "1")
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable[..., Any], world: int, tmp_path: Any, *args: Any, timeout: float = 150.0) -> None:
    store = os.path.join(str(tmp_path), f"store_{fn.__name__}_{time.monotonic_ns()}")
    ctx = mp.start_processes(_entry, args=(fn, world, store, args), nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks did not end within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


# the contract programs, on the port

SGD = {"all": {"optimizer": "sgd", "optimizer_config": {"lr": 0.05}}}


def ddpm_config(**kwargs: Any) -> Any:
    from cflearn_torch.schema import DLConfig

    return DLConfig(
        model="ddpm",
        module_name="ddpm",
        module_config={
            "img_size": 8, "in_channels": 3, "out_channels": 3, "num_timesteps": 10,
            "unet_config": {
                "start_channels": 32, "num_res_blocks": 1, "channel_multipliers": (1, 2),
                "attention_downsample_rates": (2,), "num_heads": 4, "context_dim": 32,
                "use_spatial_transformer": True,
            },
        },
        **kwargs,
    )


def transformer_config(*, moe: bool = False, pp: bool = True, microbatches: Any = None, **kwargs: Any) -> Any:
    from cflearn_torch.schema import DLConfig

    module_config = {"input_dim": 8, "output_dim": 2, "num_layers": 4, "pipeline_parallel": pp}
    if microbatches is not None:
        module_config["pp_microbatches"] = microbatches
    if moe:
        module_config.update(channel_mixing_type="moe", channel_mixing_config=dict(moe) if isinstance(moe, dict) else
                             {"num_experts": 4, "top_k": 2})
    return DLConfig(module_name="transformer", module_config=module_config, loss_name="cross_entropy", **kwargs)


def workload_data(workload: str) -> Any:
    """The JAX parity workloads' data (`tests/_parity_common.py`), as numpy."""
    import numpy as np

    rng = np.random.RandomState(0)
    if workload.startswith("ddpm"):
        x = rng.randn(32, 8, 8, 3).astype(np.float32)
        cond = rng.randn(32, 4, 32).astype(np.float32)
        return x, None, {"cond": cond}
    if workload == "fcnn":
        x = rng.randn(32, 8).astype(np.float32)
        return x, (x.sum(1, keepdims=True) > 0).astype(np.int64), None
    x = rng.randn(32, 8).astype(np.float32)
    return x, (x.sum(1, keepdims=True) > 0).astype(np.int64), None


def build_config(workload: str, mesh: Any, workspace: str, **extra: Any) -> Any:
    common = dict(workspace=workspace, fixed_steps=3, callback_names=[], optimizer_settings=SGD)
    common.update(extra)
    if mesh is not None:
        common["mesh"] = mesh
    if workload == "ddpm_attn":
        return ddpm_config(**common)
    if workload == "ddpm_ema":
        config = ddpm_config(**common)
        config.module_config["ema_decay"] = 0.9
        return config
    if workload == "transformer_pp":
        return transformer_config(**common)
    if workload == "transformer_moe":
        return transformer_config(moe=True, microbatches=1, **common)
    if workload == "moe_capacity":
        return transformer_config(moe={"num_experts": 4, "top_k": 2, "capacity_factor": 0.5}, pp=False, **common)
    if workload == "fcnn":
        from cflearn_torch.schema import DLConfig

        return DLConfig(
            module_name="fcnn", module_config={"input_dim": 8, "output_dim": 2, "hidden_units": [16]},
            loss_name="cross_entropy", **common,
        )
    raise ValueError(workload)


def run_port(workload: str, mesh: Any, workspace: str, init: str, out: Optional[str] = None, **extra: Any) -> Any:
    """Three SGD steps of `workload` through the port's `Trainer` on `mesh`
    (None: one device) from the states in the npz file `init`; returns
    {name: array} of the trained parameters, whole (and writes them to
    `out` from rank 0)."""
    import numpy as np

    from cflearn_torch.data import ArrayData
    from cflearn_torch.monitors import LazyMonitor
    from cflearn_torch.schema import IDLModel
    from cflearn_torch.toolkit.misc import is_local_rank_0
    from cflearn_torch.trainer import Trainer

    config = build_config(workload, mesh, workspace, **extra)
    model = IDLModel.from_config(config, device="cpu")
    with np.load(init) as z:
        model.load_state_dict({k: z[k] for k in z.files})
    x, y, others = workload_data(workload)
    np.random.seed(142857)
    data = ArrayData.init().fit(x, y, train_others=others) if others else ArrayData.init().fit(x, y)
    trainer = Trainer(config, monitors=[LazyMonitor()])
    trainer.fit(data, model, skip_final_evaluation=True)
    assert trainer.state is not None and trainer.state.step == 3
    params = {k: p.detach().float().numpy().copy() for k, p in model.named_parameters()}
    params.update({
        k: b.detach().float().numpy().copy() for k, b in model.named_buffers()
        if k.endswith((".mean", ".var")) or ".shadow__" in k
    })
    if out is not None and is_local_rank_0():
        np.savez(out, **params)
    return params


def mesh_worker(rank: int, workload: str, mesh: Any, workspace: str, init: str, out: str, extra: Any) -> None:
    run_port(workload, mesh, workspace, init, out, **(extra or {}))


LDM_KW = dict(
    img_size=8, in_channels=4, out_channels=4, num_timesteps=50,
    unet_config=dict(start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2), attention_downsample_rates=(1,),
                     num_heads=4, context_dim=32),
    first_stage_config=dict(img_size=64, inner_channels=32, z_channels=4, embedding_channels=4,
                            channel_multipliers=[1, 2, 2, 2], num_res_blocks=1),
)


def build_ldm(init: Optional[str] = None) -> Any:
    """`__graft_entry__.dryrun_multichip`'s serving LDM on the port (one
    text layer of two heads), seeded, its zero-initialised convs redrawn;
    or with the states of the npz file `init`."""
    import numpy as np

    import cflearn_torch
    from cflearn_torch.modules.common import redraw_zero_init
    from cflearn_torch.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel

    m = cflearn_torch.build(
        cflearn_torch.LDM, device="cpu",
        condition_model=CLIPTextConditionModel(latent_dim=32, num_layers=1, num_heads=2), **LDM_KW,
    )
    if init is None:
        redraw_zero_init(m, 5)
    else:
        with np.load(init) as z:
            m.load_state_dict({k: __import__("torch").from_numpy(z[k]) for k in z.files})
    return m


def txt2img_worker(rank: int, init: str, mesh: Any, out: str) -> None:
    import numpy as np

    from cflearn_torch.api.multimodal.diffusion import DiffusionAPI
    from cflearn_torch.parallel.mesh import make_mesh
    from cflearn_torch.schema.config import MeshConfig

    api = DiffusionAPI(build_ldm(init), device="cpu")
    api.use_mesh(make_mesh(MeshConfig(**mesh)))
    try:
        images = serve_calls(api)
    finally:
        api.use_mesh(None)
    whole = {k: v.detach().numpy() for k, v in api.m.state_dict().items()}
    np.savez(f"{out}_{rank}.npz", **images, **{f"w::{k}": v for k, v in whole.items()})


def serve_calls(api: Any) -> Any:
    """txt2img, img2img and repaint inpainting of 4 images at 64 px, 2 steps."""
    import numpy as np

    rs = np.random.RandomState(7)
    source = rs.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8)
    mask = np.zeros((4, 64, 64), np.float32)
    mask[:, 16:48, 16:48] = 1.0
    return {
        "txt2img": api.txt2img(["a"] * 4, size=(64, 64), num_steps=2, seed=5),
        "img2img": api.img2img(source, cond=["a"] * 4, fidelity=0.5, num_steps=2, seed=5),
        "inpainting": api.inpainting(source, mask, cond=["a"] * 4, num_steps=2, seed=5),
    }


def attention_inputs(heads: int = 4, seed: int = 2) -> Any:
    """(q, k, v, w) for the context-parallel tests: (2, heads, 64, 16) f32 and
    the weights of the scalar sum(o * w) whose gradients are held."""
    import numpy as np

    rs = np.random.RandomState(seed)
    return tuple(rs.randn(2, heads, 64, 16).astype(np.float32) for _ in range(4))


def attention_worker(rank: int, out: str) -> None:
    """Every context-parallel case at context = 4, saved by rank 0: the
    ring and Ulysses (causal or not, forward and gradients), "auto" on
    heads that do not divide, and `sdp_attn`'s route on a context mesh."""
    import numpy as np
    import torch

    from cflearn_torch.ops.attention import sdp_attn
    from cflearn_torch.ops.ring_attention import context_parallel_attention
    from cflearn_torch.parallel.mesh import make_mesh, mesh_context
    from cflearn_torch.schema.config import MeshConfig

    mesh = make_mesh(MeshConfig(data=1, context=4))
    res = {}

    def run(key, fn, heads=4):
        q, k, v, w = (torch.tensor(a, requires_grad=i < 3) for i, a in enumerate(attention_inputs(heads)))
        o = fn(q, k, v)
        (o * w).sum().backward()
        res.update({f"{key}/o": o.detach().numpy(), f"{key}/dq": q.grad.numpy(), f"{key}/dk": k.grad.numpy(),
                    f"{key}/dv": v.grad.numpy()})

    for method in ("ring", "ulysses"):
        for causal in (False, True):
            run(f"{method}/{causal}",
                lambda q, k, v: context_parallel_attention(q, k, v, mesh, causal=causal, method=method))
    run("auto3", lambda q, k, v: context_parallel_attention(q, k, v, mesh, method="auto"), heads=3)
    with mesh_context(mesh):
        run("sdp", lambda q, k, v: sdp_attn(q, k, v, causal=True))
        q = torch.zeros(2, 4, 64, 16)
        kv = torch.zeros(2, 4, 24, 16)
        assert sdp_attn(q, kv, kv).shape == q.shape  # cross-attention shapes stay local
    if rank == 0:
        np.savez(out, **res)


def pipeline_worker(rank: int, out: str) -> None:
    """`pipeline_apply` over pipe = 4 (8 blocks, 4 and 8 microbatches)
    against the blocks one after another: output and gradients, by rank."""
    import numpy as np
    import torch
    from torch.func import functional_call

    from cflearn_torch.modules.core.mixed_stacks import MixingBlock
    from cflearn_torch.modules.common import init_parameters
    from cflearn_torch.parallel.mesh import make_mesh
    from cflearn_torch.parallel.pp import pipeline_apply, stack_module_states
    from cflearn_torch.schema.config import MeshConfig

    torch.manual_seed(0)
    blocks = [MixingBlock(32, 12, 64, token_mixing_type="attention") for _ in range(8)]
    for i, b in enumerate(blocks):
        init_parameters(b, seed=i)
    template, stacked = stack_module_states(blocks)
    mesh = make_mesh(MeshConfig(data=1, pipe=4))
    s = mesh.coord["pipe"]
    local = {k: torch.nn.Parameter(v.detach()[2 * s:2 * s + 2].clone()) for k, v in stacked.items()}

    def block_fn(params, h):
        return functional_call(template, params, (h,))

    x = torch.from_numpy(np.random.RandomState(1).randn(16, 12, 32).astype(np.float32)).requires_grad_(True)
    res = {}
    for m in (4, 8):
        for p in local.values():
            p.grad = None
        x.grad = None
        o = pipeline_apply(block_fn, local, x, mesh=mesh, num_microbatches=m)
        (o ** 2).sum().backward()
        res[f"{m}/o"] = o.detach().numpy()
        res[f"{m}/dx"] = x.grad.numpy()
        res.update({f"{m}/g/{k}": p.grad.numpy() for k, p in local.items()})
    full = {k: torch.nn.Parameter(v.detach().clone()) for k, v in stacked.items()}
    x.grad = None
    o = pipeline_apply(block_fn, full, x, mesh=None)
    (o ** 2).sum().backward()
    res["seq/o"] = o.detach().numpy()
    res["seq/dx"] = x.grad.numpy()
    res.update({f"seq/g/{k}": p.grad[2 * s:2 * s + 2].numpy() for k, p in full.items()})
    np.savez(f"{out}_{rank}.npz", **res)


def programs_worker(rank: int, jobs: Any, tmp: str) -> None:
    """Each job (key, workload, mesh, extra) of `run_port` in turn, from
    `<tmp>/init_<workload>.npz`; rank 0 writes `<tmp>/<key>.npz`."""
    for key, workload, mesh, extra in jobs:
        run_port(workload, mesh, os.path.join(tmp, f"ws_{key}"), os.path.join(tmp, f"init_{workload}.npz"),
                 os.path.join(tmp, f"{key}.npz"), **extra)


def run_programs(jobs: Any, tmp: Any, world: int = 4) -> Any:
    """`programs_worker` on `world` gloo ranks; {key: {name: array}}."""
    import numpy as np

    spawn(programs_worker, world, tmp, list(jobs), str(tmp), timeout=240.0)
    out = {}
    for key, *_ in jobs:
        with np.load(os.path.join(str(tmp), f"{key}.npz")) as z:
            out[key] = {k: z[k] for k in z.files}
    return out


def assert_params_close(base: Any, got: Any, *, atol: float, rtol: float = 0.0, what: str = "") -> None:
    import numpy as np

    assert set(base) == set(got), sorted(set(base) ^ set(got))[:5]
    for k in sorted(base):
        np.testing.assert_allclose(got[k], base[k], atol=atol, rtol=rtol, err_msg=f"{what}: {k} diverged")


def sharded_save_worker(rank: int, init: str, folder: str) -> None:
    """The DDPM UNet placed on {"fsdp": 2, "model": 2} with ZeRO, saved by
    `save_sharded` from every rank."""
    from cflearn_torch.parallel.mesh import make_mesh
    from cflearn_torch.parallel.tp import place_params
    from cflearn_torch.schema import IDLModel
    from cflearn_torch.schema.config import MeshConfig
    import numpy as np

    model = IDLModel.from_config(build_config("ddpm_attn", None, folder), device="cpu")
    with np.load(init) as z:
        model.load_state_dict({k: z[k] for k in z.files})
    place_params(model, make_mesh(MeshConfig(fsdp=2, model=2)), use_fsdp=True)
    model.save_sharded(folder)


def sharded_load_worker(rank: int, folder: str, out: str) -> None:
    """`load_sharded` in each of 2 ranks, then placed on {"model": 2}: this rank's shards."""
    import numpy as np

    from cflearn_torch.parallel.mesh import make_mesh
    from cflearn_torch.parallel.tp import place_params
    from cflearn_torch.schema import IDLModel
    from cflearn_torch.schema.config import MeshConfig

    model = IDLModel.load_sharded(folder, device="cpu")
    place_params(model, make_mesh(MeshConfig(model=2)))
    np.savez(f"{out}_{rank}.npz", **{k: v.detach().numpy() for k, v in model.state_dict().items()})
