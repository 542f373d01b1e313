"""Serving and files on a mesh, over gloo ranks on the CPU.

- Contract program 4: `DiffusionAPI.use_mesh` txt2img of
  `dryrun_multichip`'s tiny SD pipeline (`__graft_entry__.py:202-264`) on
  {"data": 2, "model": 2} (4 ranks): the text tower, the UNet and the
  decoder's attention split over model (the decoder's one-head attention
  stays whole: its q / k / v cannot split), the 4 prompts over data; every
  rank's images held to the single-device call's at `atol=1` on uint8, as
  the JAX dryrun holds them; img2img and repaint inpainting of 4 images
  the same way; `use_mesh(None)` gives back the whole parameters bit for
  bit.
- `save_sharded` on {"fsdp": 2, "model": 2} writes from every rank only
  what that rank owns; `load_sharded` puts the whole model back bit for
  bit, in this process and in each rank of a 2-rank group, where it is
  placed on {"model": 2} again.
- `run_distributed`: two processes form a gloo group from its environment,
  all-reduce, and derive one run timestamp (one workspace)."""

import os
import socket
import sys
import textwrap

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _torch_bridge_common  # noqa: F401,E402
import _torch_mesh_common as C  # noqa: E402


def test_use_mesh_txt2img_matches_single_device(tmp_path):
    from cflearn_torch.api.multimodal.diffusion import DiffusionAPI

    m = C.build_ldm()
    np.savez(tmp_path / "ldm.npz", **{k: v.numpy() for k, v in m.state_dict().items()})
    base = C.serve_calls(DiffusionAPI(m, device="cpu"))
    assert all(v.shape == (4, 64, 64, 3) and v.std() > 10 for v in base.values())
    C.spawn(C.txt2img_worker, 4, tmp_path, str(tmp_path / "ldm.npz"), {"data": 2, "model": 2}, str(tmp_path / "t2i"))
    for rank in range(4):
        with np.load(tmp_path / f"t2i_{rank}.npz") as z:
            for path, want in base.items():
                np.testing.assert_allclose(z[path].astype(np.int16), want.astype(np.int16), atol=1, err_msg=path)
            for k, v in m.state_dict().items():
                np.testing.assert_array_equal(z[f"w::{k}"], v.numpy())


def test_save_sharded_then_load_anywhere(tmp_path):
    from cflearn_torch.parallel.tp import plan_placement
    from cflearn_torch.schema import IDLModel

    model = IDLModel.from_config(C.build_config("ddpm_attn", None, str(tmp_path)), device="cpu")
    states = {k: v.numpy() for k, v in model.state_dict().items()}
    np.savez(tmp_path / "init.npz", **states)
    folder = tmp_path / "sharded"
    C.spawn(C.sharded_save_worker, 4, tmp_path, str(tmp_path / "init.npz"), str(folder))
    files = {}
    for rank in range(4):
        with np.load(folder / f"rank{rank}.npz") as z:
            files[rank] = {k: z[k].shape for k in z.files}
    plan = plan_placement(model, {"data": 1, "fsdp": 2, "model": 2, "context": 1, "pipe": 1}, use_fsdp=True)
    for name, shape in states.items():
        spec = plan[name].spec if name in plan else ()
        holders = [r for r in range(4) if name in files[r]]
        # rank = fsdp * 2 + model: a tensor is written by the ranks along the axes it is split over
        want = [r for r in range(4) if ("fsdp" in spec or r // 2 == 0) and ("model" in spec or r % 2 == 0)]
        assert holders == want, (name, spec, holders)
        for r in holders:
            assert np.prod(files[r][name]) * len(holders) == np.prod(shape.shape), name
    loaded = IDLModel.load_sharded(str(folder), device="cpu")
    for k, v in loaded.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), states[k], err_msg=k)
    C.spawn(C.sharded_load_worker, 2, tmp_path, str(folder), str(tmp_path / "two"))
    plan2 = plan_placement(model, {"data": 1, "fsdp": 1, "model": 2, "context": 1, "pipe": 1})
    from cflearn_torch.parallel.tp import _local_of

    for rank in range(2):
        with np.load(tmp_path / f"two_{rank}.npz") as z:
            for k in z.files:
                want = states[k] if k not in plan2 else _local_of(
                    torch.from_numpy(states[k]), plan2[k], {"model": 2, "pipe": 1}, {"model": rank, "pipe": 0}
                ).numpy()
                np.testing.assert_array_equal(z[k], want, err_msg=k)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_run_distributed_two_process_all_reduce(tmp_path):
    from cflearn_torch.dist import run_distributed

    out_dir = tmp_path / "out"
    out_dir.mkdir()
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
        import torch
        import torch.distributed as dist
        from cflearn_torch.parallel.mesh import maybe_initialize_distributed, run_timestamp

        torch.set_num_threads(1)
        assert maybe_initialize_distributed()
        assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
        t = torch.tensor([float(dist.get_rank())])
        dist.all_reduce(t)
        assert t.item() == 1.0, t
        with open(os.path.join({str(out_dir)!r}, f"rank{{dist.get_rank()}}.ok"), "w") as f:
            f.write(run_timestamp())
        dist.destroy_process_group()
    """))
    code = run_distributed(str(script), num_processes=2, coordinator_port=_free_port(), force_cpu=True)
    assert code == 0
    stamps = {p.name: p.read_text() for p in out_dir.iterdir()}
    assert sorted(stamps) == ["rank0.ok", "rank1.ok"] and len(set(stamps.values())) == 1
    bad = tmp_path / "bad.py"
    bad.write_text("import sys, time\nif __import__('os').environ['RANK'] == '1':\n    sys.exit(3)\ntime.sleep(60)\n")
    assert run_distributed(str(bad), num_processes=2, coordinator_port=_free_port(), force_cpu=True) == 3
