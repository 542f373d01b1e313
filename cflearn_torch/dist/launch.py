"""Spawn the ranks of a `torch.distributed` program (counterpart of
`cflearn_tpu/dist/launch.py`, the reference's `run_accelerate`).

`run_distributed(script, num_processes=N)` starts N copies of `script`,
each with `MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE` and
`LOCAL_RANK` set (what `parallel.mesh.maybe_initialize_distributed`, which
the `Trainer` calls, reads to form the group; rank r takes `cuda:r`), and
one run timestamp for every rank (`CFLEARN_TORCH_RUN_TS`, so that the
`PrepareWorkplaceBlock` and the `Trainer` of every rank derive the same
sub-workspace). `force_cpu=True` sets `CFLEARN_TORCH_FORCE_CPU=1`: gloo on
the CPU instead of NCCL on the cards. It polls the ranks; when one exits
with an error the others would wait in a collective for ever, so they are
terminated (killed after 10 s) and its code is returned; 0 when all end
well."""

import os
import subprocess
import sys
import time

from ..parallel.mesh import RUN_TS_ENV
from ..toolkit.misc import timestamp


def run_distributed(
    script_path: str,
    *,
    num_processes: int = 2,
    coordinator_port: int = 12355,
    force_cpu: bool = False,
) -> int:
    """Run `num_processes` ranks of `script_path`; the first non-zero exit code, else 0."""
    run_ts = timestamp(ensure_different=True)
    procs = []
    for rank in range(num_processes):
        env = dict(os.environ)
        env.update(
            MASTER_ADDR="localhost",
            MASTER_PORT=str(coordinator_port),
            RANK=str(rank),
            WORLD_SIZE=str(num_processes),
            LOCAL_RANK=str(rank),
        )
        env[RUN_TS_ENV] = run_ts
        if force_cpu:
            env["CFLEARN_TORCH_FORCE_CPU"] = "1"
        procs.append(subprocess.Popen([sys.executable, script_path], env=env))
    code = 0
    try:
        while procs:
            alive = []
            for p in procs:
                rc = p.poll()
                if rc is None:
                    alive.append(p)
                elif rc != 0 and code == 0:
                    code = rc
            if code != 0:
                for p in alive:
                    p.terminate()
                for p in alive:
                    try:
                        p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        p.kill()
                return code
            procs = alive
            if procs:
                time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
    return code
