#!/usr/bin/env python3
"""How often `torch.profiler` reports no kernel for one GroupNorm call when it
profiles the call the way `tests/test_torch_cuda.py`'s `_kernels_launched`
once did: a fresh `torch.profiler.profile(activities=[CUDA])` around one
call and a synchronize, with or without a CUDA-graph capture and replay of
the same call before it (the order of
`test_group_norm_one_launch_on_both_routes`).

    python3 scripts/profiler_event_probe.py [--runs N]

Each variant runs in a process of its own (CUPTI's state is per process),
`--runs` profiled calls each, on the test's first case (B2 64x64 C960, 32
groups, bf16, no SiLU):

* `after_graph`: capture and replay a graph of the call, then profile one
  call, every run (the test's order);
* `no_graph`: profile one call, no graph ever captured in the process;
* `no_graph_no_teardown`: `no_graph` with `TEARDOWN_CUPTI=0`, which keeps
  CUPTI set up between profiler sessions (PyTorch sets it itself when its
  own CUDA graphs are on, `torch/profiler/profiler.py`);
* `no_graph_marker_before` / `no_graph_marker_after`: `no_graph` with a
  marker kernel (a one-element add) and a synchronize inside the session
  before / after the call: which end of the session loses the record;
* `helper`: the test's helper as it is in the tree
  (`tests/test_torch_cuda.py`'s `_kernels_launched`), after the capture;
* `helper_after_subprocess` / `no_graph_after_subprocess`: the helper, or
  `no_graph`, after the process has started a child process (as a
  kernel's first use does when it builds its library with `nvcc`).

Prints one JSON line per variant: runs, how many saw 0, 1 or more `gn_`
kernels, how many of the sessions that saw none held no kernel at all, the
seconds. Needs a CUDA card; builds the GroupNorm kernel. Writes
`chiprun_out/profiler_event_probe.json`.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("after_graph", "no_graph", "no_graph_no_teardown", "no_graph_marker_before", "no_graph_marker_after",
            "helper", "helper_after_subprocess", "no_graph_after_subprocess")


def run_variant(variant: str, runs: int) -> dict:
    import torch

    sys.path.insert(0, HERE)
    from cflearn_torch.ops import group_norm as G

    empty = []

    def kernels_launched(fn, key):
        marker = torch.zeros(1, device="cuda")
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            if variant.endswith("marker_before"):
                marker.add_(1)
                torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            if variant.endswith("marker_after"):
                marker.add_(1)
                torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        n = sum(key in name for name in names)
        if n == 0:
            empty.append(not names)
        return n

    if variant.startswith("helper"):
        sys.path.insert(0, os.path.join(HERE, "tests"))
        from test_torch_cuda import _kernels_launched as kernels_launched  # noqa: F811

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (2, 64, 64, 960)
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).bfloat16()
    w = (1 + 0.2 * torch.randn((960,), generator=gen, device="cuda")).bfloat16()
    b = (0.2 * torch.randn((960,), generator=gen, device="cuda")).bfloat16()

    def call():
        return G.group_norm_silu(x, w, b, num_groups=32, apply_silu=False)

    call()
    torch.cuda.synchronize()
    if variant.endswith("after_subprocess"):
        subprocess.run([sys.executable, "-c", "pass"], check=True)
    seen = {}
    t0 = time.perf_counter()
    for _ in range(runs):
        if not variant.startswith("no_graph"):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                call()
            graph.replay()
            torch.cuda.synchronize()
        n = kernels_launched(call, "gn_")
        seen[n] = seen.get(n, 0) + 1
    return {"variant": variant, "runs": runs, "kernels_seen": {str(k): v for k, v in sorted(seen.items())},
            "zero": seen.get(0, 0), "zero_with_no_kernel_at_all": sum(empty), "seconds": time.perf_counter() - t0,
            "teardown_cupti": os.environ.get("TEARDOWN_CUPTI"), "torch": torch.__version__,
            "cuda": torch.version.cuda}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--runs", type=int, default=1000)
    parser.add_argument("--variant", choices=VARIANTS)
    args = parser.parse_args()
    if args.variant is not None:
        print(json.dumps(run_variant(args.variant, args.runs)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    results = []
    for variant in VARIANTS:
        env = dict(os.environ)
        if "no_teardown" in variant:
            env["TEARDOWN_CUPTI"] = "0"
        else:
            env.pop("TEARDOWN_CUPTI", None)
        proc = subprocess.run([sys.executable, __file__, "--variant", variant, "--runs", str(args.runs)], env=env,
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profiler_event_probe.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
