#!/usr/bin/env python3
"""Launch every kernel of one tree of the port from the main thread, from a
new `threading.Thread` and from two threads at once, on the card, and say
why a launch fails.

    python3 scripts/thread_launch_probe.py --tree PATH [--label NAME] [--build-only]

PATH is a checkout of the repository: its `cflearn_torch` is imported and
its kernels are built into its own `cflearn_torch/_build/`. The cases are
`chip_smoke.thread_cases` of this script's own checkout: each kernel at a
shape of its path against its plain version. Unlike
`chip_smoke.thread_launches`, which raises, every failed call's error text
is recorded, with whether the calling thread had a CUDA context bound
before its call (the driver's `cuCtxGetCurrent`); one more thread binds one
first (`torch.cuda.synchronize()`) and then calls. Compare a parent tree
with this one in one call (build both first, `--build-only`, in parallel).
Prints one JSON line a kernel and writes
`chiprun_out/thread_probe_<label>.json`.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import sys
import threading

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def context_bound() -> bool:
    """Whether the calling thread has a CUDA context bound."""
    ctx = ctypes.c_void_p()
    ctypes.CDLL("libcuda.so.1").cuCtxGetCurrent(ctypes.byref(ctx))
    return bool(ctx.value)


def probe(torch, name, call, plain, check) -> dict:
    """One kernel: its error against the plain version and the tolerance (or
    the failed call's text) from each way of calling it, and each new
    thread's context."""
    ref = plain()

    def attempt(out, slot, bind_first=False, barrier=None):
        out[slot + "_context_before"] = context_bound()
        try:
            if bind_first:
                torch.cuda.synchronize()
            if barrier is not None:
                barrier.wait()
            out[slot] = list(check(call(), ref))  # [error, tolerance]
            torch.cuda.current_stream().synchronize()
        except Exception as e:  # noqa: BLE001 (recorded: the probe reports every failure)
            out[slot] = f"{type(e).__name__}: {e}"

    def in_threads(n, bind_first=False):
        out, barrier = {}, threading.Barrier(n) if n > 1 else None
        threads = [threading.Thread(target=attempt, args=(out, f"t{i}", bind_first, barrier)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return {"results": [out[f"t{i}"] for i in range(n)],
                "context_before": [out[f"t{i}_context_before"] for i in range(n)]}

    main = {}
    attempt(main, "main")
    torch.cuda.synchronize()
    row = {"kernel": name, "main": main["main"], "thread": in_threads(1),
           "two_at_once": in_threads(2), "thread_bound_first": in_threads(1, bind_first=True)}
    results = [row["main"]] + [r for way in ("thread", "two_at_once", "thread_bound_first")
                               for r in row[way]["results"]]
    row["ok"] = all(isinstance(r, list) and r[0] <= r[1] for r in results)
    return row


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", required=True)
    parser.add_argument("--label", default=None)
    parser.add_argument("--build-only", action="store_true")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    from cflearn_torch.ops import _native

    secs = _native.build()
    print(f"build {tree}: {json.dumps({k: round(v, 1) for k, v in secs.items()})}", flush=True)
    if args.build_only:
        return 0
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from cflearn_torch.ops import attention as A
    from cflearn_torch.ops import conv as Cv
    from cflearn_torch.ops import group_norm as Gn

    rows = []
    for case in smoke.thread_cases(torch, A, Cv, Gn):
        rows.append(probe(torch, *case))
        print(json.dumps(rows[-1]), flush=True)
    out = {"tree": tree, "card": smoke.card_line(), "rows": rows}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    label = args.label or os.path.basename(tree.rstrip("/"))
    with open(os.path.join(HERE, "chiprun_out", f"thread_probe_{label}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(smoke.card_line())
    print(f"all passed: {all(r['ok'] for r in rows)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
