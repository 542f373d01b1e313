#!/usr/bin/env python3
"""What a CUDA graph does with a `torch.Generator` of its own, on the card.

    python3 scripts/graph_generator_probe.py

A style-reference denoise draws the reference's noise from the call's own
generator inside the UNet call, so `DiffusionAPI.compile` can capture it
only where a replay advances that generator as an eager call would. This
script captures `torch.randn(..., generator=g)` with and without
`CUDAGraph.register_generator_state(g)` and replays it between eager draws
of the same generator, against the same sequence drawn eagerly from a
generator of the same seed. It prints the torch and CUDA versions, which of
the generator APIs exist, each case's outcome (or its exception, verbatim)
and one JSON line, and writes `chiprun_out/graph_generator_probe.json`.
"""

import json
import os
import sys


def draws(torch, g, shape, steps: int, graph_step=None):
    """`steps` rounds of (an eager draw, a draw through `graph_step` or eagerly) from `g`."""
    out = []
    for _ in range(steps):
        out.append(torch.randn(shape, generator=g, device="cuda").clone())
        out.append(graph_step() if graph_step is not None else torch.randn(shape, generator=g, device="cuda") * 2.0)
    return out


def case(torch, register: bool, reseed: bool) -> dict:
    shape = (2, 64, 64, 4)
    g = torch.Generator(device="cuda").manual_seed(5)
    static = torch.full((), 2.0, device="cuda")
    graph = torch.cuda.CUDAGraph()
    rec = {"register": register, "reseed_after_capture": reseed}
    try:
        if register:
            graph.register_generator_state(g)
        state = g.get_state()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            torch.randn(shape, generator=g, device="cuda")  # warm-up, as `CapturedCall` runs one
        torch.cuda.current_stream().wait_stream(s)
        with torch.cuda.graph(graph):
            out = torch.randn(shape, generator=g, device="cuda") * static
        g.set_state(state) if not reseed else g.manual_seed(5)
    except Exception as e:  # noqa: BLE001 — the outcome is what this script reports
        rec["error"] = f"{type(e).__name__}: {e}"
        return rec

    def replay():
        graph.replay()
        return out.clone()

    got = draws(torch, g, shape, 4, replay)
    want = draws(torch, torch.Generator(device="cuda").manual_seed(5), shape, 4)
    torch.cuda.synchronize()
    rec["bit_for_bit"] = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    rec["max_abs"] = max(float((a - b).abs().max()) for a, b in zip(got, want))
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    info = {
        "torch": torch.__version__, "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
        "register_generator_state": hasattr(torch.cuda.CUDAGraph, "register_generator_state"),
        "graphsafe_get_state": hasattr(torch.Generator, "graphsafe_get_state"),
        "graphsafe_set_state": hasattr(torch.Generator, "graphsafe_set_state"),
        "cases": [case(torch, register, reseed) for register, reseed in ((False, False), (True, False), (True, True))],
    }
    for c in info["cases"]:
        print(f"graph generator: register {c['register']}, reseeded after capture {c['reseed_after_capture']}: "
              + (c["error"] if "error" in c else f"bit for bit {c['bit_for_bit']} (max abs {c['max_abs']:.3e})"))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "graph_generator_probe.json"), "w") as f:
        json.dump(info, f, indent=1)
    print(json.dumps(info))
    return 0


if __name__ == "__main__":
    sys.exit(main())
