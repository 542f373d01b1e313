"""The host cost of reaching a kernel through its dispatcher operation, and
the serving paths' ms an image, on one CUDA card.

    python scripts/dispatch_cost.py [--root DIR] [--label NAME] [--images 5] [--out FILE]
                                    [--attention pinned|dispatcher]

Imports `cflearn_torch` from `--root` (default: this checkout), so that two
checkouts can be held against each other on one card, one process each;
for example the parent commit unpacked by `git archive` into a directory
that `.gitignore` lists, run parent, change, change, parent. Builds the
kernels first (`_native.build()`), then:

* **host µs a call** of each kernel's routes at a serving shape: the
  wrapper itself (`group_norm_silu`, `flash_attention`, the conv's launch),
  the entry that the modules call without a gradient (`fused_group_norm`,
  `flash_attention_trainable` under `torch.no_grad()`, `conv3x3`), and the
  `torch.library` operation where the checkout has one
  (`group_norm_silu_op`, `flash_attention_op`, `conv3x3_op`). The clock
  runs from a synchronised start over the enqueue of 200 calls (fewer
  launches than the card's queue holds, so the host never waits on the
  device), 50 rounds of each route taken in turn: 10,000 calls a route.
  Shapes: SD-1.5's GroupNorm at 64² × 320 (CFG batch 2, 32 groups, SiLU),
  its first self-attention (2 × 8 heads, 4096 tokens, d = 40) and a decoder
  conv (64² × 512 → 512), all bf16.
* **ms an image** (host clock around the call and a synchronize): the
  `DiffusionAPI.from_sd("v1")` DDIM txt2img (`api[ddim]` of `chip_smoke.py`)
  and `cflearn_torch.txt2img` in the lossless, faithful and accelerated
  configurations, 512 px, 20 steps, full-width seeded random weights, one
  warm-up each, then `--images` rounds of the four paths in turn; the
  launches of one `api[ddim]` image.

`--attention dispatcher` hands the library attention (`xla_attention`
without a mask or a bias: SD's cross-attentions) to
`F.scaled_dot_product_attention`'s dispatcher instead of the
FlashAttention-2 forward that the checkout pins, to time the pin against
the backend the dispatcher picks; `dispatcher_calls` counts the calls it
took.

Prints one JSON line prefixed `dispatch_cost:` and writes it to `--out`
(default `chiprun_out/dispatch_cost_<label>.json`). Imports no JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

PROMPT = "a photograph of an astronaut riding a horse on the moon, highly detailed, 8k"
CALLS, ROUNDS = 200, 50


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def host_us(torch, routes: dict) -> dict:
    """{route: host µs a call}: each route's enqueue of CALLS calls timed from a
    synchronised start, ROUNDS rounds, the routes in turn."""
    for fn in routes.values():
        fn()
    torch.cuda.synchronize()
    spent = dict.fromkeys(routes, 0.0)
    for _ in range(ROUNDS):
        for name, fn in routes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            spent[name] += time.perf_counter() - t0
    torch.cuda.synchronize()
    return {name: s / (CALLS * ROUNDS) * 1e6 for name, s in spent.items()}


def per_call(torch, A, Cv, Gn) -> dict:
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf16)

    x, w, b = randn(2, 64, 64, 320), randn(320), randn(320)
    q, k, v = randn(2, 8, 4096, 40), randn(2, 8, 4096, 40), randn(2, 8, 4096, 40)
    cx, cw, cb = randn(1, 64, 64, 512), randn(512, 3, 3, 512) * 0.02, randn(512)
    launch_conv = getattr(Cv, "_kernel_conv3x3", None) or Cv._launch_conv3x3
    groups = {
        "group_norm": {
            "wrapper": lambda: Gn.group_norm_silu(x, w, b, num_groups=32, eps=1e-5, apply_silu=True),
            "entry": lambda: Gn.fused_group_norm(x, w, b, 32, 1e-5, True),
            "op": getattr(Gn, "group_norm_silu_op", None) and (lambda: Gn.group_norm_silu_op(x, w, b, 32, 1e-5, True)),
        },
        "flash_attention": {
            "wrapper": lambda: A.flash_attention(q, k, v),
            "entry": lambda: A.flash_attention_trainable(q, k, v),
            "op": getattr(A, "flash_attention_op", None) and (lambda: A.flash_attention_op(q, k, v, False, None)),
        },
        "conv3x3": {
            "wrapper": lambda: launch_conv(cx, cw, cb),
            "entry": lambda: Cv.conv3x3(cx, cw, cb),
            "op": getattr(Cv, "conv3x3_op", None) and (lambda: Cv.conv3x3_op(cx, cw, cb)),
        },
    }
    with torch.no_grad():
        return {kernel: host_us(torch, {name: fn for name, fn in routes.items() if fn is not None})
                for kernel, routes in groups.items()}


def launches(A, Cv, Gn) -> dict:
    return {"flash_attention": A._WRAPPERS["flash_attention"].launches, "conv3x3": Cv._WRAPPER.launches,
            "group_norm": Gn._WRAPPER.launches}


def per_image(torch, cflearn_torch, A, Cv, Gn, images: int) -> dict:
    from cflearn_torch.modules.common import redraw_zero_init

    api = cflearn_torch.DiffusionAPI.from_sd("v1", device="cuda", seed=0)
    redraw_zero_init(api.m, seed=1)
    api.switch_sampler("ddim")
    model = cflearn_torch.build_sd("v1", device="cuda", dtype=torch.bfloat16, seed=0)
    redraw_zero_init(model, seed=1)
    z = torch.randn((1, 64, 64, 4), generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")

    def serve(config):
        def run():
            cflearn_torch.txt2img(model, PROMPT, config=config, num_steps=20, guidance_scale=7.5, z=z)
        return run

    paths = {"api[ddim]": lambda: api.txt2img(PROMPT, num_steps=20, seed=0)}
    paths.update({f"txt2img[{c}]": serve(c) for c in ("lossless", "faithful", "accelerated")})
    for fn in paths.values():
        fn()
    torch.cuda.synchronize()
    before = launches(A, Cv, Gn)
    paths["api[ddim]"]()
    torch.cuda.synchronize()
    ddim_launches = {k: n - before[k] for k, n in launches(A, Cv, Gn).items()}
    ms = {name: [] for name in paths}
    for _ in range(images):
        for name, fn in paths.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    return {"ms": ms, "median_ms": {k: statistics.median(v) for k, v in ms.items()},
            "api_ddim_launches": ddim_launches}


def unpin_library_attention(torch, A) -> dict:
    """`A.xla_attention` without a mask or a bias sent to SDPA's dispatcher;
    returns the count of calls taken that way."""
    pinned, calls = A.xla_attention, {"dispatcher_calls": 0}

    def xla_attention(q, k, v, *, causal=False, sm_scale=None, mask=None, bias=None):
        if mask is None and bias is None:
            calls["dispatcher_calls"] += 1
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=sm_scale)
        return pinned(q, k, v, causal=causal, sm_scale=sm_scale, mask=mask, bias=bias)

    A.xla_attention = xla_attention
    return calls


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default="change")
    parser.add_argument("--images", type=int, default=5)
    parser.add_argument("--out", default=None)
    parser.add_argument("--attention", choices=("pinned", "dispatcher"), default="pinned")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import cflearn_torch
    from cflearn_torch.ops import _native
    from cflearn_torch.ops import attention as A
    from cflearn_torch.ops import conv as Cv
    from cflearn_torch.ops import group_norm as Gn

    if not torch.cuda.is_available():
        print("dispatch_cost: no CUDA card", file=sys.stderr)
        return 1
    if not os.path.abspath(cflearn_torch.__file__).startswith(root + os.sep):
        print(f"dispatch_cost: imported {cflearn_torch.__file__}, not the package under {root}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    built = _native.build()
    result = {"label": args.label, "root": root, "card": card_line(), "torch": torch.__version__,
              "build_s": round(time.perf_counter() - t0, 1), "built": sorted(k for k, s in built.items() if s)}
    result["host_us_per_call"] = per_call(torch, A, Cv, Gn)
    result["attention"] = args.attention
    unpinned = unpin_library_attention(torch, A) if args.attention == "dispatcher" else {}
    result.update(per_image(torch, cflearn_torch, A, Cv, Gn, args.images))
    result.update(unpinned)
    line = json.dumps(result)
    print(f"dispatch_cost: {line}")
    out = args.out or os.path.join("chiprun_out", f"dispatch_cost_{args.label}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
