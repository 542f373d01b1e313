#!/usr/bin/env python3
"""Time the f32 flash-attention rows of one tree of the port on the card,
with their error against a float64 reference: a before / after comparison
of the f32 product (TF32 in the parent tree, 3xTF32 in this one).

    python3 scripts/f32_flash_3xtf32.py --tree PATH [--label NAME] [--build-only]

PATH is a checkout of the repository: its `cflearn_torch` is imported and
its flash kernels are built into its own `cflearn_torch/_build/`. Compare two
trees in one call, in turns (parent, change, change, parent), and build both
first (`--build-only`, one process each, in parallel).

Shapes (the port's f32 attentions): the ViT-S/16 classifier at 384 px
(B64 H6 L577 d256; its training step at B32 for rows 3-5), the tabular
transformer (B128 H8 L785 d16), CLIP ViT-L/14 and ViT-H/14 towers in f32
(B64 H16 L257, d64 and d80) and DPT-Large on a 512² image (B1 H16 L1025
d64). Row 1 is `flash_attention`, row 3 `flash_fwd_lse`, row 4
`flash_bwd_fused`, row 5 `flash_bwd_dq` + `flash_bwd_dkv`. Times are device
ms a call from CUDA events over a loop of calls after a warm-up; the error
is row 1's max |o - o64| / max |o64| on N(0, 1) inputs. Prints one JSON line
a row and writes `chiprun_out/f32_flash_<label>.json`.
"""

import argparse
import json
import os
import sys
import time

ROWS = {
    "vit384": ((64, 6, 577, 256), (32, 6, 577, 256)),
    "tab785": ((128, 8, 785, 16), (128, 8, 785, 16)),
    "clip_l14": ((64, 16, 257, 64), None),
    "clip_h14": ((64, 16, 257, 80), None),
    "dpt_large": ((1, 16, 1025, 64), None),
}
NAMES = ("flash_attention", "flash_fwd_lse", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")


def event_ms(torch, fn, calls: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", required=True)
    parser.add_argument("--label", default=None)
    parser.add_argument("--build-only", action="store_true")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from cflearn_torch.ops import _native
    from cflearn_torch.ops import attention as A

    assert os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(A.__file__)))) == tree, A.__file__
    t0 = time.perf_counter()
    _native.build(NAMES)
    if args.build_only:
        print(json.dumps({"tree": tree, "built_s": time.perf_counter() - t0}))
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for case, (fwd_shape, train_shape) in ROWS.items():
        b, h, l, d = fwd_shape
        q, k, v = (torch.randn((b, h, l, d), generator=gen, device="cuda") for _ in range(3))
        o = A.flash_attention(q, k, v)
        s = (q.double() @ k.double().transpose(-1, -2)) * d**-0.5
        o64 = torch.softmax(s, dim=-1) @ v.double()
        err = ((o.double() - o64).abs().max() / o64.abs().max()).item()
        del s, o64
        row = {"case": case, "shape": list(fwd_shape), "flash_attention_ms": event_ms(torch, lambda: A.flash_attention(q, k, v)),
               "flash_attention_rel_err_vs_f64": err}
        if train_shape is not None:
            b, h, l, d = train_shape
            q, k, v, do = (torch.randn((b, h, l, d), generator=gen, device="cuda") for _ in range(4))
            o, lse = A.flash_fwd_lse(q, k, v)
            row.update(train_shape=list(train_shape),
                       flash_fwd_lse_ms=event_ms(torch, lambda: A.flash_fwd_lse(q, k, v)),
                       flash_bwd_fused_ms=event_ms(torch, lambda: A.flash_bwd_fused(q, k, v, o, lse, do)),
                       flash_bwd_dq_ms=event_ms(torch, lambda: A.flash_bwd_dq(q, k, v, o, lse, do)),
                       flash_bwd_dkv_ms=event_ms(torch, lambda: A.flash_bwd_dkv(q, k, v, o, lse, do)))
        print(json.dumps(row), flush=True)
        out.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    label = args.label or os.path.basename(tree.rstrip("/"))
    folder = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"f32_flash_{label}.json")
    runs = json.load(open(path)) if os.path.exists(path) else []
    runs.append({"tree": tree, "card": card, "rows": out})
    with open(path, "w") as f:
        json.dump(runs, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
