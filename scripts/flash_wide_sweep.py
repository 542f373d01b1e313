#!/usr/bin/env python3
"""The wide-head flash forward (`cflearn_torch/csrc/flash_fwd_sm90_wide.cuh`, bf16 / fp16 with 256 < d <= 512) on
one CUDA card, beside its yardsticks.

    python3 scripts/flash_wide_sweep.py [--quick]

Builds the two forward libraries (`flash_attention`, `flash_fwd_lse`) and prints what ptxas says of the wide
kernels (registers at launch, spills, serialised wgmma). Then, at every d = 512 shape of the port's paths (the
VAE decode's `vae_mid`, the ae steps' `ae_mid`, the ldm path's frozen encoder `ldm_enc_mid`, the f4 VQ decode's
`vq_dec_mid`) and at ragged, causal, fp16 and d = 264 / 320 cases, the planner's choice and the same with the kv
range in one part (where the planner splits it) are held against the plain version (o and lse) and timed by
CUDA-graph replay (device ms), beside the mma.sync kernel (`kernel="mma_sync"`)
and `F.scaled_dot_product_attention` on the same inputs, and the bound (the products at the bf16 tensor-core
peak, or the bytes at the memory rate). `--quick` checks without timing. Rows go to stdout and to
`chiprun_out/flash_wide_sweep.json`.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 / fp16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
FLASH_REL = 2.0**-6  # `chip_smoke.py`'s limit: two bf16 ulps of the largest output
LSE_TOL = 1e-4
# (name, B, H, Lq, Lk, D, causal, dtype)
CASES = [
    ("vae_mid", 1, 1, 4096, 4096, 512, False, "bfloat16"),
    ("ae_mid", 8, 1, 1024, 1024, 512, False, "bfloat16"),
    ("ldm_enc_mid", 8, 1, 4096, 4096, 512, False, "bfloat16"),
    ("vq_dec_mid", 1, 1, 16384, 16384, 512, False, "bfloat16"),
    ("ragged_d512", 1, 2, 1000, 777, 512, False, "bfloat16"),
    ("causal_d512", 1, 2, 1000, 1000, 512, True, "bfloat16"),
    ("fp16_d512", 2, 1, 1024, 1024, 512, False, "float16"),
    ("d264", 1, 2, 300, 333, 264, False, "bfloat16"),
    ("d320_causal", 1, 2, 300, 300, 320, True, "float16"),
]
TIMED = ("vae_mid", "ae_mid", "ldm_enc_mid", "vq_dec_mid")


def device_ms(torch, fn, calls: int = 10, replays: int = 5) -> float:
    """Mean device ms per call: `calls` calls captured in one CUDA graph, replayed `replays` times."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch.nn.functional as F

    from cflearn_torch.ops import _native
    from cflearn_torch.ops import attention as A

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print("card", card, "torch", torch.__version__, "cuda", torch.version.cuda)
    t0 = time.perf_counter()
    secs = _native.build(["flash_attention", "flash_fwd_lse"])
    print(f"build {json.dumps(secs)} in {time.perf_counter() - t0:.1f} s")
    for name in ("flash_attention", "flash_fwd_lse"):
        log = _native.library_path(name).with_suffix(".log").read_text()
        print(f"ptxas[{name}] wgmma serialised: {log.count('wgmma.mma_async instructions are serialized')}")
        key = None
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                key = ln.split("'")[1] if "flash_fwd_wide" in ln else None
            elif key and ("Used " in ln or "spill" in ln):
                print(f"ptxas[{name}] {key}: {ln.strip()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the planner's kv parts, and one part: `SM90_WIDE_MAX_SPLITS` for the planner, restored after each case
    variants = {"planned": A.SM90_WIDE_MAX_SPLITS, "one_part": 1}
    default = A.SM90_WIDE_MAX_SPLITS
    rows, bad = [], []
    for name, b, h, lq, lk, d, causal, dtype in CASES:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda").to(dt) for n in (lq, lk, lk))
        ref_o, ref_lse = A.flash_fwd_with_lse_plain(q, k, v, causal=causal)
        tol = FLASH_REL * ref_o.float().abs().max().item()
        row = dict(case=name, shape=[b, h, lq, lk, d], causal=causal, dtype=dtype, tol=tol, card=card)
        for label, max_splits in variants.items():
            A.SM90_WIDE_MAX_SPLITS = max_splits
            A.flash_plan.cache_clear()
            plan = A.flash_plan(b, h, lq, lk, d, dt, sms)
            o = A.flash_attention(q, k, v, causal=causal)
            o2, lse = A.flash_fwd_lse(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (o.float() - ref_o.float()).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            same = torch.equal(o, o2) and torch.equal(o, A.flash_attention(q, k, v, causal=causal))
            row[label] = dict(plan=dict(splits=plan.splits, ctas=plan.ctas, smem=plan.smem), max_abs_err=err,
                              lse_err=err_lse, repeatable=same)
            if not (err <= tol and err_lse <= LSE_TOL and same):
                bad.append((name, label, err, err_lse, same))
            if name in TIMED and not args.quick:
                row[label]["device_ms"] = device_ms(torch, lambda: A.flash_attention(q, k, v, causal=causal))
                row[label]["lse_device_ms"] = device_ms(torch, lambda: A.flash_fwd_lse(q, k, v, causal=causal))
        A.SM90_WIDE_MAX_SPLITS = default
        A.flash_plan.cache_clear()
        err_old = (A.flash_attention(q, k, v, causal=causal, kernel="mma_sync").float() - ref_o.float()).abs().max()
        row["mma_sync_max_abs_err"] = err_old.item()
        if name in TIMED and not args.quick:
            row["mma_sync_device_ms"] = device_ms(torch, lambda: A.flash_attention(q, k, v, causal=causal,
                                                                                   kernel="mma_sync"), 5, 2)
            row["sdpa_device_ms"] = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
            pairs = lq * (lq + 1) / 2 if causal else lq * lk
            ops_ms = 4.0 * b * h * pairs * d / PEAK_BF16_FLOPS * 1e3
            bytes_ms = 2.0 * b * h * (2 * lq + 2 * lk) * d / PEAK_BYTES * 1e3
            row["bound_ms"], row["bound_by"] = max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"
        print("wide", json.dumps(row))
        rows.append(row)
        del q, k, v, ref_o, ref_lse
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "flash_wide_sweep.json"), "w") as f:
        json.dump(rows, f, indent=1)
    if bad:
        print("FAIL:", bad, file=sys.stderr)
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
