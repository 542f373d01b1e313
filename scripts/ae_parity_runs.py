"""How the ae parity of `chip_smoke.py` reads over many states of the weights, on one CUDA card.

    python scripts/ae_parity_runs.py [--runs 20] [--seed 4] [--f32] [--out chiprun_out/ae_parity_runs.json]

Each run builds the full-width `ae_kl` model of `chip_smoke.py` (`AE_CONFIG`, seed 0), draws the
images and the noise from its own seed (`--seed`, `--seed` + 1, ...), takes one warm-up and
`AE_STEPS` `train_autoencoder` steps at batch 8 through the kernels (their sums are not in a fixed
order, so the state differs from run to run even at one seed), then reads the parity exactly as
`chip_smoke.py` phase 8 does (`chip_smoke.ae_parity`). Prints one JSON line a run: the gate it
failed (or null), the ratios that the gates take (the worst module against its allowance, the
global norm and the median module against theirs), the largest allowance of any module and of a
conv module, and, not gated, the worst single leaf against max(its own drift, the leaves' upper
decile). `--f32` also computes the gradient through the plain versions in f32 (no TF32) as a more
exact reference, and prints how far the kernel path and the plain bf16 path each lie from it, module
by module: whether the kernels are less exact than the plain path, or only differ from it. The last
line sums the runs up. Writes all runs to `--out`. Imports no JAX.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=20)
    parser.add_argument("--seed", type=int, default=4)
    parser.add_argument("--f32", action="store_true", help="also read both paths against an f32 reference")
    parser.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "ae_parity_runs.json"))
    args = parser.parse_args()

    import math

    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this script needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as S
    import cflearn_torch
    from cflearn_torch.models.cv.diffusion import INPUT_KEY, LOSS_KEY
    from cflearn_torch.ops import _native
    from cflearn_torch.ops import attention as A
    from cflearn_torch.ops import conv as Cv
    from cflearn_torch.ops import group_norm as Gn
    from cflearn_torch.optimizers import build_optimizer
    from cflearn_torch.trainer import MultiScopeStep

    print(S.card_line())
    t0 = time.perf_counter()
    _native.build(["conv3x3", "conv3x3_wgrad", "group_norm", "flash_attention", "flash_fwd_lse", "flash_bwd_fused"])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    runs = []
    for run in range(args.runs):
        t1 = time.perf_counter()
        seed = args.seed + run
        gen = torch.Generator(device="cuda").manual_seed(seed)
        ae = cflearn_torch.build_ae(S.AE_CONFIG, device="cuda", seed=0)
        images = torch.randn((S.AE_BATCH, 256, 256, 3), generator=gen, device="cuda").clamp(-1.0, 1.0)
        kw = dict(compute_dtype=torch.bfloat16, generator=gen)
        cflearn_torch.train_autoencoder(ae, images, num_steps=1, **kw)
        cflearn_torch.train_autoencoder(ae, images, num_steps=S.AE_STEPS, **kw)
        scopes = ("core", "discriminator")
        cores = {}
        for dtype in (torch.bfloat16, torch.float32):
            multi = MultiScopeStep(ae, {s: build_optimizer("adam", 1e-4) for s in scopes}, compute_dtype=dtype)
            cores[dtype] = multi.steps["core"]
            cores[dtype].train_step.step_actives = {s: True for s in scopes}
        z_noise = torch.randn((S.AE_BATCH, 32, 32, 4), generator=gen, device="cuda")

        def fwd_bwd(x, dtype=torch.bfloat16):
            core = cores[dtype]
            losses = core.loss_and_grads({INPUT_KEY: x}, forward_kwargs={"noise": z_noise})
            grads, core.grads = core.grads, {}
            return losses[LOSS_KEY].item(), grads

        def reference(x):
            # called on the plain path: the same step in f32, with no TF32 in the matmuls and convolutions
            tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            try:
                return fwd_bwd(x, torch.float32)[1]
            finally:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

        par = S.ae_parity(torch, fwd_bwd, images, A, Cv, Gn, reference if args.f32 else None)
        mods = par["modules"]
        table = par["module_drift_and_error"]
        conv = [S.AE_PARITY_FACTOR * max(d, mods["floor"]) for name, (d, _) in table.items()
                if name.rsplit(".", 1)[-1].startswith(("conv", "shortcut"))]
        row = {
            "run": run, "seed": seed, "failure": par["failure"],
            "worst_module_ratio": mods["worst_ratio"], "worst_module": mods["worst_module"],
            "global_ratio": par["kernels_vs_plain"]["global_rel"] / par["drift"]["global_rel"],
            "median_ratio": mods["err_median"] / mods["drift_median"],
            "largest_allowance": mods["largest_allowance"], "largest_conv_allowance": max(conv),
            "leaf_worst_ratio": mods["leaf_worst_ratio"], "leaf_worst": mods["leaf_worst"],
            "drift": par["drift"], "seconds": time.perf_counter() - t1,
        }
        if par["accuracy"]:
            # each module's error against the f32 reference, the kernel path's over the plain path's
            acc = {m: k / p for m, (k, p) in par["accuracy"]["modules"].items() if p > 0}
            worst, best = max(acc, key=acc.get), min(acc, key=acc.get)
            row["f32"] = {
                "global": par["accuracy"]["global"], "mean_log_ratio": sum(map(math.log, acc.values())) / len(acc),
                "max_ratio": acc[worst], "max_module": worst, "min_ratio": acc[best], "min_module": best,
            }
        runs.append(row)
        print(json.dumps(row), flush=True)
        del par, cores, ae
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": S.card_line(), "runs": runs}, f, indent=1)
    factor = S.AE_PARITY_FACTOR
    print(json.dumps({
        "runs": len(runs), "failed": sum(r["failure"] is not None for r in runs),
        "max_worst_module_ratio": max(r["worst_module_ratio"] for r in runs),
        "max_global_ratio": max(r["global_ratio"] for r in runs),
        "max_median_ratio": max(r["median_ratio"] for r in runs),
        "max_largest_allowance": max(r["largest_allowance"] for r in runs),
        "max_largest_conv_allowance": max(r["largest_conv_allowance"] for r in runs),
        "runs_with_a_leaf_past_the_factor": sum(r["leaf_worst_ratio"] > factor for r in runs),
        "max_leaf_worst_ratio": max(r["leaf_worst_ratio"] for r in runs),
        **({"f32_mean_log_ratio": sum(r["f32"]["mean_log_ratio"] for r in runs) / len(runs),
            "f32_max_ratio": max(r["f32"]["max_ratio"] for r in runs),
            "f32_min_ratio": min(r["f32"]["min_ratio"] for r in runs)} if args.f32 else {}),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
