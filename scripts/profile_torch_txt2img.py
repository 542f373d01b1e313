"""Where the time of the port's main paths goes on one CUDA card.

    python scripts/profile_torch_txt2img.py [--steps 5] [--config lossless] [--w8a8] [--out ...]
    python scripts/profile_torch_txt2img.py --path finetune [--steps 2] [--checkpoint]
    python scripts/profile_torch_txt2img.py --path ae [--steps 2]
    python scripts/profile_torch_txt2img.py --path ldm | ae_defaults | ae_vq [--steps 2]

`--path txt2img` (default): builds full-width SD-1.5 v1 in bf16 from seeded
random weights, runs one warm-up txt2img at 512px (batch 1, CFG batch 2, one
prompt through the CLIP tokenizer), then one txt2img of `--steps` DDIM steps
under `torch.profiler`. `--config` picks the serving configuration
(lossless, faithful: ToMe 0.5 and DeepCache N=3; accelerated: ToMe 0.5 and
DeepCache N=5), `--w8a8` decodes with the W8A8 convs. Writes to
`chiprun_out/profile_torch_txt2img_<config>[_w8a8].json` unless `--out` says
otherwise.

`--path finetune`: builds the full-width SD-1.5 UNet with f32 master
parameters, runs one warm-up `finetune_unet` step at batch 8 (64x64x4
latents, a 77x768 condition, bf16 compute, AdamW 1e-5), then `--steps` steps
under `torch.profiler`. Writes to `chiprun_out/profile_torch_finetune.json`
unless `--out` says otherwise.

`--path ae`: builds the full-width `ae_kl` model (256px, 128 channels,
multipliers [1, 2, 4, 4], two res blocks, PatchGAN discriminator) with f32
master parameters, runs warm-up `train_autoencoder` steps at batch 8 (bf16
compute, Adam), then `--steps` steps under `torch.profiler`.

`--path ldm`: the finetune step of full-width SD-1.5 v1 (its `AutoEncoderKL`
first stage frozen, f32 masters, the text tower dropped) on seeded 512x512x3
images at batch 8, which the first stage encodes in each step. `--path
ae_defaults`: the `ae` workload at the JAX package's defaults (LPIPS with
random weights, the adaptive weight, the warm-up schedule). `--path ae_vq`:
the `ae_vq` model at the `ae` widths, 16384 codes.

Prints the wall time, the summed device time of all kernels and the
device's idle share over the wall, the device time by kernel group and the
top kernels. Writes the same as JSON to `--out`. Imports no JAX.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPS = [
    ("flash backward (port kernels)", ("flash_bwd_kernel", "flash_bwd_kv_outer_kernel", "flash_bwd_q_outer_kernel")),
    ("flash forward (port kernels)", ("flash_fwd_sm90_kernel", "flash_fwd_kernel", "flash_fwd_chunked_kernel")),
    ("conv3x3_w8a8 (port kernels: s8 wgmma, mma.sync yardstick)", ("conv3x3_w8a8_kernel", "epidequant")),
    ("quantize_w8a8 (port kernel)", ("quantize_w8a8_kernel",)),
    ("conv3x3_fold (port kernel)", ("conv3x3_fold_kernel", "taps)1", "kfold")),
    ("conv3x3 (port kernel)", ("conv3x3_fwd_kernel",)),
    ("conv3x3_wgrad (port kernels)", ("wgrad_kernel", "wgrad_reduce_kernel")),
    ("group_norm (port kernels)", ("gn_grid_kernel", "gn_stats_kernel", "gn_finalize_kernel", "gn_apply_kernel")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("cuDNN / library conv", ("conv", "implicit_gemm", "xmma_fprop", "fprop", "dgrad", "wgrad")),
    ("GEMM (Linear)", ("gemm", "cutlass", "sm90_xmma", "cublas", "nvjet")),
    ("library attention (SDPA)", ("fmha", "flash", "attention", "efficient")),
    ("reductions (norm statistics)", ("reduce", "norm")),
    ("elementwise / copies", ("elementwise", "vectorized", "copy", "cat", "index", "fill")),
]


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--path", choices=("txt2img", "finetune", "ae", "ldm", "ae_defaults", "ae_vq"),
                        default="txt2img")
    parser.add_argument("--steps", type=int, default=None, help="DDIM steps (default 5) or train steps (default 2)")
    parser.add_argument("--checkpoint", action="store_true", help="finetune: recompute each UNet block in the backward")
    parser.add_argument("--config", choices=("lossless", "faithful", "accelerated"), default="lossless",
                        help="txt2img: the serving configuration")
    parser.add_argument("--w8a8", action="store_true", help="txt2img: decode with the W8A8 convs")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if args.steps is None:
        args.steps = 5 if args.path == "txt2img" else 2
    if args.out is None:
        name = args.path
        if args.path == "txt2img":
            name += f"_{args.config}" + ("_w8a8" if args.w8a8 else "")
        args.out = os.path.join(ROOT, "chiprun_out", f"profile_torch_{name}.json")

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import cflearn_torch
    from cflearn_torch.modules.common import redraw_zero_init

    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.path == "txt2img":
        from cflearn_torch.ops import conv

        model = cflearn_torch.build_sd("v1", device="cuda", dtype=torch.bfloat16, seed=0)
        redraw_zero_init(model, seed=1)
        conv.W8A8_DEFAULT = args.w8a8
        z = torch.randn((1, 64, 64, 4), generator=gen, device="cuda")

        def run(steps=args.steps):
            out = cflearn_torch.txt2img(
                model, "a photograph of an astronaut riding a horse on the moon", config=args.config,
                num_steps=steps, guidance_scale=7.5, z=z,
            )
            torch.cuda.synchronize()
            return out

        run()
    elif args.path in ("ae", "ae_defaults", "ae_vq"):
        config = dict(img_size=256, in_channels=3, inner_channels=128, z_channels=4, embedding_channels=4,
                      channel_multipliers=[1, 2, 4, 4], num_res_blocks=2, use_perceptual=False, d_loss_start_step=0)
        if args.path == "ae_defaults":
            config.update(use_perceptual=True, use_adaptive_weight=True)
        if args.path == "ae_vq":
            config.update(num_code=16384)
        model = cflearn_torch.build_ae(config, model="ae_vq" if args.path == "ae_vq" else "ae_kl", device="cuda", seed=0)
        images = torch.randn((8, 256, 256, 3), generator=gen, device="cuda").clamp(-1.0, 1.0)

        def run(steps=args.steps):
            out = cflearn_torch.train_autoencoder(
                model, images, num_steps=steps, compute_dtype=torch.bfloat16, generator=gen
            )["losses"]
            torch.cuda.synchronize()
            return out

        run(1)
        run(1)
    elif args.path == "ldm":
        model = cflearn_torch.build_sd("v1", device="cuda", dtype=torch.float32, seed=0)
        model.condition_model = None
        redraw_zero_init(model, seed=1)
        images = torch.rand((8, 512, 512, 3), generator=gen, device="cuda") * 2.0 - 1.0
        ctx = torch.randn((8, 77, 768), generator=gen, device="cuda")

        def run(steps=args.steps):
            out = cflearn_torch.finetune_unet(
                model, images, ctx, num_steps=steps, lr=1e-5, compute_dtype=torch.bfloat16,
                use_checkpoint=args.checkpoint, generator=gen,
            )["losses"]
            torch.cuda.synchronize()
            return out

        run(1)
        run(1)
    else:
        from cflearn_torch.models.cv.diffusion import DDPMModel

        model = DDPMModel(cflearn_torch.build(
            cflearn_torch.DDPM, device="cuda", dtype=torch.float32, seed=0, img_size=64,
            unet_config=cflearn_torch.sd_unet_config("v1"), linear_start=0.00085, linear_end=0.012,
        ))
        redraw_zero_init(model, seed=1)
        x0 = torch.randn((8, 64, 64, 4), generator=gen, device="cuda")
        ctx = torch.randn((8, 77, 768), generator=gen, device="cuda")

        def run(steps=args.steps):
            out = cflearn_torch.finetune_unet(
                model, x0, ctx, num_steps=steps, lr=1e-5, compute_dtype=torch.bfloat16,
                use_checkpoint=args.checkpoint, generator=gen,
            )["losses"]
            torch.cuda.synchronize()
            return out

        run(1)
        run(1)  # the first step also allocates the moments
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0.0) or 0.0
        if dev_us > 0 and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = (dev_us / 1e3, evt.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    groups = {}
    for name, (ms, count) in kernels.items():
        g = groups.setdefault(group_of(name), [0.0, 0])
        g[0] += ms
        g[1] += count
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    report = {
        "device": torch.cuda.get_device_name(0),
        "path": args.path,
        "config": args.config if args.path == "txt2img" else None,
        "w8a8": bool(args.w8a8) if args.path == "txt2img" else None,
        "use_checkpoint": bool(args.checkpoint),
        "steps": args.steps,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches": sum(c for _, c in kernels.values()),
        "groups": {k: {"ms": v[0], "launches": v[1]} for k, v in sorted(groups.items(), key=lambda kv: -kv[1][0])},
        "top": [{"name": n[:160], "ms": ms, "launches": c} for n, (ms, c) in top],
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share {report['device_idle_share']:.3f}, "
          f"{report['kernel_launches']} kernel launches ({args.path} {report['config'] or ''}"
          f"{' w8a8' if args.w8a8 else ''}, {args.steps} steps)")
    for k, v in report["groups"].items():
        print(f"  {k:32s} {v['ms']:9.2f} ms  {v['launches']:6d} launches")
    for row in report["top"]:
        print(f"  {row['ms']:9.2f} ms {row['launches']:6d}  {row['name'][:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
