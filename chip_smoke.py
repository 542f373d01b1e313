#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (`cflearn_torch`) on one CUDA card.

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure exits non-zero:

1. build — compile every CUDA kernel from `cflearn_torch/csrc/` (one `nvcc`
   per source, all at once) and print the seconds.
2. kernels — hold each kernel against its plain PyTorch version at every
   shape SD-1.5 512px txt2img gives it, plus a ragged, a causal and an
   odd-width case; print max_abs_err and the kernel's, the plain version's
   and a library call's ms (the library call is timed only).
3. path — full-width SD-1.5 v1 in bf16 from seeded random weights (the
   zero-initialised output convs redrawn with small noise, so conditioning
   reaches the output), txt2img at batch 1 (CFG batch 2), 512x512, DDIM,
   guidance 7.5. Checks the image, finite latents and the kernel launch
   counts of that run.
4. parity — one full-width UNet denoise and one VAE decode through the
   kernels against the same calls on the plain versions, on the card, held
   to the plain path's own drift under a one-ulp change of its input.
5. summary — a `{"kernels": [...]}` line, the path's img/s, the card's
   name and power limit, and last `{"ok": true, "device": {...}}`.

Imports nothing of JAX or of `cflearn_tpu`. Exits non-zero, printing no
result, without a CUDA device or without the `cflearn_torch` package beside
this file.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
# flash: max_abs_err <= FLASH_REL * max|ref|, i.e. at least 2 bf16 ulps of the
# largest output. Both versions round one f32 result to bf16 (<= 1 ulp apart;
# P's per-block re-rounding adds far less). With N(0, 1) inputs |o| is only
# ~sqrt(e / L) (0.026 at L = 4096), so the limit must scale with the output:
# a dropped kv block or a 3% rescale exceeds it.
FLASH_REL = 2.0**-6
CONV_TOL = 6.25e-2  # 2 bf16 ulps at |y| < 8 (y ~ N(0, 1)); both round the same f32 sum
# whole-net parity: the kernel path may differ from the plain path (max error
# relative to the output's max) by at most PARITY_FACTOR times what the plain
# path differs from itself when its input moves one bf16 ulp, both measured in
# the same run. Each kernel agrees with its plain version to ~1 bf16 ulp per
# call, and the random-weight nets carry such a flip to the output about as far
# as an input flip (on an H100: UNet 1.24e-2, VAE 5.86e-2 for the input flip;
# 1.145e-2 and 4.44e-2 for the kernels).
PARITY_FACTOR = 1.5
STEPS = 20
DECODER_CONVS = 31  # kernel-routed VAE decoder convs per decode
FLASH_PER_UNET = 15  # self-attentions with L >= 256 per UNet call

# (name, B, H, Lq, Lk, D, causal, launches per txt2img as a function of steps)
FLASH_CASES = [
    ("unet_64x64", 2, 8, 4096, 4096, 40, False, lambda s: 5 * s),
    ("unet_32x32", 2, 8, 1024, 1024, 80, False, lambda s: 5 * s),
    ("unet_16x16", 2, 8, 256, 256, 160, False, lambda s: 5 * s),
    ("vae_mid", 1, 1, 4096, 4096, 512, False, lambda s: 1),
    ("ragged", 1, 4, 1000, 777, 64, False, lambda s: 0),
    ("causal", 1, 4, 1000, 1000, 64, True, lambda s: 0),
]
# (name, B, H, W, C, Co, launches per decode)
CONV_CASES = [
    ("64x64_512_512", 1, 64, 64, 512, 512, 10),
    ("128x128_512_512", 1, 128, 128, 512, 512, 7),
    ("256x256_512_512", 1, 256, 256, 512, 512, 1),
    ("256x256_512_256", 1, 256, 256, 512, 256, 1),
    ("256x256_256_256", 1, 256, 256, 256, 256, 5),
    ("512x512_256_256", 1, 512, 512, 256, 256, 1),
    ("512x512_256_128", 1, 512, 512, 256, 128, 1),
    ("512x512_128_128", 1, 512, 512, 128, 128, 5),
    ("odd_129x131_64_96", 2, 129, 131, 64, 96, 0),
]


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def time_ms(torch, fn, min_ms: float = 50.0) -> float:
    """Mean ms per call over a CUDA-event window after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = max(3, min(200, int(min_ms / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_kernels(torch, F, ops):
    A, Cv = ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev, bf16 = "cuda", torch.bfloat16
    rows = {"flash_attention": [], "conv3x3": []}
    for name, b, h, lq, lk, d, causal, per in FLASH_CASES:
        q = torch.randn((b, h, lq, d), generator=gen, device=dev).to(bf16)
        k = torch.randn((b, h, lk, d), generator=gen, device=dev).to(bf16)
        v = torch.randn((b, h, lk, d), generator=gen, device=dev).to(bf16)
        out = A.flash_attention(q, k, v, causal=causal)
        ref = A.flash_attention_plain(q, k, v, causal=causal)
        err = (out.float() - ref.float()).abs().max().item()
        tol = FLASH_REL * ref.float().abs().max().item()
        ms = time_ms(torch, lambda: A.flash_attention(q, k, v, causal=causal))
        plain = time_ms(torch, lambda: A.flash_attention_plain(q, k, v, causal=causal), 20.0)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
        pairs = lq * (lq + 1) / 2 if causal else lq * lk
        bms, by = bound_ms(4.0 * b * h * pairs * d, 2.0 * b * h * (2 * lq + 2 * lk) * d)
        row = dict(case=name, shape=[b, h, lq, lk, d], causal=causal, max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by, per_txt2img=per(STEPS))
        print("flash", json.dumps(row))
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"flash {name}: max_abs_err {err} > {tol}")
        rows["flash_attention"].append(row)
    for name, b, hh, ww, c, co, per in CONV_CASES:
        x = torch.randn((b, hh, ww, c), generator=gen, device=dev).to(bf16)
        w = (torch.randn((co, c, 3, 3), generator=gen, device=dev) * (9 * c) ** -0.5).to(bf16)
        bias = (torch.randn((co,), generator=gen, device=dev) * 0.1).to(bf16)
        wk = Cv.kernel_weight(w)
        out = Cv.conv3x3(x, wk, bias)
        ref = Cv.conv3x3_plain(x, wk, bias)
        err = (out.float() - ref.float()).abs().max().item()
        ms = time_ms(torch, lambda: Cv.conv3x3(x, wk, bias))
        plain = time_ms(torch, lambda: Cv.conv3x3_plain(x, wk, bias), 20.0)
        xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        wc = w.contiguous(memory_format=torch.channels_last)
        lib = time_ms(torch, lambda: F.conv2d(xc, wc, bias, padding=1))
        m = b * hh * ww
        bms, by = bound_ms(2.0 * m * co * 9 * c, 2.0 * (m * c + 9 * c * co + co + m * co))
        row = dict(case=name, shape=[b, hh, ww, c, co], max_abs_err=err, tol=CONV_TOL, ms=ms, plain_ms=plain,
                   library_ms=lib, bound_ms=bms, bound_by=by, per_txt2img=per)
        print("conv3x3", json.dumps(row))
        if not math.isfinite(err) or err > CONV_TOL:
            raise AssertionError(f"conv3x3 {name}: max_abs_err {err} > {CONV_TOL}")
        rows["conv3x3"].append(row)
    return rows


@contextlib.contextmanager
def plain_kernels(A, Cv):
    """Point the dispatchers at the kernels' plain versions: `sdp_attn` and
    `conv_call` look `flash_attention` / `conv3x3` up as module globals."""
    saved = A.flash_attention, Cv.conv3x3
    A.flash_attention, Cv.conv3x3 = A.flash_attention_plain, Cv.conv3x3_plain
    try:
        yield
    finally:
        A.flash_attention, Cv.conv3x3 = saved


def bump_ulp(torch, x):
    """x rounded to bf16 and moved one bf16 ulp away from zero, in x's dtype."""
    b = x.to(torch.bfloat16)
    return (b.view(torch.int16) + 1).view(torch.bfloat16).to(x.dtype)


def rel_err(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not os.path.isdir(os.path.join(HERE, "cflearn_torch", "csrc")):
        return fail("cflearn_torch/ is not beside chip_smoke.py: run it from a checkout of the repo")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch.nn.functional as F

    import cflearn_torch
    from cflearn_torch.modules.common import redraw_zero_init
    from cflearn_torch.ops import _native
    from cflearn_torch.ops import attention as A
    from cflearn_torch.ops import conv as Cv

    print("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))
    print("tf32: matmul", torch.backends.cuda.matmul.allow_tf32, "cudnn", torch.backends.cudnn.allow_tf32)

    # 1. build
    t0 = time.perf_counter()
    secs = _native.build()
    print(f"build: {json.dumps(secs)} total {time.perf_counter() - t0:.1f} s")
    for name in _native.SOURCES:
        log = _native.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas[{name}]", line.strip())

    # 2. kernels
    rows = phase_kernels(torch, F, (A, Cv))

    # 3. path
    steps = STEPS
    t0 = time.perf_counter()
    model = cflearn_torch.build_sd("v1", device="cuda", dtype=torch.bfloat16, seed=0)
    redrawn = redraw_zero_init(model, seed=1)
    torch.cuda.synchronize()
    print(f"path: built SD-1.5 v1 bf16 ({sum(p.numel() for p in model.parameters())} params, "
          f"{redrawn} zero-init modules redrawn) in {time.perf_counter() - t0:.1f} s")
    tokens = np.random.RandomState(0).randint(0, 49000, (1, 77))
    uncond = np.zeros((1, 77), dtype=np.int64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn((1, 64, 64, 4), generator=gen, device="cuda")
    cflearn_torch.txt2img(model, tokens, uncond, num_steps=steps, guidance_scale=7.5, z=z)  # warm-up
    torch.cuda.synchronize()
    A.flash_attention.launches = 0
    Cv.conv3x3.launches = 0
    t0 = time.perf_counter()
    images, latents = cflearn_torch.txt2img(
        model, tokens, uncond, num_steps=steps, guidance_scale=7.5, z=z, return_latents=True
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": A.flash_attention.launches, "conv3x3": Cv.conv3x3.launches}
    print(f"path: steps {steps}, {wall:.3f} s per image, launches {json.dumps(launches)}")
    if tuple(images.shape) != (1, 512, 512, 3) or images.dtype != torch.uint8:
        return fail(f"image {tuple(images.shape)} {images.dtype}, want (1, 512, 512, 3) uint8")
    if not torch.isfinite(latents).all():
        return fail("non-finite latents")
    if launches["flash_attention"] != FLASH_PER_UNET * steps + 1:
        return fail(f"flash launches {launches['flash_attention']} != {FLASH_PER_UNET * steps + 1}")
    if launches["conv3x3"] != DECODER_CONVS:
        return fail(f"conv launches {launches['conv3x3']} != {DECODER_CONVS}")
    print(f"path: image mean {images.float().mean().item():.3f} std {images.float().std().item():.3f}, "
          f"latent std {latents.std().item():.4f}")

    # 4. parity: kernels vs plain versions through the whole net
    with torch.no_grad():
        cond = model.get_cond(torch.as_tensor(np.concatenate([tokens, uncond]), device="cuda"))
        x2 = torch.cat([z, z])
        t2 = torch.full((2,), 981, dtype=torch.long, device="cuda")
        eps_k = model.denoise(x2, t2, cond).float()
        dec_k = model.decode(latents).float()
        with plain_kernels(A, Cv):
            eps_p = model.denoise(x2, t2, cond).float()
            dec_p = model.decode(latents).float()
            # the plain path against itself, its input moved by one bf16 ulp:
            # how far one rounding flip at the input carries through the net
            eps_u = model.denoise(bump_ulp(torch, x2), t2, cond).float()
            lat_b = latents.to(torch.bfloat16).float()
            drift_vae = rel_err(model.decode(bump_ulp(torch, lat_b)).float(), model.decode(lat_b).float())
    drift_unet = rel_err(eps_u, eps_p)
    rel_unet, rel_vae = rel_err(eps_k, eps_p), rel_err(dec_k, dec_p)
    mean_vae = ((dec_k - dec_p).abs().mean() / dec_p.abs().mean()).item()
    tol_unet, tol_vae = PARITY_FACTOR * drift_unet, PARITY_FACTOR * drift_vae
    print(f"parity: plain path vs itself with its input one bf16 ulp away: UNet max rel {drift_unet:.3e}, "
          f"VAE max rel {drift_vae:.3e}")
    print(f"parity: UNet denoise max rel err {rel_unet:.3e} (tolerance {tol_unet:.3e}), "
          f"VAE decode max rel err {rel_vae:.3e} (tolerance {tol_vae:.3e}), mean rel err {mean_vae:.3e}")
    if not rel_unet <= tol_unet or not rel_vae <= tol_vae:
        return fail("kernel path disagrees with the plain path")

    # 5. summary
    sources = {
        "flash_attention": ("cflearn_torch/csrc/flash_attention.cu", "cflearn_tpu/ops/attention.py:35"),
        "conv3x3": ("cflearn_torch/csrc/conv3x3.cu", "cflearn_tpu/ops/conv.py:52"),
    }
    kernels = []
    for name, cases in rows.items():
        main_cases = [r for r in cases if r["per_txt2img"] > 0]

        def total(key: str, cases=main_cases) -> float:
            return sum(r[key] * r["per_txt2img"] for r in cases)

        by = max(main_cases, key=lambda r: r["bound_ms"] * r["per_txt2img"])["bound_by"]
        kernels.append(dict(
            name=name, route="cuda", source=sources[name][0], replaces=sources[name][1],
            launches=launches[name], max_abs_err=max(r["max_abs_err"] for r in cases),
            ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"), bound_by=by,
            library_ms=total("library_ms"),
            per="one txt2img: each main-path shape's time times its launches", shapes=cases,
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"img_per_s": 1.0 / wall, "steps": steps, "batch": 1, "px": 512}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
