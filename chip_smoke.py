#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (`cflearn_torch`) on one CUDA card.

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure exits non-zero:

1. build — compile every CUDA kernel from `cflearn_torch/csrc/` (one `nvcc`
   per source, all at once) and print the seconds.
2. kernels — hold each kernel against its plain PyTorch version: the
   forward and the conv at every shape SD-1.5 512px txt2img gives them, the
   forward-with-logsumexp and the three backward kernels at the three shapes
   of the UNet finetune step (batch 8), plus ragged, causal, f32, d = 640 and
   odd-width cases; print max_abs_err and the kernel's, the plain version's
   and a library call's ms (the library call is timed only).
3. path — full-width SD-1.5 v1 in bf16 from seeded random weights (the
   zero-initialised output convs redrawn with small noise, so conditioning
   reaches the output), txt2img at batch 1 (CFG batch 2), 512x512, DDIM,
   guidance 7.5. Checks the image, finite latents and the kernel launch
   counts of that run.
4. parity — one full-width UNet denoise and one VAE decode through the
   kernels against the same calls on the plain versions, on the card, held
   to the plain path's own drift under a one-ulp change of its input.
5. train path — the full-width SD-1.5 UNet with f32 master parameters,
   `finetune_unet` at batch 8 on 64x64x4 latents and a 77x768 condition,
   bf16 compute, AdamW 1e-5: one warm-up step, then timed steps. Checks the
   losses, the gradients, that every parameter moved, and the launch counts.
6. train parity — one forward + backward through the kernels against the
   same through the plain versions (loss, per-leaf and global gradient
   error, held to the plain path's drift under a one-ulp change of its
   input); then the split dq / dk.dv kernels on the same step, twice: launch
   counts, bit-identical attention gradients, and agreement with the fused
   kernel.
7. summary — a `{"kernels": [...]}` line, the paths' img/s and samples/s,
   the card's name and power limit, and last `{"ok": true, "device": {...}}`.
   The per-shape rows also go to `chiprun_out/chip_smoke.json`.

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

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 / fp16 tensor-core rate
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 rate: what the f32 flash kernels' products run in
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
# flash: max_abs_err <= FLASH_REL * max|ref|, i.e. at least 2 bf16 ulps of the
# largest output. Both versions round one f32 result to bf16 (<= 1 ulp apart;
# P's per-block re-rounding adds far less). With N(0, 1) inputs |o| is only
# ~sqrt(e / L) (0.026 at L = 4096), so the limit must scale with the output:
# a dropped kv block or a 3% rescale exceeds it. The backward kernels' dq, dk,
# dv are held to the same limit, each against its own max|ref|: a dropped
# `- delta`, a skipped kv tile or a missing scale on dq exceeds it
# (`tests/test_torch_train_ops.py`).
FLASH_REL = 2.0**-6
# f32 inputs: the kernels' products round their operands to TF32 (10-bit
# mantissa, relative 2^-11 per operand), the plain version multiplies in full
# f32. Over a d-long dot product of N(0, 1) values that is ~1e-3 of the
# result (measured 5e-4..7e-4 of max|ref|), so the limit is 2^-8 of max|ref|.
FLASH_REL_TF32 = 2.0**-8
# lse = m + log l in f32 from both: bf16 products are exact in f32, so only
# the summation order differs; TF32 rounds the scores (|s| up to ~5) by 2^-11.
LSE_TOL = {2: 1e-4, 4: 4e-3}  # by input element size
CONV_TOL = 6.25e-2  # 2 bf16 ulps at |y| < 8 (y ~ N(0, 1)); both round the same f32 sum
# whole-net parity: the kernel path may differ from the plain path (max error
# relative to the output's max) by at most PARITY_FACTOR times what the plain
# path differs from itself when its input moves one bf16 ulp, both measured in
# the same run. Each kernel agrees with its plain version to ~1 bf16 ulp per
# call, and the random-weight nets carry such a flip to the output about as far
# as an input flip (on an H100: UNet 1.24e-2, VAE 5.86e-2 for the input flip;
# 1.145e-2 and 4.44e-2 for the kernels).
PARITY_FACTOR = 1.5
# train parity: the same idea for the gradients of one finetune step. An input
# flip enters the net once; the kernel path differs from the plain one at 15
# forward and 15 backward attention calls, each by ~1 bf16 ulp. On an H100 the
# gradients moved by 3.06e-3 (global norm) and 2.77e-2 (worst leaf) for the
# input flip and by 2.21e-3 and 2.32e-2 for the kernels, so the factor has
# more room than PARITY_FACTOR.
TRAIN_PARITY_FACTOR = 2.0
STEPS = 20
DECODER_CONVS = 31  # kernel-routed VAE decoder convs per decode
FLASH_PER_UNET = 15  # self-attentions with L >= 256 per UNet call
TRAIN_BATCH = 8
TRAIN_STEPS = 3

# (name, B, H, Lq, Lk, D, causal, dtype, launches per txt2img as a function of steps)
FLASH_CASES = [
    ("unet_64x64", 2, 8, 4096, 4096, 40, False, "bfloat16", lambda s: 5 * s),
    ("unet_32x32", 2, 8, 1024, 1024, 80, False, "bfloat16", lambda s: 5 * s),
    ("unet_16x16", 2, 8, 256, 256, 160, False, "bfloat16", lambda s: 5 * s),
    ("vae_mid", 1, 1, 4096, 4096, 512, False, "bfloat16", lambda s: 1),
    ("ragged", 1, 4, 1000, 777, 64, False, "bfloat16", lambda s: 0),
    ("causal", 1, 4, 1000, 1000, 64, True, "bfloat16", lambda s: 0),
    ("f32", 1, 4, 1000, 777, 64, False, "float32", lambda s: 0),
    ("d640", 1, 2, 512, 512, 640, False, "bfloat16", lambda s: 0),
]
# (name, B, H, Lq, Lk, D, causal, dtype, launches per finetune step)
TRAIN_CASES = [
    ("unet_64x64", TRAIN_BATCH, 8, 4096, 4096, 40, False, "bfloat16", 5),
    ("unet_32x32", TRAIN_BATCH, 8, 1024, 1024, 80, False, "bfloat16", 5),
    ("unet_16x16", TRAIN_BATCH, 8, 256, 256, 160, False, "bfloat16", 5),
    ("ragged", 1, 4, 1000, 777, 64, False, "bfloat16", 0),
    ("causal", 1, 4, 1000, 1000, 64, True, "bfloat16", 0),
    ("f32", 1, 4, 1000, 777, 64, False, "float32", 0),
    ("d640", 1, 2, 512, 512, 640, False, "bfloat16", 0),
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
# floating-point operations per (q, k, d) triple: two products forward; five
# in the fused backward; s, dp, dq in the dq kernel; s, dp, dv, dk in the dk.dv kernel
OPS_PER_TRIPLE = {"flash_fwd_lse": 4.0, "flash_bwd_fused": 10.0, "flash_bwd_dq": 6.0, "flash_bwd_dkv": 8.0}
TRAIN_KERNELS = tuple(OPS_PER_TRIPLE)


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


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def flash_rel(dtype_size: int) -> float:
    return FLASH_REL if dtype_size == 2 else FLASH_REL_TF32


def phase_kernels(torch, F, ops):
    A, Cv = ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev, bf16 = "cuda", torch.bfloat16
    rows = {"flash_attention": [], "conv3x3": []}
    for name, b, h, lq, lk, d, causal, dtype, per in FLASH_CASES:
        dt = getattr(torch, dtype)
        q = torch.randn((b, h, lq, d), generator=gen, device=dev).to(dt)
        k = torch.randn((b, h, lk, d), generator=gen, device=dev).to(dt)
        v = torch.randn((b, h, lk, d), generator=gen, device=dev).to(dt)
        out = A.flash_attention(q, k, v, causal=causal)
        ref = A.flash_attention_plain(q, k, v, causal=causal)
        err = max_err(out, ref)
        tol = flash_rel(q.element_size()) * ref.float().abs().max().item()
        ms = time_ms(torch, lambda: A.flash_attention(q, k, v, causal=causal))
        plain = time_ms(torch, lambda: A.flash_attention_plain(q, k, v, causal=causal), 20.0)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
        pairs = lq * (lq + 1) / 2 if causal else lq * lk
        peak = PEAK_BF16_FLOPS if q.element_size() == 2 else PEAK_TF32_FLOPS
        bms, by = bound_ms(4.0 * b * h * pairs * d, q.element_size() * b * h * (2 * lq + 2 * lk) * d, peak)
        row = dict(case=name, shape=[b, h, lq, lk, d], dtype=dtype, causal=causal, max_abs_err=err, tol=tol,
                   ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by, per_path=per(STEPS))
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
        err = max_err(out, ref)
        ms = time_ms(torch, lambda: Cv.conv3x3(x, wk, bias))
        plain = time_ms(torch, lambda: Cv.conv3x3_plain(x, wk, bias), 20.0)
        xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        wc = w.contiguous(memory_format=torch.channels_last)
        lib = time_ms(torch, lambda: F.conv2d(xc, wc, bias, padding=1))
        m = b * hh * ww
        bms, by = bound_ms(2.0 * m * co * 9 * c, 2.0 * (m * c + 9 * c * co + co + m * co))
        row = dict(case=name, shape=[b, hh, ww, c, co], max_abs_err=err, tol=CONV_TOL, ms=ms, plain_ms=plain,
                   library_ms=lib, bound_ms=bms, bound_by=by, per_path=per)
        print("conv3x3", json.dumps(row))
        if not math.isfinite(err) or err > CONV_TOL:
            raise AssertionError(f"conv3x3 {name}: max_abs_err {err} > {CONV_TOL}")
        rows["conv3x3"].append(row)
    return rows


def phase_train_kernels(torch, F, A):
    """The forward-with-lse and the three backward kernels against their
    plain versions. The backward kernels and the plain backward get the same
    o and lse (the plain forward's), so each comparison isolates one kernel.
    The library yardstick is autograd through `F.scaled_dot_product_attention`,
    forward and backward timed apart; the port never calls it."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {name: [] for name in TRAIN_KERNELS}
    for name, b, h, lq, lk, d, causal, dtype, per in TRAIN_CASES:
        dt = getattr(torch, dtype)
        q = torch.randn((b, h, lq, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, h, lk, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, h, lk, d), generator=gen, device="cuda").to(dt)
        # dO as autograd hands it over on the path: (B, L, H, D) storage
        do = torch.randn((b, lq, h, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
        kw = dict(causal=causal)
        o_ref, lse_ref = A.flash_fwd_with_lse_plain(q, k, v, **kw)
        grads_ref = A.flash_bwd_plain(q, k, v, o_ref, lse_ref, do, **kw)
        size = q.element_size()
        rel = flash_rel(size)
        pairs = lq * (lq + 1) / 2 if causal else lq * lk
        peak = PEAK_BF16_FLOPS if size == 2 else PEAK_TF32_FLOPS
        qo, kv, rows_q = b * h * lq * d * size, b * h * lk * d * size, b * h * lq * 4
        nbytes = {
            "flash_fwd_lse": 2 * qo + 2 * kv + rows_q,  # q, k, v in; o, lse out
            "flash_bwd_fused": 3 * qo + 4 * kv + 2 * rows_q,  # q, k, v, dO, lse, delta in; dq, dk, dv out
            "flash_bwd_dq": 3 * qo + 2 * kv + 2 * rows_q,
            "flash_bwd_dkv": 2 * qo + 4 * kv + 2 * rows_q,
        }
        # library yardstick: SDPA forward, and its backward through autograd
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True))
        del lib_out
        plain_fwd = time_ms(torch, lambda: A.flash_fwd_with_lse_plain(q, k, v, **kw), 20.0)
        plain_bwd = time_ms(torch, lambda: A.flash_bwd_plain(q, k, v, o_ref, lse_ref, do, **kw), 20.0)
        runs = {
            "flash_fwd_lse": lambda: A.flash_fwd_lse(q, k, v, **kw),
            "flash_bwd_fused": lambda: A.flash_bwd_fused(q, k, v, o_ref, lse_ref, do, **kw),
            "flash_bwd_dq": lambda: (A.flash_bwd_dq(q, k, v, o_ref, lse_ref, do, **kw),),
            "flash_bwd_dkv": lambda: A.flash_bwd_dkv(q, k, v, o_ref, lse_ref, do, **kw),
        }
        refs = {
            "flash_fwd_lse": (o_ref,),
            "flash_bwd_fused": grads_ref,
            "flash_bwd_dq": grads_ref[:1],
            "flash_bwd_dkv": grads_ref[1:],
        }
        for kernel in TRAIN_KERNELS:
            outs = runs[kernel]()
            torch.cuda.synchronize()
            errs = {}
            if kernel == "flash_fwd_lse":
                errs["lse"] = (max_err(outs[1], lse_ref), LSE_TOL[size])
                outs = outs[:1]
            for label, got, ref in zip(("o",) if kernel == "flash_fwd_lse" else
                                       {"flash_bwd_fused": ("dq", "dk", "dv"), "flash_bwd_dq": ("dq",),
                                        "flash_bwd_dkv": ("dk", "dv")}[kernel], outs, refs[kernel]):
                if got.shape != ref.shape or got.dtype != ref.dtype:
                    raise AssertionError(f"{kernel} {name}: {label} is {tuple(got.shape)} {got.dtype}")
                errs[label] = (max_err(got, ref), rel * ref.float().abs().max().item())
            ms = time_ms(torch, runs[kernel])
            bms, by = bound_ms(OPS_PER_TRIPLE[kernel] * b * h * pairs * d, nbytes[kernel], peak)
            fwd = kernel == "flash_fwd_lse"
            row = dict(case=name, shape=[b, h, lq, lk, d], dtype=dtype, causal=causal,
                       max_abs_err=max(e for e, _ in errs.values()),
                       errs={k_: e for k_, (e, _) in errs.items()}, tols={k_: t for k_, (_, t) in errs.items()},
                       ms=ms, plain_ms=plain_fwd if fwd else plain_bwd, library_ms=lib_fwd if fwd else lib_bwd,
                       bound_ms=bms, bound_by=by, per_path=per)
            print(kernel, json.dumps(row))
            for label, (e, t) in errs.items():
                if not math.isfinite(e) or e > t:
                    raise AssertionError(f"{kernel} {name}: {label} max_abs_err {e} > {t}")
            rows[kernel].append(row)
    return rows


@contextlib.contextmanager
def plain_kernels(A, Cv):
    """Point the callers at the kernels' plain versions: `sdp_attn`, the
    autograd function and `conv_call` look the wrappers up as module globals."""
    names = ("flash_attention", "flash_fwd_lse", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")
    saved = {n: getattr(A, n) for n in names}
    saved_conv = Cv.conv3x3
    A.flash_attention = A.flash_attention_plain
    A.flash_fwd_lse = A.flash_fwd_with_lse_plain
    A.flash_bwd_fused = A.flash_bwd_plain
    A.flash_bwd_dq = lambda *a, **kw: A.flash_bwd_plain(*a, **kw)[0]
    A.flash_bwd_dkv = lambda *a, **kw: A.flash_bwd_plain(*a, **kw)[1:]
    Cv.conv3x3 = Cv.conv3x3_plain
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(A, n, fn)
        Cv.conv3x3 = saved_conv


@contextlib.contextmanager
def split_backward(A, record):
    """Route the backward to the split dq / dk.dv kernels and append each
    call's inputs and outputs to `record`."""
    saved = A.FUSED_BWD, A.flash_bwd_dq, A.flash_bwd_dkv
    dq_fn, dkv_fn = A.flash_bwd_dq, A.flash_bwd_dkv

    def rec_dq(*args, **kw):
        out = dq_fn(*args, **kw)
        record.append(("dq", args, kw, (out,)))
        return out

    def rec_dkv(*args, **kw):
        out = dkv_fn(*args, **kw)
        record.append(("dkv", args, kw, tuple(out)))
        return out

    A.FUSED_BWD, A.flash_bwd_dq, A.flash_bwd_dkv = False, rec_dq, rec_dkv
    try:
        yield
    finally:
        A.FUSED_BWD, A.flash_bwd_dq, A.flash_bwd_dkv = saved


def bump_ulp(torch, x):
    """x rounded to bf16 and moved one bf16 ulp away from zero, in x's dtype."""
    b = x.to(torch.bfloat16)
    return (b.view(torch.int16) + 1).view(torch.bfloat16).to(x.dtype)


def rel_err(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def reset_launches(A, Cv) -> None:
    Cv.conv3x3.launches = 0
    A.flash_attention.launches = 0
    for name in TRAIN_KERNELS:
        getattr(A, name).launches = 0


def read_launches(A, Cv) -> dict:
    out = {"flash_attention": A.flash_attention.launches, "conv3x3": Cv.conv3x3.launches}
    out.update({name: getattr(A, name).launches for name in TRAIN_KERNELS})
    return out


def grad_errors(grads, ref) -> dict:
    """Per-leaf max relative error (max|a - b| / max|b|, over leaves with a
    non-zero reference) and the error of the whole gradient in the global
    2-norm, relative to the reference's norm."""
    worst, worst_name, num, den = 0.0, "", 0.0, 0.0
    for name, r in ref.items():
        g = grads[name].float()
        r = r.float()
        num += (g - r).square().sum().item()
        den += r.square().sum().item()
        scale = r.abs().max().item()
        if scale > 0:
            e = (g - r).abs().max().item() / scale
            if e > worst:
                worst, worst_name = e, name
    return {"leaf_max_rel": worst, "leaf": worst_name, "global_rel": math.sqrt(num / max(den, 1e-300))}


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
    from cflearn_torch.models.cv.diffusion import INPUT_KEY, LOSS_KEY, DDPMModel
    from cflearn_torch.modules.common import redraw_zero_init
    from cflearn_torch.ops import _native
    from cflearn_torch.ops import attention as A
    from cflearn_torch.ops import conv as Cv
    from cflearn_torch.trainer import make_train_step

    print("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))
    print("tf32: matmul", torch.backends.cuda.matmul.allow_tf32, "cudnn", torch.backends.cudnn.allow_tf32)
    t_start = time.perf_counter()

    # 1. build
    t0 = time.perf_counter()
    secs = _native.build()
    print(f"build: {json.dumps(secs)} total {time.perf_counter() - t0:.1f} s")
    for name in _native.SOURCES:
        log = _native.library_path(name).with_suffix(".log")
        if log.exists():
            lines = [ln for ln in log.read_text().splitlines() if "registers" in ln or "spill" in ln]
            regs = [int(ln.split("Used ")[1].split(" ")[0]) for ln in lines if "Used " in ln]
            spills = [ln for ln in lines if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
            print(f"ptxas[{name}] {len(regs)} kernels, registers {min(regs, default=0)}..{max(regs, default=0)}, "
                  f"{len(spills)} with spills")

    # 2. kernels
    rows = phase_kernels(torch, F, (A, Cv))
    rows.update(phase_train_kernels(torch, F, A))
    torch.cuda.empty_cache()
    print(f"kernels: done at {time.perf_counter() - t_start:.0f} s")

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
    reset_launches(A, Cv)
    t0 = time.perf_counter()
    images, latents = cflearn_torch.txt2img(
        model, tokens, uncond, num_steps=steps, guidance_scale=7.5, z=z, return_latents=True
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(A, Cv)
    print(f"path: steps {steps}, {wall:.3f} s per image, launches {json.dumps(launches)}")
    if tuple(images.shape) != (1, 512, 512, 3) or images.dtype != torch.uint8:
        return fail(f"image {tuple(images.shape)} {images.dtype}, want (1, 512, 512, 3) uint8")
    if not torch.isfinite(latents).all():
        return fail("non-finite latents")
    if launches["flash_attention"] != FLASH_PER_UNET * steps + 1:
        return fail(f"flash launches {launches['flash_attention']} != {FLASH_PER_UNET * steps + 1}")
    if launches["conv3x3"] != DECODER_CONVS:
        return fail(f"conv launches {launches['conv3x3']} != {DECODER_CONVS}")
    if any(launches[name] for name in TRAIN_KERNELS):
        return fail(f"txt2img launched a training kernel: {launches}")
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
    del model, images, latents, cond, eps_k, eps_p, eps_u, dec_k, dec_p
    torch.cuda.empty_cache()
    print(f"serving phases: done at {time.perf_counter() - t_start:.0f} s")

    # 5. train path: the UNet finetune step at full width, batch 8
    def build_unet():
        m = cflearn_torch.build(
            cflearn_torch.DDPM, device="cuda", dtype=torch.float32, seed=0, img_size=64,
            unet_config=cflearn_torch.sd_unet_config("v1"), linear_start=0.00085, linear_end=0.012,
        )
        redraw_zero_init(m, seed=1)
        return DDPMModel(m)

    gen = torch.Generator(device="cuda").manual_seed(2)
    x0 = torch.randn((TRAIN_BATCH, 64, 64, 4), generator=gen, device="cuda")
    ctx = torch.randn((TRAIN_BATCH, 77, 768), generator=gen, device="cuda")
    train_kw = dict(lr=1e-5, compute_dtype=torch.bfloat16, generator=gen)
    tmodel = build_unet()
    n_params = sum(p.numel() for _, p in tmodel.params_filter("all"))
    use_checkpoint = False
    try:
        cflearn_torch.finetune_unet(tmodel, x0, ctx, num_steps=1, use_checkpoint=False, **train_kw)  # warm-up
    except torch.cuda.OutOfMemoryError:
        use_checkpoint = True
    if use_checkpoint:
        # eight samples' activations do not fit beside the f32 masters, their
        # gradients and moments: recompute each block in the backward instead
        # (outside the handler, so that the failed step's tensors are freed)
        del tmodel
        torch.cuda.empty_cache()
        tmodel = build_unet()
        cflearn_torch.finetune_unet(tmodel, x0, ctx, num_steps=1, use_checkpoint=True, **train_kw)  # warm-up
    torch.cuda.synchronize()
    print(f"train: UNet {n_params} trainable f32 parameters, batch {TRAIN_BATCH}, bf16 compute, "
          f"use_checkpoint={use_checkpoint}")
    before = [p.detach().clone() for _, p in tmodel.params_filter("all")]
    torch.cuda.reset_peak_memory_stats()
    reset_launches(A, Cv)
    t0 = time.perf_counter()
    result = cflearn_torch.finetune_unet(
        tmodel, x0, ctx, num_steps=TRAIN_STEPS, use_checkpoint=use_checkpoint, **train_kw
    )
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_launches = read_launches(A, Cv)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = result["losses"].tolist()
    step_ms = train_wall / TRAIN_STEPS * 1e3
    print(f"train: {TRAIN_STEPS} steps, {step_ms:.1f} ms per step, {TRAIN_BATCH / step_ms * 1e3:.2f} samples/s, "
          f"peak memory {peak_gb:.2f} GiB, losses {losses}, launches {json.dumps(train_launches)}")
    if not all(math.isfinite(x) for x in losses):
        return fail(f"non-finite loss: {losses}")
    # non-reentrant checkpointing runs the first forward with a graph too, so
    # each routed attention takes the forward-with-lse kernel twice per step
    want = {
        "flash_fwd_lse": FLASH_PER_UNET * TRAIN_STEPS * (2 if use_checkpoint else 1),
        "flash_bwd_fused": FLASH_PER_UNET * TRAIN_STEPS,
        "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_attention": 0, "conv3x3": 0,
    }
    if train_launches != want:
        return fail(f"train launches {train_launches} != {want}")
    grads = result["step"].grads
    bad = [n for n, g in grads.items() if not torch.isfinite(g).all()]
    if bad or len(grads) != len(before):
        return fail(f"{len(bad)} of {len(grads)} gradients are not finite, e.g. {bad[:3]}")
    zero = [n for n, g in grads.items() if not g.any()]
    still = [n for (n, p), old in zip(tmodel.params_filter("all"), before) if torch.equal(p, old)]
    print(f"train: {len(grads)} gradient leaves finite, {len(zero)} all-zero, {len(still)} parameters unmoved")
    if zero or still:
        return fail(f"zero gradients {zero[:3]}, unmoved parameters {still[:3]}")
    del before, result, grads
    torch.cuda.empty_cache()
    print(f"train path: done at {time.perf_counter() - t_start:.0f} s")

    # 6. train parity: one forward + backward, kernels vs plain versions
    tmodel.m.unet.use_checkpoint = use_checkpoint
    step = make_train_step(tmodel, lr=1e-5, compute_dtype=torch.bfloat16)
    t_fix = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device="cuda")
    noise = torch.randn(x0.shape, generator=gen, device="cuda")
    x0_b = x0.to(torch.bfloat16).float()  # on the bf16 grid, so that the bump below is one ulp
    batch = {INPUT_KEY: x0_b, "cond": ctx}

    def fwd_bwd(b=batch):
        loss = step.loss_and_grads(b, t=t_fix, noise=noise)[LOSS_KEY].item()
        grads, step.grads = step.grads, {}
        return loss, grads

    loss_k, grads_k = fwd_bwd()
    with plain_kernels(A, Cv):
        loss_p, grads_p = fwd_bwd()
        # the plain path against itself, x0 moved one bf16 ulp
        loss_u, grads_u = fwd_bwd({INPUT_KEY: bump_ulp(torch, x0_b), "cond": ctx})
    drift = grad_errors(grads_u, grads_p)
    err_k = grad_errors(grads_k, grads_p)
    del grads_u
    # the loss is an f32 mean of 131072 squared errors of bf16 outputs: hold it
    # to the drift too, but not below 2^-10 of its value (a quarter bf16 ulp)
    tol_loss = max(TRAIN_PARITY_FACTOR * abs(loss_u - loss_p), 2.0**-10 * abs(loss_p))
    print(f"train parity: loss kernels {loss_k:.6f} plain {loss_p:.6f} plain+ulp {loss_u:.6f} (tolerance {tol_loss:.3e})")
    print(f"train parity: plain path vs itself with x0 one bf16 ulp away: {json.dumps(drift)}")
    print(f"train parity: kernels vs plain: {json.dumps(err_k)} (tolerance {TRAIN_PARITY_FACTOR} x the drift)")
    if not abs(loss_k - loss_p) <= tol_loss:
        return fail("train loss through the kernels disagrees with the plain path")
    if not err_k["global_rel"] <= TRAIN_PARITY_FACTOR * drift["global_rel"]:
        return fail("gradients through the kernels disagree with the plain path (global norm)")
    if not err_k["leaf_max_rel"] <= TRAIN_PARITY_FACTOR * drift["leaf_max_rel"]:
        return fail("gradients through the kernels disagree with the plain path (per leaf)")
    del grads_p

    # the split (deterministic) backward on the same step, twice
    split_runs, split_launches = [], None
    for _ in range(2):
        record = []
        reset_launches(A, Cv)
        with split_backward(A, record):
            loss_s, grads_s = fwd_bwd()
        torch.cuda.synchronize()
        split_launches = read_launches(A, Cv)
        if (split_launches["flash_bwd_dq"], split_launches["flash_bwd_dkv"], split_launches["flash_bwd_fused"]) != (
            FLASH_PER_UNET, FLASH_PER_UNET, 0
        ):
            return fail(f"split backward launches {split_launches}")
        split_runs.append((record, grads_s))
    (rec_a, grads_a), (rec_b, grads_b) = split_runs
    same_inputs = same_outputs = 0
    for (kind_a, args_a, kw_a, out_a), (kind_b, args_b, _, out_b) in zip(rec_a, rec_b):
        if kind_a != kind_b:
            return fail("the two split runs called the kernels in different orders")
        # the kernel again on the first run's inputs: bit-identical outputs
        fn = A.flash_bwd_dq if kind_a == "dq" else A.flash_bwd_dkv
        again = fn(*args_a, **kw_a)
        again = (again,) if kind_a == "dq" else tuple(again)
        if not all(torch.equal(x, y) for x, y in zip(again, out_a)):
            return fail(f"flash_bwd_{kind_a} is not bit-reproducible on the same inputs")
        if all(torch.equal(x, y) for x, y in zip(args_a, args_b)):
            same_inputs += 1
            if all(torch.equal(x, y) for x, y in zip(out_a, out_b)):
                same_outputs += 1
    whole_equal = all(torch.equal(grads_a[n], grads_b[n]) for n in grads_a)
    print(f"split backward: launches {json.dumps(split_launches)}; {len(rec_a)} kernel calls re-run on their inputs "
          f"bit-identically; across the two runs {same_inputs} calls met bit-identical inputs and {same_outputs} of "
          f"them gave bit-identical attention gradients; whole-net gradients bit-identical: {whole_equal}")
    if len(rec_a) != 2 * FLASH_PER_UNET or same_outputs != same_inputs:
        return fail("the split backward's attention gradients are not bit-reproducible")
    err_s = grad_errors(grads_k, grads_a)
    print(f"split backward: fused vs split gradients {json.dumps(err_s)} (tolerance {TRAIN_PARITY_FACTOR} x the drift)")
    if not err_s["global_rel"] <= TRAIN_PARITY_FACTOR * drift["global_rel"]:
        return fail("fused and split backward disagree")
    if not err_s["leaf_max_rel"] <= TRAIN_PARITY_FACTOR * drift["leaf_max_rel"]:
        return fail("fused and split backward disagree (per leaf)")
    print(f"train parity: done at {time.perf_counter() - t_start:.0f} s")

    # 7. summary
    src = "cflearn_torch/csrc/"
    tpu = "cflearn_tpu/ops/"
    # name: (source, TPU kernel, launches of the path that runs it, what "ms" sums over)
    per_img, per_step = "one txt2img: each main-path shape's time times its launches", \
        "one finetune step: each main-path shape's time times its launches"
    info = {
        "flash_attention": (src + "flash_attention.cu", tpu + "attention.py:35", launches["flash_attention"], per_img),
        "conv3x3": (src + "conv3x3.cu", tpu + "conv.py:52", launches["conv3x3"], per_img),
        "flash_fwd_lse": (src + "flash_fwd_lse.cu", tpu + "attention.py:196", train_launches["flash_fwd_lse"], per_step),
        "flash_bwd_fused": (src + "flash_bwd_fused.cu", tpu + "attention.py:340", train_launches["flash_bwd_fused"],
                            per_step),
        "flash_bwd_dq": (src + "flash_bwd_dq.cu", tpu + "attention.py:247", split_launches["flash_bwd_dq"], per_step),
        "flash_bwd_dkv": (src + "flash_bwd_dkv.cu", tpu + "attention.py:290", split_launches["flash_bwd_dkv"],
                          per_step),
    }
    kernels = []
    for name, cases in rows.items():
        main_cases = [r for r in cases if r["per_path"] > 0]

        def total(key: str, cases=main_cases) -> float:
            return sum(r[key] * r["per_path"] for r in cases)

        by = max(main_cases, key=lambda r: r["bound_ms"] * r["per_path"])["bound_by"]
        source, replaces, count, per = info[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=count, max_abs_err=max(r["max_abs_err"] for r in cases),
            ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"), bound_by=by,
            library_ms=total("library_ms"), per=per,
        ))
    serve = {"img_per_s": 1.0 / wall, "steps": steps, "batch": 1, "px": 512}
    train = {"finetune_steps_per_s": 1e3 / step_ms, "samples_per_s": TRAIN_BATCH / step_ms * 1e3,
             "step_ms": step_ms, "batch": TRAIN_BATCH, "use_checkpoint": use_checkpoint,
             "peak_memory_gib": peak_gb, "seconds_total": time.perf_counter() - t_start}
    # the per-shape rows printed above, once more in one file beside the checkout
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": card_line(), "kernels": kernels, "shapes": rows, "txt2img": serve, "finetune": train,
                   "train_parity": {"drift": drift, "kernels_vs_plain": err_k, "fused_vs_split": err_s}}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps(serve))
    print(json.dumps(train))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
