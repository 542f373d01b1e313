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
   odd-width cases; the conv forward, its dx (the forward kernel on dy with
   flipped weights) and the weight-gradient kernel at every shape the
   autoencoder step routes; GroupNorm with and without SiLU at the UNet's, the
   VAE decoder's and the autoencoder step's shapes, plus f32 and odd group
   widths; the conv forward, GroupNorm and the flash forward at the
   first-stage encoder's shapes of the ldm path (batch 8, 512px); the d = 512
   forward (the wide-head wgmma + TMA kernel) also at the f4 VQ decoder's
   L = 16384 and at ragged and causal cases, each with its logsumexp held
   against the plain forward's. Prints max_abs_err and the kernel's, the
   plain version's and a library call's ms (the library call is timed
   only), and the kernel's
   device time (`device_ms`: calls replayed from a CUDA graph, without the
   host's enqueue time). The flash forwards also run the mma.sync
   kernel of `flash_fwd.cuh` on request at every shape (checked and timed beside the
   wgmma + TMA kernel), and their bounds count the softmax's exponentials; so
   do the three backward kernels, beside the mma.sync kernel of
   `flash_bwd.cuh`, with SDPA's backward timed by CUDA-graph replay too
   (`yardstick` lines).
   The W8A8 route and the dj-folded conv at every VAE-decoder conv shape:
   the quantiser (one launch) bit for bit against `w8a8_operands` in bf16
   and fp16, with its byte bound; the int8 conv (s8 wgmma + TMA) bit for
   bit (its int32 sums are exact) in bf16 and fp16 out, with and without
   bias, beside its previous design, the mma.sync kernel
   (`kernel="mma_sync"`), with the bf16 cuDNN conv and the bf16 conv kernel
   timed beside it as the unquantised conv it stands in for, the whole route
   timed too, and a `yardstick` line of device ms per W8A8 decode; the flash
   forward at the ToMe-merged 64x64 shape. The
   fold runs beside its previous design, the mma.sync kernel
   (`kernel="mma_sync"`), and GroupNorm beside its previous three-launch
   design (`kernel="slabs"`), each checked and timed on the same inputs;
   GroupNorm's one launch is also replayed from a CUDA graph, bit for bit
   (`yardstick` lines, with each row's plan).
3. path — full-width SD-1.5 v1 in bf16 from seeded random weights (the
   zero-initialised output convs redrawn with small noise, so conditioning
   reaches the output), txt2img at batch 1 (CFG batch 2), 512x512, DDIM,
   guidance 7.5, one prompt through the CLIP tokenizer, in each serving
   configuration of `bench.py` from the same z: lossless, faithful (ToMe 0.5,
   DeepCache N=3 at cut 1), accelerated (ToMe 0.5, DeepCache N=5 at cut 1),
   and ToMe alone. Checks each image, finite latents, the exact kernel launch
   counts of each run, its seconds per image, and the lossy configurations'
   PSNR / SSIM against the lossless image (the JAX package's floors).
4. parity — one full-width UNet denoise and one VAE decode through the
   kernels against the same calls on the plain versions, on the card, held
   to the plain path's own drift under a one-ulp change of its input. Then
   the lossless latents decoded again with W8A8 on (31 int8 conv launches
   and 31 quantiser launches, no bf16 conv launch; PSNR >= 30 dB, SSIM >=
   0.98 against the bf16 decode; its ms by event window beside the bf16 and
   the dj-folded decodes)
   and with the dj-folded conv (31 fold launches; held to the bf16 decode
   within the parity factor times the VAE's one-ulp drift).
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
7. ae path — the full-width `ae_kl` model (256px, 128 channels, multipliers
   [1, 2, 4, 4], two res blocks, PatchGAN discriminator) with f32 masters,
   `train_autoencoder` at batch 8, bf16 compute, Adam: one warm-up step, then
   timed steps. Checks the six loss items, that every parameter of both scopes
   and the BatchNorm statistics moved, the gradients, the exact launch counts
   and the peak memory.
8. ae parity — one `core` forward + backward through the kernels against the
   same through the plain versions (same noise): the loss, the gradient's
   global norm and each module's gradient (a weight with its bias), held to
   the plain path's drift under four one-ulp changes of the images
   (`ae_parity`; `scripts/ae_parity_runs.py` repeats it over seeds); then
   the same step twice with the split attention backward: bit-identical
   gradients.
9. ldm path — full-width SD-1.5 v1 (`StableDiffusion`, its `AutoEncoderKL`
   first stage frozen, f32 masters, the text tower dropped), `finetune_unet`
   at batch 8 on seeded 512x512x3 images in [-1, 1] with a 77x768
   condition, bf16 compute, AdamW 1e-5: one warm-up step, then timed steps.
   Checks that the UNet saw 64x64x4 latents, that the first stage came out
   bit for bit unchanged, that every UNet parameter moved, the exact
   launches (the encoder's flash, conv and GroupNorm calls added to the
   finetune step's), ms per step and peak memory; then the encode through
   the kernels against the plain versions, held to the plain path's drift
   under a one-ulp move of the images (phase 4's measure).
10. ae path at the JAX package's defaults — phase 7's workload with LPIPS
   (random weights, the JAX package's warning printed), the adaptive
   weight and the default optimizer settings (Adam behind a warm-up x3 from
   lr / 3): the loss items with `core_perceptual`, each step's lr against
   the schedule, a finite adaptive weight in [0, 0.5e4], LPIPS unchanged,
   exact launches, ms per step and peak memory; phase 8's loss and
   global-norm gates on this config's `core` step.
11. ae_vq path — `ae_vq` at phase 7's widths (16384 codes of 4), batch 8:
   finite losses with `core_vq`, indices in range, the codebook moved,
   exact launches; printed, not gated, the share of code indices on which
   the kernel and plain paths agree (argmin ties in bf16).
12. DiffusionAPI path — SD-1.5 v1 served as a user of the JAX package
   serves it, through `DiffusionAPI.from_sd` (bf16, seeded random weights,
   zero-initialised convs redrawn) and `ControlledDiffusionAPI`, batch 1,
   512px, CFG 7.5: `txt2img` with every registered sampler at the API's 20
   steps (`lcm` at 4); `sample_with_control` with one full-width ControlNet
   on a 512x512x3 hint, gated on for steps 2-18; `img2img` at fidelity 0.2;
   repaint inpainting on the 4-channel model; a rank-4 LoRA pack over the
   UNet's attention projections, fused, sampled with and removed; and
   9-channel inpainting (`from_sd_inpainting`), NORMAL and MASKED. Each path
   runs twice, first under a census of the serving kernels' calls, then
   timed (ms per image on the host clock): exact launches (the encoder's
   included), its UNet calls at the CFG batch, finite latents. Gates: one
   UNet-plus-ControlNet call and the batch-1 encode through the kernels
   against the plain versions within 1.5x the plain path's one-ulp drift
   (phase 4's rule); every fused LoRA weight within one bf16 ulp of W +
   s up down, the restore bit for bit. Each distinct kernel call of the
   census is then timed alone by CUDA-graph replay: device ms per image by
   kernel for every path.
13. VQ latent-diffusion path — the zoo's VQ family served through
   `DiffusionAPI` at full width (bf16, seeded random weights, zero-initialised
   convs redrawn), batch 1, 20 DDIM steps: `from_inpainting()` runs
   `inpainting` on a 256px image with a centre mask and `outpainting` in pad
   mode (a 384px canvas) and in the RGBA convention; `from_semantic()` runs
   `semantic2img` on a 512px index map of 182 classes; `ldm_vq(6 input
   channels, concat)` runs `sr` on a 32px image (128x128 latents, 512px out).
   Each path runs under the census, then timed: exact launches (from the
   architectures, `VQ_PER_CALL`), 20 UNet calls at batch 1, finite latents,
   and for inpainting the unmasked pixels within one level of the input.
   Every distinct kernel call of the census (flash at d = 32, 64, 96, 128
   and 512; the conv at C = 224, 448, 672; GroupNorm at 7 to 64 channels a
   group) is held against its plain version with phase 2's tolerances and
   timed alone (device ms, its plain version's ms, the library call's
   device ms, the bound). One UNet call of each architecture, the f4 encode
   and the f4 decode agree with the plain path within 1.5x its one-ulp
   drift (phase 4's rule).
14. summary — a `{"kernels": [...]}` line (eleven kernels: the ten that
   replace a TPU kernel and the W8A8 quantiser), the paths' img/s
   and samples/s, the serving configurations' img/s on a line of their own,
   the new training paths' readings on a line of their own, the DiffusionAPI
   path's and the VQ family's on lines of their own, the card's name and
   power limit, and last `{"ok": true, "device": {...}}`. The per-shape
   rows also go to `chiprun_out/chip_smoke.json`.

Imports nothing of JAX or of `cflearn_tpu`. Exits non-zero, printing no
result, without a CUDA device or without the `cflearn_torch` package beside
this file.
"""

import contextlib
import copy
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 / fp16 tensor-core rate
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 rate: what the f32 flash kernels' products run in
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
# the special-function unit's exponentials (ex2) per clock on one SM, compute capability 9.0 (CUDA C
# Programming Guide, arithmetic instruction throughput): with the SM count and the card's SM clock
# (`nvidia-smi --query-gpu=clocks.max.sm`, read in `main`) the rate that bounds a softmax
EX2_PER_CLOCK_PER_SM = 16
EXP_PER_S = None  # set in `main`: SMs x EX2_PER_CLOCK_PER_SM x the SM clock in Hz
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
# the conv at the autoencoder step's shapes (forward, and dx with flipped weights, whose outputs
# have variance Co / C): the same two ulps, of the largest output
CONV_REL = 2.0**-6
# weight gradient: both versions sum exact products of 16-bit values in f32
# (in another order: at most ~1e-5 of the sum) and round once to bf16, so they
# differ by at most one ulp of an output, 2^-8 of its value. The limit is two
# ulps of the largest output. Each tap is an output slice of its own, so a
# dropped tap or a window shifted by a pixel misses by the whole value
# (`tests/test_torch_ae_ops.py`).
WGRAD_REL = 2.0**-6
# GroupNorm(+SiLU): kernel and plain version compute in f32 (sums in another
# order, FMA contraction: ~1e-6 relative) and round once to x's dtype: at most
# one ulp apart. Outputs are O(1) whatever the input's scale, so 2^-6 of
# max|ref| is two to four bf16 ulps of the largest output; a missing `- mean^2`,
# a dropped bias or a wrong group width exceeds it. f32 outputs are held to
# 2^-16 of max|ref| (about 30 f32 ulps at the largest output: the statistics of
# 10^4..10^6 values are summed in another order).
GN_REL = 2.0**-6
GN_REL_F32 = 2.0**-16
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
# ae parity: the same for the gradients of the autoencoder's `core` scope, where the kernel path
# differs from the plain one at 32 conv forwards, 32 dx, 32 weight gradients, 52 norms and 2
# attentions, each by ~1 bf16 ulp. The drift is read four times, the images moved one bf16 ulp each
# time: every pixel away from zero, every pixel towards zero, and twice every pixel in a direction
# drawn at random (a move that the first GroupNorm cannot absorb as a change of scale); each drift is
# the largest of the four readings. The factor holds the loss, the gradient's global 2-norm, the
# median module and every module, each module (a weight and its bias) in the joint 2-norm of its
# parameters against max(its own drift, the upper decile of the modules' drifts). A bias is gated
# with its weight: no kernel computes a bias gradient (it is a plain sum of the dy that also makes
# the weight's), and a bias of 4 to 512 values read alone is too noisy a statistic for a limit of its
# own (the key bias of an attention has a gradient that is zero in exact arithmetic). The state of
# the weights after the train steps differs from run to run (the fused attention backward and cuDNN
# do not sum in a fixed order), and the readings with it: `scripts/ae_parity_runs.py` repeats this
# phase over seeds and prints the ratios that the gates take, and the largest allowance of a module.
AE_PARITY_FACTOR = 2.0
AE_DRIFT_SEEDS = (1, 2)  # the random directions of the two last one-ulp moves of the images
STEPS = 20
DECODER_CONVS = 31  # kernel-routed VAE decoder convs per decode
FLASH_PER_UNET = 15  # self-attentions with L >= 256 per UNet call
# a DeepCache shallow UNet call at cut 1 runs input block 0 and the last two output blocks, all at 64x64:
# three self-attentions, and 3 + 3 + 3 GroupNorms and norm_out
FLASH_PER_SHALLOW = 3
GN_PER_SHALLOW = 10
PROMPT = "a photograph of an astronaut riding a horse on the moon, highly detailed, 8k"
# the serving configurations: name -> (ToMe ratio, DeepCache interval or None); the first three are `bench.py`'s
SERVE_CONFIGS = {"lossless": (0.0, None), "faithful": (0.5, 3), "accelerated": (0.5, 5), "tome": (0.5, None)}
# the JAX package's floors for the recorded full-scale quality of each lever (tests/test_quality.py)
QUALITY_FLOORS = {"faithful": (10.0, 0.3), "accelerated": (10.0, 0.3), "tome": (15.0, 0.5)}
W8A8_FLOOR = (30.0, 0.98)  # the W8A8 decode against the bf16 decode: PSNR dB, SSIM
TRAIN_BATCH = 8
TRAIN_STEPS = 3
AE_BATCH = 8

# (name, B, H, Lq, Lk, D, causal, dtype, launches per txt2img as a function of steps)
FLASH_CASES = [
    ("unet_64x64", 2, 8, 4096, 4096, 40, False, "bfloat16", lambda s: 5 * s),
    ("unet_64x64_tome", 2, 8, 2048, 2048, 40, False, "bfloat16", lambda s: 0),  # ToMe r = 0.5 merges 4096 to 2048
    ("unet_32x32", 2, 8, 1024, 1024, 80, False, "bfloat16", lambda s: 5 * s),
    ("unet_16x16", 2, 8, 256, 256, 160, False, "bfloat16", lambda s: 5 * s),
    ("vae_mid", 1, 1, 4096, 4096, 512, False, "bfloat16", lambda s: 1),
    ("ragged", 1, 4, 1000, 777, 64, False, "bfloat16", lambda s: 0),
    ("causal", 1, 4, 1000, 1000, 64, True, "bfloat16", lambda s: 0),
    ("f32", 1, 4, 1000, 777, 64, False, "float32", lambda s: 0),
    ("d640", 1, 2, 512, 512, 640, False, "bfloat16", lambda s: 0),
    ("ae_mid", AE_BATCH, 1, 1024, 1024, 512, False, "bfloat16", lambda s: 0),
    # the first-stage encoder's mid-block attention on the ldm path (batch 8, 512px images), without a gradient
    ("ldm_enc_mid", TRAIN_BATCH, 1, 4096, 4096, 512, False, "bfloat16", lambda s: 0),
    # the f4 VQ decoder's mid-block attention (128x128 latents: `semantic2img`, `sr`), and the wide-head kernel's
    # ragged (a kv range split in three parts) and causal (a split whose first tiles' later parts hold no block)
    # cases
    ("vq_dec_mid", 1, 1, 16384, 16384, 512, False, "bfloat16", lambda s: 0),
    ("ragged_d512", 1, 2, 1000, 777, 512, False, "bfloat16", lambda s: 0),
    ("causal_d512", 1, 2, 1000, 1000, 512, True, "bfloat16", lambda s: 0),
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
    ("ae_mid", AE_BATCH, 1, 1024, 1024, 512, False, "bfloat16", 0),
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
# the autoencoder step: `scripts/profile_training_multi.py`'s ae_kl workload
AE_CONFIG = dict(
    img_size=256, in_channels=3, inner_channels=128, z_channels=4, embedding_channels=4,
    channel_multipliers=[1, 2, 4, 4], num_res_blocks=2, use_perceptual=False, d_loss_start_step=0,
)
AE_STEPS = 3
# (name, B, H, W, C, Co, kernel-routed convs of this shape per autoencoder forward), found with a
# hook on the wrappers. One train step runs each forward conv twice (the `core` scope, and the
# discriminator scope's forward without a gradient), its dx (the forward kernel, C and Co
# swapped) once and its weight gradient once.
AE_CONV_CASES = [
    ("256x256_128_128", AE_BATCH, 256, 256, 128, 128, 9),
    ("256x256_256_128", AE_BATCH, 256, 256, 256, 128, 1),
    ("256x256_256_256", AE_BATCH, 256, 256, 256, 256, 1),
    ("128x128_128_256", AE_BATCH, 128, 128, 128, 256, 1),
    ("128x128_256_256", AE_BATCH, 128, 128, 256, 256, 8),
    ("128x128_512_256", AE_BATCH, 128, 128, 512, 256, 1),
    ("128x128_512_512", AE_BATCH, 128, 128, 512, 512, 1),
    ("64x64_512_512", AE_BATCH, 64, 64, 512, 512, 10),
    # H != W, C != Co, and 3 * 33 * 47 pixels: K tiles cross image boundaries and the last is ragged
    ("odd_3x33x47_64_136", 3, 33, 47, 64, 136, 0),
]
AE_CONVS = sum(case[-1] for case in AE_CONV_CASES)  # 32
# the ldm path: SD-1.5's first-stage encoder on 512px images at batch 8, without a gradient, once a finetune
# step. (name, B, H, W, C, Co, kernel-routed convs of this shape per encode), found with a hook on the
# dispatchers' predicates; its GroupNorm calls (H = W, C, SiLU fused, calls per encode), and one flash call
ENCODER_CONV_CASES = [
    ("enc_512x512_128_128", TRAIN_BATCH, 512, 512, 128, 128, 4),
    ("enc_256x256_128_256", TRAIN_BATCH, 256, 256, 128, 256, 1),
    ("enc_256x256_256_256", TRAIN_BATCH, 256, 256, 256, 256, 3),
    ("enc_128x128_256_512", TRAIN_BATCH, 128, 128, 256, 512, 1),
    ("enc_128x128_512_512", TRAIN_BATCH, 128, 128, 512, 512, 3),
    ("enc_64x64_512_512", TRAIN_BATCH, 64, 64, 512, 512, 8),
]
ENCODER_CONVS = sum(case[-1] for case in ENCODER_CONV_CASES)  # 20
ENCODER_GN = [
    (512, 128, True, 4), (256, 128, True, 1), (256, 256, True, 3), (128, 256, True, 1), (128, 512, True, 3),
    (64, 512, True, 8), (64, 512, False, 2),
]
GN_PER_ENCODE = sum(case[-1] for case in ENCODER_GN)  # 22
ENCODER_FLASH = 1
# the ae path at the JAX package's defaults (LPIPS with random weights, the adaptive weight, the default
# optimizer settings), and the VQ autoencoder at the same widths
AE_DEFAULTS_CONFIG = dict(AE_CONFIG, use_perceptual=True, use_adaptive_weight=True)
AE_VQ_CONFIG = dict(AE_CONFIG, num_code=16384)
AE_FLASH = 2  # the encoder's and the decoder's mid-block attention, B8 H1 L1024 d512
# GroupNorm calls, (H = W, C, SiLU fused, launches): per UNet call at 512px (61), per VAE decode at
# 512px (30) and per autoencoder forward at 256px (52; two forwards per train step)
UNET_GN = [
    (64, 320, False, 6), (64, 320, True, 7), (64, 640, True, 2), (64, 960, True, 1),
    (32, 320, True, 1), (32, 640, False, 5), (32, 640, True, 6), (32, 960, True, 1), (32, 1280, True, 1),
    (32, 1920, True, 1), (16, 640, True, 1), (16, 1280, False, 5), (16, 1280, True, 6), (16, 1920, True, 1),
    (16, 2560, True, 2), (8, 1280, False, 1), (8, 1280, True, 11), (8, 2560, True, 3),
]
DECODER_GN = [
    (64, 512, False, 1), (64, 512, True, 10), (128, 512, True, 6), (256, 512, True, 1), (256, 256, True, 5),
    (512, 256, True, 1), (512, 128, True, 5), (512, 128, False, 1),
]
AE_GN = [
    (256, 128, False, 1), (256, 128, True, 9), (256, 256, True, 1), (128, 128, True, 1), (128, 256, True, 8),
    (128, 512, True, 1), (64, 256, True, 1), (64, 512, True, 9), (32, 512, False, 3), (32, 512, True, 18),
]
GN_PER_UNET = sum(case[-1] for case in UNET_GN)  # 61
GN_PER_DECODE = sum(case[-1] for case in DECODER_GN)  # 30
GN_PER_AE_FORWARD = sum(case[-1] for case in AE_GN)  # 52
# the yardstick of the wgmma + TMA redesign of `conv3x3` and `conv3x3_wgrad`: the mma.sync kernels' ms per
# shape in the final run of the previous design (H100 80GB HBM3, 700 W), keyed by (kernel, case); the
# per-shape rows carry them as `pr4_ms`
MMA_SYNC_MS = {
    ("conv3x3", "64x64_512_512"): 0.1128, ("conv3x3", "128x128_512_512"): 0.3121,
    ("conv3x3", "256x256_512_512"): 1.2615, ("conv3x3", "256x256_512_256"): 0.6416,
    ("conv3x3", "256x256_256_256"): 0.3367, ("conv3x3", "512x512_256_256"): 1.4119,
    ("conv3x3", "512x512_256_128"): 0.6475, ("conv3x3", "512x512_128_128"): 0.3530,
    ("conv3x3", "odd_129x131_64_96"): 0.0363,
    ("conv3x3", "ae_fwd_256x256_128_128"): 0.6707, ("conv3x3", "ae_dx_256x256_128_128"): 0.6972,
    ("conv3x3", "ae_fwd_256x256_256_128"): 1.2890, ("conv3x3", "ae_dx_256x256_256_128"): 1.4184,
    ("conv3x3", "ae_fwd_256x256_256_256"): 2.4911, ("conv3x3", "ae_dx_256x256_256_256"): 2.6959,
    ("conv3x3", "ae_fwd_128x128_128_256"): 0.3675, ("conv3x3", "ae_dx_128x128_128_256"): 0.3339,
    ("conv3x3", "ae_fwd_128x128_256_256"): 0.6768, ("conv3x3", "ae_dx_128x128_256_256"): 0.6936,
    ("conv3x3", "ae_fwd_128x128_512_256"): 1.2816, ("conv3x3", "ae_dx_128x128_512_256"): 1.3915,
    ("conv3x3", "ae_fwd_128x128_512_512"): 2.5466, ("conv3x3", "ae_dx_128x128_512_512"): 2.7179,
    ("conv3x3", "ae_fwd_64x64_512_512"): 0.7270, ("conv3x3", "ae_dx_64x64_512_512"): 0.6716,
    ("conv3x3", "ae_fwd_odd_3x33x47_64_136"): 0.0199, ("conv3x3", "ae_dx_odd_3x33x47_64_136"): 0.0414,
    ("conv3x3_wgrad", "256x256_128_128"): 1.0411, ("conv3x3_wgrad", "256x256_256_128"): 1.9148,
    ("conv3x3_wgrad", "256x256_256_256"): 3.5823, ("conv3x3_wgrad", "128x128_128_256"): 0.4849,
    ("conv3x3_wgrad", "128x128_256_256"): 0.9167, ("conv3x3_wgrad", "128x128_512_256"): 1.7845,
    ("conv3x3_wgrad", "128x128_512_512"): 3.5840, ("conv3x3_wgrad", "64x64_512_512"): 0.9169,
    ("conv3x3_wgrad", "odd_3x33x47_64_136"): 0.0496,
}
REDESIGNED = ("conv3x3", "conv3x3_wgrad", "flash_attention", "flash_fwd_lse", "flash_bwd_fused", "flash_bwd_dq",
              "flash_bwd_dkv", "conv3x3_fold", "group_norm", "conv3x3_w8a8")
# the backward kernels' planner mode
BWD_MODE = {"flash_bwd_fused": "fused", "flash_bwd_dq": "dq", "flash_bwd_dkv": "dkv"}
# which path's launches and times a kernel's summary row reports; its other paths go under "other_paths"
MAIN_PATH = {
    "flash_attention": "txt2img", "conv3x3": "txt2img", "flash_fwd_lse": "finetune", "flash_bwd_fused": "finetune",
    "flash_bwd_dq": "finetune", "flash_bwd_dkv": "finetune", "conv3x3_wgrad": "ae", "group_norm": "ae",
    "conv3x3_w8a8": "w8a8", "quantize_w8a8": "w8a8", "conv3x3_fold": "fold",
}
# floating-point operations per (q, k, d) triple: two products forward; five
# in the fused backward; s, dp, dq in the dq kernel; s, dp, dv, dk in the dk.dv kernel
OPS_PER_TRIPLE = {"flash_fwd_lse": 4.0, "flash_bwd_fused": 10.0, "flash_bwd_dq": 6.0, "flash_bwd_dkv": 8.0}
TRAIN_KERNELS = tuple(OPS_PER_TRIPLE)


# the yardsticks (the previous designs, timed beside the kernels that replaced them): a short event window and a
# CUDA graph of 5 calls replayed twice, so that they add little to the run's time
YARDSTICK_MS = 5.0
YARDSTICK_GRAPH = (5, 2)


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


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS, exps: float = 0.0):
    """The least ms the card could take: the largest of the operations at the tensor-core peak, the bytes
    at the memory rate and `exps` exponentials at the special-function units' rate; and which binds."""
    times = {"operations": flops / peak_flops, "bytes": nbytes / PEAK_BYTES, "exponentials": exps / EXP_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def device_ms(torch, fn, calls: int = 10, replays: int = 5, stream=None) -> float:
    """Mean device time per call, free of the host's enqueue time that the event window of `time_ms` holds
    where a call is microseconds of device work: `calls` calls captured in one CUDA graph (on `stream`, where
    given), the graph replayed `replays` times under a CUDA-event window after a warm-up replay."""
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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
    del graph
    return start.elapsed_time(end) / (calls * replays)


def bwd_registers(log: str) -> dict:
    """{"bf16 kv_outer ks3 nc2": registers, ...} of the wgmma + TMA backward kernels in an `nvcc -Xptxas -v`
    log: the count at launch, before `setmaxnreg` hands the producer's registers to the consumers."""
    out, key = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"flash_bwd_(kv_outer|q_outer)_kernelI(\w+?)Li(\d+)ELi(\d+)E", ln)
            key = (f"{'bf16' if 'bfloat16' in m.group(2) else 'f16'} {m.group(1)} ks{m.group(3)} nc{m.group(4)}"
                   if m else None)
        elif key and "Used " in ln:
            out[key] = int(ln.split("Used ")[1].split(" ")[0])
            key = None
    return out


def sm90_registers(log: str) -> dict:
    """{"bf16 ks3 nc2": registers, ...} of the wgmma + TMA flash kernels in an `nvcc -Xptxas -v` log (the
    wide-head kernel's as "bf16 wide kh16"): the count at launch, before `setmaxnreg` hands the producer's
    registers to the consumers."""
    out, key = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"flash_fwd_sm90_kernelI(\w+?)Li(\d+)ELi(\d+)E", ln)
            w = re.search(r"flash_fwd_wide_kernelI(\w+?)Li(\d+)E", ln)
            key = (f"{'bf16' if 'bfloat16' in m.group(1) else 'f16'} ks{m.group(2)} nc{m.group(3)}" if m else
                   f"{'bf16' if 'bfloat16' in w.group(1) else 'f16'} wide kh{w.group(2)}" if w else None)
        elif key and "Used " in ln:
            out[key] = int(ln.split("Used ")[1].split(" ")[0])
            key = None
    return out


def spilled(log: str) -> list:
    """The (mangled) names of the functions that spill registers in an `nvcc -Xptxas -v` log."""
    out, name = [], None
    for ln in log.splitlines():
        if "Function properties for " in ln:
            name = ln.split("Function properties for ")[1].strip()
        elif name and "spill" in ln:
            if "0 bytes spill stores, 0 bytes spill loads" not in ln:
                out.append(name)
            name = None
    return out


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0])


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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev, bf16 = "cuda", torch.bfloat16
    rows = {"flash_attention": [], "conv3x3": [], "conv3x3_w8a8": [], "quantize_w8a8": [], "conv3x3_fold": []}
    for name, b, h, lq, lk, d, causal, dtype, per in FLASH_CASES:
        dt = getattr(torch, dtype)
        q = torch.randn((b, h, lq, d), generator=gen, device=dev).to(dt)
        k = torch.randn((b, h, lk, d), generator=gen, device=dev).to(dt)
        v = torch.randn((b, h, lk, d), generator=gen, device=dev).to(dt)
        out = A.flash_attention(q, k, v, causal=causal)
        ref = A.flash_attention_plain(q, k, v, causal=causal)
        err = max_err(out, ref)
        tol = flash_rel(q.element_size()) * ref.float().abs().max().item()
        # the yardstick: the mma.sync kernel (`flash_fwd.cuh`), on request, on the same inputs
        err_old = max_err(A.flash_attention(q, k, v, causal=causal, kernel="mma_sync"), ref)
        run = lambda: A.flash_attention(q, k, v, causal=causal)  # noqa: E731
        old = lambda: A.flash_attention(q, k, v, causal=causal, kernel="mma_sync")  # noqa: E731
        lib_run = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
        ms = time_ms(torch, run)
        plain = time_ms(torch, lambda: A.flash_attention_plain(q, k, v, causal=causal), 20.0)
        pairs = lq * (lq + 1) / 2 if causal else lq * lk
        peak = PEAK_BF16_FLOPS if q.element_size() == 2 else PEAK_TF32_FLOPS
        bms, by = bound_ms(4.0 * b * h * pairs * d, q.element_size() * b * h * (2 * lq + 2 * lk) * d, peak,
                           b * h * pairs)
        plan = A.flash_plan(b, h, lq, lk, d, dt, sms)
        row = dict(case=name, shape=[b, h, lq, lk, d], dtype=dtype, causal=causal, kernel=plan.kernel,
                   max_abs_err=err, mma_sync_max_abs_err=err_old, tol=tol, ms=ms, device_ms=device_ms(torch, run),
                   mma_sync_ms=time_ms(torch, old, YARDSTICK_MS),
                   mma_sync_device_ms=device_ms(torch, old, *YARDSTICK_GRAPH), plain_ms=plain,
                   library_ms=time_ms(torch, lib_run), library_device_ms=device_ms(torch, lib_run), bound_ms=bms,
                   bound_by=by, per_path=per(STEPS))
        if plan.kernel == "sm90_wide":
            # the wide-head kernel's plan, and its build with the lse against the plain forward's: o at FLASH_REL,
            # lse at LSE_TOL, and the same o as the build without it
            o2, lse = A.flash_fwd_lse(q, k, v, causal=causal)
            ref_o, ref_lse = A.flash_fwd_with_lse_plain(q, k, v, causal=causal)
            row.update(plan=dict(bk=plan.bk, stages=plan.stages, splits=plan.splits, ctas=plan.ctas, smem=plan.smem),
                       lse_max_abs_err=max_err(lse, ref_lse), lse_tol=LSE_TOL[2], lse_o_max_abs_err=max_err(o2, ref_o),
                       lse_o_equal=torch.equal(o2, out))
            del o2, lse, ref_o, ref_lse
            if not (row["lse_max_abs_err"] <= LSE_TOL[2] and row["lse_o_max_abs_err"] <= tol and row["lse_o_equal"]):
                raise AssertionError(f"flash_fwd_lse {name}: lse {row['lse_max_abs_err']} > {LSE_TOL[2]}, o "
                                     f"{row['lse_o_max_abs_err']} > {tol}, or o unlike flash_attention's")
        print("flash", json.dumps(row))
        if not math.isfinite(err) or err > tol or not err_old <= tol:
            raise AssertionError(f"flash {name}: max_abs_err {err} (mma.sync {err_old}) > {tol}")
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
        dev_ms = device_ms(torch, lambda: Cv.conv3x3(x, wk, bias))
        plain = time_ms(torch, lambda: Cv.conv3x3_plain(x, wk, bias), 20.0)
        xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        wc = w.contiguous(memory_format=torch.channels_last)
        lib = time_ms(torch, lambda: F.conv2d(xc, wc, bias, padding=1))
        m = b * hh * ww
        bms, by = bound_ms(2.0 * m * co * 9 * c, 2.0 * (m * c + 9 * c * co + co + m * co))
        row = dict(case=name, shape=[b, hh, ww, c, co], max_abs_err=err, tol=CONV_TOL, ms=ms, device_ms=dev_ms,
                   plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by, per_path=per, pr4_ms=MMA_SYNC_MS.get(("conv3x3", name)),
                   bound_share=bms / ms)
        print("conv3x3", json.dumps(row))
        if not math.isfinite(err) or err > CONV_TOL:
            raise AssertionError(f"conv3x3 {name}: max_abs_err {err} > {CONV_TOL}")
        rows["conv3x3"].append(row)
        # the dj-folded kernel (wgmma + TMA, one x box for the three dj taps): the same function, against
        # its plain version and the 9-tap kernel, held to CONV_TOL of each other; beside it the previous
        # design (the mma.sync implicit GEMM, `kernel="mma_sync"`) on the same inputs, the yardstick
        fold_run = lambda: Cv.conv3x3_fold(x, wk, bias)  # noqa: E731
        fold_old = lambda: Cv.conv3x3_fold(x, wk, bias, kernel="mma_sync")  # noqa: E731
        fold = fold_run()
        torch.cuda.synchronize()
        fold_ref = Cv.conv3x3_fold_plain(x, wk, bias)
        err_f = max(max_err(fold, fold_ref), max_err(fold, ref))
        err_k = max_err(fold, out)
        err_old = max_err(fold_old(), fold_ref)
        fp = Cv.conv3x3_fold_plan(b, hh, ww, c, co, sms)
        fold_ms, fold_dev = time_ms(torch, fold_run), device_ms(torch, fold_run)
        row = dict(case=name, shape=[b, hh, ww, c, co],
                   plan=dict(box=[fp.th, fp.tw], x_box=list(fp.x_box), bn=fp.bn, ctas=fp.ctas, k_slices=fp.k_slices,
                             stages=[fp.a_stages, fp.b_stages]),
                   max_abs_err=err_f, vs_conv3x3_kernel=err_k, mma_sync_max_abs_err=err_old, tol=CONV_TOL,
                   ms=fold_ms, device_ms=fold_dev, mma_sync_ms=time_ms(torch, fold_old, YARDSTICK_MS),
                   mma_sync_device_ms=device_ms(torch, fold_old, *YARDSTICK_GRAPH),
                   plain_ms=time_ms(torch, lambda: Cv.conv3x3_fold_plain(x, wk, bias), 20.0),
                   library_ms=lib, conv3x3_ms=ms, conv3x3_device_ms=dev_ms, bound_ms=bms, bound_by=by,
                   bound_share=bms / fold_ms, bound_share_device=bms / fold_dev, per={"fold": per})
        print("conv3x3_fold", json.dumps(row))
        if not max(err_f, err_k, err_old) <= CONV_TOL:
            raise AssertionError(f"conv3x3_fold {name}: max_abs_err {err_f} (mma.sync {err_old}), against the "
                                 f"9-tap kernel {err_k}")
        rows["conv3x3_fold"].append(row)
        # W8A8, the quantiser: its one launch against `w8a8_operands` (x8, w8 and the combined scale), bit for bit,
        # on the bf16 operands and on their fp16 copies
        quant = lambda: Cv.quantize_w8a8(x, wk)  # noqa: E731
        plain_quant = lambda: Cv.w8a8_operands(x, wk)  # noqa: E731
        x8, w8, scale = plain_quant()
        got = quant()
        err_z = max(max_err(g, r) for g, r in zip(got, (x8, w8, scale)))
        z_equal = all(torch.equal(g, r) for g, r in zip(got, (x8, w8, scale)))
        x16, w16 = x.half(), wk.half()
        z16_equal = all(torch.equal(g, r) for g, r in zip(Cv.quantize_w8a8(x16, w16), Cv.w8a8_operands(x16, w16)))
        del got, x16, w16
        # bytes: x and w read once, x8, w8 and the f32 scale written once (reading x again after the grid barrier
        # is the kernel's own cost)
        bms_z, by_z = bound_ms(0.0, 3 * (m * c + 9 * c * co) + 4 * co)
        row = dict(case=name, shape=[b, hh, ww, c, co], ctas=Cv.quantize_ctas(m * c, co, sms), max_abs_err=err_z,
                   bit_identical=z_equal, fp16_bit_identical=z16_equal, tol=0.0, ms=time_ms(torch, quant),
                   device_ms=device_ms(torch, quant), plain_ms=time_ms(torch, plain_quant, 20.0),
                   plain_device_ms=device_ms(torch, plain_quant, *YARDSTICK_GRAPH), library_ms=None, bound_ms=bms_z,
                   bound_by=by_z, per={"w8a8": per})
        row["bound_share_device"] = bms_z / row["device_ms"]
        print("quantize_w8a8", json.dumps(row))
        if err_z != 0.0 or not z_equal or not z16_equal:
            raise AssertionError(f"quantize_w8a8 {name}: not bit-identical to w8a8_operands (max_abs_err {err_z}, "
                                 f"fp16 {z16_equal})")
        rows["quantize_w8a8"].append(row)
        # the int8 kernel (s8 wgmma + TMA) on the quantised operands, bit for bit against its plain version (f64
        # sums on the card: exact) in both output dtypes, with and without the bias, and so is its previous design
        # (the mma.sync implicit GEMM, `kernel="mma_sync"`, the yardstick, timed beside it); then the whole route
        # (quantiser + kernel) against its plain version
        unequal = []
        for dt in (bf16, torch.float16):
            for bq in (bias.to(dt), None):
                q_ref = Cv.conv3x3_int8_plain(x8, w8, scale, bq, dt)
                for kernel in ("sm90", "mma_sync"):
                    q = Cv.conv3x3_int8(x8, w8, scale, bq, dt, kernel=kernel)
                    if not torch.equal(q, q_ref):
                        unequal.append((kernel, str(dt), bq is not None, max_err(q, q_ref)))
        q = Cv.conv3x3_int8(x8, w8, scale, bias, bf16)
        q_ref = Cv.conv3x3_int8_plain(x8, w8, scale, bias, bf16)
        err_q = max(max_err(q, q_ref), max((u[-1] for u in unequal), default=0.0))
        whole_equal = torch.equal(Cv.conv3x3_w8a8(x, wk, bias), Cv.conv3x3_w8a8_plain(x, wk, bias))
        run_q = lambda: Cv.conv3x3_int8(x8, w8, scale, bias, bf16)  # noqa: E731
        old_q = lambda: Cv.conv3x3_int8(x8, w8, scale, bias, bf16, kernel="mma_sync")  # noqa: E731
        route = lambda: Cv.conv3x3_w8a8(x, wk, bias)  # noqa: E731
        qp = Cv.conv3x3_w8a8_plan(b, hh, ww, c, co, sms)
        # bytes: int8 x and w in, the f32 scale and the bias, bf16 out
        bms_q, by_q = bound_ms(2.0 * m * co * 9 * c, m * c + 9 * c * co + 4 * co + 2 * co + 2 * m * co, PEAK_INT8_OPS)
        row = dict(case=name, shape=[b, hh, ww, c, co],
                   plan=dict(box=[qp.th, qp.tw], bn=qp.bn, ctas=qp.ctas, tiles=qp.m_tiles * qp.n_tiles,
                             k_slices=qp.k_slices, stages=qp.stages),
                   max_abs_err=err_q, bit_identical=not unequal, unequal=unequal, route_bit_identical=whole_equal,
                   tol=0.0, ms=time_ms(torch, run_q), device_ms=device_ms(torch, run_q),
                   mma_sync_ms=time_ms(torch, old_q, YARDSTICK_MS),
                   mma_sync_device_ms=device_ms(torch, old_q, *YARDSTICK_GRAPH),
                   route_ms=time_ms(torch, route), route_device_ms=device_ms(torch, route),
                   plain_ms=time_ms(torch, lambda: Cv.conv3x3_int8_plain(x8, w8, scale, bias, bf16), 20.0),
                   library_ms=None, unquantised_cudnn_bf16_ms=lib, unquantised_conv3x3_kernel_ms=ms,
                   unquantised_conv3x3_kernel_device_ms=dev_ms,
                   quantisation_error_rel=max_err(q, ref) / ref.float().abs().max().item(),
                   bound_ms=bms_q, bound_by=by_q, per={"w8a8": per})
        row["bound_share_device"] = bms_q / row["device_ms"]
        print("conv3x3_w8a8", json.dumps(row))
        if err_q != 0.0 or unequal or not whole_equal:
            raise AssertionError(f"conv3x3_w8a8 {name}: not bit-identical to its plain version (max_abs_err {err_q}, "
                                 f"{unequal}, route {whole_equal})")
        rows["conv3x3_w8a8"].append(row)
        del x8, w8, scale, q, q_ref, fold
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
        # library yardstick: SDPA forward, and its backward through autograd. Autograd runs a backward op on
        # its forward op's stream, so the forward runs on a stream of its own, on which a CUDA graph then
        # captures the backward for its device time
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal))
        lib_stream = torch.cuda.Stream()
        lib_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(lib_stream):
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        lib_bwd_run = lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True)  # noqa: E731
        lib_bwd = time_ms(torch, lib_bwd_run)
        lib_bwd_device = device_ms(torch, lib_bwd_run, stream=lib_stream)
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
            # every kernel takes one exponential per (q, k) pair: the forward's softmax, the backward's p
            bms, by = bound_ms(OPS_PER_TRIPLE[kernel] * b * h * pairs * d, nbytes[kernel], peak, b * h * pairs)
            fwd = kernel == "flash_fwd_lse"
            row = dict(case=name, shape=[b, h, lq, lk, d], dtype=dtype, causal=causal,
                       max_abs_err=max(e for e, _ in errs.values()),
                       errs={k_: e for k_, (e, _) in errs.items()}, tols={k_: t for k_, (_, t) in errs.items()},
                       ms=ms, device_ms=device_ms(torch, runs[kernel]), plain_ms=plain_fwd if fwd else plain_bwd,
                       library_ms=lib_fwd if fwd else lib_bwd, bound_ms=bms, bound_by=by, per_path=per)
            if fwd:
                # the yardstick: the mma.sync kernel (`flash_fwd.cuh`), on request, on the same inputs
                old = lambda: A.flash_fwd_lse(q, k, v, kernel="mma_sync", **kw)  # noqa: E731
                o_old, lse_old = old()
                row.update(kernel=A.flash_plan(b, h, lq, lk, d, dt, torch.cuda.get_device_properties(0).multi_processor_count).kernel,
                           mma_sync_errs={"o": max_err(o_old, o_ref), "lse": max_err(lse_old, lse_ref)},
                           mma_sync_ms=time_ms(torch, old, YARDSTICK_MS),
                           mma_sync_device_ms=device_ms(torch, old, *YARDSTICK_GRAPH),
                           library_device_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                               ql, kl, vl, is_causal=causal)))
                if not (row["mma_sync_errs"]["o"] <= errs["o"][1] and row["mma_sync_errs"]["lse"] <= errs["lse"][1]):
                    raise AssertionError(f"flash_fwd_lse {name}: the mma.sync kernel's {row['mma_sync_errs']}")
            else:
                # the yardstick: the mma.sync kernel (`flash_bwd.cuh`), on request, on the same inputs
                fn = getattr(A, kernel)
                old = lambda fn=fn: fn(q, k, v, o_ref, lse_ref, do, kernel="mma_sync", **kw)  # noqa: E731
                outs_old = old()
                outs_old = (outs_old,) if kernel == "flash_bwd_dq" else outs_old
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                row.update(kernel=A.flash_bwd_plan(b, h, lq, lk, d, dt, sms, mode=BWD_MODE[kernel]).kernel,
                           mma_sync_errs={k_: max_err(got, ref) for k_, got, ref in zip(errs, outs_old, refs[kernel])},
                           mma_sync_ms=time_ms(torch, old, YARDSTICK_MS),
                           mma_sync_device_ms=device_ms(torch, old, *YARDSTICK_GRAPH),
                           library_device_ms=lib_bwd_device)
                if not all(row["mma_sync_errs"][k_] <= errs[k_][1] for k_ in errs):
                    raise AssertionError(f"{kernel} {name}: the mma.sync kernel's {row['mma_sync_errs']}")
            print(kernel, json.dumps(row))
            for label, (e, t) in errs.items():
                if not math.isfinite(e) or e > t:
                    raise AssertionError(f"{kernel} {name}: {label} max_abs_err {e} > {t}")
            rows[kernel].append(row)
    return rows


def gn_cases():
    """(name, shape, groups, dtype, SiLU, {path: launches per image or step})."""
    cases = []
    for h, c, silu, n in UNET_GN:
        tag = f"{h}x{h}_{c}{'_silu' if silu else ''}"
        cases.append((f"unet_b2_{tag}", (2, h, h, c), 32, "bfloat16", silu, {"txt2img": n * STEPS}))
        cases.append((f"unet_b{TRAIN_BATCH}_{tag}", (TRAIN_BATCH, h, h, c), 32, "bfloat16", silu, {"finetune": n}))
    for h, c, silu, n in DECODER_GN:
        cases.append((f"vae_b1_{h}x{h}_{c}{'_silu' if silu else ''}", (1, h, h, c), 32, "bfloat16", silu, {"txt2img": n}))
    for h, c, silu, n in AE_GN:
        cases.append((f"ae_b{AE_BATCH}_{h}x{h}_{c}{'_silu' if silu else ''}", (AE_BATCH, h, h, c), 32, "bfloat16", silu,
                      {"ae": 2 * n}))
    for h, c, silu, n in ENCODER_GN:
        cases.append((f"enc_b{TRAIN_BATCH}_{h}x{h}_{c}{'_silu' if silu else ''}", (TRAIN_BATCH, h, h, c), 32, "bfloat16",
                      silu, {"ldm": n}))
    for silu in (False, True):
        cases.append((f"f32_odd_width{'_silu' if silu else ''}", (2, 17, 13, 96), 32, "float32", silu, {}))  # 3 per group
        cases.append((f"fp16_unvectorised{'_silu' if silu else ''}", (2, 9, 7, 36), 4, "float16", silu, {}))  # 9 per group
    # more than 256 chunks of channels: the statistics pass walks tiles of channels, groups span them
    cases.append(("wide_6152_silu", (2, 5, 3, 6152), 2, "bfloat16", True, {}))
    cases.append(("f32_wide_unvectorised_777", (1, 4, 4, 777), 3, "float32", False, {}))
    return cases


def phase_ae_kernels(torch, F, Cv, Gn):
    """The conv forward, its dx and the weight-gradient kernel at the shapes
    the autoencoder step routes, and GroupNorm(+SiLU) at every shape of the
    three paths, each against its plain version. Library yardsticks, timed
    only: cuDNN's forward, input gradient and weight gradient;
    `F.group_norm` (+ `F.silu`) on the NCHW view."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16 = torch.bfloat16
    rows = {"conv3x3": [], "conv3x3_wgrad": [], "group_norm": []}

    def check(kernel, name, err, tol):
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"{kernel} {name}: max_abs_err {err} > {tol}")

    for name, b, hh, ww, c, co, per in AE_CONV_CASES:
        x = torch.randn((b, hh, ww, c), generator=gen, device="cuda").to(bf16)
        dy = torch.randn((b, hh, ww, co), generator=gen, device="cuda").to(bf16)
        w = (torch.randn((co, c, 3, 3), generator=gen, device="cuda") * (9 * c) ** -0.5).to(bf16)
        bias = (torch.randn((co,), generator=gen, device="cuda") * 0.1).to(bf16)
        wk = Cv.kernel_weight(w)
        wf = Cv.flip_weights(wk)
        xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)  # NCHW views of NHWC memory: channels_last
        wc = w.contiguous(memory_format=torch.channels_last)
        m = b * hh * ww
        # forward (C -> Co) and dx (the forward kernel, Co -> C, flipped weights, no bias)
        xg = x.detach().clone().requires_grad_()
        ref_y = Cv.conv3x3_plain(xg, wk, bias)
        (ref_dx,) = torch.autograd.grad(ref_y, xg, dy)
        ref_y = ref_y.detach()
        del xg
        for kind, run, plain_run, lib_run, ref, cin, cout, count in (
            ("fwd", lambda: Cv.conv3x3(x, wk, bias), lambda: Cv.conv3x3_plain(x, wk, bias),
             lambda: F.conv2d(xc, wc, bias, padding=1), ref_y, c, co, 2 * per),
            ("dx", lambda: Cv.conv3x3(dy, wf), lambda: Cv.conv3x3_plain(dy, wf),
             lambda: torch.nn.grad.conv2d_input(xc.shape, wc, dyc, padding=1), ref_dx, co, c, per),
        ):
            out = run()
            torch.cuda.synchronize()
            err, tol = max_err(out, ref), CONV_REL * ref.float().abs().max().item()
            bms, by = bound_ms(2.0 * m * cin * cout * 9, 2.0 * (m * cin + 9 * cin * cout + cout + m * cout))
            ms = time_ms(torch, run)
            row = dict(case=f"ae_{kind}_{name}", shape=[b, hh, ww, cin, cout], max_abs_err=err, tol=tol,
                       ms=ms, device_ms=device_ms(torch, run), plain_ms=time_ms(torch, plain_run, 20.0), library_ms=time_ms(torch, lib_run),
                       bound_ms=bms, bound_by=by, per={"ae": count}, pr4_ms=MMA_SYNC_MS.get(("conv3x3", f"ae_{kind}_{name}")),
                       bound_share=bms / ms)
            print("conv3x3", json.dumps(row))
            check("conv3x3", row["case"], err, tol)
            rows["conv3x3"].append(row)
        del ref_y, ref_dx
        # weight gradient
        out = Cv.conv3x3_wgrad(x, dy)
        torch.cuda.synchronize()
        ref = Cv.conv3x3_wgrad_plain(x, dy)
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise AssertionError(f"conv3x3_wgrad {name}: {tuple(out.shape)} {out.dtype}")
        if not torch.equal(out, Cv.conv3x3_wgrad(x, dy)):
            raise AssertionError(f"conv3x3_wgrad {name}: a second launch on the same inputs differs")
        err, tol = max_err(out, ref), WGRAD_REL * ref.float().abs().max().item()
        bms, by = bound_ms(2.0 * m * c * co * 9, 2.0 * (m * c + m * co + 9 * c * co))
        ms = time_ms(torch, lambda: Cv.conv3x3_wgrad(x, dy))
        row = dict(case=name, shape=[b, hh, ww, c, co], splits=Cv.wgrad_plan(b, hh, ww, c, co).splits, max_abs_err=err,
                   tol=tol, ms=ms, device_ms=device_ms(torch, lambda: Cv.conv3x3_wgrad(x, dy)),
                   plain_ms=time_ms(torch, lambda: Cv.conv3x3_wgrad_plain(x, dy), 20.0),
                   library_ms=time_ms(torch, lambda: torch.nn.grad.conv2d_weight(xc, w.shape, dyc, padding=1)),
                   bound_ms=bms, bound_by=by, per={"ae": per}, pr4_ms=MMA_SYNC_MS.get(("conv3x3_wgrad", name)),
                   bound_share=bms / ms)
        print("conv3x3_wgrad", json.dumps(row))
        check("conv3x3_wgrad", name, err, tol)
        rows["conv3x3_wgrad"].append(row)
        del x, dy, out, ref
    torch.cuda.empty_cache()

    # the forward at the first-stage encoder's shapes on the ldm path (no gradient there)
    for name, b, hh, ww, c, co, per in ENCODER_CONV_CASES:
        x = torch.randn((b, hh, ww, c), generator=gen, device="cuda").to(bf16)
        w = (torch.randn((co, c, 3, 3), generator=gen, device="cuda") * (9 * c) ** -0.5).to(bf16)
        bias = (torch.randn((co,), generator=gen, device="cuda") * 0.1).to(bf16)
        wk = Cv.kernel_weight(w)
        xc, wc = x.permute(0, 3, 1, 2), w.contiguous(memory_format=torch.channels_last)
        run = lambda: Cv.conv3x3(x, wk, bias)  # noqa: E731
        out = run()
        torch.cuda.synchronize()
        ref = Cv.conv3x3_plain(x, wk, bias)
        err, tol = max_err(out, ref), CONV_REL * ref.float().abs().max().item()
        del out, ref
        m = b * hh * ww
        bms, by = bound_ms(2.0 * m * c * co * 9, 2.0 * (m * c + 9 * c * co + co + m * co))
        ms = time_ms(torch, run)
        row = dict(case=name, shape=[b, hh, ww, c, co], max_abs_err=err, tol=tol, ms=ms, device_ms=device_ms(torch, run),
                   plain_ms=time_ms(torch, lambda: Cv.conv3x3_plain(x, wk, bias), 20.0),
                   library_ms=time_ms(torch, lambda: F.conv2d(xc, wc, bias, padding=1)), bound_ms=bms, bound_by=by,
                   per={"ldm": per}, bound_share=bms / ms)
        print("conv3x3", json.dumps(row))
        check("conv3x3", name, err, tol)
        rows["conv3x3"].append(row)
        del x, xc
    torch.cuda.empty_cache()

    for name, shape, groups, dtype, silu, per in gn_cases():
        dt = getattr(torch, dtype)
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(dt)
        w = (1.0 + 0.2 * torch.randn((c,), generator=gen, device="cuda")).to(dt)
        bias = (0.2 * torch.randn((c,), generator=gen, device="cuda")).to(dt)
        kw = dict(num_groups=groups, eps=1e-6, apply_silu=silu)
        out = Gn.group_norm_silu(x, w, bias, **kw)
        torch.cuda.synchronize()
        ref = Gn.group_norm_silu_plain(x, w, bias, **kw)
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise AssertionError(f"group_norm {name}: {tuple(out.shape)} {out.dtype}")
        if not torch.equal(out, Gn.group_norm_silu(x, w, bias, **kw)):
            raise AssertionError(f"group_norm {name}: a second launch on the same inputs differs")
        err = max_err(out, ref)
        tol = (GN_REL_F32 if dt == torch.float32 else GN_REL) * ref.float().abs().max().item()
        xn = x.permute(0, 3, 1, 2)

        def lib():
            y = F.group_norm(xn, groups, w, bias, 1e-6)
            return F.silu(y) if silu else y

        # the previous design, three launches (`kernel="slabs"`), on the same inputs: the yardstick
        slabs_run = lambda: Gn.group_norm_silu(x, w, bias, kernel="slabs", **kw)  # noqa: E731
        err_old = max_err(slabs_run(), ref)
        # bytes: x read once and y written once, w and b
        bms, by = bound_ms(0.0, x.element_size() * (2.0 * x.numel() + 2.0 * c))
        gp = Gn.gn_plan(shape[0], math.prod(shape[1:-1]), c, groups, x.element_size(),
                        sms=torch.cuda.get_device_properties(0).multi_processor_count)
        run = lambda: Gn.group_norm_silu(x, w, bias, **kw)  # noqa: E731
        # the one launch captured in a CUDA graph and replayed: the same bits
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = run()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(replayed, out):
            raise AssertionError(f"group_norm {name}: a CUDA-graph replay differs from the launch")
        del graph, replayed
        ms, dev = time_ms(torch, run, 10.0), device_ms(torch, run, 10, 3)
        row = dict(case=name, shape=list(shape), groups=groups, dtype=dtype, silu=silu,
                   plan=dict(route=gp.route, per_sample=gp.per_sample, rows=gp.rows, keep=gp.keep,
                             samples_per_wave=gp.spw, ctas=gp.ctas, smem=gp.smem),
                   max_abs_err=err, slabs_max_abs_err=err_old, tol=tol, ms=ms, device_ms=dev,
                   slabs_ms=time_ms(torch, slabs_run, YARDSTICK_MS),
                   slabs_device_ms=device_ms(torch, slabs_run, *YARDSTICK_GRAPH),
                   plain_ms=time_ms(torch, lambda: Gn.group_norm_silu_plain(x, w, bias, **kw), 5.0),
                   library_ms=time_ms(torch, lib, 10.0), bound_ms=bms, bound_by=by, bound_share=bms / ms,
                   bound_share_device=bms / dev, per=per)
        print("group_norm", json.dumps(row))
        check("group_norm", name, max(err, err_old), tol)
        rows["group_norm"].append(row)
    return rows


@contextlib.contextmanager
def plain_kernels(A, Cv, Gn):
    """Point the callers at the kernels' plain versions: `sdp_attn`, the
    autograd functions, `conv_call` and the GroupNorm dispatcher look the
    wrappers up as module globals."""
    names = ("flash_attention", "flash_fwd_lse", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")
    saved = {n: getattr(A, n) for n in names}
    saved_conv = Cv.conv3x3, Cv.conv3x3_wgrad, Gn.group_norm_silu
    assert not Cv.W8A8_DEFAULT and not Cv.FOLD, "the plain path is compared with the 9-tap bf16 route"
    A.flash_attention = A.flash_attention_plain
    A.flash_fwd_lse = A.flash_fwd_with_lse_plain
    A.flash_bwd_fused = A.flash_bwd_plain
    A.flash_bwd_dq = lambda *a, **kw: A.flash_bwd_plain(*a, **kw)[0]
    A.flash_bwd_dkv = lambda *a, **kw: A.flash_bwd_plain(*a, **kw)[1:]
    Cv.conv3x3 = Cv.conv3x3_plain
    Cv.conv3x3_wgrad = Cv.conv3x3_wgrad_plain
    Gn.group_norm_silu = Gn.group_norm_silu_plain
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(A, n, fn)
        Cv.conv3x3, Cv.conv3x3_wgrad, Gn.group_norm_silu = saved_conv


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


def _bits(torch, t):
    """Two order-independent checksums of a tensor's bit pattern (wrapping int64 sums)."""
    b = t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32).to(torch.int64)
    return b.sum().item(), (b * b).sum().item()


@contextlib.contextmanager
def record_bits(torch, Cv, Gn, record):
    """Append (kernel, checksums of the inputs, checksums of the output) of every
    `conv3x3_wgrad` and `group_norm_silu` call to `record`."""
    saved = Cv.conv3x3_wgrad, Gn.group_norm_silu

    def rec(kind, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            record.append((kind, tuple(_bits(torch, a) for a in args), _bits(torch, out)))
            return out

        return call

    Cv.conv3x3_wgrad, Gn.group_norm_silu = rec("conv3x3_wgrad", saved[0]), rec("group_norm", saved[1])
    try:
        yield
    finally:
        Cv.conv3x3_wgrad, Gn.group_norm_silu = saved


def bump_ulp(torch, x):
    """x rounded to bf16 and moved one bf16 ulp away from zero, in x's dtype."""
    b = x.to(torch.bfloat16)
    return (b.view(torch.int16) + 1).view(torch.bfloat16).to(x.dtype)


def rel_err(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def reset_launches(A, Cv, Gn) -> None:
    Cv.conv3x3.launches = Cv.conv3x3_wgrad.launches = Gn.group_norm_silu.launches = 0
    Cv.conv3x3_w8a8.launches = Cv.quantize_w8a8.launches = Cv.conv3x3_fold.launches = 0
    A.flash_attention.launches = 0
    for name in TRAIN_KERNELS:
        getattr(A, name).launches = 0


def read_launches(A, Cv, Gn) -> dict:
    out = {"flash_attention": A.flash_attention.launches, "conv3x3": Cv.conv3x3.launches,
           "conv3x3_wgrad": Cv.conv3x3_wgrad.launches, "group_norm": Gn.group_norm_silu.launches,
           "conv3x3_w8a8": Cv.conv3x3_w8a8.launches, "quantize_w8a8": Cv.quantize_w8a8.launches,
           "conv3x3_fold": Cv.conv3x3_fold.launches}
    out.update({name: getattr(A, name).launches for name in TRAIN_KERNELS})
    return out


def leaf_errors(grads, ref) -> dict:
    """{leaf: max|a - b| / max|b|} over the leaves with a non-zero reference."""
    out = {}
    for name, r in ref.items():
        scale = r.float().abs().max().item()
        if scale > 0:
            out[name] = (grads[name].float() - r.float()).abs().max().item() / scale
    return out


def leaf_norm_errors(grads, ref) -> dict:
    """{leaf: ||a - b||_2 / ||b||_2} over the leaves with a non-zero reference."""
    out = {}
    for name, r in ref.items():
        scale = r.double().square().sum().item()
        if scale > 0:
            out[name] = math.sqrt((grads[name].double() - r.double()).square().sum().item() / scale)
    return out


def quantile(values, q: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


def grad_errors(grads, ref) -> dict:
    """Per-leaf max relative error (max|a - b| / max|b|, over leaves with a
    non-zero reference) and the error of the whole gradient in the global
    2-norm, relative to the reference's norm."""
    num = sum((grads[name].float() - r.float()).square().sum().item() for name, r in ref.items())
    den = sum(r.float().square().sum().item() for r in ref.values())
    leaves = leaf_errors(grads, ref)
    worst_name = max(leaves, key=leaves.get, default="")
    return {"leaf_max_rel": leaves.get(worst_name, 0.0), "leaf": worst_name,
            "global_rel": math.sqrt(num / max(den, 1e-300))}


def bump_ulp_random(torch, x, seed: int):
    """x rounded to bf16 and moved one bf16 ulp, each element away from or towards zero as drawn from
    `seed` (zeros away)."""
    b = x.to(torch.bfloat16)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    step = torch.randint(0, 2, b.shape, generator=gen, device=x.device, dtype=torch.int16) * 2 - 1
    step = torch.where(b == 0, torch.ones_like(step), step)
    return (b.view(torch.int16) + step).view(torch.bfloat16).to(x.dtype)


def module_norm_errors(grads, ref) -> dict:
    """{module: ||a - b||_2 / ||b||_2} over the parameters of each module together (a weight and its
    bias: the names before their last dot), over the modules with a non-zero reference."""
    num, den = {}, {}
    for name, r in ref.items():
        module = name.rsplit(".", 1)[0]
        num[module] = num.get(module, 0.0) + (grads[name].double() - r.double()).square().sum().item()
        den[module] = den.get(module, 0.0) + r.double().square().sum().item()
    return {m: math.sqrt(num[m] / den[m]) for m in den if den[m] > 0}


def ae_parity(torch, fwd_bwd, images, A, Cv, Gn, reference=None) -> dict:
    """The ae parity's readings and gates (AE_PARITY_FACTOR). `fwd_bwd(x)` runs one `core` forward +
    backward of the autoencoder on images x and returns (loss, {leaf: gradient}); it runs once through
    the kernels, once through their plain versions, and once through the plain versions for each of
    four one-ulp moves of the images. `failure` is None where every gate holds. `reference(x)`, where
    given, returns the same gradients computed more exactly (read, not gated): `accuracy` then holds
    each module's error of the kernel path and of the plain path against them."""
    x0 = images.to(torch.bfloat16).float()  # on the bf16 grid, so that each move below is one ulp
    loss_k, grads_k = fwd_bwd(x0)
    drift = {"loss": 0.0, "global_rel": 0.0}
    drift_modules, drift_leaves, shares = {}, {}, {}
    with plain_kernels(A, Cv, Gn):
        loss_p, grads_p = fwd_bwd(x0)
        accuracy = None
        if reference is not None:
            grads_r = reference(x0)
            acc_k, acc_p = module_norm_errors(grads_k, grads_r), module_norm_errors(grads_p, grads_r)
            accuracy = {"global": [grad_errors(g, grads_r)["global_rel"] for g in (grads_k, grads_p)],
                        "modules": {m: [e, acc_p[m]] for m, e in acc_k.items()}}
            del grads_r
        total = sum(r.double().square().sum().item() for r in grads_p.values())

        def top_shares(grads):
            # the leaves that carry most of a global-norm error: ||a - b||^2 of the leaf over ||ref||^2 of all
            share = {n: (grads[n].double() - r.double()).square().sum().item() / total for n, r in grads_p.items()}
            return [(n, share[n], grads_p[n].double().square().sum().item() / total)
                    for n in sorted(share, key=share.get, reverse=True)[:4]]

        up = bump_ulp(torch, x0)
        moves = {"up": up, "down": x0 - (up - x0)}
        moves.update({f"random{seed}": bump_ulp_random(torch, x0, seed) for seed in AE_DRIFT_SEEDS})
        for label, x in moves.items():
            loss, grads = fwd_bwd(x)
            drift["loss"] = max(drift["loss"], abs(loss - loss_p))
            drift[f"global_rel_{label}"] = grad_errors(grads, grads_p)["global_rel"]
            drift["global_rel"] = max(drift["global_rel"], drift[f"global_rel_{label}"])
            for table, errors in ((drift_modules, module_norm_errors(grads, grads_p)),
                                  (drift_leaves, leaf_norm_errors(grads, grads_p))):
                for n, e in errors.items():
                    table[n] = max(table.get(n, 0.0), e)
            shares[label] = top_shares(grads)
            del grads
    shares["kernels"] = top_shares(grads_k)
    err = grad_errors(grads_k, grads_p)
    err_modules = module_norm_errors(grads_k, grads_p)
    err_leaves = leaf_norm_errors(grads_k, grads_p)
    n_modules = len({n.rsplit(".", 1)[0] for n in grads_p})
    del grads_k, grads_p
    floor = quantile(drift_modules.values(), 0.9)
    ratio = {m: err_modules[m] / max(drift_modules[m], floor) for m in err_modules}
    worst = max(ratio, key=ratio.get)
    # the leaves one by one against max(their own drift, the leaves' upper decile): printed, not gated
    leaf_floor = quantile(drift_leaves.values(), 0.9)
    leaf_ratio = {n: err_leaves[n] / max(drift_leaves[n], leaf_floor) for n in err_leaves}
    worst_leaf = max(leaf_ratio, key=leaf_ratio.get)
    modules = {
        "modules": len(err_modules), "floor": floor,
        "drift_median": quantile(drift_modules.values(), 0.5), "drift_max": max(drift_modules.values()),
        "err_median": quantile(err_modules.values(), 0.5), "err_max": max(err_modules.values()),
        "worst_ratio": ratio[worst], "worst_module": worst,
        "largest_allowance": AE_PARITY_FACTOR * max(max(d, floor) for d in drift_modules.values()),
        "leaf_worst_ratio": leaf_ratio[worst_leaf], "leaf_worst": worst_leaf,
    }
    tol_loss = max(AE_PARITY_FACTOR * drift["loss"], 2.0**-10 * abs(loss_p))
    failure = None
    if len(err_modules) != n_modules or set(drift_modules) != set(err_modules):
        failure = f"ae parity: {len(err_modules)} of {n_modules} modules have a non-zero gradient"
    elif not abs(loss_k - loss_p) <= tol_loss:
        failure = "ae loss through the kernels disagrees with the plain path"
    elif not err["global_rel"] <= AE_PARITY_FACTOR * drift["global_rel"]:
        failure = "ae gradients through the kernels disagree with the plain path (global norm)"
    elif not modules["err_median"] <= AE_PARITY_FACTOR * modules["drift_median"]:
        failure = "ae gradients through the kernels disagree with the plain path (median module)"
    elif not ratio[worst] <= AE_PARITY_FACTOR:
        failure = f"ae gradients through the kernels disagree with the plain path (module {worst})"
    return {"loss": {"kernels": loss_k, "plain": loss_p, "tolerance": tol_loss}, "drift": drift, "kernels_vs_plain": err,
            "modules": modules, "module_drift_and_error": {m: [drift_modules[m], err_modules[m]] for m in err_modules},
            "ratio": ratio, "shares": shares, "accuracy": accuracy, "failure": failure}


# 12. the DiffusionAPI path (the JAX package's serving entry point) at full SD-1.5 v1 width, batch 1, 512px,
# CFG 7.5: every registered sampler at the API's 20 steps (lcm at its 4), ControlNet, img2img, inpainting, LoRA
API_STEPS = 20
LCM_STEPS = 4
IMG2IMG_FIDELITY = 0.2
# a ControlNet call: its input blocks' self-attentions at 64x64, 32x32 and 16x16, two each (the mid block's, at 8x8,
# L = 64, stays on the library path), and a GroupNorm for each res block's two norms (8 blocks and the mid's 2) and
# each transformer (6 and the mid's)
FLASH_PER_CONTROL = 6
GN_PER_CONTROL = 27


def unet_calls(sampler: str, steps: int) -> int:
    """UNet calls of one sampling loop: PLMS's improved-Euler first step evaluates twice, Heun's corrector once a
    step but on the last (sigma 0, plain Euler)."""
    return {"plms": steps + 1, "k_heun": 2 * steps - 1}.get(sampler, steps)


def _call_spec(a):
    return ("T", tuple(a.shape), str(a.dtype)) if hasattr(a, "shape") else a


@contextlib.contextmanager
def census(A, Cv, Gn, counts):
    """Count each launch of the three serving kernels by the shapes and dtypes of its tensors and its other
    arguments, in `counts` {(kernel, args, kwargs): launches}. The callers look the wrappers up as module globals;
    each launch still counts on the wrapper's own `launches`."""
    saved = A.flash_attention, Cv.conv3x3, Gn.group_norm_silu

    def rec(name, fn):
        def call(*args, **kw):
            key = (name, tuple(_call_spec(a) for a in args), tuple(sorted(kw.items())))
            counts[key] = counts.get(key, 0) + 1
            return fn(*args, **kw)

        return call

    A.flash_attention, Cv.conv3x3, Gn.group_norm_silu = (
        rec("flash_attention", saved[0]), rec("conv3x3", saved[1]), rec("group_norm", saved[2]))
    try:
        yield
    finally:
        A.flash_attention, Cv.conv3x3, Gn.group_norm_silu = saved


def watch(model):
    """Record the input shape of every UNet call and the latents of every decode of `model`."""
    seen = {"unet": [], "latents": []}
    model.unet.register_forward_pre_hook(lambda mod, args: seen["unet"].append(tuple(args[0].shape)))
    decode = model.decode

    def caught(z, **kw):
        seen["latents"].append(z.detach())
        return decode(z, **kw)

    model.decode = caught
    return seen


def drive_path(torch, A, Cv, Gn, label, name, fn, seen, want, censuses):
    """Run `fn` under the census (the warm-up), then timed on the host clock with the launch counters reset at 0
    and read just after: the launches equal `want` exactly, the census agrees with the counters, and one decode's
    latents are finite. The census goes to `censuses[name]`. Returns (the result, the path's record)."""
    kernels = ("flash_attention", "conv3x3", "group_norm")
    counts = {}
    with census(A, Cv, Gn, counts):
        fn()
    torch.cuda.synchronize()
    seen["unet"].clear()
    seen["latents"].clear()
    reset_launches(A, Cv, Gn)
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches(A, Cv, Gn)
    expected = dict.fromkeys(got, 0)
    expected.update(want)
    by_kernel = {k: sum(n for key, n in counts.items() if key[0] == k) for k in kernels}
    lat = seen["latents"][0].float() if len(seen["latents"]) == 1 else None
    print(f"{label}[{name}]: {wall * 1e3:.1f} ms per image, {len(seen['unet'])} UNet calls, launches "
          f"{json.dumps({k: v for k, v in got.items() if v})}, {len(counts)} distinct kernel calls"
          + ("" if lat is None else f", latent std {lat.std().item():.4f} max |z| {lat.abs().max().item():.3f}"))
    if got != expected:
        raise AssertionError(f"{label}: {name}: launches {got} != {expected}")
    if by_kernel != {k: got[k] for k in kernels}:
        raise AssertionError(f"{label}: {name}: the census {by_kernel} disagrees with the counters")
    if lat is None or not bool(torch.isfinite(lat).all()) or lat.abs().max().item() >= 1e3:
        raise AssertionError(f"{label}: {name}: latents not finite or out of range")
    censuses[name] = counts
    return result, {"ms_per_image": wall * 1e3, "unet_calls": len(seen["unet"]),
                    "launches": {k: v for k, v in got.items() if v}, "latent_std": lat.std().item()}


def bf16_ulp(torch, x):
    """The bf16 spacing at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def phase_diffusion_api(torch, np, cflearn_torch, A, Cv, Gn) -> dict:
    """Drive `DiffusionAPI` / `ControlledDiffusionAPI` as a user would. Every path runs twice: under the census
    (the warm-up), then timed on the host clock around the call and a synchronize, its launches counted and gated
    exactly, its UNet calls counted at the CFG batch, its latents (caught at the decode) finite. Each distinct
    kernel call of the census is then timed alone (`device_ms`), for each path's device ms by kernel."""
    from cflearn_torch.api.multimodal.diffusion import InpaintingMode, InpaintingSettings, fidelity_start_step
    from cflearn_torch.modules.common import redraw_zero_init
    from cflearn_torch.modules.core.convs import ResidualBlockWithTimeEmbedding
    from cflearn_torch.modules.core.lora import LoRAPack
    from cflearn_torch.modules.core.mixed_stacks import SpatialTransformer
    from cflearn_torch.modules.multimodal.diffusion.samplers import ISampler

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"diffusion api: {msg}")

    kernels = {"flash_attention": A.flash_attention, "conv3x3": Cv.conv3x3, "group_norm": Gn.group_norm_silu}
    out = {"samplers": {}, "paths": {}}
    censuses = {}

    def run_path(name, fn, seen, calls, want):
        result, out["paths"][name] = drive_path(torch, A, Cv, Gn, "api", name, fn, seen, want, censuses)
        batches = [shape[0] for shape in seen["unet"]]
        check(batches == [2] * calls, f"{name}: UNet calls at batches {batches}, want {calls} at the CFG batch 2")
        check(result.shape == (1, 512, 512, 3) and result.dtype == np.uint8, f"{name}: image {result.shape}")
        return result

    t0 = time.perf_counter()
    api = cflearn_torch.DiffusionAPI.from_sd("v1", device="cuda", seed=0)
    redraw_zero_init(api.m, seed=1)
    seen = watch(api.m)
    torch.cuda.synchronize()
    print(f"api: DiffusionAPI.from_sd('v1') bf16 built in {time.perf_counter() - t0:.1f} s")

    def serving(unets, encodes=0, controls=0):
        return {"flash_attention": (FLASH_PER_UNET + FLASH_PER_CONTROL * controls) * unets + 1 + ENCODER_FLASH * encodes,
                "conv3x3": DECODER_CONVS + ENCODER_CONVS * encodes,
                "group_norm": (GN_PER_UNET + GN_PER_CONTROL * controls) * unets + GN_PER_DECODE + GN_PER_ENCODE * encodes}

    images = {}
    for sampler in sorted(ISampler.d):
        steps = LCM_STEPS if sampler == "lcm" else API_STEPS
        calls = unet_calls(sampler, steps)
        api.switch_sampler(sampler)
        images[sampler] = run_path(sampler, lambda: api.txt2img(PROMPT, num_steps=steps, seed=0), seen, calls,
                                   serving(calls))
        out["samplers"][sampler] = dict(out["paths"][sampler], steps=steps)
    api.switch_sampler("ddim")
    image = images["ddim"]

    # ControlNet: one full-width net on a 512x512x3 hint, on for steps [2, 18] of 20
    cn = cflearn_torch.build(cflearn_torch.ControlNet, device="cuda", dtype=torch.bfloat16, seed=2)
    redraw_zero_init(cn, seed=3)
    n_res = sum(isinstance(m, ResidualBlockWithTimeEmbedding) for m in cn.modules())
    n_st = sum(isinstance(m, SpatialTransformer) for m in cn.modules())
    check(GN_PER_CONTROL == 2 * n_res + n_st and FLASH_PER_CONTROL == n_st - 1,
          f"the ControlNet holds {n_res} res blocks and {n_st} transformers")
    capi = cflearn_torch.ControlledDiffusionAPI(api.m, device="cuda")
    capi.prepare_control("canny", cn)
    gen = torch.Generator(device="cuda").manual_seed(6)
    hint = torch.randint(0, 256, (512, 512, 3), generator=gen, device="cuda").to(torch.uint8).cpu().numpy()
    run_path("control", lambda: capi.sample_with_control(
        1, {"canny": hint}, cond=PROMPT, num_steps=API_STEPS, seed=0, hint_starts={"canny": 0.1},
        hint_ends={"canny": 0.9}), seen, API_STEPS, serving(API_STEPS, controls=1))
    # one UNet-plus-control call through the kernels against the plain versions, held to the plain path's drift
    # under a one-ulp move of its input (phase 4's rule)
    with torch.no_grad():
        tokens = api.tokenizer.tokenize([PROMPT, ""]).astype(np.int64)
        cond = api.m.get_cond(torch.as_tensor(tokens, device="cuda"))
        x2 = torch.randn((1, 64, 64, 4), generator=gen, device="cuda").repeat(2, 1, 1, 1)
        t2 = torch.full((2,), 981, dtype=torch.long, device="cuda")
        hint2 = torch.as_tensor(hint, device="cuda").float().div(127.5).sub(1.0)[None].repeat(2, 1, 1, 1)

        def controlled(x):
            return api.m.denoise(x, t2, cond, control_net=cn, control_hint=hint2).float()

        eps_k = controlled(x2)
        with plain_kernels(A, Cv, Gn):
            eps_p = controlled(x2)
            drift = rel_err(controlled(bump_ulp(torch, x2)), eps_p)
    rel = rel_err(eps_k, eps_p)
    print(f"api parity: UNet + ControlNet call, kernels vs plain max rel err {rel:.3e} (tolerance "
          f"{PARITY_FACTOR * drift:.3e}: {PARITY_FACTOR} x the one-ulp drift {drift:.3e})")
    check(rel <= PARITY_FACTOR * drift, "the UNet + ControlNet call through the kernels disagrees with the plain path")
    out["control_parity"] = {"kernels_vs_plain": rel, "drift": drift}
    del capi, cn, eps_k, eps_p, cond

    # img2img at fidelity 0.2 and repaint on the 4-channel model: the first-stage encode at batch 1 through the kernels
    start = fidelity_start_step(IMG2IMG_FIDELITY, API_STEPS)
    run_path("img2img", lambda: api.img2img(image, cond=PROMPT, fidelity=IMG2IMG_FIDELITY, num_steps=API_STEPS, seed=0),
             seen, API_STEPS - start, serving(API_STEPS - start, encodes=1))
    mask = np.zeros((512, 512), np.float32)
    mask[128:320, 160:416] = 1.0
    run_path("repaint", lambda: api.inpainting(image, mask, cond=PROMPT, num_steps=API_STEPS, seed=0), seen, API_STEPS,
             serving(API_STEPS, encodes=1))
    # the encode through the kernels against the plain versions (phase 9's rule, at batch 1)
    with torch.no_grad():
        x = torch.as_tensor(image, device="cuda").float().div(127.5).sub(1.0).to(torch.bfloat16).float()
        lat_k = api.m.encode_first_stage(x).float()
        with plain_kernels(A, Cv, Gn):
            lat_p = api.m.encode_first_stage(x).float()
            drift_enc = rel_err(api.m.encode_first_stage(bump_ulp(torch, x)).float(), lat_p)
    rel_enc = rel_err(lat_k, lat_p)
    print(f"api parity: encode at batch 1, kernels vs plain max rel err {rel_enc:.3e} (tolerance "
          f"{PARITY_FACTOR * drift_enc:.3e}: {PARITY_FACTOR} x the one-ulp drift {drift_enc:.3e})")
    check(rel_enc <= PARITY_FACTOR * drift_enc, "the encode through the kernels disagrees with the plain path")
    out["encode_parity"] = {"kernels_vs_plain": rel_enc, "drift": drift_enc}

    # LoRA: a rank-4 pack over the UNet's attention projections, fused, sampled with, removed
    names = (r"unet\..*attn.*\.to_[qkv]\.weight", r"unet\..*attn.*\.to_out\.weight")
    fresh = LoRAPack.create(api.m, rank=4, target_patterns=names, generator=gen)
    deltas = {n: (d, (torch.randn(u.shape, generator=gen, device="cuda") * 0.05).to(u.dtype))
              for n, (d, u) in fresh.deltas.items()}
    params = dict(api.m.named_parameters())
    base = {n: params[n].detach().clone() for n in deltas}
    api.load_sd_lora("card", pack=LoRAPack(deltas, rank=4, alpha=2.0))
    api.set_sd_lora_scales({"card": 0.8})
    worst = 0.0
    for n, (d, u) in deltas.items():
        delta = 0.8 * 0.5 * (u.float() @ d.float())
        exact = base[n].float() + delta
        # the delta rounded to bf16, then the bf16 add: half an ulp of each, within one ulp at the larger of
        # |delta| and |the fused weight|
        room = bf16_ulp(torch, torch.maximum(delta.abs(), params[n].float().abs()))
        worst = max(worst, ((params[n].float() - exact).abs() / room).max().item())
    print(f"api lora: {len(deltas)} weights fused, the largest error {worst:.3f} bf16 ulps (at the larger of "
          f"|s up down| and |the fused weight|) from W + s up down")
    check(worst <= 1.0, f"a fused weight is {worst:.3f} ulps from W + s up down")
    lora_image = run_path("lora", lambda: api.txt2img(PROMPT, num_steps=API_STEPS, seed=0), seen, API_STEPS,
                          serving(API_STEPS))
    api.cleanup_sd_lora()
    restored = all(torch.equal(params[n], base[n]) for n in deltas)
    moved = int(np.abs(lora_image.astype(np.int16) - image.astype(np.int16)).max())
    print(f"api lora: restored bit for bit {restored}; the image moved by up to {moved} levels (printed, not gated)")
    check(restored, "LoRA: the base weights are not restored bit for bit")
    out["lora"] = {"weights": len(deltas), "max_ulps": worst, "restored": restored, "image_max_diff": moved}
    del api, base, deltas, fresh, params

    # 9-channel inpainting (`StableDiffusionInpainting`): the image and the masked image encoded, NORMAL and MASKED
    iapi = cflearn_torch.DiffusionAPI.from_sd_inpainting(device="cuda", seed=4)
    redraw_zero_init(iapi.m, seed=5)
    iseen = watch(iapi.m)
    check(iapi.m.unet.in_channels == 9 and iapi.m.unet.conv_in.weight.shape[1] == 9, "the inpainting UNet is not 9-channel")
    run_path("inpaint_normal", lambda: iapi.inpainting(image, mask, cond=PROMPT, num_steps=API_STEPS, seed=0), iseen,
             API_STEPS, serving(API_STEPS, encodes=2))
    masked = InpaintingSettings(mode=InpaintingMode.MASKED, mask_padding=32)
    run_path("inpaint_masked", lambda: iapi.inpainting(image, mask, cond=PROMPT, num_steps=API_STEPS, seed=0,
                                                       inpainting_settings=masked), iseen, API_STEPS,
             serving(API_STEPS, encodes=2))
    del iapi
    torch.cuda.empty_cache()

    # each distinct kernel call, timed alone on random inputs of its shapes: every path's device ms by kernel
    gen = torch.Generator(device="cuda").manual_seed(7)
    call_ms = {}
    for key in sorted({key for counts in censuses.values() for key in counts}, key=str):
        name, args, kw = key
        inputs = [torch.randn(a[1], generator=gen, device="cuda").to(getattr(torch, a[2].split(".")[1]))
                  if isinstance(a, tuple) and a[:1] == ("T",) else a for a in args]
        call_ms[key] = device_ms(torch, lambda: kernels[name](*inputs, **dict(kw)), 5, 3)
    for path, counts in censuses.items():
        out["paths"][path]["device_ms"] = {k: sum(call_ms[key] * n for key, n in counts.items() if key[0] == k)
                                           for k in kernels}
    print(f"api: {len(call_ms)} distinct kernel calls timed; device ms per image by kernel: "
          f"{json.dumps({p: v['device_ms'] for p, v in out['paths'].items()})}")
    return out


# 13. the VQ latent-diffusion family through DiffusionAPI (the zoo's `ldm_inpainting`, `ldm_semantic` and `ldm_vq`
# at full width, bf16), batch 1, no CFG, 20 DDIM steps
VQ_STEPS = 20
VQ_IMAGE = 256  # inpainting's and the outpainting conventions' image side
SEMANTIC_SIDE, SEMANTIC_CLASSES = 512, 182
SR_SIDE = 32  # sr's input side: 128x128 latents, a 512x512 image
# launches (flash, conv3x3, group_norm) of one call of each kind, counted from the architectures by the routing
# rules (flash: self-attention with L >= 256; conv3x3: 3x3 stride-1 convs with C, Co >= 64 at H * W >= 128^2 or the
# pinned 64x64x512x512; GroupNorm: every norm). The UNets' norms are also counted from their modules below
VQ_PER_CALL = {
    "inpaint_unet": (10, 2, 73),  # 64x64 latents: 5 attentions at L 1024 (d 64) and 5 at L 256 (d 96); the up
    # resblock's two 512-channel convs at 64x64 (the pinned shape)
    "outpaint_unet": (10, 0, 73),  # 96x96 latents (the 384px canvas): L 2304 and 576; no level reaches 128^2
    "semantic_unet": (1, 17, 36),  # 128x128 latents: only the mid block's attention (L 1024, d 128) routes
    "sr_unet": (16, 11, 61),  # 128x128 latents, 32 channels a head: L 4096, 1024, 256 (5, 5, 6 calls)
    "encode_256": (0, 15, 17),  # the attention-free f4 encoder on a 256px image (64x64x512 pinned)
    "encode_384": (0, 8, 17),
    "decode_64": (0, 24, 23),  # the attention-free f4 decoder to 256px
    "decode_96": (0, 14, 23),
    "decode_128": (1, 24, 24),  # the f4 decoder with its mid attention (L 16384, d 512) to 512px
}


def vq_launches(**calls) -> dict:
    """{kernel: launches} of `calls` {kind: number of calls}."""
    out = {"flash_attention": 0, "conv3x3": 0, "group_norm": 0}
    for kind, n in calls.items():
        for name, per in zip(out, VQ_PER_CALL[kind]):
            out[name] += per * n
    return out


def check_call(torch, F, A, Cv, Gn, key, gen) -> dict:
    """One distinct serving-kernel call of the census, on random inputs of its shapes: the kernel against its plain
    version (phase 2's tolerances), its device ms (CUDA-graph replay), its plain version's ms, the library call's
    device ms and the bound."""
    name, args, kw = key
    kw = dict(kw)
    dt = getattr(torch, args[0][2].split(".")[1])
    if name == "flash_attention":
        q, k, v = (torch.randn(a[1], generator=gen, device="cuda").to(dt) for a in args[:3])
        run = lambda: A.flash_attention(q, k, v, **kw)  # noqa: E731
        plain = lambda: A.flash_attention_plain(q, k, v, **kw)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        b, h, lq, d = q.shape
        lk = k.shape[2]
        bms, by = bound_ms(4.0 * b * h * lq * lk * d, q.element_size() * b * h * (2 * lq + 2 * lk) * d,
                           exps=b * h * lq * lk)
        tol_rel, shape = FLASH_REL, [b, h, lq, lk, d]
    elif name == "conv3x3":
        x = torch.randn(args[0][1], generator=gen, device="cuda").to(dt)
        co, c = args[1][1][0], args[1][1][-1]
        w = (torch.randn((co, c, 3, 3), generator=gen, device="cuda") * (9 * c) ** -0.5).to(dt)
        wk = Cv.kernel_weight(w)
        bias = None if args[2] is None else (torch.randn((co,), generator=gen, device="cuda") * 0.1).to(dt)
        xc, wc = x.permute(0, 3, 1, 2), w.contiguous(memory_format=torch.channels_last)
        run = lambda: Cv.conv3x3(x, wk, bias, **kw)  # noqa: E731
        plain = lambda: Cv.conv3x3_plain(x, wk, bias)  # noqa: E731
        lib = lambda: F.conv2d(xc, wc, bias, padding=1)  # noqa: E731
        m = x.numel() // c
        bms, by = bound_ms(2.0 * m * co * 9 * c, 2.0 * (m * c + 9 * c * co + co + m * co))
        tol_rel, shape = CONV_REL, list(x.shape) + [co]
    else:
        shape = list(args[0][1])
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(dt)
        w = (1.0 + 0.2 * torch.randn((c,), generator=gen, device="cuda")).to(dt)
        bias = (0.2 * torch.randn((c,), generator=gen, device="cuda")).to(dt)
        run = lambda: Gn.group_norm_silu(x, w, bias, **kw)  # noqa: E731
        plain = lambda: Gn.group_norm_silu_plain(x, w, bias, **kw)  # noqa: E731
        xn = x.permute(0, 3, 1, 2)

        def lib():
            y = F.group_norm(xn, kw["num_groups"], w, bias, kw["eps"])
            return F.silu(y) if kw.get("apply_silu") else y

        bms, by = bound_ms(0.0, x.element_size() * (2.0 * x.numel() + 2.0 * c))
        tol_rel = GN_REL
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    err = max_err(out, ref)
    tol = tol_rel * ref.float().abs().max().item()
    row = dict(kernel=name, shape=shape, kw=kw, max_abs_err=err, tol=tol, device_ms=device_ms(torch, run, 5, 3),
               plain_ms=time_ms(torch, plain, 5.0), library_device_ms=device_ms(torch, lib, 5, 3), bound_ms=bms,
               bound_by=by)
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"vq api: {name} {shape} {kw}: max_abs_err {err} > {tol}")
    return row


def phase_vq_api(torch, np, F, cflearn_torch, A, Cv, Gn) -> dict:
    """Serve the VQ latent-diffusion family as a user of the JAX package does: `DiffusionAPI.from_inpainting()`
    (inpainting, outpainting in pad mode and in the RGBA convention), `DiffusionAPI.from_semantic()`
    (`semantic2img` on a 512px index map of 182 classes) and `DiffusionAPI(ldm_vq(latent_in_channels=6,
    condition_type="concat"))` (`sr` on a 32px image), bf16 from seeds 0, 2, 4, the zero-initialised convs redrawn. Each
    path runs under the census, then timed on the host clock: exact launches, its UNet calls at batch 1, finite
    latents. Every distinct kernel call of the census is then held against its plain version and timed alone
    (`check_call`); one UNet call of each architecture, the f4 encode (before the codebook) and the f4 decode
    through the kernels against the plain versions within PARITY_FACTOR x the plain path's one-ulp drift."""
    from cflearn_torch.modules.common import redraw_zero_init
    from cflearn_torch.modules.core.attentions import MultiHeadSpatialAttention
    from cflearn_torch.modules.core.convs import ResidualBlockWithTimeEmbedding

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"vq api: {msg}")

    kernels = ("flash_attention", "conv3x3", "group_norm")
    out = {"paths": {}, "parity": {}}
    censuses = {}
    gen = torch.Generator(device="cuda").manual_seed(12)

    def build(factory, seed):
        t0 = time.perf_counter()
        api = factory(seed)
        redraw_zero_init(api.m, seed=seed + 1)
        seen = watch(api.m)
        unet = api.m.unet
        n_res = sum(isinstance(m, ResidualBlockWithTimeEmbedding) for m in unet.modules())
        n_attn = sum(isinstance(m, MultiHeadSpatialAttention) for m in unet.modules())
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in api.m.parameters())
        print(f"vq api: {type(api.m).__name__} of {n_params:,} bf16 parameters built in {time.perf_counter() - t0:.1f} s "
              f"({n_res} res blocks, {n_attn} multi-head attentions in the UNet)")
        return api, seen, 2 * n_res + n_attn + 1

    def run_path(name, fn, seen, latent, want, side):
        result, out["paths"][name] = drive_path(torch, A, Cv, Gn, "vq api", name, fn, seen, want, censuses)
        grids = [shape[:3] for shape in seen["unet"]]
        check(grids == [(1, latent, latent)] * VQ_STEPS,
              f"{name}: UNet calls at {sorted(set(grids))}, want {VQ_STEPS} at batch 1 and {latent}x{latent}")
        check(result.shape == (1, side, side, 3) and result.dtype == np.uint8, f"{name}: image {result.shape}")
        return result

    def parity(label, fn, x):
        """fn through the kernels against the plain versions, held to the plain path's drift under a one-ulp move
        of x (phase 4's rule)."""
        with torch.no_grad():
            y_k = fn(x).float()
            with plain_kernels(A, Cv, Gn):
                y_p = fn(x).float()
                drift = rel_err(fn(bump_ulp(torch, x)).float(), y_p)
        rel = rel_err(y_k, y_p)
        print(f"vq api parity: {label}, kernels vs plain max rel err {rel:.3e} (tolerance {PARITY_FACTOR * drift:.3e}: "
              f"{PARITY_FACTOR} x the one-ulp drift {drift:.3e})")
        check(rel <= PARITY_FACTOR * drift, f"{label} through the kernels disagrees with the plain path")
        out["parity"][label] = {"kernels_vs_plain": rel, "drift": drift}

    def unet_parity(label, m, latent, cond_channels):
        x = torch.randn((1, latent, latent, m.out_channels), generator=gen, device="cuda").to(torch.bfloat16)
        cond = torch.randn((1, latent, latent, cond_channels), generator=gen, device="cuda").to(torch.bfloat16)
        t = torch.full((1,), 981, dtype=torch.long, device="cuda")
        parity(f"{label} UNet call at {latent}x{latent}", lambda z: m.denoise(z, t, cond), x)

    # the inpainting model: inpainting, outpainting (pad, RGBA) on a 256px image
    iapi, iseen, gn_unet = build(lambda seed: cflearn_torch.DiffusionAPI.from_inpainting(device="cuda", seed=seed), 0)
    check(iapi.m.unet.in_channels == 7 and iapi.m.first_stage.encoder.mid_attn is None and
          gn_unet == VQ_PER_CALL["inpaint_unet"][2] == VQ_PER_CALL["outpaint_unet"][2],
          f"the inpainting model: {iapi.m.unet.in_channels} UNet input channels, {gn_unet} norms a UNet call")
    image = torch.randint(0, 256, (VQ_IMAGE // 8, VQ_IMAGE // 8, 3), generator=gen, device="cuda").to(torch.float32)
    image = F.interpolate(image.permute(2, 0, 1)[None], scale_factor=8, mode="bilinear")[0].permute(1, 2, 0)
    image = image.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    mask = np.zeros((VQ_IMAGE, VQ_IMAGE), np.float32)
    mask[64:192, 64:192] = 1.0
    inpainted = run_path("inpainting", lambda: iapi.inpainting(image, mask, num_steps=VQ_STEPS, seed=0), iseen, 64,
                         vq_launches(inpaint_unet=VQ_STEPS, encode_256=2, decode_64=1), VQ_IMAGE)
    kept = inpainted[0][mask == 0].astype(np.int16) - image[mask == 0].astype(np.int16)
    print(f"vq api[inpainting]: the unmasked pixels move by at most {int(np.abs(kept).max())} levels")
    check(int(np.abs(kept).max()) <= 1, "inpainting changed the unmasked pixels")
    side = VQ_IMAGE + 2 * (VQ_IMAGE // 4)
    run_path("outpainting_pad", lambda: iapi.outpainting(image, num_steps=VQ_STEPS, seed=0), iseen, side // 4,
             vq_launches(outpaint_unet=VQ_STEPS, encode_384=2, decode_96=1), side)
    alpha = np.full((VQ_IMAGE, VQ_IMAGE, 1), 255, np.uint8)
    alpha[:, 3 * VQ_IMAGE // 4:] = 0
    rgba = np.concatenate([image, alpha], axis=-1)
    run_path("outpainting_rgba", lambda: iapi.outpainting("", rgba, num_steps=VQ_STEPS, seed=0), iseen, 64,
             vq_launches(inpaint_unet=VQ_STEPS, encode_256=2, decode_64=1), VQ_IMAGE)
    unet_parity("ldm_inpainting", iapi.m, 64, 4)
    x = torch.as_tensor(image, device="cuda").float().div(127.5).sub(1.0)[None].to(torch.bfloat16)
    fs = iapi.m.first_stage
    parity("the attention-free f4 encode at 256px (before the codebook)", lambda im: fs.to_embedding(fs.encoder(im)), x)
    del iapi, iseen
    torch.cuda.empty_cache()

    # the semantic model: semantic2img on a 512px index map of 182 classes
    sapi, sseen, gn_unet = build(lambda seed: cflearn_torch.DiffusionAPI.from_semantic(device="cuda", seed=seed), 2)
    check(gn_unet == VQ_PER_CALL["semantic_unet"][2], f"the semantic UNet runs {gn_unet} norms a call")
    labels = torch.randint(0, SEMANTIC_CLASSES, (SEMANTIC_SIDE // 16, SEMANTIC_SIDE // 16), generator=gen, device="cuda")
    labels = labels.repeat_interleave(16, 0).repeat_interleave(16, 1).cpu().numpy()
    run_path("semantic2img", lambda: sapi.semantic2img(labels, num_steps=VQ_STEPS, seed=0), sseen, 128,
             vq_launches(semantic_unet=VQ_STEPS, decode_128=1), SEMANTIC_SIDE)
    unet_parity("ldm_semantic", sapi.m, 128, 3)
    del sapi, sseen
    torch.cuda.empty_cache()

    # the VQ LDM made concat-conditioned on 6 channels: sr on a 32px image
    def sr_api(seed):
        m = cflearn_torch.ldm_vq(latent_in_channels=6, condition_type="concat", device="cuda", dtype=torch.bfloat16,
                                 seed=seed)
        return cflearn_torch.DiffusionAPI(m, use_bf16=True, device="cuda")

    rapi, rseen, gn_unet = build(sr_api, 4)
    check(gn_unet == VQ_PER_CALL["sr_unet"][2], f"the sr UNet runs {gn_unet} norms a call")
    small = torch.randint(0, 256, (SR_SIDE, SR_SIDE, 3), generator=gen, device="cuda").to(torch.uint8).cpu().numpy()
    run_path("sr", lambda: rapi.sr(small, num_steps=VQ_STEPS, seed=0), rseen, 4 * SR_SIDE,
             vq_launches(sr_unet=VQ_STEPS, decode_128=1), 16 * SR_SIDE)
    unet_parity("ldm_vq (sr)", rapi.m, 128, 3)
    z = torch.randn((1, 128, 128, 3), generator=gen, device="cuda").to(torch.bfloat16)
    parity("the f4 decode from 128x128 latents (mid attention at L 16384)", lambda lat: rapi.m.decode_first_stage(lat), z)
    del rapi, rseen, z
    torch.cuda.empty_cache()

    # every distinct kernel call of the census against its plain version, timed alone; each path's sums
    t0 = time.perf_counter()
    calls = {}
    for key in sorted({key for counts in censuses.values() for key in counts}, key=str):
        calls[key] = check_call(torch, F, A, Cv, Gn, key, gen)
    out["calls"] = [dict(calls[key], launches={p: c[key] for p, c in censuses.items() if key in c})
                    for key in sorted(calls, key=str)]
    for path, counts in censuses.items():
        out["paths"][path]["by_kernel"] = {
            k: {f: sum(calls[key][f] * n for key, n in counts.items() if key[0] == k)
                for f in ("device_ms", "plain_ms", "library_device_ms", "bound_ms")}
            for k in kernels}
    worst = {k: max((r["max_abs_err"] / r["tol"] for r in calls.values() if r["kernel"] == k), default=0.0)
             for k in kernels}
    print(f"vq api: {len(calls)} distinct kernel calls held against their plain versions in "
          f"{time.perf_counter() - t0:.1f} s (largest error / tolerance by kernel {json.dumps(worst)}); device ms per "
          f"image by kernel: {json.dumps({p: {k: v['device_ms'] for k, v in o['by_kernel'].items()} for p, o in out['paths'].items()})}")
    return out


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
    from cflearn_torch.modules.core.mixed_stacks import SpatialTransformer
    from cflearn_torch.modules.multimodal.diffusion.samplers import deepcache_refresh_mask
    from cflearn_torch.toolkit.quality import compare_outputs
    from cflearn_torch.ops import _native
    from cflearn_torch.ops import attention as A
    from cflearn_torch.ops import conv as Cv
    from cflearn_torch.ops import group_norm as Gn
    from cflearn_torch.optimizers import build_optimizer
    from cflearn_torch.trainer import MultiScopeStep, make_train_step

    print("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))
    print("tf32: matmul", torch.backends.cuda.matmul.allow_tf32, "cudnn", torch.backends.cudnn.allow_tf32)
    global EXP_PER_S
    clock = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    EXP_PER_S = sms * EX2_PER_CLOCK_PER_SM * clock * 1e6
    print(f"sm clock (clocks.max.sm) {clock:.0f} MHz, {sms} SMs: {EXP_PER_S:.4g} exponentials/s")
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
            # ptxas's "wgmma.mma_async instructions are serialized" (C7515 / C7520): each wgmma then waits for the last
            serial = log.read_text().count("wgmma.mma_async instructions are serialized")
            ptxas_ms = sum(float(ln.split("Compile time = ")[1].split(" ")[0])
                           for ln in log.read_text().splitlines() if "Compile time = " in ln)
            print(f"ptxas[{name}] {len(regs)} kernels, registers {min(regs, default=0)}..{max(regs, default=0)}, "
                  f"{len(spills)} with spills{spilled(log.read_text()) if spills else ''}, {serial} with wgmma "
                  f"serialised, ptxas {ptxas_ms:.0f} ms, library built in {secs[name]:.1f} s")
            if name in BWD_MODE:
                regs90 = bwd_registers(log.read_text())
                print(f"ptxas[{name}] wgmma + TMA backward kernels (loop, K steps, consumers): registers at launch, "
                      f"bf16 {json.dumps({k[5:]: v for k, v in regs90.items() if k.startswith('bf16')})} (fp16 the "
                      f"same: {all(regs90[k] == regs90['bf16' + k[3:]] for k in regs90 if k.startswith('f16'))})")
            if name in ("flash_attention", "flash_fwd_lse"):
                regs90 = sm90_registers(log.read_text())
                print(f"ptxas[{name}] wgmma + TMA kernels (K steps, consumers): registers at launch, bf16 "
                      f"{json.dumps({k[5:]: v for k, v in regs90.items() if k.startswith('bf16')})} (fp16 the same: "
                      f"{all(regs90[k] == regs90['bf16' + k[3:]] for k in regs90 if k.startswith('f16'))})")

    # 2. kernels
    rows = phase_kernels(torch, F, (A, Cv))
    rows.update(phase_train_kernels(torch, F, A))
    torch.cuda.empty_cache()
    for name, cases in phase_ae_kernels(torch, F, Cv, Gn).items():
        rows.setdefault(name, []).extend(cases)
    # every row says on which path it is launched how often
    for name, cases in rows.items():
        for r in cases:
            if "per" not in r:
                r["per"] = {MAIN_PATH[name]: r.pop("per_path")}
            if r["case"] == "ae_mid" and name in ("flash_attention", "flash_fwd_lse", "flash_bwd_fused"):
                r["per"]["ae"] = AE_FLASH
            if r["case"] == "ldm_enc_mid" and name == "flash_attention":
                r["per"]["ldm"] = ENCODER_FLASH
    # the flash shapes of the lossy serving configurations: the 64x64 attentions at the merged length
    for config in ("faithful", "accelerated"):
        full = int(deepcache_refresh_mask(STEPS, SERVE_CONFIGS[config][1]).sum())
        per_case = {"unet_64x64_tome": 5 * full + FLASH_PER_SHALLOW * (STEPS - full), "unet_32x32": 5 * full,
                    "unet_16x16": 5 * full, "vae_mid": 1}
        for r in rows["flash_attention"]:
            if r["case"] in per_case:
                r["per"][config] = per_case[r["case"]]
    torch.cuda.empty_cache()
    for name in ("flash_attention", "flash_fwd_lse"):
        for r in rows[name]:
            if r.get("kernel") in ("sm90", "sm90_wide"):
                print(f"yardstick {name} {r['case']}: device ms {r['kernel']} {r['device_ms']:.4f}, mma.sync "
                      f"{r['mma_sync_device_ms']:.4f} ({r['mma_sync_device_ms'] / r['device_ms']:.2f}x), "
                      f"SDPA {r['library_device_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']})")
    for r in rows["conv3x3_fold"]:
        print(f"yardstick conv3x3_fold {r['case']}: plan {json.dumps(r['plan'])}, ms {r['ms']:.4f} (device "
              f"{r['device_ms']:.4f}), mma.sync {r['mma_sync_ms']:.4f} (device {r['mma_sync_device_ms']:.4f}, "
              f"{r['mma_sync_device_ms'] / r['device_ms']:.2f}x), 9-tap conv3x3 device {r['conv3x3_device_ms']:.4f}, "
              f"cuDNN {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}, "
              f"{r['bound_share_device']:.0%} of the device time)")
    for r in rows["conv3x3_w8a8"]:
        print(f"yardstick conv3x3_w8a8 {r['case']}: plan {json.dumps(r['plan'])}, device ms {r['device_ms']:.4f}, "
              f"mma.sync {r['mma_sync_device_ms']:.4f} ({r['mma_sync_device_ms'] / r['device_ms']:.2f}x), bf16 "
              f"conv3x3 {r['unquantised_conv3x3_kernel_device_ms']:.4f}, route {r['route_device_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}, {r['bound_share_device']:.0%} of the device time)")
    on = {name: [r for r in rows[name] if r["per"].get("w8a8", 0) > 0] for name in ("conv3x3_w8a8", "quantize_w8a8")}
    dec = {f"{name} {key}": sum(r[key] * r["per"]["w8a8"] for r in on[name])
           for name, keys in (("conv3x3_w8a8", ("device_ms", "mma_sync_device_ms", "unquantised_conv3x3_kernel_device_ms",
                                                "route_device_ms", "route_ms", "bound_ms")),
                              ("quantize_w8a8", ("device_ms", "plain_device_ms", "bound_ms")))
           for key in keys}
    print(f"yardstick W8A8 per decode ({sum(r['per']['w8a8'] for r in on['conv3x3_w8a8'])} convs), device ms: "
          f"{json.dumps(dec)}")
    for path in ("txt2img", "finetune", "ae"):
        on = [r for r in rows["group_norm"] if r["per"].get(path, 0) > 0]
        tot = {k: sum(r[k] * r["per"][path] for r in on) for k in ("ms", "device_ms", "slabs_ms", "slabs_device_ms",
                                                                   "library_ms", "bound_ms")}
        print(f"yardstick group_norm per {path} ({sum(r['per'][path] for r in on)} calls): ms {tot['ms']:.3f} (device "
              f"{tot['device_ms']:.3f}), slabs {tot['slabs_ms']:.3f} (device {tot['slabs_device_ms']:.3f}), "
              f"F.group_norm + F.silu {tot['library_ms']:.3f}, bound {tot['bound_ms']:.3f} (bytes, "
              f"{tot['bound_ms'] / tot['device_ms']:.0%} of the device time)")
    for name in BWD_MODE:
        for r in rows[name]:
            print(f"yardstick {name} {r['case']}: plan {r['kernel']}, device ms {r['device_ms']:.4f}, mma.sync "
                  f"{r['mma_sync_device_ms']:.4f} ({r['mma_sync_device_ms'] / r['device_ms']:.2f}x), SDPA backward "
                  f"{r['library_device_ms']:.4f}, bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}, {r['bound_ms'] / r['device_ms']:.0%} of the device time)")
    print(f"kernels: done at {time.perf_counter() - t_start:.0f} s")

    # 3. path: the serving configurations, one prompt through the tokenizer, the same z
    steps = STEPS
    t0 = time.perf_counter()
    model = cflearn_torch.build_sd("v1", device="cuda", dtype=torch.bfloat16, seed=0)
    redrawn = redraw_zero_init(model, seed=1)
    torch.cuda.synchronize()
    print(f"path: built SD-1.5 v1 bf16 ({sum(p.numel() for p in model.parameters())} params, "
          f"{redrawn} zero-init modules redrawn) in {time.perf_counter() - t0:.1f} s")
    tokenizer = cflearn_torch.CLIPTokenizer()
    tokens = tokenizer.tokenize([PROMPT]).astype(np.int64)
    uncond = tokenizer.tokenize([""]).astype(np.int64)
    print(f"path: tokenizer {tokenizer.provenance}, prompt ids {tokens[0, :12].tolist()}...")
    gen = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn((1, 64, 64, 4), generator=gen, device="cuda")
    serve = {}
    for config, (ratio, interval) in SERVE_CONFIGS.items():
        bench_config = config if config in cflearn_torch.CONFIGS else None
        if bench_config is None:  # ToMe alone
            cflearn_torch.configure(model, "lossless")
            for module in model.modules():
                if isinstance(module, SpatialTransformer):
                    module.set_tome_ratio(ratio)
        kw = dict(config=bench_config, num_steps=steps, guidance_scale=7.5, z=z)
        cflearn_torch.txt2img(model, PROMPT, **kw)  # warm-up
        torch.cuda.synchronize()
        reset_launches(A, Cv, Gn)
        t0 = time.perf_counter()
        images_c, latents_c = cflearn_torch.txt2img(model, PROMPT, return_latents=True, **kw)
        torch.cuda.synchronize()
        wall_c = time.perf_counter() - t0
        launches_c = read_launches(A, Cv, Gn)
        full = steps if interval is None else int(deepcache_refresh_mask(steps, interval).sum())
        shallow = steps - full
        want = dict.fromkeys(launches_c, 0)
        want.update(flash_attention=FLASH_PER_UNET * full + FLASH_PER_SHALLOW * shallow + 1, conv3x3=DECODER_CONVS,
                    group_norm=GN_PER_UNET * full + GN_PER_SHALLOW * shallow + GN_PER_DECODE)
        print(f"path[{config}]: steps {steps} ({full} full and {shallow} shallow UNet calls), {wall_c:.3f} s per image, "
              f"launches {json.dumps(launches_c)}")
        if tuple(images_c.shape) != (1, 512, 512, 3) or images_c.dtype != torch.uint8:
            return fail(f"{config}: image {tuple(images_c.shape)} {images_c.dtype}, want (1, 512, 512, 3) uint8")
        if not torch.isfinite(latents_c).all():
            return fail(f"{config}: non-finite latents")
        if launches_c != want:
            return fail(f"{config}: launches {launches_c} != {want}")
        with torch.no_grad():
            decoded = model.decode(latents_c).float().cpu().numpy()
        serve[config] = dict(seconds_per_image=wall_c, img_per_s=1.0 / wall_c, full_unet_calls=full,
                             shallow_unet_calls=shallow, launches=launches_c, images=images_c, latents=latents_c,
                             decoded=decoded)
    cflearn_torch.configure(model, "lossless")
    images, latents = serve["lossless"]["images"], serve["lossless"]["latents"]
    wall, launches = serve["lossless"]["seconds_per_image"], serve["lossless"]["launches"]
    print(f"path: image mean {images.float().mean().item():.3f} std {images.float().std().item():.3f}, "
          f"latent std {latents.std().item():.4f}")
    ref_lat, ref_dec = latents.float().cpu().numpy(), serve["lossless"]["decoded"]
    for config, (psnr_min, ssim_min) in QUALITY_FLOORS.items():
        report = compare_outputs(ref_lat, ref_dec, serve[config]["latents"].float().cpu().numpy(), serve[config]["decoded"])
        serve[config]["quality"] = report.to_dict()
        print(f"quality[{config}] vs lossless: {json.dumps(report.to_dict())} (floors PSNR {psnr_min} dB, SSIM {ssim_min})")
        if not (report.image_psnr >= psnr_min and report.image_ssim >= ssim_min):
            return fail(f"{config}: PSNR {report.image_psnr:.2f} dB / SSIM {report.image_ssim:.3f} below the floors")

    # 4. parity: kernels vs plain versions through the whole net
    with torch.no_grad():
        cond = model.get_cond(torch.as_tensor(np.concatenate([tokens, uncond]), device="cuda"))
        x2 = torch.cat([z, z])
        t2 = torch.full((2,), 981, dtype=torch.long, device="cuda")
        eps_k = model.denoise(x2, t2, cond).float()
        dec_k = model.decode(latents).float()
        with plain_kernels(A, Cv, Gn):
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

    # the lossless latents decoded again: W8A8 on, then the dj-folded conv (module defaults, restored)
    decodes = {}
    with torch.no_grad():
        for route, attr in (("w8a8", "W8A8_DEFAULT"), ("fold", "FOLD")):
            setattr(Cv, attr, True)
            try:
                reset_launches(A, Cv, Gn)
                dec = model.decode(latents)
                torch.cuda.synchronize()
                decodes[route] = (dec.float(), read_launches(A, Cv, Gn))
                decodes[route + "_ms"] = time_ms(torch, lambda: model.decode(latents))
                # the device's time alone: one decode captured in a CUDA graph and replayed
                decodes[route + "_device_ms"] = device_ms(torch, lambda: model.decode(latents), 1, 3)
            finally:
                setattr(Cv, attr, False)
        decodes["bf16_ms"] = time_ms(torch, lambda: model.decode(latents))
        decodes["bf16_device_ms"] = device_ms(torch, lambda: model.decode(latents), 1, 3)
    w8a8_launches, fold_launches = decodes["w8a8"][1], decodes["fold"][1]
    # a W8A8 conv is one quantiser launch and one int8 conv launch
    for route, kernels in (("w8a8", ("conv3x3_w8a8", "quantize_w8a8")), ("fold", ("conv3x3_fold",))):
        got = decodes[route][1]
        want = dict.fromkeys(got, 0)
        want.update({"flash_attention": 1, "group_norm": GN_PER_DECODE}, **dict.fromkeys(kernels, DECODER_CONVS))
        print(f"{route} decode: launches {json.dumps(got)}, {decodes[route + '_ms']:.2f} ms (bf16 9-tap decode "
              f"{decodes['bf16_ms']:.2f} ms, W8A8 decode {decodes['w8a8_ms']:.2f} ms, dj-folded decode "
              f"{decodes['fold_ms']:.2f} ms; event windows); device ms by graph replay: bf16 "
              f"{decodes['bf16_device_ms']:.2f}, W8A8 {decodes['w8a8_device_ms']:.2f}, dj-folded "
              f"{decodes['fold_device_ms']:.2f}")
        if got != want:
            return fail(f"{route} decode launches {got} != {want}")
    w8a8_quality = compare_outputs(ref_lat, dec_k.cpu().numpy(), ref_lat, decodes["w8a8"][0].cpu().numpy())
    print(f"w8a8 decode vs the bf16 decode: {json.dumps(w8a8_quality.to_dict())} "
          f"(floors PSNR {W8A8_FLOOR[0]} dB, SSIM {W8A8_FLOOR[1]})")
    if not (w8a8_quality.image_psnr >= W8A8_FLOOR[0] and w8a8_quality.image_ssim >= W8A8_FLOOR[1]):
        return fail("the W8A8 decode is below its quality floors")
    rel_fold = rel_err(decodes["fold"][0], dec_k)
    print(f"fold decode vs the 9-tap decode: max rel err {rel_fold:.3e} (tolerance {tol_vae:.3e})")
    if not rel_fold <= tol_vae:
        return fail("the dj-folded decode disagrees with the 9-tap decode")
    serve_out = {
        config: {key: serve[config][key] for key in ("seconds_per_image", "img_per_s", "full_unet_calls",
                                                     "shallow_unet_calls", "launches", "quality") if key in serve[config]}
        for config in serve
    }
    serve_out["decode_ms"] = {route: decodes[route + "_ms"] for route in ("bf16", "w8a8", "fold")}
    serve_out["decode_device_ms"] = {route: decodes[route + "_device_ms"] for route in ("bf16", "w8a8", "fold")}
    serve_out["w8a8_decode_quality"] = w8a8_quality.to_dict()
    serve_out["fold_decode_rel_err"] = rel_fold
    del model, images, latents, cond, eps_k, eps_p, eps_u, dec_k, dec_p, serve, decodes
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
    reset_launches(A, Cv, Gn)
    t0 = time.perf_counter()
    result = cflearn_torch.finetune_unet(
        tmodel, x0, ctx, num_steps=TRAIN_STEPS, use_checkpoint=use_checkpoint, **train_kw
    )
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_launches = read_launches(A, Cv, Gn)
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
        "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_attention": 0, "conv3x3": 0, "conv3x3_wgrad": 0,
        "conv3x3_w8a8": 0, "quantize_w8a8": 0, "conv3x3_fold": 0,
        # the forward's norms; their backward recomputes the plain version. A checkpointed block's
        # forward runs twice
        "group_norm": GN_PER_UNET * TRAIN_STEPS * (2 if use_checkpoint else 1),
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
    with plain_kernels(A, Cv, Gn):
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
        reset_launches(A, Cv, Gn)
        with split_backward(A, record):
            loss_s, grads_s = fwd_bwd()
        torch.cuda.synchronize()
        split_launches = read_launches(A, Cv, Gn)
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

    del tmodel, step, grads_k, grads_a, grads_b, grads_s, split_runs, rec_a, rec_b, record
    torch.cuda.empty_cache()

    # 7. ae path: the ae_kl adversarial train step at full width, batch 8, 256px
    gen = torch.Generator(device="cuda").manual_seed(4)
    ae = cflearn_torch.build_ae(AE_CONFIG, device="cuda", seed=0)
    images = torch.randn((AE_BATCH, 256, 256, 3), generator=gen, device="cuda").clamp(-1.0, 1.0)
    ae_kw = dict(compute_dtype=torch.bfloat16, generator=gen)
    cflearn_torch.train_autoencoder(ae, images, num_steps=1, **ae_kw)  # warm-up
    torch.cuda.synchronize()
    scopes = {scope: ae.params_filter(scope) for scope in ("core", "discriminator")}
    print(f"ae: {sum(p.numel() for _, p in scopes['core'])} core + "
          f"{sum(p.numel() for _, p in scopes['discriminator'])} discriminator f32 parameters, batch {AE_BATCH}, 256px")
    before = {n: p.detach().clone() for named in scopes.values() for n, p in named}
    stats_before = {n: b.detach().clone() for n, b in ae.named_buffers()}
    torch.cuda.reset_peak_memory_stats()
    reset_launches(A, Cv, Gn)
    t0 = time.perf_counter()
    result = cflearn_torch.train_autoencoder(ae, images, num_steps=AE_STEPS, **ae_kw)
    torch.cuda.synchronize()
    ae_wall = time.perf_counter() - t0
    ae_launches = read_launches(A, Cv, Gn)
    ae_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    ae_step_ms = ae_wall / AE_STEPS * 1e3
    ae_losses = [{k: v.item() for k, v in step_losses.items()} for step_losses in result["losses"]]
    print(f"ae: {AE_STEPS} steps, {ae_step_ms:.1f} ms per step, {AE_BATCH / ae_step_ms * 1e3:.2f} samples/s, "
          f"peak memory {ae_peak_gb:.2f} GiB, launches {json.dumps(ae_launches)}")
    print(f"ae: losses {json.dumps(ae_losses)}")
    names = {"core_loss", "core_l1", "core_kl", "core_g", "discriminator_loss", "discriminator_d"}
    for step_losses in ae_losses:
        if set(step_losses) != names or not all(math.isfinite(v) for v in step_losses.values()):
            return fail(f"ae losses {step_losses}")
    # per step: every routed conv forward twice (core, and the discriminator scope's forward) and
    # its dx once through the forward kernel, its weight gradient once; the norms of two forwards;
    # the two attentions with a gradient in core and without in the discriminator scope
    want = {
        "conv3x3": 3 * AE_CONVS * AE_STEPS, "conv3x3_wgrad": AE_CONVS * AE_STEPS,
        "group_norm": 2 * GN_PER_AE_FORWARD * AE_STEPS, "flash_fwd_lse": AE_FLASH * AE_STEPS,
        "flash_bwd_fused": AE_FLASH * AE_STEPS, "flash_attention": AE_FLASH * AE_STEPS,
        "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "conv3x3_w8a8": 0, "quantize_w8a8": 0, "conv3x3_fold": 0,
    }
    if ae_launches != want:
        return fail(f"ae launches {ae_launches} != {want}")
    still = [n for named in scopes.values() for n, p in named if torch.equal(p, before[n])]
    stats_still = [n for n, b in ae.named_buffers() if torch.equal(b, stats_before[n])]
    n_leaves = 0
    for scope, fn in result["steps"].items():
        bad = [n for n, g in fn.grads.items() if not torch.isfinite(g).all()]
        zero = [n for n, g in fn.grads.items() if not g.any()]
        if bad or zero or len(fn.grads) != len(scopes[scope]):
            return fail(f"ae {scope}: non-finite gradients {bad[:3]}, all-zero gradients {zero[:3]}")
        n_leaves += len(fn.grads)
    print(f"ae: {n_leaves} gradient leaves finite, none all-zero, {len(still)} parameters unmoved, "
          f"{len(stats_before)} BatchNorm statistics, {len(stats_still)} of them unmoved")
    if still or stats_still or not stats_before:
        return fail(f"unmoved parameters {still[:3]}, unmoved BatchNorm statistics {stats_still[:3]}")
    del before, result
    torch.cuda.empty_cache()
    print(f"ae path: done at {time.perf_counter() - t_start:.0f} s")

    # 8. ae parity: one core forward + backward, kernels vs plain versions, same noise
    multi = MultiScopeStep(ae, {scope: build_optimizer("adam", 1e-4) for scope in scopes}, compute_dtype=torch.bfloat16)
    core = multi.steps["core"]
    core.train_step.step_actives = {"core": True, "discriminator": True}
    z_noise = torch.randn((AE_BATCH, 32, 32, 4), generator=gen, device="cuda")
    images_b = images.to(torch.bfloat16).float()

    def ae_fwd_bwd(x=images_b):
        losses = core.loss_and_grads({INPUT_KEY: x}, forward_kwargs={"noise": z_noise})
        grads, core.grads = core.grads, {}
        return losses[LOSS_KEY].item(), grads

    ae_par = ae_parity(torch, ae_fwd_bwd, images_b, A, Cv, Gn)
    ae_drift, ae_err, ae_modules = ae_par["drift"], ae_par["kernels_vs_plain"], ae_par["modules"]
    for label, top in ae_par["shares"].items():
        print(f"ae parity: global-norm error^2 by leaf, {label}: {[(n, f'{e:.3e}', f'{r:.3e}') for n, e, r in top]}")
    drift_mod = {m: d for m, (d, _) in ae_par["module_drift_and_error"].items()}
    err_mod = {m: e for m, (_, e) in ae_par["module_drift_and_error"].items()}
    for label, table in (("drift", drift_mod), ("kernels", err_mod), ("kernels / allowed drift", ae_par["ratio"])):
        top = sorted(((v, m) for m, v in table.items()), reverse=True)[:4]
        print(f"ae parity: worst modules in the 2-norm, {label}: {[(m, round(v, 4)) for v, m in top]}")
    print(f"ae parity: per module {json.dumps(ae_modules)}")
    print(f"ae parity: loss kernels {ae_par['loss']['kernels']:.6f} plain {ae_par['loss']['plain']:.6f} "
          f"(tolerance {ae_par['loss']['tolerance']:.3e})")
    print(f"ae parity: plain path vs itself with the images one bf16 ulp away (global_rel: the largest of the "
          f"four moves): {json.dumps(ae_drift)}")
    print(f"ae parity: kernels vs plain: {json.dumps(ae_err)} (tolerance {AE_PARITY_FACTOR} x the drift)")
    if ae_par["failure"]:
        return fail(ae_par["failure"])
    ae_mod_table = ae_par["module_drift_and_error"]
    del ae_par
    # the weight gradient and GroupNorm sum in a fixed order. With the split attention backward and
    # cuDNN held to its deterministic algorithms (the convs that are not routed to the kernels),
    # two runs of the step give bit-identical gradients; every call of the two kernels that met
    # bit-identical inputs in both runs must have given bit-identical outputs
    det_runs = []
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    reset_launches(A, Cv, Gn)
    try:
        for _ in range(2):
            record = []
            with split_backward(A, []), record_bits(torch, Cv, Gn, record):
                _, grads = ae_fwd_bwd()
            det_runs.append((record, grads))
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    torch.cuda.synchronize()
    det_launches = read_launches(A, Cv, Gn)
    (rec_a, ae_grads_a), (rec_b, ae_grads_b) = det_runs
    same_in = [i for i, (a, b) in enumerate(zip(rec_a, rec_b)) if a[:2] == b[:2]]
    same_out = [i for i in same_in if rec_a[i][2] == rec_b[i][2]]
    ae_equal = [n for n in ae_grads_a if not torch.equal(ae_grads_a[n], ae_grads_b[n])]
    print(f"ae parity: split attention backward, launches of two runs {json.dumps(det_launches)}; of "
          f"{len(rec_a)} conv3x3_wgrad and group_norm calls {len(same_in)} met bit-identical inputs in both runs and "
          f"{len(same_out)} of them gave bit-identical outputs; "
          f"{len(ae_grads_a) - len(ae_equal)} of {len(ae_grads_a)} gradient leaves bit-identical")
    if (det_launches["flash_bwd_dq"], det_launches["flash_bwd_dkv"], det_launches["flash_bwd_fused"]) != (
        2 * AE_FLASH, 2 * AE_FLASH, 0
    ) or det_launches["conv3x3_wgrad"] != 2 * AE_CONVS or not len(rec_a) == len(rec_b) == AE_CONVS + GN_PER_AE_FORWARD:
        return fail(f"ae split backward launches {det_launches}")
    if len(same_out) != len(same_in) or not same_in:
        return fail("conv3x3_wgrad or group_norm gave different outputs on bit-identical inputs")
    if ae_equal:
        return fail(f"ae gradients are not bit-reproducible with the split backward, e.g. {ae_equal[:3]}")
    del det_runs, rec_a, rec_b
    del ae_grads_a, ae_grads_b
    print(f"ae parity: done at {time.perf_counter() - t_start:.0f} s")
    del ae, multi, core, images, images_b, z_noise
    torch.cuda.empty_cache()

    # 9. ldm path: SD-1.5 finetuned on images, the frozen first stage encoding them in each step
    t0 = time.perf_counter()
    sd = cflearn_torch.build_sd("v1", device="cuda", dtype=torch.float32, seed=0)
    sd.condition_model = None  # the condition is a precomputed 77x768 embedding
    redraw_zero_init(sd, seed=1)
    torch.cuda.synchronize()
    print(f"ldm: built SD-1.5 v1 with its first stage, f32 masters, text tower dropped, in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(5)
    ldm_images = torch.rand((TRAIN_BATCH, 512, 512, 3), generator=gen, device="cuda") * 2.0 - 1.0
    ldm_ctx = torch.randn((TRAIN_BATCH, 77, 768), generator=gen, device="cuda")
    ldm_kw = dict(lr=1e-5, compute_dtype=torch.bfloat16, generator=gen)
    first_stage = {n: p.detach().clone() for n, p in sd.first_stage.named_parameters()}
    unet_seen = []
    hook = sd.unet.register_forward_pre_hook(lambda mod, args: unet_seen.append(tuple(args[0].shape)))
    ldm_checkpoint = False
    try:
        cflearn_torch.finetune_unet(sd, ldm_images, ldm_ctx, num_steps=1, use_checkpoint=False, **ldm_kw)  # warm-up
    except torch.cuda.OutOfMemoryError:
        ldm_checkpoint = True
    if ldm_checkpoint:  # as in phase 5, outside the handler so that the failed step's tensors are freed
        torch.cuda.empty_cache()
        cflearn_torch.finetune_unet(sd, ldm_images, ldm_ctx, num_steps=1, use_checkpoint=True, **ldm_kw)
    torch.cuda.synchronize()
    unet_before = {n: p.detach().clone() for n, p in sd.unet.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    reset_launches(A, Cv, Gn)
    unet_seen.clear()
    t0 = time.perf_counter()
    result = cflearn_torch.finetune_unet(sd, ldm_images, ldm_ctx, num_steps=TRAIN_STEPS, use_checkpoint=ldm_checkpoint,
                                         **ldm_kw)
    torch.cuda.synchronize()
    ldm_wall = time.perf_counter() - t0
    ldm_launches = read_launches(A, Cv, Gn)
    ldm_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    hook.remove()
    ldm_losses = result["losses"].tolist()
    ldm_step_ms = ldm_wall / TRAIN_STEPS * 1e3
    print(f"ldm: {TRAIN_STEPS} steps at batch {TRAIN_BATCH} on 512x512 images, {ldm_step_ms:.1f} ms per step, "
          f"{TRAIN_BATCH / ldm_step_ms * 1e3:.2f} samples/s, peak memory {ldm_peak_gb:.2f} GiB, losses {ldm_losses}, "
          f"use_checkpoint={ldm_checkpoint}, launches {json.dumps(ldm_launches)}")
    twice = 2 if ldm_checkpoint else 1
    want = dict.fromkeys(ldm_launches, 0)
    want.update(flash_fwd_lse=FLASH_PER_UNET * TRAIN_STEPS * twice, flash_bwd_fused=FLASH_PER_UNET * TRAIN_STEPS,
                flash_attention=ENCODER_FLASH * TRAIN_STEPS, conv3x3=ENCODER_CONVS * TRAIN_STEPS,
                group_norm=(GN_PER_UNET * twice + GN_PER_ENCODE) * TRAIN_STEPS)
    if ldm_launches != want:
        return fail(f"ldm launches {ldm_launches} != {want}")
    if not all(math.isfinite(x) for x in ldm_losses):
        return fail(f"ldm: non-finite loss {ldm_losses}")
    if set(unet_seen) != {(TRAIN_BATCH, 64, 64, 4)}:
        return fail(f"ldm: the UNet saw {sorted(set(unet_seen))}, not 64x64x4 latents")
    changed = [n for n, p in sd.first_stage.named_parameters() if not torch.equal(p, first_stage[n])]
    still = [n for n, p in sd.unet.named_parameters() if torch.equal(p, unet_before[n])]
    grads = result["step"].grads
    bad = [n for n, g in grads.items() if not torch.isfinite(g).all() or not g.any()]
    print(f"ldm: UNet inputs {sorted(set(unet_seen))}; first stage: {len(changed)} of {len(first_stage)} parameters "
          f"changed; UNet: {len(still)} of {len(unet_before)} parameters unmoved, {len(bad)} of {len(grads)} gradients "
          f"non-finite or all-zero")
    if changed or still or bad:
        return fail(f"ldm: first stage changed {changed[:3]}, unmoved {still[:3]}, bad gradients {bad[:3]}")
    del unet_before, first_stage, result, grads
    torch.cuda.empty_cache()
    # the encode through the kernels against the plain versions, held to the plain path's drift under a
    # one-ulp move of the images (phase 4's measure); the encoder in bf16, as the step's compute cast runs it
    encoder = copy.deepcopy(sd.first_stage).to(torch.bfloat16)
    del sd
    torch.cuda.empty_cache()
    images_b16 = ldm_images.to(torch.bfloat16).float()

    def encode(x):
        return encoder.encode(x).mode().float()

    with torch.no_grad():
        lat_k = encode(images_b16)
        with plain_kernels(A, Cv, Gn):
            lat_p = encode(images_b16)
            drift_enc = rel_err(encode(bump_ulp(torch, images_b16)), lat_p)
    rel_enc = rel_err(lat_k, lat_p)
    tol_enc = PARITY_FACTOR * drift_enc
    print(f"ldm parity: encoded latents {tuple(lat_k.shape)}, kernels vs plain max rel err {rel_enc:.3e} (tolerance "
          f"{tol_enc:.3e}: {PARITY_FACTOR} x the plain path's drift under a one-ulp move of the images, {drift_enc:.3e})")
    if tuple(lat_k.shape) != (TRAIN_BATCH, 64, 64, 4) or not rel_enc <= tol_enc:
        return fail("the encode through the kernels disagrees with the plain path")
    ldm_out = {"step_ms": ldm_step_ms, "samples_per_s": TRAIN_BATCH / ldm_step_ms * 1e3, "batch": TRAIN_BATCH,
               "px": 512, "peak_memory_gib": ldm_peak_gb, "use_checkpoint": ldm_checkpoint, "losses": ldm_losses,
               "encode_parity": {"kernels_vs_plain": rel_enc, "drift": drift_enc}}
    del encoder, ldm_images, ldm_ctx, images_b16, lat_k, lat_p
    torch.cuda.empty_cache()
    print(f"ldm path: done at {time.perf_counter() - t_start:.0f} s")

    # 10. the ae path at the JAX package's defaults: LPIPS (random weights), the adaptive weight, the
    # default optimizer settings (Adam behind a warm-up x3 from lr / 3 over min(3e5 / 8, 10) steps)
    gen = torch.Generator(device="cuda").manual_seed(4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ae = cflearn_torch.build_ae(AE_DEFAULTS_CONFIG, device="cuda", seed=0)
    for w in caught:
        print(f"ae defaults: warning: {w.message}")
    images = torch.randn((AE_BATCH, 256, 256, 3), generator=gen, device="cuda").clamp(-1.0, 1.0)
    ae_kw = dict(compute_dtype=torch.bfloat16, generator=gen)
    cflearn_torch.train_autoencoder(ae, images, num_steps=1, **ae_kw)  # warm-up
    torch.cuda.synchronize()
    lpips_before = {n: p.detach().clone() for n, p in ae.perceptual.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    reset_launches(A, Cv, Gn)
    t0 = time.perf_counter()
    result = cflearn_torch.train_autoencoder(ae, images, num_steps=AE_STEPS, **ae_kw)
    torch.cuda.synchronize()
    aed_step_ms = (time.perf_counter() - t0) / AE_STEPS * 1e3
    aed_launches = read_launches(A, Cv, Gn)
    aed_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    aed_losses = [{k: v.item() for k, v in step_losses.items()} for step_losses in result["losses"]]
    aed_lrs = result["lrs"]
    weight = result["steps"]["core"].train_step.adaptive_weight
    weight = None if weight is None else weight.item()
    print(f"ae defaults: {AE_STEPS} steps, {aed_step_ms:.1f} ms per step, {AE_BATCH / aed_step_ms * 1e3:.2f} samples/s, "
          f"peak memory {aed_peak_gb:.2f} GiB, launches {json.dumps(aed_launches)}")
    print(f"ae defaults: losses {json.dumps(aed_losses)}; lrs {json.dumps(aed_lrs)}; adaptive weight {weight}")
    names = {"core_loss", "core_l1", "core_perceptual", "core_kl", "core_g", "discriminator_loss", "discriminator_d"}
    for step_losses in aed_losses:
        if set(step_losses) != names or not all(math.isfinite(v) for v in step_losses.values()):
            return fail(f"ae defaults losses {step_losses}")
    # the warm-up's lr at update k: (1e-3 / 3) (1 + 2 k / 10)
    want_lrs = [dict.fromkeys(("core", "discriminator"), 1e-3 / 3 * (1 + 2 * k / 10)) for k in range(AE_STEPS)]
    if len(aed_lrs) != AE_STEPS or any(set(got) != set(lr) or any(abs(got[s] - lr[s]) > 1e-12 * lr[s] for s in lr)
                                       for got, lr in zip(aed_lrs, want_lrs)):
        return fail(f"ae defaults: learning rates {aed_lrs} != the schedule's {want_lrs}")
    if weight is None or not 0.0 <= weight <= 0.5e4:
        return fail(f"ae defaults: adaptive weight {weight}")
    lpips_moved = [n for n, p in ae.perceptual.named_parameters() if not torch.equal(p, lpips_before[n])]
    want = {
        "conv3x3": 3 * AE_CONVS * AE_STEPS, "conv3x3_wgrad": AE_CONVS * AE_STEPS,
        "group_norm": 2 * GN_PER_AE_FORWARD * AE_STEPS, "flash_fwd_lse": AE_FLASH * AE_STEPS,
        "flash_bwd_fused": AE_FLASH * AE_STEPS, "flash_attention": AE_FLASH * AE_STEPS,
        "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "conv3x3_w8a8": 0, "quantize_w8a8": 0, "conv3x3_fold": 0,
    }
    if aed_launches != want or lpips_moved:
        return fail(f"ae defaults: launches {aed_launches} != {want}, LPIPS parameters moved {lpips_moved[:3]}")
    del result, lpips_before
    torch.cuda.empty_cache()
    # phase 8's loss and global-norm gates on this config's core step (its per-module gate stays on phase 8's config)
    multi = MultiScopeStep(ae, {scope: build_optimizer("adam", 1e-4) for scope in ("core", "discriminator")},
                           compute_dtype=torch.bfloat16)
    core = multi.steps["core"]
    core.train_step.step_actives = {"core": True, "discriminator": True}
    z_noise = torch.randn((AE_BATCH, 32, 32, 4), generator=gen, device="cuda")
    images_b = images.to(torch.bfloat16).float()

    def aed_fwd_bwd(x=images_b):
        losses = core.loss_and_grads({INPUT_KEY: x}, forward_kwargs={"noise": z_noise})
        grads, core.grads = core.grads, {}
        return losses[LOSS_KEY].item(), grads

    aed_par = ae_parity(torch, aed_fwd_bwd, images_b, A, Cv, Gn)
    print(f"ae defaults parity: loss kernels {aed_par['loss']['kernels']:.6f} plain {aed_par['loss']['plain']:.6f} "
          f"(tolerance {aed_par['loss']['tolerance']:.3e}); drift {json.dumps(aed_par['drift'])}; kernels vs plain "
          f"{json.dumps(aed_par['kernels_vs_plain'])} (tolerance {AE_PARITY_FACTOR} x the drift); per module, not "
          f"gated here: {json.dumps(aed_par['modules'])}")
    if not abs(aed_par["loss"]["kernels"] - aed_par["loss"]["plain"]) <= aed_par["loss"]["tolerance"]:
        return fail("ae defaults: the loss through the kernels disagrees with the plain path")
    if not aed_par["kernels_vs_plain"]["global_rel"] <= AE_PARITY_FACTOR * aed_par["drift"]["global_rel"]:
        return fail("ae defaults: gradients through the kernels disagree with the plain path (global norm)")
    aed_out = {"step_ms": aed_step_ms, "samples_per_s": AE_BATCH / aed_step_ms * 1e3, "batch": AE_BATCH, "px": 256,
               "peak_memory_gib": aed_peak_gb, "losses": aed_losses, "lrs": aed_lrs, "adaptive_weight": weight,
               "parity": {"drift": aed_par["drift"], "kernels_vs_plain": aed_par["kernels_vs_plain"],
                          "modules": aed_par["modules"]}}
    del ae, multi, core, aed_par, z_noise, images_b
    torch.cuda.empty_cache()
    print(f"ae defaults path: done at {time.perf_counter() - t_start:.0f} s")

    # 11. ae_vq path: the VQ autoencoder at phase 7's widths, 16384 codes
    vq = cflearn_torch.build_ae(AE_VQ_CONFIG, model="ae_vq", device="cuda", seed=0)
    cflearn_torch.train_autoencoder(vq, images, num_steps=1, **ae_kw)  # warm-up
    torch.cuda.synchronize()
    codes_before = vq.m.codebook.embedding.detach().clone()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(A, Cv, Gn)
    t0 = time.perf_counter()
    result = cflearn_torch.train_autoencoder(vq, images, num_steps=AE_STEPS, **ae_kw)
    torch.cuda.synchronize()
    vq_step_ms = (time.perf_counter() - t0) / AE_STEPS * 1e3
    vq_launches = read_launches(A, Cv, Gn)
    vq_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    vq_losses = [{k: v.item() for k, v in step_losses.items()} for step_losses in result["losses"]]
    names = {"core_loss", "core_l1", "core_vq", "core_g", "discriminator_loss", "discriminator_d"}
    codes_moved = int((vq.m.codebook.embedding.detach() != codes_before).any(dim=1).sum())
    # the codes of the images through the kernels and through the plain versions, in bf16 as the step computes
    encoder = copy.deepcopy(vq.m).to(torch.bfloat16)
    with torch.no_grad():
        idx_k = encoder.encode(images).indices
        with plain_kernels(A, Cv, Gn):
            idx_p = encoder.encode(images).indices
    agree = (idx_k == idx_p).float().mean().item()
    in_range = 0 <= int(idx_k.min()) and int(idx_k.max()) < AE_VQ_CONFIG["num_code"]
    print(f"ae_vq: {AE_STEPS} steps, {vq_step_ms:.1f} ms per step, {AE_BATCH / vq_step_ms * 1e3:.2f} samples/s, peak "
          f"memory {vq_peak_gb:.2f} GiB, launches {json.dumps(vq_launches)}; losses {json.dumps(vq_losses)}; "
          f"{codes_moved} of {AE_VQ_CONFIG['num_code']} codes moved; {len(torch.unique(idx_k))} distinct codes in "
          f"range: {in_range}; kernel and plain paths agree on {agree:.2%} of the indices (printed, not gated: "
          f"argmin ties in bf16)")
    for step_losses in vq_losses:
        if set(step_losses) != names or not all(math.isfinite(v) for v in step_losses.values()):
            return fail(f"ae_vq losses {step_losses}")
    if vq_launches != want:
        return fail(f"ae_vq launches {vq_launches} != {want}")
    if not in_range or not codes_moved:
        return fail(f"ae_vq: indices in range {in_range}, codes moved {codes_moved}")
    vq_out = {"step_ms": vq_step_ms, "samples_per_s": AE_BATCH / vq_step_ms * 1e3, "batch": AE_BATCH, "px": 256,
              "peak_memory_gib": vq_peak_gb, "losses": vq_losses, "codes_moved": codes_moved,
              "index_agreement": agree}
    del vq, encoder, result, images, idx_k, idx_p
    torch.cuda.empty_cache()
    print(f"ae_vq path: done at {time.perf_counter() - t_start:.0f} s")

    # 12. the DiffusionAPI path
    api_out = phase_diffusion_api(torch, np, cflearn_torch, A, Cv, Gn)
    print(f"diffusion api path: done at {time.perf_counter() - t_start:.0f} s")

    # 13. the VQ latent-diffusion family through DiffusionAPI
    vq_api_out = phase_vq_api(torch, np, F, cflearn_torch, A, Cv, Gn)
    print(f"vq api path: done at {time.perf_counter() - t_start:.0f} s")

    # 14. summary
    src = "cflearn_torch/csrc/"
    tpu = "cflearn_tpu/ops/"
    # name: (source, TPU kernel); launches come from the run of the kernel's main path
    info = {
        "flash_attention": (src + "flash_attention.cu", tpu + "attention.py:35"),
        "conv3x3": (src + "conv3x3.cu", tpu + "conv.py:52"),
        "flash_fwd_lse": (src + "flash_fwd_lse.cu", tpu + "attention.py:196"),
        "flash_bwd_fused": (src + "flash_bwd_fused.cu", tpu + "attention.py:340"),
        "flash_bwd_dq": (src + "flash_bwd_dq.cu", tpu + "attention.py:247"),
        "flash_bwd_dkv": (src + "flash_bwd_dkv.cu", tpu + "attention.py:290"),
        "conv3x3_wgrad": (src + "conv3x3_wgrad.cu", tpu + "conv.py:304"),
        "group_norm": (src + "group_norm.cu", tpu + "group_norm.py:24"),
        "conv3x3_w8a8": (src + "conv3x3_w8a8.cu", tpu + "conv.py:74"),
        # the JAX package quantises in XLA, outside its Pallas kernel: no TPU kernel of its own
        "quantize_w8a8": (src + "quantize_w8a8.cu", tpu + "conv.py:263-267 (XLA, no Pallas kernel)"),
        "conv3x3_fold": (src + "conv3x3_fold.cu", tpu + "conv.py:96"),
    }
    path_launches = {"txt2img": launches, "finetune": train_launches, "ae": ae_launches, "w8a8": w8a8_launches,
                     "fold": fold_launches, "faithful": serve_out["faithful"]["launches"],
                     "accelerated": serve_out["accelerated"]["launches"], "ldm": ldm_launches,
                     "ae_defaults": aed_launches, "ae_vq": vq_launches}
    path_unit = {"txt2img": "one txt2img", "finetune": "one finetune step", "ae": "one autoencoder train step",
                 "w8a8": "one W8A8 VAE decode", "fold": "one dj-folded VAE decode",
                 "faithful": "one faithful txt2img", "accelerated": "one accelerated txt2img",
                 "ldm": "one finetune step on 512px images", "ae_defaults": "one autoencoder train step at the defaults",
                 "ae_vq": "one ae_vq train step"}
    path_run = dict(path_unit, finetune=f"{TRAIN_STEPS} finetune steps", ae=f"{AE_STEPS} autoencoder train steps",
                    ldm=f"{TRAIN_STEPS} finetune steps on 512px images",
                    ae_defaults=f"{AE_STEPS} autoencoder train steps at the defaults", ae_vq=f"{AE_STEPS} ae_vq train steps")
    # the new paths run the UNet step's and the autoencoder step's shapes too: their rows count for them where the
    # path launched the kernel (the ldm step adds the encoder's rows of its own)
    for name, cases in rows.items():
        for r in cases:
            for path, same in (("ldm", "finetune"), ("ae_defaults", "ae"), ("ae_vq", "ae")):
                if r["per"].get(same, 0) > 0 and path_launches[path][name] > 0:
                    r["per"][path] = r["per"][same]
    kernels = []
    for name, cases in rows.items():
        source, replaces = info[name]

        def totals(path: str, cases=cases) -> dict:
            on_path = [r for r in cases if r["per"].get(path, 0) > 0]
            out = {key: sum(r[key] * r["per"][path] for r in on_path) for key in ("ms", "device_ms", "plain_ms", "bound_ms")}
            # the yardsticks in the same run: the previous designs (the mma.sync kernels, GroupNorm's three
            # launches) and SDPA's device time
            for key in ("mma_sync_ms", "mma_sync_device_ms", "library_device_ms", "slabs_ms", "slabs_device_ms"):
                if all(key in r for r in on_path):
                    out[key] = sum(r[key] * r["per"][path] for r in on_path)
            # no single PyTorch call computes W8A8: its rows carry the unquantised convs' times instead
            out["library_ms"] = None if any(r["library_ms"] is None for r in on_path) else sum(
                r["library_ms"] * r["per"][path] for r in on_path)
            for key in ("unquantised_cudnn_bf16_ms", "unquantised_conv3x3_kernel_ms", "route_ms", "route_device_ms",
                        "plain_device_ms"):
                if key in on_path[0]:
                    out[key] = sum(r[key] * r["per"][path] for r in on_path)
            out["bound_by"] = max(on_path, key=lambda r: r["bound_ms"] * r["per"][path])["bound_by"]
            # the split kernels run where the deterministic backward is chosen: the train parity phase
            split = name in ("flash_bwd_dq", "flash_bwd_dkv")
            out["launches"] = split_launches[name] if split and path == "finetune" else path_launches[path][name]
            out["launches_of"] = "one finetune forward + backward with the split backward" if split and path == "finetune" else path_run[path]
            out["per"] = f"the times are of {path_unit[path]}: each of its shapes' time times its launches in it"
            if name in REDESIGNED or name == "quantize_w8a8":
                out["bound_share"] = out["bound_ms"] / out["ms"]
            return out

        paths = sorted({p for r in cases for p, n in r["per"].items() if n > 0})
        main_path = MAIN_PATH[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, path=main_path,
            max_abs_err=max(r["max_abs_err"] for r in cases), **totals(main_path),
            other_paths={p: totals(p) for p in paths if p != main_path},
        ))
    serve = {"img_per_s": 1.0 / wall, "steps": steps, "batch": 1, "px": 512}
    train = {"finetune_steps_per_s": 1e3 / step_ms, "samples_per_s": TRAIN_BATCH / step_ms * 1e3,
             "step_ms": step_ms, "batch": TRAIN_BATCH, "use_checkpoint": use_checkpoint,
             "peak_memory_gib": peak_gb}
    ae_out = {"ae_steps_per_s": 1e3 / ae_step_ms, "samples_per_s": AE_BATCH / ae_step_ms * 1e3, "step_ms": ae_step_ms,
              "batch": AE_BATCH, "px": 256, "peak_memory_gib": ae_peak_gb, "losses": ae_losses,
              "seconds_total": time.perf_counter() - t_start}
    ae_out["seconds_total"] = time.perf_counter() - t_start
    # the per-shape rows printed above, once more in one file beside the checkout
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": card_line(), "kernels": kernels, "shapes": rows, "txt2img": serve, "finetune": train,
                   "autoencoder": ae_out, "serve_configs": serve_out,
                   "serve_parity": {"unet": rel_unet, "unet_drift": drift_unet, "vae": rel_vae, "vae_drift": drift_vae},
                   "ldm": ldm_out, "ae_defaults": aed_out, "ae_vq": vq_out, "diffusion_api": api_out,
                   "vq_api": vq_api_out,
                   "train_parity": {"drift": drift, "kernels_vs_plain": err_k, "fused_vs_split": err_s},
                   "ae_parity": {"drift": ae_drift, "kernels_vs_plain": ae_err, "modules": ae_modules,
                                 "module_drift_and_error": ae_mod_table}}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serve_configs": serve_out}))
    print(json.dumps(serve))
    print(json.dumps(train))
    print(json.dumps(ae_out))
    print(json.dumps({"ldm": ldm_out, "ae_defaults": aed_out, "ae_vq": vq_out}))
    print(json.dumps({"diffusion_api": api_out}))
    print(json.dumps({"vq_api": {k: v for k, v in vq_api_out.items() if k != "calls"}}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
