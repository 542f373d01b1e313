#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (`cflearn_torch`) on one CUDA card.

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure exits non-zero:

1. build — compile every CUDA kernel from `cflearn_torch/csrc/` (one `nvcc`
   per source, all at once) and print the seconds.
2. kernels — hold each kernel against its plain PyTorch version: the
   forward and the conv at every shape SD-1.5 512px txt2img gives them, the
   forward-with-logsumexp and the three backward kernels at the three shapes
   of the UNet finetune step (batch 8) and of the SD v2 step (phase 18:
   batch 4, 64 channels a head, L 9216 / 2304 / 576), plus ragged, causal,
   f32, d = 640 and odd-width cases; the conv forward, its dx (the forward kernel on dy with
   flipped weights) and the weight-gradient kernel at every shape the
   autoencoder step routes; GroupNorm with and without SiLU at the UNet's, the
   VAE decoder's and the autoencoder step's shapes, plus f32 and odd group
   widths; the conv forward, GroupNorm and the flash forward at the
   first-stage encoder's shapes of the ldm path (batch 8, 512px); the d = 512
   forward (the wide-head wgmma + TMA kernel) also at the f4 VQ decoder's
   L = 16384 and at ragged and causal cases, each with its logsumexp held
   against the plain forward's; the forward at the ViT-S/16 classifier's
   384 px shape (phase 19: B64 H6 L577 d256, f32 and bf16) and the
   forward-with-logsumexp and backward kernels at its training step's
   (B32, f32 and bf16), the tabular transformer's (phase 21: B128 H8 L785
   d16, f32), and DPT-Large's (phase 23: B1 H16 L1025 d64, f32, with a
   `yardstick` line). Prints max_abs_err and the kernel's, the
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
14. CLIP and ESRGAN — the zoo's ViT-B/32, ViT-L/14 and ViT-H/14 (`clip`,
   `clip_large`, `open_clip_ViT_H_14`, f32 from seed 0) through
   `CLIPExtractor(use_bf16=True)` as its users run it: f32 images against
   bf16 weights, so f32 compute, every /14 self-attention (L 257) on the
   flash kernel's f32 route. `get_image_latent` on 64 uint8 224px images
   (one chunk), `get_text_latent` on 8 prompts, `zero_shot_classify`,
   `clip_score_from_embeddings`; then the /14 modules (as the API cast
   them, bf16 parameters) on bf16 images straight into `encode_image`: the
   wgmma route. Each run under the census, then with the counters at 0:
   exact launches (0 for B/32 and for text, 24 a chunk for L/14, 32 for
   H/14); finite embeddings of unit norm (1e-5; the bf16 text embeddings
   within 2^-7); the score in [0, 100]; every distinct kernel call of the
   census against its plain version with phase 2's tolerances, timed
   alone beside SDPA, with its bound; the /14 image embeddings through the
   kernels against the plain path within 1.5x its one-ulp drift (phase 4's
   rule) in both dtypes; image- and text-embeds/s on the host clock (the
   best of two windows of 5 chunks). ESRGAN: `TranslatorAPI.from_esr` (23
   blocks) and `from_esr_anime` (6), bf16 weights, `sr` on a 128px RGB and
   a 128px RGBA uint8 image: 512px uint8 outputs with 3 and 4 channels, the
   network's f32 output finite, no hand-written kernel launched (the JAX
   package routes none), img/s; `offload` frees the parameters' device
   memory, `restore` takes it back, and the output after them is the same
   bit for bit.
15. checkpoint policies — the full-width UNet finetune step (phase 5's
   inputs, batch 8) through `finetune_unet(use_checkpoint=...)` under False,
   True and the `jax.checkpoint_policies` names `nothing_saveable`,
   `dots_saveable`, `dots_with_no_batch_dims_saveable` and
   `everything_saveable`: the first step's loss and gradients against the
   unchecked step within phase 8's loss and global-norm gates; one warm-up
   and three timed steps each, exact launches (each checkpointed block's
   flash forward and GroupNorms twice, unless the policy keeps the kernels'
   outputs: `everything_saveable`), ms per step and peak memory (printed);
   the same at batch 16 for True, `dots_saveable` and False (printed; an
   out-of-memory is reported).
16. style reference and tiling — `DiffusionAPI.from_sd("v1")`, bf16, batch
   1, 512px, DDIM 20 steps, CFG 7.5: `setup_hooks(style_reference_image=`
   a seeded 512px uint8 image`)` then `txt2img` at fidelity 0.5 and
   reference weight 1, then at weight 0.5 with a guidance interval (0.25,
   0.75); `setup_hooks()` clearing it (phase 12's DDIM launches);
   `switch_circular(True)` then `txt2img` (the decoder's three routed
   upsample convs on `F.conv2d`), and `switch_circular(False)` giving back
   the never-switched image bit for bit. Each path under the census, then
   timed: exact launches (each step's WRITE and READ passes, the reference's
   encode), UNet calls and batches, finite latents, ms per image. Every
   distinct kernel call of the census, the three kv = 2q flash shapes of
   the READ pass included, against its plain version with phase 2's
   tolerances, timed alone beside SDPA with its bound; one READ-mode denoise
   and one circular decode against the plain path within 1.5x its one-ulp
   drift (phase 4's rule).
17. SD v2 — `DiffusionAPI.from_sd("v2_v")` (the 768-v model, bf16, seeded
   random weights, zero-initialised convs redrawn), batch 1, CFG 7.5, 20
   steps: txt2img at 768x768 by DDIM and by `k_euler`; `from_sd("v2_base")`
   at 512x512 by DDIM. Each path under the census, then timed twice (the
   best kept): exact launches (15 routed self-attentions a UNet call at 64
   channels a head, 5 / 10 / 20 heads; 61 GroupNorms; the decoder's 21
   routed convs at 96x96 latents, 31 at 64x64), 20 UNet calls at the CFG
   batch, finite latents, a uint8 image of the size asked. Every distinct
   kernel call of the census (flash at L 9216 / 2304 / 576 and the decoder's
   d = 512 at L 9216; GroupNorm and the conv at 768^2) against its plain
   version with phase 2's tolerances, timed alone beside SDPA / cuDNN with
   its bound; one v-prediction UNet call at 96x96 latents and one 768^2
   decode against the plain path within 1.5x its one-ulp drift (phase 4's
   rule).
18. v2_v finetune through the model core — `IDLModel.from_config(DLConfig(
   model="ddpm", module_name="sd", module_config={"version": "v2_v",
   "with_first_stage": False}))`, f32 masters, bf16 compute, AdamW 1e-5, on
   96x96x4 latents at batch 4 with a 77x1024 condition, the v target: the
   first step's loss and gradients against the plain path within phase 8's
   loss and global-norm gates; `finetune_unet` on the model, one warm-up and
   three timed steps: exact launches of the forward with the logsumexp, the
   fused backward and GroupNorm, every trained parameter moved, ms per step
   and peak memory (an out-of-memory fails). Phase 2 holds the step's
   attention kernels at its three shapes.
19. CV models through the model core — `IDLModel.from_config` at the JAX
   modules' defaults, f32, seeded random weights, `MultiScopeStep` with Adam
   1e-4: "gan" (vanilla, wgangp with its gradient penalty, conditional on 10
   classes), "vae" and conditional "vae", "vq_vae" (512 codes of 128), all
   at 64 px and batch 64, then "ar" (PixelCNN over the VQ-VAE's 8x8 code
   maps of the images) and one `sample` of 16 maps; "clf" with the ViT-S/16
   encoder (latent 384, 6 heads of 256, 1000 classes) at 224 px (197
   tokens: SDPA) and 384 px (577 tokens: rows 1, 3, 4), classifying 64
   images and training at batch 32. Each: one warm-up step and two windows
   of three (ms a step, the best window, host clock), peak memory, finite
   losses, every trained parameter moved, exact launches (none but the
   384 px ViT's 12 flash forwards a classify, 12 forwards with the
   logsumexp and 12 fused backwards a step, counted by the census in the
   classify), and one forward + backward of the first scope through the
   kernels against the plain path within TRAIN_PARITY_FACTOR x its drift
   under a one-ulp move of the input (the images; the GAN's z; PixelCNN's
   first masked conv weight). About 10 s.
20. framework — `cflearn_torch.fit_array` on the ViT-S/16 at 384 px (f32, 128
   training and 64 validation images from a seed, batch 32, "acc" on the
   validation set every 2 steps, 8 steps at the `Trainer`'s defaults: top-k
   checkpoints, the rollback, the final evaluation), then `save`,
   `load_inference`, `predict` and `evaluate` on the 64 validation images:
   finite losses, every trained parameter moved, `scores.json` and its
   checkpoints on disk, the model after the fit bit for bit its best
   checkpoint, the loaded pipeline's predictions bit for bit the trained
   one's, exact launches (12 `flash_fwd_lse` and 12 `flash_bwd_fused` a
   step, 12 `flash_attention` a 64-image evaluation or predict batch,
   counted from the run's steps and batches), and the first step's loss
   and gradients through the kernels against the plain path (phase 19's
   rule); ms a step through the `Trainer` beside phase 19's bare step,
   the evaluation pass's ms, peak memory. Then `ae_kl` through
   `fit_array` at phase 7's workload (256 px, batch 8, bf16 compute, 3
   steps): phase 7's launches a step, exactly.
21. tabular — `cflearn_torch.fit_ml` as its users call it, at the JAX
   package's defaults: (a) `MLConfig(module_name="fcnn")` (hidden [64, 64],
   BatchNorm, batch 128) on a table of UCI Covertype's raw shape made from a
   seed (581,012 rows: 10 float columns with 1% NaN cells, a 4-value and a
   40-value string column, 7 classes), 150 steps with a monitor every 50 (the
   last 50 traced by `torch.profiler` for the device's idle share), `save`,
   `load_inference`, `predict`, `evaluate`: the two string columns
   recognised categorical and encoded by "ml.common", finite losses, every
   trained parameter moved, no kernel launched, the loaded predictions bit
   for bit, the first step's loss and gradients against the plain path
   (phase 19's rule); the block stack's host seconds by block, ms a step
   through the `Trainer`, each monitor's ms with its evaluation pass's and
   its checkpoint write's, predict rows/s. (b) the "transformer" at its
   defaults (4 layers, 8 heads of 16, f32) on MNIST's shape (70,000 rows of
   784 columns, 10 classes; 785 tokens), 12 steps with a monitor every 4
   (the last 4 traced by `torch.profiler` for the flash kernels' share of a
   step): exact launches (4 `flash_fwd_lse`
   and 4 `flash_bwd_fused` a step, 4 `flash_attention` an evaluation or
   predict batch), each distinct forward call of the fit's census against
   its plain version and timed beside SDPA with its bound (phase 2 holds the
   train step's shape, `tab785_f32`), the first step's parity against the
   plain f32 path (phase 19's rule), the loaded predictions bit for bit.
22. the rest of the framework — `prepare_image_folder` packs 512 seeded
   JPEGs (400-480 px, 10 classes) at 384 px into rcache stores built from the
   port's own source; three ViT-S/16 "clf" members train from the packed
   folder through `ImageFolderData`, the normalize blocks and
   `DLTrainingPipeline.fit` (batch 32, 16 steps, `ImageClassificationCallback`
   writing its grids), exact launches; `fuse_inference` over their folders
   predicts the members' mean bit for bit and `fuse_evaluation` scores it;
   member 0 and phase 20's `ae_kl` (bf16, posterior mode) through
   `export_model` / `load_exported` on the card (the program's kernel
   operation nodes equal to the eager forward's launches, one call launching
   them, outputs bit for bit) and `aot_compile` (CUDA-graph replays bit for
   bit, launches = captures x replays); `GeneralEvaluationPipeline` over a
   predictor of member 0 scoring what its `evaluate` scores; `VQVAEInference`
   over a 64 px `vq_vae` (the code export, a PixelCNN prior, samples, no
   kernel). Prints the prepare's seconds, ms a step, each write's and
   callback's ms, the fused predict's rows/s beside a member's, the exports'
   trace seconds and the eager, exported and captured forwards' device ms.
23. the ControlNet annotators and `compile` — a seeded DPT-Large
   checkpoint in the upstream layout through `Annotator.make("depth",
   {"ckpt": ...})` on a 512² image: 24 flash launches a forward (B1 H16
   L1025 d64 f32, phase 2's `dpt_large_f32` row), the forward held to the
   plain route within PARITY_FACTOR x its f32 drift (a one-f32-ulp move of
   the image, or the library's f32 attention in place of the plain one,
   whichever moves it more); HED, PiDiNet,
   M-LSD and OpenPose (body, hand) seeded at full width on the card against
   the same nets on the CPU, each annotator's host ms an image, whether cv2
   imports; `get_hint_of("depth")` feeding `sample_with_control` on SD-1.5
   with one full-width ControlNet at 512², 20 steps, exact launches (the
   controlled path's plus 24); `DiffusionAPI.compile` at 512², batch 1, 20
   steps in the lossless, faithful and accelerated configurations: the
   compiled txt2img bit for bit the eager one, launches = the counters' plus
   the graphs' captures x replays = the eager run's, host ms an image eager
   and compiled, and each one's device idle share; and with phase 16's
   style reference set: one graph a UNet call (its WRITE pass, the bank and
   its READ pass, the reference's noise drawn inside from the registered
   generator), the image bit for bit the eager one, its flash launches a
   replay `style_flash_per_step` and its replays the steps, only the
   reference's encode and the decode outside the graph.
24. pretrained weights from the cache — under a temporary `OPT.cache_dir`
   (inside the checkout; the free space printed first, too little is a
   failure), with every fetch refused: a seeded SD-1.5 written as a 4.3 GB
   f32 `.safetensors` in the upstream layout under `sd_v1.5`'s file name,
   `DiffusionAPI.from_sd("v1", pretrained=True)` (bf16; the first use pins
   its sha) with every parameter bit for bit its source cast to bf16,
   txt2img at 512², batch 1, 20 DDIM steps, CFG 7.5 with phase 12's launches
   and the image bit for bit that of the same weights given by
   `load_state_dict`, a second load from the converted cache; an f16
   ControlNet under `control_v11f1p_sd15_depth.pth` refused by the entry's
   `min_size`, the f32 one (1.45 GB) through `load_control_net("depth",
   pretrained=True)` bit for bit and `sample_with_control` with phase 12's
   launches; one changed byte refused against its pin; the same SD-1.5 file
   through the converter script (`scripts.sd.convert` -> `inject` into an API
   built from other weights -> txt2img): phase 12's launches and the image bit
   for bit the pretrained load's. Prints whether
   `import safetensors` works, and the host seconds and GB/s of the sha,
   the read, the convert, the move to the card, the converted cache's write
   and a load from it. The files are removed.
25. the mesh on one card — a one-rank NCCL group (`torch.distributed`,
   `parallel.mesh.maybe_initialize_distributed`) and its mesh: the SD-1.5
   UNet finetune step (phase 15's batch 8) through `Trainer.fit` with
   `shard_optimizer_states=True` under `remat` False, True and
   "dots_saveable", its first step's loss and gradients (fed the reference
   step's t and noise) against the unchecked step within phase 15's gates,
   then three steps through the Trainer's step with exact launches (15 flash
   forwards with lse a step, 30 with `remat`), ms per step, the step's peak
   memory and the peak of its forward + backward alone;
   `DiffusionAPI.use_mesh` txt2img bit for bit the unmeshed image with phase
   12's launches; the ring of `ops.ring_attention`, its ranks run in turn
   in one process through the library's `ring_forward` / `ring_backward`
   (`OneProcessRing` hands each rank its blocks and sums dk / dv for their
   owners), at SD-1.5's 64² self-attention (B 8, H 8, L 4096, d 40,
   bf16), cp 2 and 4, causal and not, forward and backward, against rows 3
   and 4 over the whole sequence and the plain ring, each sequence position
   held to its own gate (a dropped block must fail it), with exact launches
   (cp² blocks of each row, cp(cp + 1)/2 with causal masking) and device ms
   beside the whole-sequence kernels'.
26. the public surface — (a) each kernel of the `kernels` line launched from
   the main thread, from a new `threading.Thread` after it and from two
   threads at once (`thread_launches`), each result against its plain version
   with phase 2's tolerance, the launches counted exactly; (b) phase 12's
   txt2img as two requests on a two-worker `ThreadPoolExecutor`, each image
   bit for bit the same request served from the main thread; (c) the zoo's
   `diffusion/ddpm` preset at its published width (64 px, 128 channels, bf16,
   seeded): one UNet call's launches exact (5 flash calls, B16 H4 L256 d64,
   and 51 GroupNorms) and within 1.5x the plain path's one-ulp drift, each
   distinct kernel call against its plain version and timed beside the
   library call, `sample(16, num_steps=20)`'s launches, ms and peak memory; (d) `repeat_ml` of the tabular
   "transformer" on phase 21's MNIST-shaped table (8,192 rows), two tasks as
   processes on the card, each task's pipeline against the same config
   fitted in this process, then `run_multiple(is_fix=True)` after one task's
   pipeline is removed: that task alone, on the card.
27. the last modules — at the JAX package's defaults, seeded random
   weights: `zoo.chinese_clip()` (ViT-L/14 at 224 px, a 24-layer BERT)
   through `CLIPExtractor`, which picks `ChineseCLIPTokenizer`: 8 images in
   f32, under `use_bf16` and as bf16 images, exactly 24 flash launches a
   batch (B8 H16 L257 d64), 8 Chinese texts with none, the image
   embeddings within PARITY_FACTOR x the plain path's drift (phase 23's
   rule in f32, a one-bf16-ulp move in bf16); `BLIPCaptioner` (ViT-B/16 at
   384 px, 12 + 12 layers) through `generate_caption_tokens` to 30 ids from
   [DEC] "a picture of", exactly 12 flash launches (B1 H12 L577 d64), the
   vision features against the plain path, the decoder's logits over the
   plain path's ids against the CPU's (NET_REL), the greedy ids agreeing
   with the CPU's (printed), `caption` raising without a tokenizer; the
   GPT-2 sampler at distilgpt2's width and the `PromptConfig` defaults, 4
   sequences, `top_k=1`, ids equal to the CPU's; LaMa (`inpaint` at 512²),
   ISNet (`segment` at 1024 on a 768 x 1024 image) and iharm (`run` on 300 x
   200) from seeded upstream-layout checkpoints through the zoo's strict
   converters, each against the same API on the CPU (NET_REL; iharm's uint8
   within one level) and its net in f64 against the CPU's f64 (NET_REL; the
   f32 outputs' errors against f64 printed), no kernel launched; where `transformers` has the vocabularies cached, `caption` and
   `enhance` run whole; host ms a batch, caption, sequence and image, each
   distinct flash call against its plain version and timed.
28. summary — a `{"kernels": [...]}` line (eleven kernels: the ten that
   replace a TPU kernel and the W8A8 quantiser), the paths' img/s
   and samples/s, the serving configurations' img/s on a line of their own,
   the new training paths' readings on a line of their own, the DiffusionAPI
   path's, the VQ family's, the CLIP and ESRGAN, the checkpoint policies',
   the style and tiling, the SD v2 and v2 finetune, the CV models', the
   framework's, the tabular, the rest of the framework's, the
   annotators and compile, the pretrained loads', the mesh's, the public
   surface's and the last modules' readings on lines of their own (each kernel's threaded checks on
   the `kernels` line), the card's name and power limit, and last `{"ok":
   true, "device": {...}}`. The per-shape rows also go to
   `chiprun_out/chip_smoke.json`.

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
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 rate
# the fastest f32-accurate product on the card: three TF32 products a multiply-add (3xTF32), what the f32 flash
# kernels run (`csrc/mma_common.cuh`)
PEAK_F32_FLOPS = PEAK_TF32_FLOPS / 3
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
# f32 inputs: the limit from when the kernels' products rounded their operands
# to TF32 (~1e-3 of the result over a d-long dot product of N(0, 1) values),
# 2^-8 of max|ref|; with 3xTF32 the error is at f32 level, far inside it
# (`tests/test_torch_cuda.py` holds the product to f32 level itself).
FLASH_REL_TF32 = 2.0**-8
# lse = m + log l in f32 from both: bf16 products are exact in f32, so only
# the summation order differs; f32's limit dates from the TF32 products, which rounded the scores (|s| up to
# ~5) by 2^-11.
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
V2_TRAIN_BATCH = 4  # the v2_v finetune step's batch (phase 18)
# phase 19: the CV models at the JAX modules' defaults (64 px, latent 128; 512 codes of 128), f32
CV_BATCH = 64  # the GAN / VAE / VQ-VAE / PixelCNN steps and the ViT classifier's classify batch
CV_STEPS = 3  # timed steps a window; two windows, the best kept
VIT_TRAIN_BATCH = 32  # the ViT-S/16 training steps at 384 px
VIT_LAYERS = 12  # ViT-S/16: one routed self-attention a layer at 384 px (577 tokens), none at 224 px (197)
VIT_HEADS, VIT_DIM = 6, 256  # the JAX package's ViT: 6 heads over 4 x 384 = 1536 channels
VIT_TOKENS = {224: 197, 384: 577}
PIXEL_CNN_SAMPLES = 16

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
    # the ViT-S/16 classifier at 384 px (phase 19): 577 tokens, 6 heads of 256, classifying 64 images; f32 as the
    # JAX default runs it (the mma.sync chunked kernel), bf16 on the wgmma + TMA kernel at its widest head
    ("vit384_f32", CV_BATCH, VIT_HEADS, 577, 577, VIT_DIM, False, "float32", lambda s: 0),
    ("vit384_bf16", CV_BATCH, VIT_HEADS, 577, 577, VIT_DIM, False, "bfloat16", lambda s: 0),
    # the tabular transformer at its defaults on MNIST's 784 columns (phase 21): 785 tokens, 8 heads of 16, f32,
    # predicting a batch of 128
    ("tab785_f32", 128, 8, 785, 785, 16, False, "float32", lambda s: 0),
    # DPT-Large's self-attention on a 512x512 depth hint (phase 23): 1025 tokens, 16 heads of 64, f32, 24 a forward
    ("dpt_large_f32", 1, 16, 1025, 1025, 64, False, "float32", lambda s: 0),
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
    # the SD v2 UNet's self-attentions at 96x96 latents, 64 channels a head (5 calls a v2_v finetune step each)
    ("v2_96x96", V2_TRAIN_BATCH, 5, 9216, 9216, 64, False, "bfloat16", 0),
    ("v2_48x48", V2_TRAIN_BATCH, 10, 2304, 2304, 64, False, "bfloat16", 0),
    ("v2_24x24", V2_TRAIN_BATCH, 20, 576, 576, 64, False, "bfloat16", 0),
    # the ViT-S/16 training step at 384 px, batch 32 (phase 19: 12 calls a step each), f32 and bf16
    ("vit384_f32", VIT_TRAIN_BATCH, VIT_HEADS, 577, 577, VIT_DIM, False, "float32", 0),
    ("vit384_bf16", VIT_TRAIN_BATCH, VIT_HEADS, 577, 577, VIT_DIM, False, "bfloat16", 0),
    # the tabular transformer's train step at batch 128 (phase 21: 4 calls a step each)
    ("tab785_f32", 128, 8, 785, 785, 16, False, "float32", 0),
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
        peak = PEAK_BF16_FLOPS if q.element_size() == 2 else PEAK_F32_FLOPS
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
        peak = PEAK_BF16_FLOPS if size == 2 else PEAK_F32_FLOPS
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


def serving(unets, encodes=0, controls=0):
    """The launches of one SD-1.5 sampling path: `unets` UNet calls (each with `controls` ControlNets), the decode,
    and `encodes` first-stage encodes."""
    return {"flash_attention": (FLASH_PER_UNET + FLASH_PER_CONTROL * controls) * unets + 1 + ENCODER_FLASH * encodes,
            "conv3x3": DECODER_CONVS + ENCODER_CONVS * encodes,
            "group_norm": (GN_PER_UNET + GN_PER_CONTROL * controls) * unets + GN_PER_DECODE + GN_PER_ENCODE * encodes}


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


def check_call(torch, F, A, Cv, Gn, key, gen, host_ms: bool = False) -> dict:
    """One distinct serving-kernel call of the census, on random inputs of its shapes: the kernel against its plain
    version (phase 2's tolerances), its device ms (CUDA-graph replay), its plain version's ms, the library call's
    device ms and the bound; with `host_ms` also the kernel's and the library call's ms on the host clock (`ms`,
    `library_ms`), as phase 2's rows have them."""
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
        # f32 inputs run the products in 3xTF32: its rate, and phase 2's f32 tolerance
        bms, by = bound_ms(4.0 * b * h * lq * lk * d, q.element_size() * b * h * (2 * lq + 2 * lk) * d,
                           PEAK_F32_FLOPS if q.element_size() == 4 else PEAK_BF16_FLOPS, exps=b * h * lq * lk)
        tol_rel, shape = flash_rel(q.element_size()), [b, h, lq, lk, d]
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
    row = dict(kernel=name, shape=shape, dtype=str(dt).split(".")[-1], kw=kw, max_abs_err=err, tol=tol,
               device_ms=device_ms(torch, run, 5, 3),
               plain_ms=time_ms(torch, plain, 5.0), library_device_ms=device_ms(torch, lib, 5, 3), bound_ms=bms,
               bound_by=by)
    if host_ms:
        row.update(ms=time_ms(torch, run), library_ms=time_ms(torch, lib))
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{name} {shape} {str(dt)} {kw}: max_abs_err {err} > {tol}")
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


# the CLIP and ESRGAN phase: a chunk of images (the extractor's batch_size), the prompts, flash launches per chunk
# (every self-attention of a /14 tower runs at L 257 and takes the kernel; ViT-B/32's L 50 and the text tower's L 77
# stay on SDPA), the windows of chunks timed on the host clock, the ESRGAN input side
CLIP_CHUNK = 64
CLIP_PROMPTS = ["a photo of a cat", "a photo of a dog", "a red sports car", "a bowl of fruit on a table",
                "a mountain lake at dawn", "an astronaut riding a horse", "a city street at night", "a plate of sushi"]
CLIP_MODELS = {"clip": 0, "clip_large": 24, "open_clip_ViT_H_14": 32}
CLIP_WINDOWS = (2, 5)  # windows, chunks a window: the best window's rate
ESR_SIDE = 128
ESR_WINDOWS = (2, 3)
# the text embeddings come out in bf16 with `use_bf16`, as in the JAX package (the token table is looked up in
# the weights' dtype): their norm is one within bf16 rounding of the norm and of each element
TEXT_NORM_TOL = 2.0**-7


def phase_clip_esrgan(torch, np, F, cflearn_torch, A, Cv, Gn) -> dict:
    """CLIP ViT-B/32, ViT-L/14 and ViT-H/14 through `CLIPExtractor(use_bf16=True)` (f32 images against bf16
    weights: f32 compute, the flash kernel's f32 route at L 257), and the /14 modules with bf16 images straight
    into `encode_image` (the wgmma route); then ESRGAN and its anime preset through `TranslatorAPI.sr`. Each run
    goes under the census, then again with the counters at 0 (exact launches), then timed on the host clock
    (windows of chunks, the best). Gates: finite unit-norm embeddings, `zero_shot_classify` in range,
    `clip_score_from_embeddings` in [0, 100], every distinct kernel call of the census against its plain version
    (phase 2's tolerances), the /14 image embeddings through the kernels against the plain path within
    PARITY_FACTOR x its one-bf16-ulp drift in both dtypes; ESRGAN's shapes and dtypes, its f32 output finite
    before the clip, no hand-written kernel launched, and `offload` / `restore` (device memory falls by the
    parameters' bytes and comes back; the same output bit for bit)."""
    from cflearn_torch.api import CLIPExtractor, TranslatorAPI
    from cflearn_torch.api.multimodal.clip import CLIP_MEAN, CLIP_STD
    from cflearn_torch.toolkit.quality import clip_score_from_embeddings

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"clip / esrgan: {msg}")

    def launches_of(fn, want, counts=None):
        """fn under the census (into `counts`), then with the counters at 0: exact launches. Returns fn's result."""
        with census(A, Cv, Gn, counts if counts is not None else {}):
            fn()
        torch.cuda.synchronize()
        reset_launches(A, Cv, Gn)
        result = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
        check(got == want, f"launches {got} != {want}")
        return result

    def best_rate(fn, items, windows):
        rates = []
        for _ in range(windows[0]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(windows[1]):
                fn()
            torch.cuda.synchronize()
            rates.append(items * windows[1] / (time.perf_counter() - t0))
        return max(rates)

    def parity(label, fn, x):
        """fn through the kernels against the plain versions, held to the plain path's drift under a one-ulp move
        of x (x exactly representable in bf16: phase 4's rule)."""
        with torch.no_grad():
            y_k = fn(x).float()
            with plain_kernels(A, Cv, Gn):
                y_p = fn(x).float()
                drift = rel_err(fn(bump_ulp(torch, x)).float(), y_p)
        rel = rel_err(y_k, y_p)
        print(f"clip parity: {label}, kernels vs plain max rel err {rel:.3e} (tolerance {PARITY_FACTOR * drift:.3e}: "
              f"{PARITY_FACTOR} x the one-ulp drift {drift:.3e})")
        check(rel <= PARITY_FACTOR * drift, f"{label} through the kernels disagrees with the plain path")
        return {"kernels_vs_plain": rel, "drift": drift}

    out = {"clip": {}, "esrgan": {}}
    censuses = {}
    gen = torch.Generator(device="cuda").manual_seed(14)
    window = CLIP_WINDOWS[1] * CLIP_CHUNK  # images a window: one extractor call, chunk by chunk
    pixels = torch.randint(0, 256, (window, 224, 224, 3), generator=gen, device="cuda").to(torch.uint8)
    images = pixels.cpu().numpy()
    mean, std = (torch.as_tensor(v, device="cuda") for v in (CLIP_MEAN, CLIP_STD))
    # the extractor's own normalisation, on the card: the bf16 route's input, and the parity checks' (rounded to
    # bf16, so that a one-ulp move is one)
    normed = ((pixels[:CLIP_CHUNK].float() / 255.0 - mean) / std)
    for name, flash in CLIP_MODELS.items():
        t0 = time.perf_counter()
        m = getattr(cflearn_torch, name)(device="cuda", seed=0)
        n_params = sum(p.numel() for p in m.parameters())
        api = CLIPExtractor(m, use_bf16=True, device="cuda")
        torch.cuda.synchronize()
        attn = m.vit.blocks[0].attn
        print(f"clip[{name}]: {n_params:,} parameters (bf16 through the API) built in {time.perf_counter() - t0:.1f} s; "
              f"{m.vit.positional_embedding.shape[0]} image tokens, {attn.num_heads} heads of "
              f"{attn.q_proj.weight.shape[0] // attn.num_heads}")
        rec = {"parameters": n_params, "flash_per_chunk": flash}
        want = {"flash_attention": flash} if flash else {}
        counts = censuses.setdefault(f"{name} f32", {})
        img = launches_of(lambda: api.get_image_latent(images[:CLIP_CHUNK]), want, counts)
        txt = launches_of(lambda: api.get_text_latent(CLIP_PROMPTS), {})
        classes = api.zero_shot_classify(images[:len(CLIP_PROMPTS)], CLIP_PROMPTS)
        score = clip_score_from_embeddings(img[:len(CLIP_PROMPTS)], txt)
        img_norm = np.abs(np.linalg.norm(img.astype(np.float64), axis=-1) - 1.0).max()
        txt_norm = np.abs(np.linalg.norm(txt.astype(np.float64), axis=-1) - 1.0).max()
        check(img.shape == (CLIP_CHUNK, m.visual_projection.weight.shape[0]) and np.isfinite(img).all(),
              f"{name}: image embeddings {img.shape}")
        check(txt.shape == (len(CLIP_PROMPTS), img.shape[1]) and np.isfinite(txt).all(), f"{name}: text {txt.shape}")
        check(img_norm <= 1e-5 and txt_norm <= TEXT_NORM_TOL, f"{name}: norms off one by {img_norm}, {txt_norm}")
        check(classes.shape == (len(CLIP_PROMPTS),) and 0 <= classes.min() and classes.max() < len(CLIP_PROMPTS),
              f"{name}: zero-shot classes {classes}")
        check(0.0 <= score <= 100.0, f"{name}: clip score {score}")
        rec.update(image_embeds_per_s=best_rate(lambda: api.get_image_latent(images), window, (CLIP_WINDOWS[0], 1)),
                   text_embeds_per_s=best_rate(lambda: api.get_text_latent(CLIP_PROMPTS * 8), 64, CLIP_WINDOWS),
                   image_norm_err=float(img_norm), text_norm_err=float(txt_norm), clip_score=score,
                   zero_shot=classes.tolist())
        if flash:
            rec["parity_f32"] = parity(f"{name} image embeddings, f32 images", api.m.encode_image,
                                       normed.to(torch.bfloat16).float())
            # the module as the API cast it (bf16 parameters), fed bf16 images: the wgmma route
            xb = normed.to(torch.bfloat16)
            bf16 = censuses.setdefault(f"{name} bf16", {})
            with torch.no_grad():
                emb = launches_of(lambda: api.m.encode_image(xb), want, bf16)
                check(emb.dtype == torch.bfloat16 and bool(torch.isfinite(emb).all()), f"{name}: bf16 embeddings")
                rec["bf16_image_embeds_per_s"] = best_rate(lambda: api.m.encode_image(xb), CLIP_CHUNK, CLIP_WINDOWS)
            rec["parity_bf16"] = parity(f"{name} image embeddings, bf16 images", api.m.encode_image, xb)
        print(f"clip[{name}]: launches per chunk {json.dumps(want)}, image-embeds/s {rec['image_embeds_per_s']:.1f} "
              f"(f32 images, bf16 weights)" + (f", {rec['bf16_image_embeds_per_s']:.1f} (bf16)" if flash else "")
              + f", text-embeds/s {rec['text_embeds_per_s']:.1f}; norms off one by {img_norm:.2e} (image), "
              f"{txt_norm:.2e} (text, bf16); clip score {score:.3f}; zero-shot {classes.tolist()}")
        out["clip"][name] = rec
        del api, m, img, txt
        torch.cuda.empty_cache()

    # every distinct kernel call of the census against its plain version, timed alone
    calls = {}
    for key in sorted({key for counts in censuses.values() for key in counts}, key=str):
        calls[key] = check_call(torch, F, A, Cv, Gn, key, gen)
    out["calls"] = [dict(calls[key], launches={p: c[key] for p, c in censuses.items() if key in c})
                    for key in sorted(calls, key=str)]
    for row in out["calls"]:
        print(f"clip flash {row['shape']} {row['dtype']}: max_abs_err {row['max_abs_err']:.3e} (tol {row['tol']:.3e}), "
              f"device {row['device_ms']:.4f} ms, plain {row['plain_ms']:.4f}, SDPA device {row['library_device_ms']:.4f}, "
              f"bound {row['bound_ms']:.4f} ({row['bound_by']}); launches {json.dumps(row['launches'])}")
    del pixels, normed
    torch.cuda.empty_cache()

    # ESRGAN 4x through TranslatorAPI
    rgb = torch.randint(0, 256, (ESR_SIDE, ESR_SIDE, 3), generator=gen, device="cuda").to(torch.uint8).cpu().numpy()
    alpha = torch.randint(0, 256, (ESR_SIDE, ESR_SIDE, 1), generator=gen, device="cuda").to(torch.uint8).cpu().numpy()
    rgba = np.concatenate([rgb, alpha], axis=-1)
    side = 4 * ESR_SIDE
    for name, factory in (("esr", TranslatorAPI.from_esr), ("esr_anime", TranslatorAPI.from_esr_anime)):
        t0 = time.perf_counter()
        api = factory(pretrained=False, use_bf16=True, device="cuda")
        n_params = sum(p.numel() for p in api.m.parameters())
        raw = []
        hook = api.m.register_forward_hook(lambda mod, args, y: raw.append(y.detach()))
        out_rgb = launches_of(lambda: api.sr(rgb), {})
        out_rgba = launches_of(lambda: api.sr(rgba), {})
        check(all(y.dtype == torch.float32 and bool(torch.isfinite(y).all()) for y in raw),
              f"{name}: the network's output is not finite f32")
        hook.remove()
        check(out_rgb.shape == (side, side, 3) and out_rgba.shape == (side, side, 4)
              and out_rgb.dtype == out_rgba.dtype == np.uint8, f"{name}: outputs {out_rgb.shape}, {out_rgba.shape}")
        rate = best_rate(lambda: api.sr(rgb), 1, ESR_WINDOWS)
        torch.cuda.synchronize()
        param_bytes = sum(p.numel() * p.element_size() for p in api.m.parameters())
        before = torch.cuda.memory_allocated()
        api.offload()
        offloaded = torch.cuda.memory_allocated()
        api.restore()
        restored = torch.cuda.memory_allocated()
        again = api.sr(rgb)
        print(f"esrgan[{name}]: {n_params:,} parameters (bf16) built in {time.perf_counter() - t0:.1f} s; {ESR_SIDE}px -> "
              f"{side}px, {rate:.2f} img/s; no kernel launched; offload frees {before - offloaded:,} bytes (parameters "
              f"{param_bytes:,}), restore takes back {restored - offloaded:,}; the same output after restore "
              f"{bool(np.array_equal(again, out_rgb))}")
        check(before - offloaded >= param_bytes and abs(restored - before) <= param_bytes // 100,
              f"{name}: device memory {before} -> {offloaded} -> {restored} (parameters {param_bytes})")
        check(np.array_equal(again, out_rgb), f"{name}: the output after offload / restore differs")
        out["esrgan"][name] = {"parameters": n_params, "img_per_s": rate, "in_px": ESR_SIDE, "out_px": side,
                               "offload_freed_bytes": before - offloaded, "parameter_bytes": param_bytes}
        del api
        torch.cuda.empty_cache()
    return out


# 15. the UNet finetune step under each checkpoint policy at full SD-1.5 width, batch 8, phase 5's inputs. A policy
# that keeps no kernel output runs each checkpointed block's forward again in the backward: the input and output
# blocks hold all 15 routed self-attentions and 55 of the 61 GroupNorms (two a res block, one a transformer: 22 in
# the input blocks, 33 in the output blocks); the mid block (two res blocks and a transformer at 8x8, on the library
# path) and norm_out are not checkpointed. `everything_saveable` keeps the kernels' outputs (dispatcher operations,
# `flash_fwd_lse_op` and `group_norm_silu_op`), so nothing is launched again: as in the JAX package, where only
# `everything_saveable` keeps a `pallas_call`'s outputs (`tests/test_torch_checkpoint_policies.py` counts the JAX
# step's kernel calls under each policy)
POLICIES = (False, True, "nothing_saveable", "dots_saveable", "dots_with_no_batch_dims_saveable",
            "everything_saveable")
POLICY_BIG_BATCH = 16  # where the JAX package's own sweep (`docs/remat_policy_sweep.json`) needed full remat
POLICIES_BIG = (True, "dots_saveable", False)
GN_CHECKPOINTED = 55


def policy_launches(policy, steps: int) -> dict:
    """The finetune step's launches under `policy`: each routed attention's forward with lse and each checkpointed
    GroupNorm twice where the policy keeps no kernel output."""
    again = policy not in (False, "everything_saveable")
    return {"flash_fwd_lse": FLASH_PER_UNET * (2 if again else 1) * steps, "flash_bwd_fused": FLASH_PER_UNET * steps,
            "group_norm": (GN_PER_UNET + (GN_CHECKPOINTED if again else 0)) * steps}


def phase_checkpoint_policies(torch, cflearn_torch, A, Cv, Gn, build_unet) -> dict:
    """`finetune_unet(use_checkpoint=...)` under each policy: the first step's loss and gradients against the
    unchecked step within phase 8's loss and global-norm gates (AE_PARITY_FACTOR x the unchecked step's drift under
    a one-ulp move of x0, up and down); then one warm-up and TRAIN_STEPS timed steps each, exact launches, ms per
    step and peak memory; the same at batch 16 for three policies (printed; an out-of-memory is reported)."""
    from cflearn_torch.models.cv.diffusion import INPUT_KEY, LOSS_KEY
    from cflearn_torch.modules.core.convs import ResidualBlockWithTimeEmbedding
    from cflearn_torch.modules.core.mixed_stacks import SpatialTransformer
    from cflearn_torch.trainer import make_train_step

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"checkpoint policies: {msg}")

    gen = torch.Generator(device="cuda").manual_seed(2)
    x0 = torch.randn((TRAIN_BATCH, 64, 64, 4), generator=gen, device="cuda")  # phase 5's inputs
    ctx = torch.randn((TRAIN_BATCH, 77, 768), generator=gen, device="cuda")
    tmodel = build_unet()
    unet = tmodel.m.unet
    n_gn = sum(2 * isinstance(m, ResidualBlockWithTimeEmbedding) + isinstance(m, SpatialTransformer)
               for block in list(unet.input_blocks) + list(unet.output_blocks) for m in block.modules())
    check(n_gn == GN_CHECKPOINTED, f"{n_gn} GroupNorms in the checkpointed blocks")
    out = {"parity": {}, "batch8": {}, "batch16": {}}

    # the first step's gradients under each policy against the unchecked step's
    step = make_train_step(tmodel, lr=1e-5, compute_dtype=torch.bfloat16)
    t_fix = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device="cuda")
    noise = torch.randn(x0.shape, generator=gen, device="cuda")
    x0_b = x0.to(torch.bfloat16).float()

    def fwd_bwd(policy, x=x0_b):
        unet.use_checkpoint = policy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        loss = step.loss_and_grads({INPUT_KEY: x, "cond": ctx}, t=t_fix, noise=noise)[LOSS_KEY].item()
        torch.cuda.synchronize()
        # the forward + backward's peak above what was resident before it: the activations the policy keeps,
        # the recomputation's and the gradients (no optimizer state: it is not stepped)
        above[str(policy)] = (torch.cuda.max_memory_allocated() - resident) / 2**30
        grads, step.grads = step.grads, {}
        return loss, grads

    above = {}
    loss_0, grads_0 = fwd_bwd(False)
    above_0 = above["False"]
    up = bump_ulp(torch, x0_b)
    drift_loss = drift_global = 0.0
    for x in (up, x0_b - (up - x0_b)):
        loss_u, grads_u = fwd_bwd(False, x)
        drift_loss = max(drift_loss, abs(loss_u - loss_0))
        drift_global = max(drift_global, grad_errors(grads_u, grads_0)["global_rel"])
        del grads_u
    tol_loss = max(AE_PARITY_FACTOR * drift_loss, 2.0**-10 * abs(loss_0))
    print(f"policies: unchecked step loss {loss_0:.6f}; its drift under a one-ulp move of x0: loss {drift_loss:.3e}, "
          f"global {drift_global:.3e} (tolerances {tol_loss:.3e} and {AE_PARITY_FACTOR * drift_global:.3e})")
    for policy in POLICIES[1:]:
        loss, grads = fwd_bwd(policy)
        err = grad_errors(grads, grads_0)
        del grads
        print(f"policies[{policy}]: loss {loss:.6f} (off {abs(loss - loss_0):.3e}), gradients against the unchecked "
              f"step {json.dumps(err)}; forward + backward peak {above[str(policy)]:.2f} GiB above the resident "
              f"state (unchecked {above_0:.2f})")
        check(abs(loss - loss_0) <= tol_loss, f"{policy}: the loss moved from the unchecked step's")
        check(err["global_rel"] <= AE_PARITY_FACTOR * drift_global, f"{policy}: the gradients moved (global norm)")
        out["parity"][str(policy)] = {"loss_err": abs(loss - loss_0), "global_rel": err["global_rel"],
                                      "leaf_max_rel": err["leaf_max_rel"], "fwd_bwd_peak_gib": above[str(policy)]}
    out["parity"]["False"] = {"fwd_bwd_peak_gib": above_0}
    out["drift"] = {"loss": drift_loss, "global_rel": drift_global, "loss_tolerance": tol_loss}
    unet.use_checkpoint = False
    del step, grads_0
    torch.cuda.empty_cache()

    # one warm-up and TRAIN_STEPS timed steps under each policy
    x16 = torch.randn((POLICY_BIG_BATCH, 64, 64, 4), generator=gen, device="cuda")
    ctx16 = torch.randn((POLICY_BIG_BATCH, 77, 768), generator=gen, device="cuda")
    for key, xb, cb, policies in (("batch8", x0, ctx, POLICIES), ("batch16", x16, ctx16, POLICIES_BIG)):
        for policy in policies:
            kw = dict(lr=1e-5, compute_dtype=torch.bfloat16, use_checkpoint=policy,
                      generator=torch.Generator(device="cuda").manual_seed(3))
            oom = False
            try:
                cflearn_torch.finetune_unet(tmodel, xb, cb, num_steps=1, **kw)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches(A, Cv, Gn)
                t0 = time.perf_counter()
                result = cflearn_torch.finetune_unet(tmodel, xb, cb, num_steps=TRAIN_STEPS, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            except torch.cuda.OutOfMemoryError:
                check(key == "batch16", f"{policy}: out of memory at batch {TRAIN_BATCH}")
                oom = True
            if oom:  # outside the handler, so that the failed step's tensors are freed
                torch.cuda.empty_cache()
                print(f"policies[{policy}] at batch {POLICY_BIG_BATCH}: out of memory")
                out[key][str(policy)] = {"oom": True}
                continue
            launches = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
            peak = torch.cuda.max_memory_allocated() / 2**30
            losses = result["losses"].tolist()
            del result
            step_ms = wall / TRAIN_STEPS * 1e3
            print(f"policies[{policy}] at batch {xb.shape[0]}: {step_ms:.1f} ms per step, peak memory {peak:.2f} GiB, "
                  f"launches {json.dumps(launches)}, losses {losses}")
            check(all(math.isfinite(v) for v in losses), f"{policy}: losses {losses}")
            check(launches == policy_launches(policy, TRAIN_STEPS),
                  f"{policy}: launches {launches} != {policy_launches(policy, TRAIN_STEPS)}")
            out[key][str(policy)] = {"step_ms": step_ms, "samples_per_s": xb.shape[0] / step_ms * 1e3,
                                     "peak_memory_gib": peak, "launches_per_step": policy_launches(policy, 1)}
    unet.use_checkpoint = False
    del tmodel, unet
    torch.cuda.empty_cache()
    return out


# 16. style reference and tiling through DiffusionAPI at full SD-1.5 v1 width, bf16, batch 1 (CFG batch 2), 512px,
# DDIM 20 steps, CFG 7.5
STYLE_STATES = {"style_fidelity": 0.5, "reference_weight": 1.0}
STYLE_HALF = {"style_fidelity": 0.5, "reference_weight": 0.5}
STYLE_INTERVAL = (0.25, 0.75)  # the second run's guidance interval: CFG on steps 5-14 of 20, batch 1 outside
# the SD-1.5 UNet's transformer blocks in call order at 64x64 latents: (width, tokens)
STYLE_BLOCKS = ([(320, 4096)] * 2 + [(640, 1024)] * 2 + [(1280, 256)] * 2 + [(1280, 64)] + [(1280, 256)] * 3
                + [(640, 1024)] * 3 + [(320, 4096)] * 3)
# tiling mode: circular padding moves every `Conv2d` to `F.conv2d`. Those are the UNet's three upsample convs (at
# 16^2, 32^2 and 64^2: never routed) and the decoder's three (128^2 x 512, 256^2 x 512, 512^2 x 256: routed)
CIRCULAR_UNROUTED = 3


def style_flash_per_step(gates, fidelity: float, cfg: bool) -> int:
    """Flash launches of one style-reference denoise step: the WRITE pass's self-attentions with L >= 256 (the mid
    block's, L 64, is on the library path); then the READ pass's: a block with a bank attends over [self, bank]
    (kv = 2 L), and on a CFG call with fidelity > 1e-5 plainly once more for the uncond rows' mix; a block without
    one attends plainly."""
    routed = [tokens >= 256 for _, tokens in STYLE_BLOCKS]
    read = sum((2 if fidelity > 1e-5 and cfg else 1) if gate else 1 for r, gate in zip(routed, gates) if r)
    return sum(routed) + read


def phase_style_tiling(torch, np, F, cflearn_torch, A, Cv, Gn) -> dict:
    """`DiffusionAPI.setup_hooks(style_reference_image=...)` then `txt2img` (fidelity 0.5, reference weight 1; then
    weight 0.5 with a guidance interval), `setup_hooks()` clearing it, `switch_circular(True)` then `txt2img`, and
    `switch_circular(False)` giving back, bit for bit, the image of the model that never switched. Each path under
    the census, then timed: exact launches (`style_flash_per_step`, the encode of the reference each call), its
    UNet calls and their batches, finite latents. Every distinct kernel call of the census against its plain version
    and timed alone (`check_call`; the three kv = 2 q flash shapes in a table of their own); one READ-mode denoise
    (WRITE then READ) and one circular decode through the kernels against the plain path within PARITY_FACTOR x its
    one-ulp drift."""
    from cflearn_torch.modules.common import redraw_zero_init
    from cflearn_torch.modules.core.convs import Conv2d
    from cflearn_torch.modules.core.mixed_stacks import SpatialTransformerHooks, StyleReferenceStates
    from cflearn_torch.modules.multimodal.diffusion.unet import style_reference_write_gates, walk_transformer_blocks

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"style / tiling: {msg}")

    out = {"paths": {}}
    censuses = {}
    t0 = time.perf_counter()
    api = cflearn_torch.DiffusionAPI.from_sd("v1", device="cuda", seed=0)
    redraw_zero_init(api.m, seed=1)
    seen = watch(api.m)
    print(f"style: DiffusionAPI.from_sd('v1') bf16 built in {time.perf_counter() - t0:.1f} s")
    widths = [b.norm1.weight.shape[0] for b in walk_transformer_blocks(api.m.unet)]
    check(widths == [w for w, _ in STYLE_BLOCKS], f"transformer widths {widths}")
    n_conv2d = sum(isinstance(m, Conv2d) for m in api.m.modules())
    n_unet_conv2d = sum(isinstance(m, Conv2d) for m in api.m.unet.modules())
    check((n_conv2d, n_unet_conv2d) == (6, 3), f"{n_conv2d} Conv2d modules, {n_unet_conv2d} in the UNet")
    gen = torch.Generator(device="cuda").manual_seed(11)
    reference = torch.randint(0, 256, (512, 512, 3), generator=gen, device="cuda").to(torch.uint8).cpu().numpy()

    def run_path(name, fn, batches, want):
        result, out["paths"][name] = drive_path(torch, A, Cv, Gn, "style", name, fn, seen, want, censuses)
        got = [shape[0] for shape in seen["unet"]]
        check(got == batches, f"{name}: UNet calls at batches {got}, want {batches}")
        check(result.shape == (1, 512, 512, 3) and result.dtype == np.uint8, f"{name}: image {result.shape}")
        return result

    def launches(flash_steps, unets, encodes, convs=DECODER_CONVS):
        return {"flash_attention": flash_steps + 1 + ENCODER_FLASH * encodes, "conv3x3": convs + ENCODER_CONVS * encodes,
                "group_norm": GN_PER_UNET * unets + GN_PER_DECODE + GN_PER_ENCODE * encodes}

    txt2img = lambda: api.txt2img(PROMPT, num_steps=API_STEPS, seed=0)  # noqa: E731
    # fidelity 0.5, every block banks
    api.setup_hooks(style_reference_image=reference, style_reference_states=STYLE_STATES)
    gates = style_reference_write_gates(api.m.unet, STYLE_STATES["reference_weight"])
    check(all(gates), f"gates at weight 1: {gates}")
    per_step = style_flash_per_step(gates, STYLE_STATES["style_fidelity"], True)
    run_path("style", txt2img, [2] * 2 * API_STEPS, launches(per_step * API_STEPS, 2 * API_STEPS, 1))
    # weight 0.5 (the widest half banks) and a guidance interval: outside the band batch 1, no uncond rows to mix
    api.setup_hooks(style_reference_image=reference, style_reference_states=STYLE_HALF)
    api.switch_sampler("ddim", guidance_interval=STYLE_INTERVAL)
    half = style_reference_write_gates(api.m.unet, STYLE_HALF["reference_weight"])
    s0, s1 = (int(round(f * API_STEPS)) for f in STYLE_INTERVAL)
    band = s1 - s0
    flash = (style_flash_per_step(half, STYLE_HALF["style_fidelity"], True) * band
             + style_flash_per_step(half, STYLE_HALF["style_fidelity"], False) * (API_STEPS - band))
    batches = [1] * 2 * s0 + [2] * 2 * band + [1] * 2 * (API_STEPS - s1)
    run_path("style_half_interval", txt2img, batches, launches(flash, 2 * API_STEPS, 1))
    api.switch_sampler("ddim")
    # cleared: phase 12's DDIM path
    api.setup_hooks()
    plain_image = run_path("cleared", txt2img, [2] * API_STEPS, launches(FLASH_PER_UNET * API_STEPS, API_STEPS, 0))
    # tiling: the decoder's three routed upsample convs go to F.conv2d
    api.switch_circular(True)
    run_path("circular", txt2img, [2] * API_STEPS,
             launches(FLASH_PER_UNET * API_STEPS, API_STEPS, 0, DECODER_CONVS - CIRCULAR_UNROUTED))
    circular_latents = seen["latents"][0]
    api.switch_circular(False)
    back = txt2img()
    same = bool(np.array_equal(back, plain_image))
    print(f"style: after switch_circular(False) the image equals the never-switched one bit for bit: {same}")
    check(same, "switch_circular(False) does not give back the never-switched image")
    ms = {name: out["paths"][name]["ms_per_image"] for name in out["paths"]}
    out["style_over_plain"] = ms["style"] / ms["cleared"]
    print(f"style: ms per image {json.dumps(ms)}; style reference over plain txt2img {out['style_over_plain']:.2f}x")

    # parity: one READ-mode denoise (WRITE then READ) and one circular decode, kernels against the plain versions
    with torch.no_grad():
        tokens = api.tokenizer.tokenize([PROMPT, ""]).astype(np.int64)
        cond = api.m.get_cond(torch.as_tensor(tokens, device="cuda"))
        x2 = torch.randn((1, 64, 64, 4), generator=gen, device="cuda").repeat(2, 1, 1, 1)
        t2 = torch.full((2,), 981, dtype=torch.long, device="cuda")
        ref_z = api.m.encode_first_stage(torch.as_tensor(api._norm_image(reference), device="cuda")).float()
        mask = (torch.arange(2, device="cuda") >= 1)[:, None, None]

        def styled(x):
            hooks = SpatialTransformerHooks(
                style=StyleReferenceStates(**STYLE_STATES), write_gates=gates, uncond_mask=mask, ref_latent=ref_z,
                generator=torch.Generator(device="cuda").manual_seed(12),
            )
            return api.m.denoise(x, t2, cond, hooks=hooks).float()

        eps_k = styled(x2)
        with plain_kernels(A, Cv, Gn):
            eps_p = styled(x2)
            drift = rel_err(styled(bump_ulp(torch, x2)), eps_p)
        rel = rel_err(eps_k, eps_p)
        api.switch_circular(True)
        lat = circular_latents.to(torch.bfloat16).float()
        dec_k = api.m.decode(lat).float()
        with plain_kernels(A, Cv, Gn):
            dec_p = api.m.decode(lat).float()
            drift_dec = rel_err(api.m.decode(bump_ulp(torch, lat)).float(), dec_p)
        api.switch_circular(False)
        rel_dec = rel_err(dec_k, dec_p)
    print(f"style parity: READ-mode denoise, kernels vs plain max rel err {rel:.3e} (tolerance "
          f"{PARITY_FACTOR * drift:.3e}: {PARITY_FACTOR} x the one-ulp drift {drift:.3e})")
    print(f"style parity: circular decode, kernels vs plain max rel err {rel_dec:.3e} (tolerance "
          f"{PARITY_FACTOR * drift_dec:.3e}: {PARITY_FACTOR} x the one-ulp drift {drift_dec:.3e})")
    check(rel <= PARITY_FACTOR * drift, "the READ-mode denoise through the kernels disagrees with the plain path")
    check(rel_dec <= PARITY_FACTOR * drift_dec, "the circular decode through the kernels disagrees with the plain path")
    out["read_parity"] = {"kernels_vs_plain": rel, "drift": drift}
    out["circular_decode_parity"] = {"kernels_vs_plain": rel_dec, "drift": drift_dec}
    del api, cond, eps_k, eps_p, dec_k, dec_p
    torch.cuda.empty_cache()

    # every distinct kernel call of the census against its plain version, timed alone
    gen = torch.Generator(device="cuda").manual_seed(13)
    calls = {}
    for key in sorted({key for counts in censuses.values() for key in counts}, key=str):
        calls[key] = check_call(torch, F, A, Cv, Gn, key, gen)
    for path, counts in censuses.items():
        out["paths"][path]["device_ms"] = {
            k: sum(calls[key]["device_ms"] * n for key, n in counts.items() if key[0] == k)
            for k in ("flash_attention", "conv3x3", "group_norm")}
    worst = max(r["max_abs_err"] / r["tol"] for r in calls.values())
    print(f"style: {len(calls)} distinct kernel calls within their tolerances (at most {worst:.2f} of it); device ms "
          f"per image by kernel {json.dumps({p: v['device_ms'] for p, v in out['paths'].items()})}")
    out["kv2q"] = []
    for key, r in calls.items():
        if r["kernel"] == "flash_attention" and r["shape"][3] == 2 * r["shape"][2]:
            per_image = censuses["style"].get(key, 0)
            row = dict(shape=r["shape"], device_ms=r["device_ms"], sdpa_device_ms=r["library_device_ms"],
                       bound_ms=r["bound_ms"], bound_by=r["bound_by"], share=r["bound_ms"] / r["device_ms"],
                       plain_ms=r["plain_ms"], max_abs_err=r["max_abs_err"], tol=r["tol"], launches_style=per_image)
            out["kv2q"].append(row)
            print(f"style kv = 2q: B{r['shape'][0]} H{r['shape'][1]} Lq{r['shape'][2]} Lk{r['shape'][3]} "
                  f"d{r['shape'][4]}: device {r['device_ms']:.4f} ms, SDPA {r['library_device_ms']:.4f}, bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}, {row['share']:.0%}), plain {r['plain_ms']:.3f}, "
                  f"{per_image} a style image, err {r['max_abs_err']:.3e} (tolerance {r['tol']:.3e})")
    # the READ pass's three shapes at the CFG batch (the guidance interval's batch-1 steps add their own)
    at_cfg = sorted(tuple(r["shape"][2:]) for r in out["kv2q"] if r["shape"][0] == 2)
    check(at_cfg == [(256, 512, 160), (1024, 2048, 80), (4096, 8192, 40)], f"kv = 2q flash shapes at batch 2: {at_cfg}")
    out["calls"] = list(calls.values())
    return out


# 17. SD v2 served through DiffusionAPI at full width, bf16, batch 1 (CFG batch 2), CFG 7.5, 20 steps: v2_v (the
# 768-v model) at 768x768 by DDIM and by k_euler, and v2_base at 512x512 by DDIM. The v2 UNet has v1's blocks: 15
# self-attentions with L >= 256 a call (the mid block's, at 12x12 or 8x8 latents, stays on SDPA), now 64 channels a
# head (5, 10 and 20 heads), and 61 GroupNorms. The decoder routes its 3x3 convs at >= 128^2 (and the pinned
# 64^2 x 512 level): 21 at 96x96 latents (the upsample conv and the three res blocks' six at 192^2, 384^2 and 768^2),
# 31 at 64x64 (phase 3's)
V2_STEPS = 20
V2_PATHS = (("v2_v", "ddim", 768), ("v2_v", "k_euler", 768), ("v2_base", "ddim", 512))
V2_DECODER_CONVS = {96: 21, 64: DECODER_CONVS}


def phase_sd_v2(torch, np, F, cflearn_torch, A, Cv, Gn) -> dict:
    """`DiffusionAPI.from_sd("v2_v")` txt2img at 768x768 by DDIM and by k_euler, and `from_sd("v2_base")` at
    512x512 by DDIM, bf16 from seeds 0 and 2, the zero-initialised convs redrawn. Each path runs under the census,
    then timed twice on the host clock (the best kept): exact launches, 20 UNet calls at the CFG batch 2, finite
    latents, a uint8 image of the asked size. Every distinct kernel call of the census against its plain version
    (phase 2's tolerances), timed alone beside SDPA / cuDNN with its bound (`check_call`); one v-prediction UNet call
    at 96x96 latents and one 768^2 decode through the kernels against the plain path within PARITY_FACTOR x its
    one-ulp drift (phase 4's rule)."""
    from cflearn_torch.modules.common import redraw_zero_init
    from cflearn_torch.modules.core.convs import ResidualBlockWithTimeEmbedding
    from cflearn_torch.modules.core.mixed_stacks import SpatialTransformer

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"sd v2: {msg}")

    kernels = ("flash_attention", "conv3x3", "group_norm")
    out = {"paths": {}, "parity": {}}
    censuses = {}
    gen = torch.Generator(device="cuda").manual_seed(21)
    apis = {}
    for version, seed in (("v2_v", 0), ("v2_base", 2)):
        t0 = time.perf_counter()
        api = cflearn_torch.DiffusionAPI.from_sd(version, device="cuda", seed=seed)
        redraw_zero_init(api.m, seed=seed + 1)
        unet = api.m.unet
        n_res = sum(isinstance(m, ResidualBlockWithTimeEmbedding) for m in unet.modules())
        n_st = sum(isinstance(m, SpatialTransformer) for m in unet.modules())
        heads = sorted({b.attn1.heads for m in unet.modules() if isinstance(m, SpatialTransformer) for b in m.blocks})
        torch.cuda.synchronize()
        n_unet = sum(p.numel() for p in unet.parameters())
        print(f"sd v2: DiffusionAPI.from_sd('{version}') bf16 built in {time.perf_counter() - t0:.1f} s: "
              f"{sum(p.numel() for p in api.m.parameters()):,} parameters, UNet {n_unet:,}, "
              f"parameterization {api.m.parameterization}, heads {heads}")
        check(api.m.parameterization == ("v" if version == "v2_v" else "eps"), f"{version}: {api.m.parameterization}")
        check(2 * n_res + n_st + 1 == GN_PER_UNET and n_st - 1 == FLASH_PER_UNET and heads == [5, 10, 20],
              f"{version}: {n_res} res blocks, {n_st} transformers, heads {heads}")
        out[version] = {"parameters": sum(p.numel() for p in api.m.parameters()), "unet_parameters": n_unet}
        apis[version] = (api, watch(api.m))

    for version, sampler, side in V2_PATHS:
        api, seen = apis[version]
        latent = side // 8
        name = f"{version}_{sampler}_{side}"
        api.switch_sampler(sampler)
        calls = unet_calls(sampler, V2_STEPS)
        want = {"flash_attention": FLASH_PER_UNET * calls + 1, "conv3x3": V2_DECODER_CONVS[latent],
                "group_norm": GN_PER_UNET * calls + GN_PER_DECODE}
        fn = lambda: api.txt2img(PROMPT, size=(side, side), num_steps=V2_STEPS, seed=0)  # noqa: E731
        image, record = drive_path(torch, A, Cv, Gn, "sd v2", name, fn, seen, want, censuses)
        grids = [shape[:3] for shape in seen["unet"]]
        check(grids == [(2, latent, latent)] * calls, f"{name}: UNet calls at {sorted(set(grids))}")
        check(image.shape == (1, side, side, 3) and image.dtype == np.uint8, f"{name}: image {image.shape}")
        # a second timed run, with its launches read again: the best of the two on the host clock
        reset_launches(A, Cv, Gn)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        again = (time.perf_counter() - t0) * 1e3
        check({k: v for k, v in read_launches(A, Cv, Gn).items() if v} == record["launches"], f"{name}: launches moved")
        record.update(ms_runs=[record["ms_per_image"], again], ms_per_image=min(record["ms_per_image"], again),
                      latents=seen["latents"][-1] if name == "v2_v_ddim_768" else None)
        print(f"sd v2[{name}]: {record['ms_per_image']:.1f} ms per image (best of {record['ms_runs']})")
        out["paths"][name] = record
    api.switch_sampler("ddim")

    def parity(label, fn, x):
        with torch.no_grad():
            y_k = fn(x).float()
            with plain_kernels(A, Cv, Gn):
                y_p = fn(x).float()
                drift = rel_err(fn(bump_ulp(torch, x)).float(), y_p)
        rel = rel_err(y_k, y_p)
        print(f"sd v2 parity: {label}, kernels vs plain max rel err {rel:.3e} (tolerance {PARITY_FACTOR * drift:.3e}: "
              f"{PARITY_FACTOR} x the one-ulp drift {drift:.3e})")
        check(rel <= PARITY_FACTOR * drift, f"{label} through the kernels disagrees with the plain path")
        out["parity"][label] = {"kernels_vs_plain": rel, "drift": drift}

    api = apis["v2_v"][0]
    with torch.no_grad():
        tokens = api.tokenizer.tokenize([PROMPT, ""]).astype(np.int64)
        cond = api.m.get_cond(torch.as_tensor(tokens, device="cuda"))
    x2 = torch.randn((1, 96, 96, 4), generator=gen, device="cuda").to(torch.bfloat16).repeat(2, 1, 1, 1)
    t2 = torch.full((2,), 981, dtype=torch.long, device="cuda")
    parity("v-prediction UNet call at 96x96 latents", lambda x: api.m.denoise(x, t2, cond), x2)
    lat = out["paths"]["v2_v_ddim_768"]["latents"].to(torch.bfloat16)
    parity("768x768 decode", lambda z: api.m.decode(z), lat)
    for name in out["paths"]:
        out["paths"][name].pop("latents", None)
    del apis, api, cond, x2, lat
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
    print(f"sd v2: {len(calls)} distinct kernel calls held against their plain versions in "
          f"{time.perf_counter() - t0:.1f} s (largest error / tolerance by kernel {json.dumps(worst)})")
    print(f"sd v2: device ms per image by kernel "
          f"{json.dumps({p: {k: v['device_ms'] for k, v in o['by_kernel'].items()} for p, o in out['paths'].items()})}")
    return out


# 18. the v2_v finetune step through the model core: `IDLModel.from_config(DLConfig(model="ddpm", module_name="sd",
# module_config={"version": "v2_v", "with_first_stage": False}))`, f32 masters, bf16 compute, AdamW 1e-5, on 96x96x4
# latents at batch 4 with a precomputed 77x1024 condition (phase 5's settings: the text tower is not run), the v
# target. Each routed attention (L 9216, 2304, 576 at 64 channels a head) takes the forward with the logsumexp and
# the fused backward once a step, each GroupNorm one launch; phase 2 holds those kernels at these shapes (`v2_*`
# of TRAIN_CASES)
def phase_v2_finetune(torch, cflearn_torch, A, Cv, Gn) -> dict:
    """The v2_v UNet's finetune step through `IDLModel.from_config`: the first step's loss and gradients through
    the kernels against the plain path within phase 8's loss and global-norm gates (AE_PARITY_FACTOR x the plain
    path's drift under a one-ulp move of the latents, up and down); then `finetune_unet` on the model, one warm-up
    and TRAIN_STEPS timed steps: exact launches of the forward with the logsumexp, the fused backward and GroupNorm,
    finite losses, every trained parameter moved, ms per step and peak memory. An out-of-memory fails."""
    from cflearn_torch.constants import INPUT_KEY, LOSS_KEY
    from cflearn_torch.modules.common import redraw_zero_init
    from cflearn_torch.trainer import make_train_step

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"v2 finetune: {msg}")

    t0 = time.perf_counter()
    config = cflearn_torch.DLConfig(model="ddpm", module_name="sd", seed=0,
                                    module_config={"version": "v2_v", "with_first_stage": False})
    model = cflearn_torch.IDLModel.from_config(config, device="cuda")
    redraw_zero_init(model.m, seed=1)
    trained = model.params_filter("all")
    n_trained = sum(p.numel() for _, p in trained)
    torch.cuda.synchronize()
    print(f"v2 finetune: IDLModel.from_config built {type(model).__name__}({type(model.m).__name__} v2_v, "
          f"parameterization {model.m.parameterization}) in {time.perf_counter() - t0:.1f} s: {model.num_params:,} "
          f"f32 parameters, {n_trained:,} trained (the UNet)")
    check(isinstance(model, cflearn_torch.DDPMModel) and model.m.parameterization == "v", "not the v2_v DDPMModel")
    check(all(n.startswith("m.unet.") for n, _ in trained), "the trained scope reaches beyond the UNet")
    gen = torch.Generator(device="cuda").manual_seed(22)
    x0 = torch.randn((V2_TRAIN_BATCH, 96, 96, 4), generator=gen, device="cuda")
    ctx = torch.randn((V2_TRAIN_BATCH, 77, 1024), generator=gen, device="cuda")
    out = {"parameters": model.num_params, "trained_parameters": n_trained, "batch": V2_TRAIN_BATCH, "latent": 96}

    # the first step's loss and gradients: kernels against the plain path, held to the plain path's one-ulp drift
    step = make_train_step(model, lr=1e-5, compute_dtype=torch.bfloat16)
    t_fix = torch.randint(0, 1000, (V2_TRAIN_BATCH,), generator=gen, device="cuda")
    noise = torch.randn(x0.shape, generator=gen, device="cuda")
    x0_b = x0.to(torch.bfloat16).float()

    def fwd_bwd(x):
        loss = step.loss_and_grads({INPUT_KEY: x, "cond": ctx}, t=t_fix, noise=noise)[LOSS_KEY].item()
        grads, step.grads = step.grads, {}
        return loss, grads

    with plain_kernels(A, Cv, Gn):
        loss_p, grads_p = fwd_bwd(x0_b)
        up = bump_ulp(torch, x0_b)
        drift_loss = drift_global = 0.0
        for x in (up, x0_b - (up - x0_b)):
            loss_u, grads_u = fwd_bwd(x)
            drift_loss = max(drift_loss, abs(loss_u - loss_p))
            drift_global = max(drift_global, grad_errors(grads_u, grads_p)["global_rel"])
            del grads_u
    reset_launches(A, Cv, Gn)
    loss_k, grads_k = fwd_bwd(x0_b)
    one = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
    err = grad_errors(grads_k, grads_p)
    del grads_k, grads_p
    tol_loss = max(AE_PARITY_FACTOR * drift_loss, 2.0**-10 * abs(loss_p))
    print(f"v2 finetune parity: loss kernels {loss_k:.6f} plain {loss_p:.6f} (off {abs(loss_k - loss_p):.3e}, "
          f"tolerance {tol_loss:.3e}); gradients {json.dumps(err)} (global tolerance "
          f"{AE_PARITY_FACTOR * drift_global:.3e}: {AE_PARITY_FACTOR} x the one-ulp drift {drift_global:.3e}); "
          f"launches of the forward + backward {json.dumps(one)}")
    check(abs(loss_k - loss_p) <= tol_loss, "the loss through the kernels disagrees with the plain path")
    check(err["global_rel"] <= AE_PARITY_FACTOR * drift_global, "the gradients disagree with the plain path")
    check(one == {k: v for k, v in policy_launches(False, 1).items() if v}, f"one forward + backward launched {one}")
    out["parity"] = {"loss_err": abs(loss_k - loss_p), "loss_tolerance": tol_loss, "global_rel": err["global_rel"],
                     "leaf_max_rel": err["leaf_max_rel"], "drift_loss": drift_loss, "drift_global": drift_global}
    del step
    torch.cuda.empty_cache()

    # one warm-up and TRAIN_STEPS timed steps through `finetune_unet` on the IDLModel
    kw = dict(lr=1e-5, compute_dtype=torch.bfloat16, generator=torch.Generator(device="cuda").manual_seed(23))
    cflearn_torch.finetune_unet(model, x0, ctx, num_steps=1, **kw)
    torch.cuda.synchronize()
    before = [p.detach().clone() for _, p in trained]
    torch.cuda.reset_peak_memory_stats()
    reset_launches(A, Cv, Gn)
    t0 = time.perf_counter()
    result = cflearn_torch.finetune_unet(model, x0, ctx, num_steps=TRAIN_STEPS, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(A, Cv, Gn)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = result["losses"].tolist()
    want = dict.fromkeys(launches, 0)
    want.update(policy_launches(False, TRAIN_STEPS))
    still = sum(torch.equal(p, old) for (_, p), old in zip(trained, before))
    step_ms = wall / TRAIN_STEPS * 1e3
    print(f"v2 finetune: {TRAIN_STEPS} steps at batch {V2_TRAIN_BATCH} on 96x96x4 latents, {step_ms:.1f} ms per step, "
          f"{V2_TRAIN_BATCH / step_ms * 1e3:.2f} samples/s, peak memory {peak:.2f} GiB, losses {losses}, launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}, {still} trained parameters unmoved")
    check(result["model"] is model, "finetune_unet did not train the IDLModel it was given")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(launches == want, f"launches {launches} != {want}")
    check(still == 0, f"{still} trained parameters did not move")
    out.update(step_ms=step_ms, samples_per_s=V2_TRAIN_BATCH / step_ms * 1e3, peak_memory_gib=peak, losses=losses,
               launches=launches, launches_per_step=policy_launches(False, 1))
    del result, before, model, trained
    torch.cuda.empty_cache()
    return out

# 19. the CV models through the model core, at the JAX modules' defaults, f32, seeded random weights: "gan" (vanilla,
# wgangp with its gradient penalty, conditional on 10 classes with the PatchGAN's class head), "vae" and conditional
# "vae", "vq_vae" (512 codes of 128) and "ar" (PixelCNN over the VQ-VAE's 8x8 code maps, trained on the codes of the
# images, then sampled), all at 64 px and batch 64; and "clf" with the ViT-S/16 encoder (latent 384, 6 heads of
# 4 x 384 / 6 = 256, 1000 classes) at 224 px (197 tokens: the library path) and at 384 px (577 tokens: the flash
# kernels). Phase 2 holds the 384 px attention shapes (`vit384_*`)
CV_MODELS = [
    # (name, DLConfig keyword arguments, the batch has labels of this many classes)
    ("gan", dict(model="gan", module_name="gan"), None),
    ("gan_wgangp", dict(model="gan", module_name="gan", loss_config={"gan_mode": "wgangp"}), None),
    ("gan_conditional", dict(model="gan", module_name="gan", module_config={"num_classes": 10}), 10),
    ("vae", dict(model="vae", module_name="vae"), None),
    ("vae_conditional", dict(model="vae", module_name="vae", module_config={"num_classes": 10}), 10),
    ("vq_vae", dict(model="vq_vae", module_name="vq_vae"), None),
]


def vit_config(size: int) -> dict:
    return dict(model="common", module_name="clf", loss_name="cross_entropy", module_config=dict(
        img_size=size, in_channels=3, num_classes=1000, encoder="vit", latent_dim=384))


def phase_cv_models(torch, np, cflearn_torch, A, Cv, Gn) -> dict:
    """Each model built by `IDLModel.from_config` on the card (f32), its train steps through `MultiScopeStep`
    (Adam 1e-4): one warm-up step, then two windows of CV_STEPS steps on the host clock (the best window's ms per
    step kept), peak memory, finite loss items, every trained parameter moved, exact launches (none for the
    GAN, VAE, VQ-VAE and PixelCNN, whose convs run in f32 and which have no attention or GroupNorm; 12 flash
    forwards with the logsumexp and 12 fused backwards a ViT step at 384 px). One forward + backward of each
    model's first scope through the kernels against the plain path within TRAIN_PARITY_FACTOR x the plain
    path's drift under a one-ulp move of its input (the images; the GAN generator's z; PixelCNN's first
    masked conv weight, its input being integer codes), the loss and the gradient's global norm, its draws
    held fixed. PixelCNN samples 16 code maps. The ViT classifies 64 images
    at 224 and at 384 px under the census (none and 12 flash calls), the best of two on the host clock."""
    from cflearn_torch.constants import INPUT_KEY, LABEL_KEY, LOSS_KEY
    from cflearn_torch.optimizers import build_optimizer
    from cflearn_torch.trainer import MultiScopeStep

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"cv models: {msg}")

    gen = torch.Generator(device="cuda").manual_seed(31)
    images = torch.rand((CV_BATCH, 64, 64, 3), generator=gen, device="cuda") * 2.0 - 1.0
    out = {}

    def fixed_draws(model):
        """The module's draws made once a shape and then repeated: the kernel and the plain runs see the same."""
        made = {}
        model.m._randn = lambda shape: made.setdefault(("n",) + tuple(shape), torch.randn(
            tuple(shape), generator=gen, device="cuda"))
        model.m._uniform = lambda shape: made.setdefault(("u",) + tuple(shape), torch.rand(
            tuple(shape), generator=gen, device="cuda"))
        return made

    def parity(name, model, batch):
        """The first scope's loss and gradients through the kernels against the plain path (TRAIN_PARITY_FACTOR
        x its one-ulp drift, up and down), with the draws fixed; returns the launches of the kernel run."""
        made = fixed_draws(model)
        step = MultiScopeStep(model, {ts.scope: build_optimizer("sgd", 0.0) for ts in model.train_steps})
        core = next(iter(step.steps.values()))
        core.train_step.step_actives = {ts.scope: True for ts in model.train_steps}
        # the input that moves one ulp: the generator's z for a GAN (its core loss does not read the images), the
        # first masked conv's weight for PixelCNN (whose input is integer codes), the images otherwise
        z_key = ("n", CV_BATCH, getattr(model.m, "latent_dim", 0))
        if name.startswith("gan"):
            made[z_key] = torch.randn(z_key[1:], generator=gen, device="cuda").to(torch.bfloat16).float()
            x0 = made[z_key]
        elif name == "ar":
            weight = model.m.convs[0].conv.weight
            with torch.no_grad():
                weight.copy_(weight.to(torch.bfloat16).float())
            x0 = weight.detach().clone()
        else:
            x0 = batch[INPUT_KEY].to(torch.bfloat16).float()

        def fwd_bwd(x):
            b = batch
            if name.startswith("gan"):
                made[z_key] = x
            elif name == "ar":
                with torch.no_grad():
                    weight.copy_(x)
            else:
                b = dict(batch, **{INPUT_KEY: x})
            loss = core.loss_and_grads(b)[LOSS_KEY].item()
            grads, core.grads = core.grads, {}
            return loss, grads

        with plain_kernels(A, Cv, Gn):
            loss_p, grads_p = fwd_bwd(x0)
            up = bump_ulp(torch, x0)
            drift_loss = drift_global = 0.0
            for x in (up, x0 - (up - x0)):
                loss_u, grads_u = fwd_bwd(x)
                drift_loss = max(drift_loss, abs(loss_u - loss_p))
                drift_global = max(drift_global, grad_errors(grads_u, grads_p)["global_rel"])
        reset_launches(A, Cv, Gn)
        loss_k, grads_k = fwd_bwd(x0)
        launches = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
        err = grad_errors(grads_k, grads_p)
        tol_loss = max(TRAIN_PARITY_FACTOR * drift_loss, 1e-6 * abs(loss_p))
        print(f"cv models parity[{name}]: {core.scope} loss kernels {loss_k:.6f} plain {loss_p:.6f} (off "
              f"{abs(loss_k - loss_p):.3e}, tolerance {tol_loss:.3e}); gradients {json.dumps(err)} (global tolerance "
              f"{TRAIN_PARITY_FACTOR * drift_global:.3e}: {TRAIN_PARITY_FACTOR} x the one-ulp drift "
              f"{drift_global:.3e}); launches {json.dumps(launches)}")
        check(abs(loss_k - loss_p) <= tol_loss, f"{name}: the loss through the kernels disagrees with the plain path")
        check(err["global_rel"] <= TRAIN_PARITY_FACTOR * drift_global,
              f"{name}: the gradients through the kernels disagree with the plain path")
        for attr in ("_randn", "_uniform"):
            vars(model.m).pop(attr, None)
        if name == "ar":
            with torch.no_grad():
                weight.copy_(x0)
        return launches, {"loss_err": abs(loss_k - loss_p), "loss_tolerance": tol_loss, "drift_loss": drift_loss,
                          "global_rel": err["global_rel"], "leaf_max_rel": err["leaf_max_rel"],
                          "drift_global": drift_global}

    def train(name, config, batch, per_step):
        """Warm-up, two timed windows, the checks; `per_step` the launches of one step."""
        t0 = time.perf_counter()
        model = cflearn_torch.IDLModel.from_config(cflearn_torch.DLConfig(seed=0, **config), device="cuda")
        torch.cuda.synchronize()
        scopes = [ts.scope for ts in model.train_steps]
        print(f"cv models[{name}]: IDLModel.from_config built {type(model).__name__}({type(model.m).__name__}) in "
              f"{time.perf_counter() - t0:.2f} s: {model.num_params:,} f32 parameters, scopes {scopes}")
        parity_launches, par = parity(name, model, batch)
        check(parity_launches == {k: v for k, v in per_step.items() if v},
              f"{name}: one forward + backward launched {parity_launches}")
        step = MultiScopeStep(model, {s: build_optimizer("adam", 1e-4) for s in scopes})
        step.step(batch)  # warm-up
        torch.cuda.synchronize()
        trained = [(n, p) for s in scopes for n, p in model.params_filter(s)]
        before = [p.detach().clone() for _, p in trained]
        torch.cuda.reset_peak_memory_stats()
        reset_launches(A, Cv, Gn)
        windows, losses = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(CV_STEPS):
                losses.append({k: v.item() for k, v in step.step(batch).items()})
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) / CV_STEPS * 1e3)
        launches = read_launches(A, Cv, Gn)
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = dict.fromkeys(launches, 0)
        want.update({k: v * 2 * CV_STEPS for k, v in per_step.items()})
        unmoved = [n for (n, p), old in zip(trained, before) if torch.equal(p, old)]
        # wgangp: the patch logits' bias cancels between the real and the fake mean, and the penalty does not
        # read it: its gradient is exactly zero, in the JAX package too
        still = len(set(unmoved) - ({"discriminator.conv_out.bias"} if name == "gan_wgangp" else set()))
        step_ms = min(windows)
        bsz = batch[INPUT_KEY].shape[0]
        print(f"cv models[{name}]: {step_ms:.2f} ms per step (best of windows {[round(w, 2) for w in windows]}), "
              f"{bsz / step_ms * 1e3:.1f} samples/s, peak memory {peak:.2f} GiB, last losses {json.dumps(losses[-1])}, "
              f"launches {json.dumps({k: v for k, v in launches.items() if v})}, {still} trained parameters unmoved")
        check(all(math.isfinite(v) for items in losses for v in items.values()), f"{name}: losses {losses[-1]}")
        check(launches == want, f"{name}: launches {launches} != {want}")
        check(still == 0, f"{name}: trained parameters did not move: {unmoved}")
        record = {"parameters": model.num_params, "batch": bsz, "step_ms": step_ms, "windows_ms": windows,
                  "samples_per_s": bsz / step_ms * 1e3, "peak_memory_gib": peak, "losses": losses[-1],
                  "launches": {k: v for k, v in launches.items() if v}, "launches_per_step": per_step, "parity": par}
        return model, record

    for name, config, classes in CV_MODELS:
        batch = {INPUT_KEY: images}
        if classes:
            batch[LABEL_KEY] = torch.randint(0, classes, (CV_BATCH, 1), generator=gen, device="cuda")
        model, out[name] = train(name, config, batch, {})
        if name == "vq_vae":
            model.eval()
            with torch.no_grad():
                codes = model.m.get_code_indices(images)
            check(codes.shape == (CV_BATCH, 8, 8) and 0 <= int(codes.min()) and int(codes.max()) < 512,
                  f"vq_vae codes {tuple(codes.shape)}")
            out[name]["distinct_codes"] = len(torch.unique(codes))
        del model
        torch.cuda.empty_cache()

    # PixelCNN over the VQ-VAE's code maps, then sampled
    ar_config = dict(model="ar", module_name="pixel_cnn", module_config={"num_codes": 512, "img_size": 8,
                                                                       "in_channels": 1})
    model, out["ar"] = train("ar", ar_config, {INPUT_KEY: codes[..., None]}, {})
    model.eval()
    model.m.generator = torch.Generator(device="cuda").manual_seed(32)
    reset_launches(A, Cv, Gn)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        sampled = model.m.sample(PIXEL_CNN_SAMPLES)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    sample_launches = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
    print(f"cv models[ar]: sample of {PIXEL_CNN_SAMPLES} 8x8 code maps ({64} forwards) in {min(runs):.1f} ms (best of "
          f"{[round(r, 1) for r in runs]}), {len(torch.unique(sampled))} distinct codes, launches {sample_launches}")
    check(sampled.shape == (PIXEL_CNN_SAMPLES, 8, 8, 1) and 0 <= int(sampled.min()) and int(sampled.max()) < 512,
          f"ar sample {tuple(sampled.shape)}")
    check(not sample_launches, f"ar sample launched {sample_launches}")
    out["ar"].update(sample_ms=min(runs), sample_runs_ms=runs, sample_distinct_codes=len(torch.unique(sampled)))
    del model, codes, sampled
    torch.cuda.empty_cache()

    # the ViT-S/16 classifier at 224 and 384 px
    for size in (224, 384):
        name = f"clf_vit_{size}"
        routed = VIT_TOKENS[size] >= 256
        x = torch.rand((CV_BATCH, size, size, 3), generator=gen, device="cuda") * 2.0 - 1.0
        y = torch.randint(0, 1000, (VIT_TRAIN_BATCH, 1), generator=gen, device="cuda")
        per_step = {"flash_fwd_lse": VIT_LAYERS, "flash_bwd_fused": VIT_LAYERS} if routed else {}
        model, out[name] = train(name, vit_config(size), {INPUT_KEY: x[:VIT_TRAIN_BATCH], LABEL_KEY: y}, per_step)
        attn = model.m.encoder.encoder.blocks[0].token_mixer.net
        check((attn.num_heads, attn.head_dim, len(model.m.encoder.encoder.blocks)) == (VIT_HEADS, VIT_DIM, VIT_LAYERS),
              f"{name}: {attn.num_heads} heads of {attn.head_dim}")
        model.eval()
        counts = {}
        with torch.no_grad(), census(A, Cv, Gn, counts):
            logits = model.run({INPUT_KEY: x})["predictions"]
        torch.cuda.synchronize()
        runs = []
        for _ in range(2):
            reset_launches(A, Cv, Gn)
            t0 = time.perf_counter()
            with torch.no_grad():
                model.run({INPUT_KEY: x})
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        got = read_launches(A, Cv, Gn)
        want = dict.fromkeys(got, 0)
        want["flash_attention"] = VIT_LAYERS if routed else 0
        shapes = sorted({str(key[1][0]) for key in counts if key[0] == "flash_attention"})
        print(f"cv models[{name}]: classify {CV_BATCH} images in {min(runs):.1f} ms (best of "
              f"{[round(r, 1) for r in runs]}), {CV_BATCH / min(runs) * 1e3:.1f} img/s, logits {tuple(logits.shape)}, "
              f"launches {json.dumps({k: v for k, v in got.items() if v})}, census flash calls "
              f"{sum(n for k, n in counts.items() if k[0] == 'flash_attention')} at {shapes}")
        check(logits.shape == (CV_BATCH, 1000) and bool(torch.isfinite(logits).all()), f"{name}: logits")
        check(got == want, f"{name}: classify launches {got} != {want}")
        check(sum(counts.values()) == want["flash_attention"], f"{name}: the census {counts} disagrees")
        out[name].update(classify_ms=min(runs), classify_runs_ms=runs, classify_img_per_s=CV_BATCH / min(runs) * 1e3,
                         classify_launches=got, tokens=VIT_TOKENS[size])
        del model, x, logits
        torch.cuda.empty_cache()
    return out


# 20. the framework: the ViT-S/16 classifier at 384 px through `fit_array` (phase 19's model, f32), then the
# pipeline saved, loaded and predicting; and `ae_kl` at phase 7's workload through `fit_array`
FW_SIZE = 384
FW_TRAIN, FW_VALID = 128, 64  # images; batch 32 (4 steps an epoch), the validation set in one batch of 64
FW_BATCH, FW_VALID_BATCH = 32, 64
FW_STEPS = 8  # a monitor (and a snapshot) every 2 steps: 4 validation passes and the final one
FW_CLASSES = 4  # the labels' classes, each image offset by its class, so that the scores move between monitors
FW_KEEP = 2  # max_snapshot_file: of the 4 snapshots, the best 2 stay
FW_AE_IMAGES = 24


def phase_framework(torch, np, cflearn_torch, A, Cv, Gn, bare_step_ms: float) -> dict:
    """`cflearn_torch.fit_array` on the ViT-S/16 at 384 px (f32, seeded random weights; 128 training and 64
    validation images made from a seed, bf16-representable so that a one-ulp move is defined, labelled with 4
    classes whose images are offset by their class): 8 steps at the `Trainer`'s defaults (Adam behind the
    warm-up), "acc" and "auc" on the validation set every 2 steps, a snapshot at every monitor ("conservative")
    with the best 2 kept, the rollback, the final evaluation; then `save`, `load_inference`, `predict` on the 64
    validation images and `evaluate`. Gates: finite loss items, every trained parameter moved, 4 snapshots
    written with at least two scores, the 2 kept in `scores.json` and on disk ranking at or above the removed
    ones (scores may tie), the model after the fit bit for bit the best-scored of them, the loaded pipeline's
    predictions bit for bit the
    trained one's, exact launches (12 `flash_fwd_lse` and 12 `flash_bwd_fused` a step, 12 `flash_attention` a
    64-image evaluation or predict batch, counted from the steps and the batches the run made), and the first
    step's loss and gradient (kernels) against the plain path on its state and batch within TRAIN_PARITY_FACTOR x
    the plain path's drift under a one-ulp move of the images (phase 19's rule). Reports the ms a step through the
    `Trainer` (between a monitor's checkpoint, its writer thread drained, and the next monitor: the loop's host
    work included) beside phase 19's bare `MultiScopeStep`, the ms of each checkpoint's write, the evaluation
    pass's ms and peak memory. Then `ae_kl` through `fit_array` at phase 7's workload (256 px, batch 8,
    bf16 compute), 3 steps, no validation set and no final evaluation: phase 7's launches a step, exactly."""
    import shutil
    import tempfile

    from cflearn_torch.trainer import get_sorted_checkpoints, read_states

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"framework: {msg}")

    out = {}
    root = tempfile.mkdtemp(prefix="framework_")
    gen = torch.Generator().manual_seed(41)
    vit = vit_config(FW_SIZE)
    classes = vit["module_config"]["num_classes"]
    y = torch.randint(0, FW_CLASSES, (FW_TRAIN + FW_VALID, 1), generator=gen)
    x = torch.rand((FW_TRAIN + FW_VALID, FW_SIZE, FW_SIZE, 3), generator=gen) * 1.6 - 1.0
    x = (x + 0.1 * y.view(-1, 1, 1, 1)).to(torch.bfloat16).float().numpy()
    y = y.numpy()
    xt, yt, xv, yv = x[:FW_TRAIN], y[:FW_TRAIN], x[FW_TRAIN:], y[FW_TRAIN:]

    # what the run makes, read through the Trainer's own methods: the first step's state, batch, loss and
    # gradients; the monitors' edges; the evaluation passes; the batches the inference ran; the snapshots written,
    # with their scores
    rec = {}
    with recording_fit(torch, rec):
        config = cflearn_torch.DLConfig(
            **vit, seed=0, workspace=os.path.join(root, "vit"), metric_names=["acc", "auc"], min_num_sample=0,
            num_snapshot_per_epoch=2, fixed_steps=FW_STEPS, monitor_names="conservative",
            max_snapshot_file=FW_KEEP,
        )
        data_config = cflearn_torch.DataConfig()
        data_config.batch_size, data_config.valid_batch_size = FW_BATCH, FW_VALID_BATCH
        torch.cuda.reset_peak_memory_stats()
        reset_launches(A, Cv, Gn)
        t0 = time.perf_counter()
        p = cflearn_torch.fit_array(xt, yt, xv, yv, config=config, data_config=data_config)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = read_launches(A, Cv, Gn)
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer, model = p.trainer, p.model
    steps, eval_batches = trainer.state.step, rec["batches"]
    monitors = steps // trainer.state.num_step_per_snapshot
    want = dict.fromkeys(fit_launches, 0)
    want.update(flash_fwd_lse=VIT_LAYERS * steps, flash_bwd_fused=VIT_LAYERS * steps,
                flash_attention=VIT_LAYERS * eval_batches)
    losses = [{k: v.item() for k, v in items.items()} for items in rec["items"]]
    folder = trainer.checkpoint_folder
    scores = get_sorted_checkpoints(folder)
    on_disk = sorted(f for f in os.listdir(folder) if f.endswith(".npz"))
    written = rec["snapshots"]
    evicted = [f for f in written if f not in scores]
    best = read_states(os.path.join(folder, scores[0])) if scores else {}
    rolled_back = bool(best) and all(
        torch.equal(v.cpu(), torch.from_numpy(best[k]).to(v.dtype)) for k, v in model.state_dict().items())
    trained = [n for n, _ in model.params_filter("all")]
    state = model.state_dict()
    unmoved = [n for n in trained if torch.equal(state[n], rec["state0"][n])]
    windows = rec["windows"]
    step_ms = min(windows) if windows else float("nan")
    print(f"framework[vit]: fit_array ViT-S/16 {FW_SIZE} px, {steps} steps at batch {FW_BATCH}, {monitors} monitors and "
          f"{len(rec['evals'])} evaluation passes ({eval_batches} batches of {FW_VALID_BATCH}) in {fit_s:.2f} s; "
          f"{step_ms:.2f} ms a step through the Trainer (best of {[round(w, 2) for w in windows]}) against "
          f"{bare_step_ms:.2f} ms for phase 19's bare MultiScopeStep: {step_ms - bare_step_ms:.2f} ms of the loop a "
          f"step; evaluation pass {min(rec['evals']):.1f} ms (of {[round(e, 1) for e in rec['evals']]}); checkpoint "
          f"writes {[round(w, 1) for w in rec['writes']]} ms; peak memory "
          f"{peak:.2f} GiB; launches {json.dumps({k: v for k, v in fit_launches.items() if v})}")
    print(f"framework[vit]: snapshots written {json.dumps(written)}; scores.json {json.dumps(trainer.checkpoint_scores)}, "
          f"checkpoints on disk {on_disk}, rolled back to {scores[:1]}: {rolled_back}; final {json.dumps(trainer.final_results.metric_values)}; last losses "
          f"{json.dumps(losses[-1])}; {len(unmoved)} of {len(trained)} trained parameters unmoved")
    check(steps == FW_STEPS and len(losses) == steps, f"{steps} steps, {len(losses)} recorded")
    check(all(math.isfinite(v) for items in losses for v in items.values()), f"losses {losses}")
    check(eval_batches == monitors + 1 and len(rec["evals"]) == monitors + 1,
          f"{eval_batches} evaluation batches in {len(rec['evals'])} passes, {monitors} monitors")
    check(fit_launches == want, f"fit launches {fit_launches} != {want}")
    # scores may tie (the accuracy moves by 1/64, the AUC saturates): the kept ones rank at or above the evicted
    check(len(written) == monitors and len(set(written.values())) >= 2,
          f"{monitors} monitors, snapshots {written}: one a monitor, at least two scores")
    check(len(scores) == FW_KEEP and set(scores) <= set(written)
          and min(written[f] for f in scores) >= max(written[f] for f in evicted)
          and written[scores[0]] == max(written.values()),
          f"scores.json {scores} is not the best {FW_KEEP} of the snapshots {written}, best first")
    check(on_disk == sorted(scores), f"scores {scores} against the files {on_disk}")
    check(rolled_back, f"the model after the fit is not its best checkpoint {scores[:1]}")
    check(not unmoved, f"trained parameters did not move: {unmoved[:5]}")
    out["vit"] = {"steps": steps, "batch": FW_BATCH, "fit_s": fit_s, "trainer_step_ms": step_ms,
                  "trainer_step_windows_ms": windows, "bare_step_ms": bare_step_ms,
                  "loop_ms_per_step": step_ms - bare_step_ms, "eval_pass_ms": min(rec["evals"]),
                  "eval_passes_ms": rec["evals"], "checkpoint_writes_ms": rec["writes"], "eval_batches": eval_batches, "monitors": monitors,
                  "peak_memory_gib": peak, "launches": {k: v for k, v in fit_launches.items() if v},
                  "launches_per_step": {"flash_fwd_lse": VIT_LAYERS, "flash_bwd_fused": VIT_LAYERS},
                  "launches_per_eval_batch": {"flash_attention": VIT_LAYERS}, "checkpoints": on_disk,
                  "snapshots": written, "scores": trainer.checkpoint_scores, "rolled_back_to": scores[0], "final_metrics": trainer.final_results.metric_values,
                  "losses": losses}

    # save, load, predict, evaluate: 12 flash forwards a batch of 64
    saved = cflearn_torch.save(p, os.path.join(root, "saved"))
    loaded = cflearn_torch.load_inference(saved)
    calls = {}
    for name, fn in (("predict", lambda: p.predict(xv, batch_size=FW_VALID_BATCH)["predictions"]),
                     ("loaded_predict", lambda: loaded.predict(xv, batch_size=FW_VALID_BATCH)["predictions"]),
                     ("evaluate", lambda: cflearn_torch.evaluate(
                         loaded, xv, yv, metrics="acc", verbose=False, batch_size=FW_VALID_BATCH)["pipeline"])):
        reset_launches(A, Cv, Gn)
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        got = read_launches(A, Cv, Gn)
        calls[name] = (result, (time.perf_counter() - t0) * 1e3, got)
        want = dict.fromkeys(got, 0)
        want["flash_attention"] = VIT_LAYERS
        check(got == want, f"{name} launches {got} != {want}")
    pred, pred_loaded = calls["predict"][0], calls["loaded_predict"][0]
    same = bool(np.array_equal(pred, pred_loaded))
    acc = calls["evaluate"][0].metric_values["acc"]
    print(f"framework[vit]: saved to {sorted(os.listdir(saved))}; predict {pred.shape} in "
          f"{calls['predict'][1]:.1f} ms, loaded {calls['loaded_predict'][1]:.1f} ms, bit for bit: {same}; evaluate "
          f"acc {acc:.4f} in {calls['evaluate'][1]:.1f} ms; launches {VIT_LAYERS} flash_attention each")
    check(pred.shape == (FW_VALID, classes) and bool(np.isfinite(pred).all()), f"predictions {pred.shape}")
    check(same, "the loaded pipeline's predictions differ from the trained pipeline's")
    check(acc == float(np.mean(np.argmax(pred, -1) == yv[:, 0])), "evaluate's accuracy")
    out["vit"].update(predict_ms=calls["predict"][1], loaded_predict_ms=calls["loaded_predict"][1],
                      evaluate_ms=calls["evaluate"][1], predictions_bit_equal=same, evaluate_acc=acc)
    del loaded, calls, pred, pred_loaded

    # the first step through the kernels (in the fit) against the plain path on its state and batch
    parity = first_step_parity(torch, model, rec, A, Cv, Gn, random_moves=False)
    print(f"framework parity: first step's loss through the kernels {parity['loss']:.6f}, plain "
          f"{parity['loss_plain']:.6f} (off {parity['loss_err']:.3e}, tolerance {parity['loss_tolerance']:.3e}); "
          f"gradients global {parity['global_rel']:.3e}, leaf max {parity['leaf_max_rel']:.3e} (global tolerance "
          f"{parity['global_tolerance']:.3e}: {TRAIN_PARITY_FACTOR} x the one-ulp drift {parity['drift_global']:.3e})")
    check(parity["loss_err"] <= parity["loss_tolerance"], "the first step's loss disagrees with the plain path")
    check(parity["global_rel"] <= parity["global_tolerance"], "the first step's gradients disagree")
    out["vit"]["parity"] = {k: parity[k] for k in ("loss_err", "loss_tolerance", "drift_loss", "global_rel",
                                                   "leaf_max_rel", "drift_global")}
    del p, trainer, model, rec, x, xt, xv
    torch.cuda.empty_cache()

    # ae_kl at phase 7's workload through fit_array: the two scopes' kernels, phase 7's launches a step
    side = AE_CONFIG["img_size"]
    images = (torch.rand((FW_AE_IMAGES, side, side, 3), generator=gen) * 2.0 - 1.0).numpy()
    ae_config = cflearn_torch.DLConfig(
        model="ae_kl", module_name="ae_kl", module_config=dict(AE_CONFIG), seed=0, mixed_precision="bf16",
        fixed_steps=AE_STEPS, workspace=os.path.join(root, "ae"), callback_names=[],
    )
    ae_data = cflearn_torch.DataConfig()
    ae_data.batch_size = AE_BATCH
    torch.cuda.reset_peak_memory_stats()
    reset_launches(A, Cv, Gn)
    t0 = time.perf_counter()
    ae_p = cflearn_torch.fit_array(images, config=ae_config, data_config=ae_data, skip_final_evaluation=True)
    torch.cuda.synchronize()
    ae_s = time.perf_counter() - t0
    ae_launches = read_launches(A, Cv, Gn)
    ae_steps = ae_p.trainer.state.step
    want = dict.fromkeys(ae_launches, 0)
    want.update(conv3x3=3 * AE_CONVS * ae_steps, conv3x3_wgrad=AE_CONVS * ae_steps,
                group_norm=2 * GN_PER_AE_FORWARD * ae_steps, flash_fwd_lse=AE_FLASH * ae_steps,
                flash_bwd_fused=AE_FLASH * ae_steps, flash_attention=AE_FLASH * ae_steps)
    ae_losses = ae_p.trainer.intermediate.metric_values if ae_p.trainer.intermediate else {}
    ae_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"framework[ae_kl]: fit_array at {side} px, batch {AE_BATCH}, bf16 compute, {ae_steps} steps in {ae_s:.2f} s "
          f"(the model's build and files included), peak memory {ae_peak:.2f} GiB, monitored losses "
          f"{json.dumps(ae_losses)}, launches {json.dumps({k: v for k, v in ae_launches.items() if v})}")
    check(ae_steps == AE_STEPS, f"ae_kl: {ae_steps} steps")
    check(ae_losses and all(math.isfinite(v) for v in ae_losses.values()), f"ae_kl losses {ae_losses}")
    check(ae_launches == want, f"ae_kl launches {ae_launches} != {want}")
    # the trained model, kept for phase 22's export (which removes it)
    ae_saved = os.path.join(tempfile.mkdtemp(prefix="framework_ae_"), "ae_kl.npz")
    ae_p.model.save(ae_saved)
    out["ae_kl"] = {"steps": ae_steps, "batch": AE_BATCH, "fit_s": ae_s, "peak_memory_gib": ae_peak,
                    "losses": ae_losses, "launches": {k: v for k, v in ae_launches.items() if v},
                    "saved_model": ae_saved}
    del ae_p
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return out


# phase 21: the tabular side at the JAX package's defaults
COVTYPE_ROWS = 581012  # UCI Covertype: 10 float columns, wilderness area (4 values), soil type (40), 7 classes
COVTYPE_CLASSES = 7
COVTYPE_NAN = 0.01  # NaN cells among the float columns
TAB_FCNN_STEPS = 150  # a monitor every TAB_FCNN_WINDOW steps: the first window timed, the second profiled
TAB_FCNN_WINDOW = 50
MNIST_ROWS, MNIST_COLUMNS, MNIST_CLASSES = 70000, 784, 10
TAB_LAYERS, TAB_HEADS, TAB_HEAD_DIM = 4, 8, 16  # the "transformer" defaults: latent 32, mixers 4 x 32 over 8 heads
TAB_TOKENS = MNIST_COLUMNS + 1  # the features and the head token
TAB_BATCH = 128  # `MLConfig`'s and `DataConfig`'s default batch
TAB_TF_STEPS, TAB_TF_WINDOW = 12, 4  # a monitor every 4 steps: the second window timed, the third profiled
TAB_PREDICT_ROWS = 1024


def covtype_table(np, seed: int):
    """Covertype's raw shape from a seed (no file is read): an object table of 10 float columns (1% NaN cells),
    the wilderness area as one of 4 strings and the soil type as one of 40, and 7 classes labelled by a seeded
    linear rule of the features, so that the loss can fall."""
    rs = np.random.RandomState(seed)
    n = COVTYPE_ROWS
    floats = rs.randn(n, 10) * rs.uniform(0.5, 200.0, 10) + rs.uniform(-10.0, 3000.0, 10)
    area, soil = rs.randint(0, 4, n), rs.randint(0, 40, n)
    score = ((floats - floats.mean(0)) / floats.std(0)) @ rs.randn(10, COVTYPE_CLASSES)
    score += rs.randn(4, COVTYPE_CLASSES)[area] + 0.5 * rs.randn(40, COVTYPE_CLASSES)[soil]
    y = score.argmax(1)[:, None]
    floats[rs.rand(n, 10) < COVTYPE_NAN] = np.nan
    x = np.empty((n, 12), dtype=object)
    x[:, :10] = floats
    x[:, 10] = np.array([f"Wilderness_Area{i + 1}" for i in range(4)], dtype=object)[area]
    x[:, 11] = np.array([f"Soil_Type{i + 1}" for i in range(40)], dtype=object)[soil]
    return x, y


def mnist_table(np, seed: int):
    """MNIST's shape from a seed: 70,000 rows of 784 pixel columns in [0, 1] (bf16-representable, so that a
    one-ulp move is defined), labelled 0-9 by a seeded linear rule."""
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 256, (MNIST_ROWS, MNIST_COLUMNS)).astype(np.float32) / 255.0
    x = x.astype(np.float32)
    w = rs.randn(MNIST_COLUMNS, MNIST_CLASSES).astype(np.float32)
    y = ((x - 0.5) @ w).argmax(1)[:, None]
    return x, y


@contextlib.contextmanager
def recording_fit(torch, rec, *, block_classes=(), profile_window=None):
    """Record in `rec` what a fit makes, through the `Trainer`'s, the inference's and the blocks' own methods:
    the first step's state, batch, loss and gradients (`state0`, `batch0`, `loss0`, `grads0`); every step's loss
    items (`items`); the monitors' edges, synchronised (`edges`: ("in" or "out", step, host s)); each evaluation
    pass's ms, synchronised (`evals`), and the batches the inference ran (`batches`); each snapshot with its score
    (`snapshots`), its write's ms with the writer thread drained (`writes`: the windows then hold the steps alone)
    and when it ended (`saved_at`); each of `block_classes`' host seconds (`blocks`: its `fit_transform`, the
    transform inside it included); for the steps in `profile_window` (first, last), a `torch.profiler` trace of
    the device's kernels (`profile`). The methods are the originals again when the block exits."""
    from cflearn_torch.constants import LOSS_KEY
    from cflearn_torch.inference import DLInference
    from cflearn_torch.trainer import Trainer

    rec.update(items=[], edges=[], evals=[], batches=0, snapshots={}, writes=[], saved_at={}, blocks={}, profile=None)
    originals = (Trainer._train_step, Trainer._monitor_step, Trainer._get_metrics, DLInference._eval,
                 Trainer.save_checkpoint)
    block_originals = {cls: cls.fit_transform for cls in block_classes}

    def timed_block(cls):
        def fit_transform(self, bundle):
            t0 = time.perf_counter()
            out = block_originals[cls](self, bundle)
            rec["blocks"][cls.__name__] = rec["blocks"].get(cls.__name__, 0.0) + time.perf_counter() - t0
            return out

        return fit_transform

    def train_step(self, batch, state):
        step = state.step  # the step this call runs (the loop counts it first)
        if not rec["items"]:
            rec["state0"] = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
            rec["batch0"] = {k: v.clone() for k, v in batch.items() if torch.is_tensor(v)}
        if profile_window and step == profile_window[0]:
            torch.cuda.synchronize()
            rec["profiler"] = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            rec["profiler"].__enter__()
            rec["profile_t0"] = time.perf_counter()
        items = originals[0](self, batch, state)
        if not rec["items"]:
            rec["loss0"] = items[LOSS_KEY].item()
            rec["grads0"] = {n: g.detach().clone() for n, g in self.step_fn.steps["all"].grads.items()}
        if profile_window and step == profile_window[1]:
            torch.cuda.synchronize()
            wall = (time.perf_counter() - rec["profile_t0"]) * 1e3
            prof = rec.pop("profiler")
            prof.__exit__(None, None, None)
            kernels = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
            device = sum(e.self_device_time_total for e in kernels) / 1e3
            flash = sum(e.self_device_time_total for e in kernels if "flash" in e.key) / 1e3
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
            rec["profile"] = {"steps": profile_window[1] - profile_window[0] + 1, "wall_ms": wall, "device_ms": device,
                              "idle_share": 1.0 - device / wall if wall > 0 else float("nan"),
                              "kernel_launches": sum(e.count for e in kernels), "flash_device_ms": flash,
                              "flash_launches": sum(e.count for e in kernels if "flash" in e.key),
                              "flash_share_of_wall": flash / wall if wall > 0 else float("nan"),
                              "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top]}
        rec["items"].append(items)
        return items

    def monitor_step(self, state):
        torch.cuda.synchronize()
        rec["edges"].append(("in", state.step, time.perf_counter()))
        result = originals[1](self, state)
        torch.cuda.synchronize()
        rec["edges"].append(("out", state.step, time.perf_counter()))
        return result

    def get_metrics(self, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = originals[2](self, **kwargs)
        torch.cuda.synchronize()
        rec["evals"].append((time.perf_counter() - t0) * 1e3)
        return result

    def run_eval(self, *args, **kwargs):
        rec["batches"] += 1
        return originals[3](self, *args, **kwargs)

    def save_checkpoint(self, score, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec["snapshots"][f"model_{self.state.step}.npz"] = score
        result = originals[4](self, score, *args, **kwargs)
        self._drain_checkpoints()
        rec["saved_at"][self.state.step] = time.perf_counter()
        rec["writes"].append((rec["saved_at"][self.state.step] - t0) * 1e3)
        return result

    (Trainer._train_step, Trainer._monitor_step, Trainer._get_metrics, DLInference._eval,
     Trainer.save_checkpoint) = (train_step, monitor_step, get_metrics, run_eval, save_checkpoint)
    for cls in block_classes:
        cls.fit_transform = timed_block(cls)
    try:
        yield rec
    finally:
        (Trainer._train_step, Trainer._monitor_step, Trainer._get_metrics, DLInference._eval,
         Trainer.save_checkpoint) = originals
        for cls, fn in block_originals.items():
            cls.fit_transform = fn
        edges = rec["edges"]
        # between the exit of one monitor (its checkpoint's write included) and the entry of the next: the steps
        # of the loop, synchronised at both ends; and each monitor from its entry to its exit
        rec["windows"] = [(t_in - rec["saved_at"].get(s_out, t_out)) * 1e3 / (s_in - s_out)
                          for (k_out, s_out, t_out), (k_in, s_in, t_in) in zip(edges[1::2], edges[2::2])
                          if k_out == "out" and k_in == "in" and s_in > s_out]
        rec["monitors_ms"] = [(t_out - t_in) * 1e3 for (k_in, _, t_in), (k_out, _, t_out) in zip(edges[::2], edges[1::2])
                              if k_in == "in" and k_out == "out"]


def fit_ml_recorded(torch, np, cflearn_torch, A, Cv, Gn, x, y, config, *, profile_window=None, counts=None):
    """`cflearn_torch.fit_ml(x, y, config=config)` on the card under `recording_fit`, each ML block's host
    seconds included, and, into `counts` where given, the census of the serving kernels' calls (the launch
    counters are reset before the census starts and read after it ends: it swaps the wrappers). Returns
    (pipeline, record, launches of the fit, seconds of the fit)."""
    from cflearn_torch.data.blocks import ml as blocks

    block_classes = (blocks.FileParserBlock, blocks.RecognizerBlock, blocks.NanHandlerBlock, blocks.SplitterBlock,
                     blocks.PreProcessorBlock, blocks.GatherBlock)
    rec = {}
    with recording_fit(torch, rec, block_classes=block_classes, profile_window=profile_window):
        reset_launches(A, Cv, Gn)
        t0 = time.perf_counter()
        with census(A, Cv, Gn, counts) if counts is not None else contextlib.nullcontext():
            p = cflearn_torch.fit_ml(x, y, config=config)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read_launches(A, Cv, Gn)
    return p, rec, launches, fit_s


def first_step_parity(torch, model, rec, A, Cv, Gn, columns=None, random_moves=True):
    """The first step's loss and gradients (through the kernels, in the fit) against the plain path on its
    state and batch, within TRAIN_PARITY_FACTOR x the plain path's drift (phase 19's rule). The drift is the
    largest of one-bf16-ulp moves of the input's `columns` (all where None; the categorical columns are indices
    and stay put): every value away from zero and towards zero (phase 20's), and with `random_moves` twice in
    directions drawn at random (phase 8's four). Each error's share of its gate is in `margins`."""
    from cflearn_torch.constants import INPUT_KEY, LOSS_KEY
    from cflearn_torch.optimizers import build_optimizer
    from cflearn_torch.trainer import TrainStepFn

    model.load_state_dict(rec["state0"])
    core = TrainStepFn(model, build_optimizer("sgd", 0.0))
    batch0 = rec["batch0"]
    x0 = batch0[INPUT_KEY]
    mask = torch.zeros_like(x0, dtype=torch.bool)
    mask[..., slice(None) if columns is None else columns] = True

    def fwd_bwd(inputs):
        loss = core.loss_and_grads(dict(batch0, **{INPUT_KEY: inputs}))[LOSS_KEY].item()
        grads, core.grads = core.grads, {}
        return loss, grads

    with plain_kernels(A, Cv, Gn):
        loss_p, grads_p = fwd_bwd(x0)
        up = bump_ulp(torch, x0)
        moves = {"away": up, "towards": x0 - (up - x0)}
        if random_moves:
            moves.update({f"random{seed}": bump_ulp_random(torch, x0, seed) for seed in AE_DRIFT_SEEDS})
        drifts = {}
        for label, moved in moves.items():
            loss_u, grads_u = fwd_bwd(torch.where(mask, moved, x0))
            drifts[label] = (abs(loss_u - loss_p), grad_errors(grads_u, grads_p)["global_rel"])
    drift_loss = max(d[0] for d in drifts.values())
    drift_global = max(d[1] for d in drifts.values())
    err = grad_errors(rec["grads0"], grads_p)
    tol_loss = max(TRAIN_PARITY_FACTOR * drift_loss, 1e-6 * abs(loss_p))
    tol_global = TRAIN_PARITY_FACTOR * drift_global
    loss_err = abs(rec["loss0"] - loss_p)
    out = {"loss": rec["loss0"], "loss_plain": loss_p, "loss_err": loss_err, "loss_tolerance": tol_loss,
           "drift_loss": drift_loss, "global_rel": err["global_rel"], "leaf_max_rel": err["leaf_max_rel"],
           "drift_global": drift_global, "global_tolerance": tol_global, "drifts": drifts,
           "margins": {"loss": loss_err / tol_loss, "global_rel": err["global_rel"] / tol_global if tol_global else
                       float("inf") if err["global_rel"] else 0.0},
           "ok": loss_err <= tol_loss and err["global_rel"] <= tol_global}
    return out


def phase_tabular(torch, np, F, cflearn_torch, A, Cv, Gn) -> dict:
    """The tabular side as its users drive it, on the card. (a) `cflearn_torch.fit_ml` at the JAX package's
    defaults (`MLConfig(module_name="fcnn")`: hidden [64, 64], BatchNorm, batch 128, Adam behind the warm-up) on
    a table of Covertype's raw shape (581,012 rows: 10 float columns with 1% NaN cells, a 4-value and a 40-value
    string column, 7 classes), the bundled block stack splitting off 10% for validation, TAB_FCNN_STEPS steps
    with a monitor every TAB_FCNN_WINDOW (the second window traced by `torch.profiler` for the device's idle
    share), then `save`, `load_inference`, `predict` on the validation rows and `evaluate`. Gates: the recogniser
    marks the two string columns categorical and "ml.common" builds its `Encoder`; finite losses; every trained
    parameter moved; the loaded pipeline's predictions bit for bit the trained one's; the first step's loss and
    gradients against the plain path (phase 19's rule; no kernel runs on this path, so both are the same
    PyTorch ops); no kernel launched. (b) the "transformer" at its defaults (4 layers, latent 32, 8 heads of
    16, f32) on a table of MNIST's shape (70,000 rows of 784 columns, 10 classes): 785 tokens, so rows 1, 3 and
    4 at d = 16, TAB_TF_STEPS steps with a monitor every TAB_TF_WINDOW (the last window traced by
    `torch.profiler` for the flash kernels' share of the step). Gates: exact launches (4 `flash_fwd_lse` and 4
    `flash_bwd_fused` a step, 4 `flash_attention` an evaluation or predict batch), each distinct `flash_attention` call of the census against its plain
    version with phase 2's tolerances (phase 2 holds the train shapes), the first step's loss and gradients
    against the plain f32 path (phase 19's rule, `first_step_parity`), the loaded pipeline's predictions bit for bit. Prints the block stack's host seconds
    by block, ms a step through the `Trainer`, each monitor's ms with its evaluation pass's and its checkpoint
    write's, and predict rows/s."""
    import shutil
    import tempfile

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"tabular: {msg}")

    out = {}
    root = tempfile.mkdtemp(prefix="tabular_")

    # (a) fcnn at the defaults on Covertype's shape
    t0 = time.perf_counter()
    x, y = covtype_table(np, 51)
    make_s = time.perf_counter() - t0
    config = cflearn_torch.MLConfig(
        module_name="fcnn", workspace=os.path.join(root, "fcnn"), fixed_steps=TAB_FCNN_STEPS,
        max_step_per_snapshot=TAB_FCNN_WINDOW, callback_names=[],
    )
    np.random.seed(0)
    p, rec, launches, fit_s = fit_ml_recorded(
        torch, np, cflearn_torch, A, Cv, Gn, x, y, config,
        profile_window=(TAB_FCNN_WINDOW * 2 + 1, TAB_FCNN_WINDOW * 3))
    model, trainer = p.model, p.trainer
    recognizer = p.data.processor.try_get_block(cflearn_torch.RecognizerBlock)
    types = recognizer.column_types
    steps = trainer.state.step
    losses = [{k: v.item() for k, v in items.items()} for items in rec["items"]]
    state = model.state_dict()
    trained = [n for n, _ in model.params_filter("all")]
    unmoved = [n for n in trained if torch.equal(state[n], rec["state0"][n])]
    n_params = sum(p_.numel() for _, p_ in model.named_parameters())
    blocks_s = rec["blocks"]
    step_ms = rec["windows"][0] if rec["windows"] else float("nan")
    eval_batch_ms = sum(rec["evals"]) / rec["batches"] if rec["batches"] else float("nan")
    print(f"tabular[fcnn]: Covertype's shape {x.shape} made in {make_s:.2f} s; fit_ml {steps} steps (fixed_steps "
          f"{config.fixed_steps}, CI flag {os.environ.get('CI', '0')}) in {fit_s:.2f} s; block stack host s "
          f"{json.dumps({k: round(v, 3) for k, v in blocks_s.items()})} (total {sum(blocks_s.values()):.2f}); "
          f"{p.data.num_train} train / {p.data.num_valid} valid rows; column types {json.dumps(types)}; encoder "
          f"{json.dumps(model.config.encoder_settings)}; {n_params} parameters; ms a step through the Trainer "
          f"{step_ms:.3f} (windows {[round(w, 3) for w in rec['windows']]}, the second under torch.profiler); "
          f"profiled window {json.dumps(rec['profile'])}; monitors in to out ms {[round(m, 1) for m in rec['monitors_ms']]}"
          f", of which evaluation passes ms {[round(e, 1) for e in rec['evals']]} ({rec['batches']} batches: "
          f"{eval_batch_ms:.3f} ms a batch of {TAB_BATCH}) and checkpoint writes ms "
          f"{[round(w, 1) for w in rec['writes']]}; last losses {json.dumps(losses[-1])}; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}")
    check(steps == TAB_FCNN_STEPS and len(losses) == steps, f"{steps} steps")
    check(types["10"] == types["11"] == "categorical" and all(types[str(j)] == "numerical" for j in range(10)),
          f"column types {types}")
    check(model.config.model == "ml.common" and model.encoder is not None
          and sorted(model.encoder.embeds) == ["10", "11"], "ml.common did not build the encoder")
    check(all(math.isfinite(v) for items in losses for v in items.values()), f"losses {losses[-3:]}")
    check(not unmoved, f"trained parameters did not move: {unmoved}")
    check(not any(launches.values()), f"kernels launched on the fcnn path: {launches}")
    # save, load, predict as many raw rows as the validation set holds (through the block stack), evaluate
    valid_x = x[: p.data.num_valid]
    saved = cflearn_torch.save(p, os.path.join(root, "fcnn_saved"))
    loaded = cflearn_torch.load_inference(saved)
    t0 = time.perf_counter()
    pred = p.predict(valid_x)["predictions"]
    predict_s = time.perf_counter() - t0
    pred_loaded = loaded.predict(valid_x)["predictions"]
    same = bool(np.array_equal(pred, pred_loaded))
    t0 = time.perf_counter()
    acc = cflearn_torch.evaluate(loaded, valid_x, y[: p.data.num_valid], metrics="acc", verbose=False)[
        "pipeline"].metric_values["acc"]
    evaluate_s = time.perf_counter() - t0
    parity = first_step_parity(torch, model, rec, A, Cv, Gn, columns=slice(0, 10))
    print(f"tabular[fcnn]: predict {pred.shape} in {predict_s:.3f} s ({len(valid_x) / predict_s:.0f} rows/s, the "
          f"block stack's transform included), loaded bit for bit: {same}; evaluate acc {acc:.4f} in "
          f"{evaluate_s:.3f} s; first step parity {json.dumps(parity)}")
    check(pred.shape == (len(valid_x), COVTYPE_CLASSES) and bool(np.isfinite(pred).all()), f"predictions {pred.shape}")
    check(same, "the loaded pipeline's predictions differ from the trained pipeline's")
    check(parity["ok"], "the first step's loss or gradients disagree with the plain path")
    out["fcnn"] = {"rows": int(x.shape[0]), "columns": int(x.shape[1]), "steps": steps, "batch": TAB_BATCH,
                   "fit_s": fit_s, "block_stack_s": blocks_s, "trainer_step_ms": step_ms, "windows_ms": rec["windows"],
                   "profiled_window": rec["profile"], "monitors_ms": rec["monitors_ms"], "eval_passes_ms": rec["evals"],
                   "eval_batches": rec["batches"], "eval_batch_ms": eval_batch_ms,
                   "checkpoint_writes_ms": rec["writes"], "params": n_params, "num_train": p.data.num_train,
                   "num_valid": p.data.num_valid, "predict_rows_per_s": len(valid_x) / predict_s,
                   "predict_s": predict_s, "evaluate_s": evaluate_s, "evaluate_acc": acc,
                   "predictions_bit_equal": same, "parity": parity, "last_losses": losses[-1]}
    del p, loaded, model, trainer, rec, x, valid_x
    torch.cuda.empty_cache()

    # (b) the transformer at its defaults on MNIST's shape
    t0 = time.perf_counter()
    x, y = mnist_table(np, 52)
    make_s = time.perf_counter() - t0
    config = cflearn_torch.MLConfig(
        module_name="transformer", workspace=os.path.join(root, "transformer"), fixed_steps=TAB_TF_STEPS,
        max_step_per_snapshot=TAB_TF_WINDOW, callback_names=[],
    )
    counts = {}
    np.random.seed(1)
    p, rec, launches, fit_s = fit_ml_recorded(torch, np, cflearn_torch, A, Cv, Gn, x, y, config, counts=counts,
                                              profile_window=(TAB_TF_WINDOW * 2 + 1, TAB_TF_WINDOW * 3))
    model, trainer = p.model, p.trainer
    steps, eval_batches = trainer.state.step, rec["batches"]
    attn = model.m.encoder.blocks[0].token_mixer.net
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd_lse=TAB_LAYERS * steps, flash_bwd_fused=TAB_LAYERS * steps,
                flash_attention=TAB_LAYERS * eval_batches)
    losses = [{k: v.item() for k, v in items.items()} for items in rec["items"]]
    state = model.state_dict()
    trained = [n for n, _ in model.params_filter("all")]
    unmoved = [n for n in trained if torch.equal(state[n], rec["state0"][n])]
    n_params = sum(p_.numel() for _, p_ in model.named_parameters())
    step_ms = rec["windows"][0] if rec["windows"] else float("nan")
    blocks_s = rec["blocks"]
    print(f"tabular[transformer]: MNIST's shape {x.shape} made in {make_s:.2f} s; fit_ml {steps} steps in "
          f"{fit_s:.2f} s; block stack host s {json.dumps({k: round(v, 3) for k, v in blocks_s.items()})} (total "
          f"{sum(blocks_s.values()):.2f}); {len(model.m.encoder.blocks)} layers, {attn.num_heads} heads of "
          f"{attn.head_dim}, {n_params} parameters; ms a step through the Trainer {step_ms:.2f} (windows "
          f"{[round(w, 2) for w in rec['windows']]}, the second under torch.profiler); profiled window "
          f"{json.dumps(rec['profile'])}; monitors in to out ms {[round(m, 1) for m in rec['monitors_ms']]}, of "
          f"which evaluation passes ms {[round(e, 1) for e in rec['evals']]}; {eval_batches} evaluation batches; "
          f"last losses "
          f"{json.dumps(losses[-1])}; launches {json.dumps({k: v for k, v in launches.items() if v})}")
    check((len(model.m.encoder.blocks), attn.num_heads, attn.head_dim) == (TAB_LAYERS, TAB_HEADS, TAB_HEAD_DIM),
          "the transformer's defaults")
    check(steps == TAB_TF_STEPS and all(math.isfinite(v) for items in losses for v in items.values()),
          f"{steps} steps, losses {losses}")
    check(launches == want, f"fit launches {launches} != {want}")
    census_total = sum(n for key, n in counts.items() if key[0] == "flash_attention")
    check(census_total == launches["flash_attention"], f"the census counts {census_total} forward calls")
    check(not unmoved, f"trained parameters did not move: {unmoved[:5]}")
    # every distinct forward call of the fit's census against its plain version, timed beside SDPA
    calls = [check_call(torch, F, A, Cv, Gn, key, torch.Generator(device="cuda").manual_seed(7))
             for key in sorted(counts) if key[0] == "flash_attention"]
    for row in calls:
        print(f"tabular[transformer] call: {json.dumps(row)}")
    check(calls and all(r["shape"][2:] == [TAB_TOKENS, TAB_TOKENS, TAB_HEAD_DIM] for r in calls),
          f"census shapes {[r['shape'] for r in calls]}")
    # predict a batch-aligned slice, save, load, predict again
    rows = x[:TAB_PREDICT_ROWS]
    reset_launches(A, Cv, Gn)
    t0 = time.perf_counter()
    pred = p.predict(rows, batch_size=TAB_BATCH)["predictions"]
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    got = read_launches(A, Cv, Gn)
    want = dict.fromkeys(got, 0)
    want["flash_attention"] = TAB_LAYERS * (TAB_PREDICT_ROWS // TAB_BATCH)
    loaded = cflearn_torch.load_inference(cflearn_torch.save(p, os.path.join(root, "transformer_saved")))
    same = bool(np.array_equal(loaded.predict(rows, batch_size=TAB_BATCH)["predictions"], pred))
    parity = first_step_parity(torch, model, rec, A, Cv, Gn)
    print(f"tabular[transformer]: predict {pred.shape} in {predict_s:.3f} s ({len(rows) / predict_s:.0f} rows/s), "
          f"launches {json.dumps({k: v for k, v in got.items() if v})}, loaded bit for bit: {same}; first step "
          f"parity {json.dumps(parity)}")
    check(got == want, f"predict launches {got} != {want}")
    check(pred.shape == (len(rows), MNIST_CLASSES) and bool(np.isfinite(pred).all()), f"predictions {pred.shape}")
    check(same, "the loaded pipeline's predictions differ from the trained pipeline's")
    check(parity["ok"], "the first step's loss or gradients disagree with the plain path")
    out["transformer"] = {"rows": int(x.shape[0]), "columns": int(x.shape[1]), "tokens": TAB_TOKENS, "steps": steps,
                          "batch": TAB_BATCH, "fit_s": fit_s, "block_stack_s": blocks_s, "trainer_step_ms": step_ms,
                          "windows_ms": rec["windows"], "profiled_window": rec["profile"],
                          "monitors_ms": rec["monitors_ms"], "eval_passes_ms": rec["evals"], "params": n_params,
                          "eval_batches": eval_batches,
                          "launches": {k: v for k, v in launches.items() if v},
                          "launches_per_step": {"flash_fwd_lse": TAB_LAYERS, "flash_bwd_fused": TAB_LAYERS},
                          "launches_per_eval_batch": {"flash_attention": TAB_LAYERS},
                          "predict_launches": {k: v for k, v in got.items() if v}, "predict_launches_all": got,
                          "launches_all": launches,
                          "predict_rows_per_s": len(rows) / predict_s, "predictions_bit_equal": same,
                          "calls": calls, "parity": parity, "last_losses": losses[-1]}
    del p, loaded, model, trainer, rec, x
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return out


# phase 22: the rest of the framework — image folders, the CV blocks, fit, the image callbacks, ensembles, export,
# CUDA-graph capture, third-party evaluation, VQVAEInference

CVF_IMAGES = 512  # seeded images in CVF_CLASSES class folders, sides in CVF_SIDES
CVF_CLASSES = 10
CVF_SIDES = (400, 480)
CVF_SIZE = 384  # ResizedPreparation(384): the ViT-S/16 at 384 px (H6 L577 d256: rows 1, 3, 4)
CVF_BATCH = 32
CVF_STEPS = 16
CVF_MEMBERS = (0, 1, 2)  # the ensemble's seeds
CVF_VALID_SPLIT = 0.1  # 51 validation images
CVF_BLOCKS = {"block_names": ["static_normalize", "affine_normalize"],
              "block_configs": {"affine_normalize": {"center": 0.5, "scale": 0.5}}}  # uint8 -> [-1, 1]
CVF_REPLAYS = 3
VQI_IMAGES, VQI_SIZE, VQI_BATCH, VQI_STEPS, VQI_SAMPLES = 256, 64, 64, 4, 16


def make_image_folder(np, src: str, seed: int) -> bool:
    """CVF_IMAGES images in CVF_CLASSES class folders, sides drawn from CVF_SIDES, each a class colour over a
    smooth ramp plus noise in 4 x 4 blocks; JPEG (quality 95) where PIL imports (returns True), else `.npy`
    arrays (returns False)."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    rs = np.random.RandomState(seed)
    colours = rs.randint(40, 216, (CVF_CLASSES, 3))
    for i in range(CVF_IMAGES):
        c = i % CVF_CLASSES
        folder = os.path.join(src, f"class_{c}")
        os.makedirs(folder, exist_ok=True)
        h, w = rs.randint(CVF_SIDES[0], CVF_SIDES[1] + 1, 2)
        ramp = np.linspace(-30.0, 30.0, w)[None, :, None] + np.linspace(-20.0, 20.0, h)[:, None, None]
        noise = rs.randint(-40, 41, (-(-h // 4), -(-w // 4), 3)).repeat(4, 0).repeat(4, 1)[:h, :w]
        img = np.clip(colours[c] + ramp + noise, 0, 255).astype(np.uint8)
        if Image is None:
            np.save(os.path.join(folder, f"{i:04d}.npy"), img)
        else:
            Image.fromarray(img).save(os.path.join(folder, f"{i:04d}.jpg"), quality=95)
    return Image is not None


def phase_cv_framework(torch, np, cflearn_torch, A, Cv, Gn, ae_saved: str) -> dict:
    """The rest of the framework as its users run it, at full width, f32 unless said:
    1. an image folder made from a seed (CVF_IMAGES images of 400-480 px in 10 classes, JPEG), packed by
       `prepare_image_folder` at 384 px (`ResizedPreparation(384)`) into rcache stores built from the port's
       own source (`cflearn_torch/native/rcache.cpp`); without PIL the same arrays are written as `.npy` and
       packed by the same step (a line says so);
    2. three members trained from it: `ImageFolderData` -> the CV blocks (`static_normalize`,
       `affine_normalize`: [-1, 1]) -> `DLTrainingPipeline.fit` of "clf" with the ViT-S/16 encoder (phase 19's
       config) at batch 32, CVF_STEPS steps, "acc" every monitor, `ImageClassificationCallback` writing its
       grid, each from its own seed; then `save`. Gates: finite losses, exact launches (12 `flash_fwd_lse` and
       12 `flash_bwd_fused` a step, 12 `flash_attention` an evaluation batch), the callback's grid on disk;
    3. `fuse_inference` over the three folders: `predict` on the valid split equals the mean of the members'
       own raw predictions, bit for bit; `fuse_evaluation` scores the fused outputs (its accuracy that of the
       fused predictions);
    4. member 0 exported (`export_model`, then `load_exported` on the card): exactly the flash operation nodes
       the eager forward launches (12), one call moving the launch counter by as many, the outputs bit for bit
       the eager `predict`'s at the export's batch (else within PARITY_FACTOR x the one-ulp drift);
    5. phase 20's trained `ae_kl` (bf16 compute, its posterior mode) exported the same way: the conv, GroupNorm
       and flash operation nodes equal to its eager forward's launches, one call launching them, bit for bit;
    6. `aot_compile` of member 0 and of the `ae_kl`: the CUDA-graph replay bit for bit the eager forward, the
       capture's launches the eager forward's, the counters still during replays (launches = captures x
       replays);
    7. `GeneralEvaluationPipeline` over an `IPredictor` that returns member 0's predictions: the accuracy that
       `load_evaluation(...).evaluate` gives member 0;
    8. `VQVAEInference` over a "vq_vae" at 64 px (phase 19's config) fitted by `fit_array`: the code export,
       a "pixel_cnn" prior fitted VQI_STEPS steps on the codes, `sample`; no kernel launched.
    Reports the prepare's seconds, ms a step through the `Trainer`, each write's and callback's ms, the fused
    predict's rows/s beside a member's own, the export's trace seconds, and the eager, exported and captured
    forwards' device ms (CUDA-graph replay; the captured one by its own replay)."""
    import shutil
    import tempfile

    from cflearn_torch.callbacks.generator import ImageClassificationCallback
    from cflearn_torch.data.cv import image_folder as IF
    from cflearn_torch.data.utils import ArrayDataset, ArrayLoader
    from cflearn_torch.native import has_native
    from cflearn_torch.pipeline.export import KERNEL_OPS
    from cflearn_torch.schema.data import DataProcessorConfig

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"cv framework: {msg}")

    out = {"card": card_line()}
    root = tempfile.mkdtemp(prefix="cv_framework_")
    src, packed = os.path.join(root, "images"), os.path.join(root, "packed")

    # 1. the image folder, packed
    t0 = time.perf_counter()
    pil = make_image_folder(np, src, 20)
    made_s = time.perf_counter() - t0
    check(has_native(), "the rcache library did not build from cflearn_torch/native/rcache.cpp")
    preparation = IF.ResizedPreparation(CVF_SIZE)
    saved_loader = IF._load_image
    if not pil:
        print("cv framework: PIL is not importable here: the seeded images are written as .npy arrays and "
              "packed by the same prepare_image_folder step (its decode reads the arrays)")
        preparation.is_ready = lambda path: path.endswith(".npy")
        IF._load_image = np.load
    np.random.seed(20)
    t0 = time.perf_counter()
    try:
        cflearn_torch.prepare_image_folder(src, packed, preparation=preparation, valid_split=CVF_VALID_SPLIT)
    finally:
        IF._load_image = saved_loader
    prepare_s = time.perf_counter() - t0
    with open(os.path.join(packed, "meta.json")) as f:
        meta = json.load(f)
    counts = {k: sum(s["num"] for s in v) for k, v in meta["shards"].items()}
    print(f"cv framework: {CVF_IMAGES} images ({'JPEG' if pil else 'npy'}) made in {made_s:.2f} s, packed at "
          f"{CVF_SIZE} px into rcache stores in {prepare_s:.2f} s ({prepare_s / CVF_IMAGES * 1e3:.1f} ms an image: "
          f"decode, resize on the host, write), splits {counts}, {len(meta['classes'])} classes [{out['card']}]")
    check(meta["native"] and meta["image_shape"] == [CVF_SIZE, CVF_SIZE, 3] and sum(counts.values()) == CVF_IMAGES
          and len(meta["classes"]) == CVF_CLASSES, f"packed folder {meta}")
    out["prepare"] = {"images": CVF_IMAGES, "pil": pil, "make_s": made_s, "prepare_s": prepare_s, "splits": counts}

    def image_data(batch_size):
        config = cflearn_torch.DataConfig()
        config.batch_size = config.valid_batch_size = batch_size
        return cflearn_torch.ImageFolderData.from_folder(packed, config=config,
                                                         processor_config=DataProcessorConfig(**CVF_BLOCKS))

    # 2. three members trained from the folder, each written with its callback's grids
    callback_ms = []
    log_artifacts = ImageClassificationCallback.log_artifacts

    def timed_log_artifacts(self, trainer):
        torch.cuda.synchronize()
        t = time.perf_counter()
        log_artifacts(self, trainer)
        callback_ms.append((time.perf_counter() - t) * 1e3)

    folders, members_out = [], []
    ImageClassificationCallback.log_artifacts = timed_log_artifacts
    try:
        for seed in CVF_MEMBERS:
            rec = {}
            callback_ms.clear()
            with recording_fit(torch, rec):
                config = cflearn_torch.DLConfig(
                    **vit_config(CVF_SIZE), seed=seed, workspace=os.path.join(root, f"member_{seed}"),
                    metric_names=["acc"], min_num_sample=0, num_snapshot_per_epoch=2, fixed_steps=CVF_STEPS,
                    max_snapshot_file=1, callback_names=["image_classification"],
                )
                reset_launches(A, Cv, Gn)
                np.random.seed(seed)
                t0 = time.perf_counter()
                p = cflearn_torch.DLTrainingPipeline.init(config).fit(image_data(CVF_BATCH))
                torch.cuda.synchronize()
                fit_s = time.perf_counter() - t0
                launches = read_launches(A, Cv, Gn)
            steps = p.trainer.state.step
            want = dict.fromkeys(launches, 0)
            want.update(flash_fwd_lse=VIT_LAYERS * steps, flash_bwd_fused=VIT_LAYERS * steps,
                        flash_attention=VIT_LAYERS * rec["batches"])
            losses = [v.item() for items in rec["items"] for v in items.values()]
            grids = sorted(os.path.relpath(os.path.join(r, f), p.trainer.workspace)
                           for r, _, fs in os.walk(os.path.join(p.trainer.workspace, "images")) for f in fs)
            t0 = time.perf_counter()
            saved = cflearn_torch.save(p, os.path.join(root, f"saved_{seed}"))
            save_ms = (time.perf_counter() - t0) * 1e3
            step_ms = min(rec["windows"]) if rec["windows"] else float("nan")
            print(f"cv framework[member {seed}]: {steps} steps at batch {CVF_BATCH} in {fit_s:.2f} s, {step_ms:.2f} ms "
                  f"a step through the Trainer (of {[round(w, 2) for w in rec['windows']]}), evaluation passes "
                  f"{[round(e, 1) for e in rec['evals']]} ms ({rec['batches']} batches), checkpoint writes "
                  f"{[round(w, 1) for w in rec['writes']]} ms, image_classification callback "
                  f"{[round(c, 1) for c in callback_ms]} ms ({grids}), save {save_ms:.1f} ms; launches "
                  f"{json.dumps({k: v for k, v in launches.items() if v})} [{out['card']}]")
            check(steps == CVF_STEPS and losses and all(math.isfinite(v) for v in losses), f"member {seed}: losses")
            check(launches == want, f"member {seed}: launches {launches} != {want}")
            check(grids and all(g.endswith("batch.png") for g in grids) and len(grids) == len(callback_ms),
                  f"member {seed}: the callback's grids {grids}")
            folders.append(saved)
            members_out.append({"seed": seed, "steps": steps, "fit_s": fit_s, "trainer_step_ms": step_ms,
                                "step_windows_ms": rec["windows"], "eval_passes_ms": rec["evals"],
                                "checkpoint_writes_ms": rec["writes"], "callback_ms": list(callback_ms),
                                "save_ms": save_ms, "grids": grids,
                                "launches": {k: v for k, v in launches.items() if v}})
            del p, rec
            torch.cuda.empty_cache()
    finally:
        ImageClassificationCallback.log_artifacts = log_artifacts
    out["members"] = members_out

    # 3. the ensemble: the fused predict is the members' mean, bit for bit
    valid_loader = image_data(CVF_BATCH).get_loaders()[1]
    n_valid = len(valid_loader.dataset)
    members = [cflearn_torch.load_inference(f) for f in folders]
    own = []
    for m in members:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        own.append(m.predict(valid_loader)["predictions"])
        torch.cuda.synchronize()
        member_s = time.perf_counter() - t0
    fused = cflearn_torch.fuse_inference(folders)
    fused.predict(valid_loader)
    reset_launches(A, Cv, Gn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused_pred = fused.predict(valid_loader)["predictions"]
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    fused_launches = read_launches(A, Cv, Gn)
    mean = np.mean(own, axis=0)
    same = bool(np.array_equal(fused_pred, mean))
    evaluation = cflearn_torch.fuse_evaluation(folders).evaluate(valid_loader)
    labels = valid_loader.get_full_batch()["labels"][:, 0]
    fused_acc = float(np.mean(np.argmax(mean, -1) == labels))
    valid_batches = -(-n_valid // CVF_BATCH)
    print(f"cv framework[fuse]: {len(folders)} members, predict of the {n_valid} validation images "
          f"{fused_s * 1e3:.1f} ms "
          f"({n_valid / fused_s:.1f} rows/s; a member alone {member_s * 1e3:.1f} ms, {n_valid / member_s:.1f} rows/s), "
          f"the members' mean bit for bit: {same}; fuse_evaluation {json.dumps(evaluation.metric_values)} (accuracy of "
          f"the fused predictions {fused_acc:.4f}); launches "
          f"{json.dumps({k: v for k, v in fused_launches.items() if v})} "
          f"[{out['card']}]")
    check(same, "the fused predictions are not the members' mean")
    check(abs(evaluation.metric_values["acc"] - fused_acc) <= 1e-12,
          "fuse_evaluation does not score the fused predictions")
    want = dict.fromkeys(fused_launches, 0)
    want["flash_attention"] = VIT_LAYERS * valid_batches * len(folders)
    check(fused_launches == want, f"fused predict launches {fused_launches} != {want}")
    out["fuse"] = {"members": len(folders), "rows": n_valid, "fused_ms": fused_s * 1e3,
                   "fused_rows_per_s": n_valid / fused_s,
                   "member_ms": member_s * 1e3, "member_rows_per_s": n_valid / member_s, "mean_bit_for_bit": same,
                   "evaluation": evaluation.metric_values, "launches": {k: v for k, v in fused_launches.items() if v}}

    def kernel_launches(fn):
        reset_launches(A, Cv, Gn)
        result = fn()
        torch.cuda.synchronize()
        return result, {k: v for k, v in read_launches(A, Cv, Gn).items() if v}

    def export_case(label, model, batch, forward_kwargs, eager_reference):
        """export_model -> load_exported of `model` at `batch`; aot_compile; the gates of steps 4-6."""
        with torch.no_grad():
            eager, eager_launches = kernel_launches(lambda: model.run(
                {k: v.clone() for k, v in batch.items()}, training=False, **forward_kwargs))
        folder = os.path.join(root, f"export_{label}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cflearn_torch.export_model(model, batch, folder, forward_kwargs=forward_kwargs)
        export_s = time.perf_counter() - t0
        exported = cflearn_torch.load_exported(folder, device="cuda")
        ops = exported.op_counts()
        node_launches = {KERNEL_OPS[k]: v for k, v in ops.items()}
        got, exported_launches = kernel_launches(lambda: exported(batch))
        reference = eager_reference if eager_reference is not None else eager["predictions"]
        bit = bool(torch.equal(got["predictions"], reference))
        if not bit:
            with torch.no_grad():
                moved = model.run({k: bump_ulp(torch, v) if v.is_floating_point() else v for k, v in batch.items()},
                                  training=False, **forward_kwargs)["predictions"]
            drift = rel_err(moved.float(), eager["predictions"].float())
            off = rel_err(got["predictions"].float(), reference.float())
            print(f"cv framework[{label}]: the exported forward is {off:.3e} from the eager one (the one-ulp drift "
                  f"{drift:.3e}); the program's non-kernel nodes are torch.export's: "
                  f"{sorted({str(n.target) for n in exported.program.graph.nodes if n.op == 'call_function'})[:12]}")
            check(off <= PARITY_FACTOR * drift, f"{label}: the exported forward disagrees with the eager one")
        compiled = cflearn_torch.aot_compile(model, batch, forward_kwargs=forward_kwargs)
        reset_launches(A, Cv, Gn)
        replayed = [compiled(batch)["predictions"] for _ in range(CVF_REPLAYS)]
        torch.cuda.synchronize()
        during_replays = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
        replay_bit = all(torch.equal(r, reference) for r in replayed)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CVF_REPLAYS):
            compiled.replay()
        end.record()
        torch.cuda.synchronize()
        captured_ms = start.elapsed_time(end) / CVF_REPLAYS
        with torch.no_grad():
            eager_ms = device_ms(torch, lambda: model.run(batch, training=False, **forward_kwargs), calls=2, replays=2)
            exported_ms = device_ms(torch, lambda: exported.module(batch), calls=2, replays=2)
        print(f"cv framework[{label}]: export traced and saved in {export_s:.2f} s; program nodes {json.dumps(ops)}, "
              f"eager launches {json.dumps(eager_launches)}, one exported call {json.dumps(exported_launches)}; "
              f"outputs bit for bit: {bit}; aot_compile: {compiled.replays} replays bit for bit: {replay_bit}, the "
              f"capture's launches {json.dumps(compiled.launches_per_replay)} x {compiled.replays} replays, counters "
              f"during the replays {json.dumps(during_replays)}; device ms a forward (CUDA-graph replay): eager "
              f"{eager_ms:.3f}, exported {exported_ms:.3f}, aot_compile {captured_ms:.3f} [{out['card']}]")
        check(node_launches == eager_launches, f"{label}: program nodes {ops} against eager launches {eager_launches}")
        check(exported_launches == eager_launches, f"{label}: an exported call launched {exported_launches}")
        check(compiled.launches_per_replay == eager_launches and compiled.replays == 2 * CVF_REPLAYS
              and not during_replays, f"{label}: the capture launched {compiled.launches_per_replay}, replays moved "
              f"the counters {during_replays}")
        check(replay_bit, f"{label}: the CUDA-graph replay differs from the eager forward")
        return {"export_s": export_s, "program_ops": ops, "eager_launches": eager_launches,
                "exported_launches": exported_launches, "bit_for_bit": bit, "aot_bit_for_bit": replay_bit,
                "aot_launches_per_replay": compiled.launches_per_replay, "aot_replays": compiled.replays,
                "device_ms": {"eager": eager_ms, "exported": exported_ms, "aot_compile": captured_ms}}

    # 4. member 0 exported at the validation loader's first batch; its predict's rows for it as the reference
    model = members[0].model
    first = next(iter(valid_loader))
    vit_batch = {"input": torch.from_numpy(first["input"]).cuda()}
    out["export_vit"] = export_case("vit", model, vit_batch, {}, torch.from_numpy(own[0][:CVF_BATCH]).cuda())
    check(out["export_vit"]["program_ops"] == {"cflearn_torch::flash_attention": VIT_LAYERS},
          f"the exported ViT holds {out['export_vit']['program_ops']}")

    # 5. phase 20's ae_kl, bf16 compute, the posterior's mode
    ae = cflearn_torch.IDLModel.load(ae_saved, device="cuda")
    ae.m.to(torch.bfloat16)
    side = AE_CONFIG["img_size"]
    ae_x = (torch.rand((AE_BATCH, side, side, 3), generator=torch.Generator().manual_seed(22)) * 2 - 1)
    ae_batch = {"input": ae_x.to("cuda", torch.bfloat16)}
    out["export_ae_kl"] = export_case("ae_kl", ae, ae_batch, {"sample": False}, None)
    check(set(out["export_ae_kl"]["program_ops"]) == {"cflearn_torch::conv3x3", "cflearn_torch::group_norm_silu",
                                                      "cflearn_torch::flash_attention"},
          f"the exported ae_kl holds {out['export_ae_kl']['program_ops']}")
    del ae, ae_batch
    shutil.rmtree(os.path.dirname(ae_saved), ignore_errors=True)

    # 7. a third-party predictor scored by the framework's metrics: member 0's own predictions
    class MemberPredictor(cflearn_torch.IPredictor):
        def predict(self, x):
            return members[0].predict(ArrayLoader(ArrayDataset({"input": x}), batch_size=CVF_BATCH))["predictions"]

    general = cflearn_torch.GeneralEvaluationPipeline(cflearn_torch.DLConfig(metric_names=["acc"]), MemberPredictor())
    third = general.evaluate(valid_loader).metric_values
    own_eval = cflearn_torch.load_evaluation(folders[0]).evaluate(valid_loader).metric_values
    print(f"cv framework[third party]: GeneralEvaluationPipeline {json.dumps(third)}, member 0's evaluate "
          f"{json.dumps(own_eval)}")
    # one accuracy of the full batch against the batches' accuracies weighted by their sizes: equal to rounding
    check(abs(third["acc"] - own_eval["acc"]) <= 1e-12, "the third-party score differs from the member's own")
    out["third_party"] = {"general": third, "member": own_eval}
    del members, fused, model
    torch.cuda.empty_cache()

    # 8. VQVAEInference over a 64 px vq_vae: the code export, a PixelCNN prior, samples; no kernel on this path
    gen = torch.Generator().manual_seed(23)
    vq_x = (torch.rand((VQI_IMAGES, VQI_SIZE, VQI_SIZE, 3), generator=gen) * 2 - 1).numpy()
    data_config = cflearn_torch.DataConfig()
    data_config.batch_size = VQI_BATCH
    reset_launches(A, Cv, Gn)
    t0 = time.perf_counter()
    vq = cflearn_torch.fit_array(vq_x[:192], None, vq_x[192:], config=cflearn_torch.DLConfig(
        model="vq_vae", module_name="vq_vae", workspace=os.path.join(root, "vq"), fixed_steps=VQI_STEPS,
        min_num_sample=0, callback_names=[], metric_names=None), data_config=data_config, skip_final_evaluation=True)
    torch.cuda.synchronize()
    vq_fit_ms = (time.perf_counter() - t0) * 1e3
    prior_config = cflearn_torch.DLConfig(model="ar", module_name="pixel_cnn", module_config={
        "num_codes": vq.model.m.num_codes, "img_size": vq.model.m.latent_resolution, "in_channels": 1},
        workspace=os.path.join(root, "prior"), fixed_steps=VQI_STEPS, min_num_sample=0, callback_names=[])
    t0 = time.perf_counter()
    inference = cflearn_torch.VQVAEInference(prior_config, workspace=os.path.join(root, "vq_inference"),
                                             vqvae_log_folder=vq.trainer.workspace)
    codes_data = cflearn_torch.ArrayData.init(data_config).fit(vq_x[:192], None, vq_x[192:])
    inference.export_code_indices(codes_data, inference.code_export_folder)
    torch.cuda.synchronize()
    codes_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    inference.fit(codes_data, data_config)
    torch.cuda.synchronize()
    prior_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    samples = inference.sample(VQI_SAMPLES)
    torch.cuda.synchronize()
    sample_ms = (time.perf_counter() - t0) * 1e3
    vq_launches = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
    codes = np.load(os.path.join(inference.code_export_folder, "train.npy"))
    print(f"cv framework[vq_vae inference]: vq_vae fit_array {VQI_STEPS} steps at {VQI_SIZE} px {vq_fit_ms:.1f} ms; "
          f"pack, load and the code export of {VQI_IMAGES} images {codes_ms:.1f} ms (codes {codes.shape}); the "
          f"pixel_cnn prior fit {VQI_STEPS} steps {prior_ms:.1f} ms; sample {VQI_SAMPLES} images {sample_ms:.1f} ms "
          f"{samples.shape}; launches {json.dumps(vq_launches)} [{out['card']}]")
    check(codes.shape[1:] == (inference.vqvae.latent_resolution,) * 2 and codes.max() < inference.vqvae.num_codes,
          f"codes {codes.shape}")
    check(samples.shape == (VQI_SAMPLES, VQI_SIZE, VQI_SIZE, 3) and bool(np.isfinite(samples).all()), "samples")
    check(not vq_launches, f"kernels launched on the VQ-VAE path: {vq_launches}")
    out["vq_vae_inference"] = {"vq_fit_ms": vq_fit_ms, "codes_ms": codes_ms, "prior_fit_ms": prior_ms,
                               "sample_ms": sample_ms, "codes_shape": list(codes.shape)}
    del vq, inference
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return out


# 23. the ControlNet annotators and DiffusionAPI.compile: DPT-Large (24 blocks, 16 heads of 64) on a 512x512
# image is L = 32 x 32 + 1 = 1025 tokens, f32; the other nets at full width; SD-1.5 at 512px, batch 1, 20 steps
DPT_FLASH = 24
ANNOTATOR_SIDE = 512
HAND_BOX = 368  # `detect_hand_peaks`'s crop side
NET_REL = 1e-4  # an f32 net on the card against the same net on the CPU: summation order (TF32 is off)
COMPILE_CONFIGS = ("lossless", "faithful", "accelerated")


def bump_ulp_f32(torch, x):
    """x moved one f32 ulp away from zero."""
    return (x.float().view(torch.int32) + 1).view(torch.float32)


def seeded_(torch, net, seed: int):
    """Fill `net`'s parameters in place from a generator on their device: weights ~ N(0, 1 / fan_in), 1-D
    parameters at 0 (biases) or 1 (norm weights), the position and class tokens ~ N(0, 0.02^2)."""
    gen = torch.Generator(device=next(net.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(("pos_embed", "cls_token")):
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * 0.02)
            elif p.ndim > 1:
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * p[0].numel() ** -0.5)
            else:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
    return net


def dpt_large_checkpoint(torch, TM, folder: str, image, seed: int = 0) -> str:
    """A seeded DPT-Large state dict in the upstream layout, written to `folder`/dpt_large.pt. The depth head's
    last bias is set so that its map on `image` sits above the head's ReLU (1 above its least value there)."""
    with torch.device("meta"):
        net = TM.DPTDepth("dpt_large")
    net = seeded_(torch, net.to_empty(device="cuda"), seed).eval()
    head = net.scratch.output_conv[4]
    pre = []
    hook = head.register_forward_hook(lambda mod, args, out: pre.append(out.detach()))
    with torch.no_grad():
        net(torch.as_tensor(image[None], device="cuda").float().div(127.5).sub(1.0))
    hook.remove()
    with torch.no_grad():
        head.bias.fill_(1.0 - pre[0].min().item())
    path = os.path.join(folder, "dpt_large.pt")
    torch.save({k: v.cpu() for k, v in net.state_dict().items()}, path)
    return path


def compile_configs(torch, np, cflearn_torch, A, Cv, Gn) -> dict:
    """Phase 23 (d): `DiffusionAPI.compile(num_samples=1, size=(512, 512), num_steps=20)` in the lossless,
    faithful and accelerated configurations against the eager txt2img of the same API, seed and prompt."""
    from cflearn_torch.modules.common import redraw_zero_init
    from cflearn_torch.modules.multimodal.diffusion.samplers import deepcache_refresh_mask
    from cflearn_torch.pipeline.sd import ACCEL_DC, FAITHFUL_DC, TOME_RATIO

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"compile: {msg}")

    api = cflearn_torch.DiffusionAPI.from_sd("v1", device="cuda", seed=0)
    redraw_zero_init(api.m, seed=1)
    kw = dict(num_steps=API_STEPS, guidance_scale=7.5, seed=0)

    def profiled(fn):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        device = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        return (1.0 - device / wall) if device > 0 else None

    out = {}
    for config in COMPILE_CONFIGS:
        interval, cut = {"lossless": (None, 1), "faithful": FAITHFUL_DC, "accelerated": ACCEL_DC}[config]
        api.set_tome_ratio(0.0 if config == "lossless" else TOME_RATIO)
        api.set_deepcache(interval, cut=cut)
        api._compiled.clear()  # the previous configuration's bucket: this one's eager run first
        api.txt2img(PROMPT, **kw)  # warm-up
        torch.cuda.synchronize()
        reset_launches(A, Cv, Gn)
        t0 = time.perf_counter()
        eager = api.txt2img(PROMPT, **kw)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        eager_launches = read_launches(A, Cv, Gn)
        full = API_STEPS if interval is None else int(deepcache_refresh_mask(API_STEPS, interval).sum())
        shallow = API_STEPS - full
        want = dict.fromkeys(eager_launches, 0)
        want.update(flash_attention=FLASH_PER_UNET * full + FLASH_PER_SHALLOW * shallow + 1, conv3x3=DECODER_CONVS,
                    group_norm=GN_PER_UNET * full + GN_PER_SHALLOW * shallow + GN_PER_DECODE)
        check(eager_launches == want, f"{config}: eager launches {eager_launches} != {want}")
        t0 = time.perf_counter()
        api.compile(num_samples=1, size=(512, 512), num_steps=API_STEPS)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        graphs = len(api._graphs)
        api.txt2img(PROMPT, **kw)  # the first replays
        torch.cuda.synchronize()
        reset_launches(A, Cv, Gn)
        before = api.graph_launches()
        t0 = time.perf_counter()
        compiled = api.txt2img(PROMPT, **kw)
        torch.cuda.synchronize()
        compiled_ms = (time.perf_counter() - t0) * 1e3
        counted = read_launches(A, Cv, Gn)
        replayed = {k: n - before.get(k, 0) for k, n in api.graph_launches().items()}
        total = {k: counted[k] + replayed.get(k, 0) for k in counted}
        per_replay = {("shallow" if "deep_cache" in dict(key[:-1]) else "full"): call.launches_per_replay
                      for key, call in api._graphs.items()}
        same = bool(np.array_equal(compiled, eager))
        idle_compiled = profiled(lambda: api.txt2img(PROMPT, **kw))
        api._compiled.clear()  # the bucket forgotten: txt2img runs eagerly again
        idle_eager = profiled(lambda: api.txt2img(PROMPT, **kw))
        fmt = lambda v: "not measured" if v is None else f"{v:.3f}"  # noqa: E731
        print(f"compile[{config}]: {graphs} graphs captured in {compile_s:.1f} s (with one txt2img), launches per "
              f"replay {json.dumps(per_replay)}; eager {eager_ms:.1f} ms an image, compiled {compiled_ms:.1f} ms "
              f"({eager_ms / compiled_ms:.2f}x); idle share eager {fmt(idle_eager)}, compiled {fmt(idle_compiled)}; "
              f"launches eager {json.dumps({k: v for k, v in eager_launches.items() if v})}, compiled (counters + "
              f"replays) {json.dumps({k: v for k, v in total.items() if v})}; image bit for bit: {same} "
              f"[{card_line()}]")
        check(same, f"{config}: the compiled txt2img differs from the eager one")
        check(total == eager_launches, f"{config}: compiled launches {total} != eager {eager_launches}")
        check(counted == dict(want, flash_attention=1, group_norm=GN_PER_DECODE),
              f"{config}: outside the graphs the run launched {counted}, want the decode's alone")
        out[config] = {"graphs": graphs, "compile_s": compile_s, "eager_ms": eager_ms, "compiled_ms": compiled_ms,
                       "idle_share_eager": idle_eager, "idle_share_compiled": idle_compiled, "launches": total,
                       "bit_for_bit": same}
    api.set_tome_ratio(0.0)
    api.set_deepcache(None)
    out["style"] = compile_style(torch, np, A, Cv, Gn, api, profiled)
    del api
    torch.cuda.empty_cache()
    return out


def compile_style(torch, np, A, Cv, Gn, api, profiled) -> dict:
    """`compile` with phase 16's style reference set (a seeded 512² reference, fidelity 0.5, every block banks):
    one graph holds a UNet call's WRITE pass, the bank and its READ pass, the reference's noise drawn inside it
    from the API's registered generator. The compiled txt2img bit for bit the eager one; the eager run's launches
    exact (`style_flash_per_step` a step, the reference's encode each call), the graph's flash launches a replay
    `style_flash_per_step` and its replays the steps (flash launches = captures x replays), and outside the graph
    only the encode and the decode; host ms an image eager and compiled, and each one's device idle share."""
    from cflearn_torch.modules.multimodal.diffusion.unet import style_reference_write_gates

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"compile[style]: {msg}")

    kw = dict(num_steps=API_STEPS, guidance_scale=7.5, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(11)
    reference = torch.randint(0, 256, (512, 512, 3), generator=gen, device="cuda").to(torch.uint8).cpu().numpy()
    api.setup_hooks(style_reference_image=reference, style_reference_states=STYLE_STATES)
    gates = style_reference_write_gates(api.m.unet, STYLE_STATES["reference_weight"])
    per_step = style_flash_per_step(gates, STYLE_STATES["style_fidelity"], True)
    outside = {"flash_attention": 1 + ENCODER_FLASH, "conv3x3": DECODER_CONVS + ENCODER_CONVS,
               "group_norm": GN_PER_DECODE + GN_PER_ENCODE}
    api.txt2img(PROMPT, **kw)  # warm-up
    torch.cuda.synchronize()
    reset_launches(A, Cv, Gn)
    t0 = time.perf_counter()
    eager = api.txt2img(PROMPT, **kw)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    eager_launches = read_launches(A, Cv, Gn)
    want = dict.fromkeys(eager_launches, 0)
    want.update(outside, flash_attention=outside["flash_attention"] + per_step * API_STEPS,
                group_norm=outside["group_norm"] + 2 * GN_PER_UNET * API_STEPS)
    check(eager_launches == want, f"eager launches {eager_launches} != {want}")
    t0 = time.perf_counter()
    api.compile(num_samples=1, size=(512, 512), num_steps=API_STEPS)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    check(len(api._graphs) == 1, f"{len(api._graphs)} graphs captured, want 1 (the CFG batch's style call)")
    (key, call), = api._graphs.items()
    check(dict(key[:1]).get("hooks") == api._style_sig() and call.launches_per_replay.get("flash_attention") ==
          per_step, f"the graph's key {key[:1]}, flash launches a replay {call.launches_per_replay}")
    api.txt2img(PROMPT, **kw)  # the first replays
    torch.cuda.synchronize()
    reset_launches(A, Cv, Gn)
    replays0, before = call.replays, api.graph_launches()
    t0 = time.perf_counter()
    compiled = api.txt2img(PROMPT, **kw)
    torch.cuda.synchronize()
    compiled_ms = (time.perf_counter() - t0) * 1e3
    counted = read_launches(A, Cv, Gn)
    replays = call.replays - replays0
    replayed = {k: n - before.get(k, 0) for k, n in api.graph_launches().items()}
    total = {k: counted[k] + replayed.get(k, 0) for k in counted}
    same = bool(np.array_equal(compiled, eager))
    idle_compiled = profiled(lambda: api.txt2img(PROMPT, **kw))
    api._compiled.clear()  # the bucket forgotten: txt2img runs eagerly again
    idle_eager = profiled(lambda: api.txt2img(PROMPT, **kw))
    api.setup_hooks()
    fmt = lambda v: "not measured" if v is None else f"{v:.3f}"  # noqa: E731
    print(f"compile[style]: 1 graph (WRITE + bank + READ) captured in {compile_s:.1f} s (with one txt2img), launches "
          f"per replay {json.dumps(call.launches_per_replay)}, {replays} replays; eager {eager_ms:.1f} ms an image, "
          f"compiled {compiled_ms:.1f} ms ({eager_ms / compiled_ms:.2f}x); idle share eager {fmt(idle_eager)}, "
          f"compiled {fmt(idle_compiled)}; launches eager {json.dumps({k: v for k, v in eager_launches.items() if v})}"
          f", compiled (counters + replays) {json.dumps({k: v for k, v in total.items() if v})}; image bit for bit: "
          f"{same} [{card_line()}]")
    check(same, "the compiled style-reference txt2img differs from the eager one")
    check(replays == API_STEPS and replayed.get("flash_attention") == per_step * replays,
          f"{replays} replays, their flash launches {replayed.get('flash_attention')} != {per_step} x {replays}")
    check(total == eager_launches, f"compiled launches {total} != eager {eager_launches}")
    check(counted == dict(want, **outside), f"outside the graph the run launched {counted}, want {outside}")
    return {"graphs": 1, "compile_s": compile_s, "eager_ms": eager_ms, "compiled_ms": compiled_ms,
            "idle_share_eager": idle_eager, "idle_share_compiled": idle_compiled, "launches": total,
            "flash_per_replay": per_step, "replays": replays, "bit_for_bit": same}


def phase_annotators_compile(torch, np, F, cflearn_torch, A, Cv, Gn) -> dict:
    """Drive the annotators, `get_hint_of` into `sample_with_control`, and `DiffusionAPI.compile` as a user would.

    (a) depth: a seeded DPT-Large checkpoint (upstream layout) through `Annotator.make("depth", {"ckpt": ...})`
    on a 512² image: exactly 24 flash launches a forward (B1 H16 L1025 d64 f32), the raw depth through the kernels
    against the plain route within PARITY_FACTOR x the plain route's f32 drift: the larger of its move under a
    one-f32-ulp move of the image and its distance from the same forward with the library's f32 attention.
    (b) HED, PiDiNet, M-LSD and OpenPose (body, and hand on a 368² crop), seeded, at full width on the card against
    the same nets on the CPU (NET_REL), no kernel launched; each annotator's host ms an image.
    (c) `get_hint_of("depth")` -> `sample_with_control` on SD-1.5 with one full-width ControlNet, 512², 20 steps:
    exact launches (the controlled path's plus 24).
    (d) `compile(num_samples=1, size=(512, 512), num_steps=20)` in the lossless, faithful and accelerated
    configurations: the compiled txt2img bit for bit the eager one, its launches (the counters' and the graphs'
    launches per replay x replays) the eager run's exactly; host ms an image eager and compiled, and each one's
    device idle share from `torch.profiler`; then the same with a style reference set (`compile_style`)."""
    import tempfile

    from cflearn_torch.api.cv import annotator as TAnn
    from cflearn_torch.api.cv import third_party as TP
    from cflearn_torch.api.cv.third_party import midas as TM
    from cflearn_torch.modules.common import redraw_zero_init

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"annotators / compile: {msg}")

    out = {}
    try:
        import cv2  # noqa: F401

        has_cv2 = True
    except ImportError:
        has_cv2 = False
    print(f"annotators: cv2 imports: {has_cv2}" + ("" if has_cv2 else " (the nets run; the pose and mlsd annotate "
                                                                       "steps, which draw with cv2, are not run)"))
    out["cv2"] = has_cv2
    rng = np.random.RandomState(0)
    low = rng.uniform(0, 255, (ANNOTATOR_SIDE // 32, ANNOTATOR_SIDE // 32, 3))
    image = np.clip(np.kron(low, np.ones((32, 32, 1))) + rng.uniform(-20, 20, (ANNOTATOR_SIDE, ANNOTATOR_SIDE, 3)),
                    0, 255).astype(np.uint8)

    def host_ms(fn, runs=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / runs * 1e3

    with tempfile.TemporaryDirectory() as folder:
        # (a) DPT-Large depth
        t0 = time.perf_counter()
        ckpt = dpt_large_checkpoint(torch, TM, folder, image)
        t_ckpt = time.perf_counter() - t0
        t0 = time.perf_counter()
        depth = TAnn.Annotator.make("depth", {"ckpt": ckpt})
        t_load = time.perf_counter() - t0
        n_params = sum(p.numel() for p in depth._net.parameters())
        hint = depth.annotate(image)
        torch.cuda.synchronize()
        reset_launches(A, Cv, Gn)
        hint = depth.annotate(image)
        torch.cuda.synchronize()
        launches = read_launches(A, Cv, Gn)
        want = dict.fromkeys(launches, 0)
        want["flash_attention"] = DPT_FLASH
        check(launches == want, f"a DPT-Large forward launched {launches}, want {want}")
        check(hint.shape == (ANNOTATOR_SIDE, ANNOTATOR_SIDE, 3) and hint.dtype == np.uint8 and hint.max() == 255,
              f"depth hint {hint.shape} {hint.dtype} max {hint.max()}")
        x = torch.as_tensor(image[None], device="cuda").float().div(127.5).sub(1.0)
        with torch.no_grad():
            d_k = depth._net(x)
            with plain_kernels(A, Cv, Gn):
                d_p = depth._net(x)
                drifts = {"image_one_f32_ulp": rel_err(depth._net(bump_ulp_f32(torch, x)), d_p)}
                # the same forward with the library's f32 attention: exact f32 arithmetic in another order, as the
                # kernel's (a one-ulp move of the image alone stays under what f32 rounding at each of the 24
                # attentions reaches)
                A.flash_attention = lambda q, k, v, causal=False, sm_scale=None: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, scale=sm_scale)
                drifts["library_f32_attention"] = rel_err(depth._net(x), d_p)
        drift = max(drifts.values())
        rel = rel_err(d_k, d_p)
        print(f"depth: DPT-Large ({n_params / 1e6:.1f} M parameters) checkpoint written in {t_ckpt:.1f} s, loaded in "
              f"{t_load:.1f} s; launches {json.dumps({k: v for k, v in launches.items() if v})} a forward; kernels vs "
              f"plain max rel err {rel:.3e} (tolerance {PARITY_FACTOR * drift:.3e}: {PARITY_FACTOR} x the plain "
              f"route's f32 drift, the larger of {json.dumps(drifts)}); depth range [{d_k.min().item():.3f}, "
              f"{d_k.max().item():.3f}]")
        check(bool(torch.isfinite(d_k).all()) and rel <= PARITY_FACTOR * drift,
              "the DPT-Large forward through the kernels disagrees with the plain route")
        ms = {"depth": host_ms(lambda: depth.annotate(image))}
        out["depth"] = {"parameters": n_params, "launches": launches, "kernels_vs_plain": rel,
                        "drifts": drifts, "checkpoint_s": t_ckpt, "load_s": t_load}
        del d_k, d_p

        # (b) HED, PiDiNet, M-LSD, OpenPose at full width, the card against the CPU
        img_f = image.astype(np.float32)
        nets = {
            "hed": (TP.HED, img_f[None], lambda a: a),
            "pidi": (TP.PiDiNet, img_f[None] / 255.0, lambda a: a),
            "mlsd": (TP.MLSD, np.concatenate([img_f, np.ones_like(img_f[..., :1])], -1)[None] / 127.5 - 1.0,
                     lambda a: a),
            "openpose_body": (TP.OpenPoseBody, img_f[None] / 255.0 - 0.5, lambda a: a[1]),
            "openpose_hand": (TP.OpenPoseHand, img_f[None, :HAND_BOX, :HAND_BOX] / 256.0 - 0.5, lambda a: a),
        }
        cards = {}
        out["nets"] = {}
        for i, (name, (ctor, xin, pick)) in enumerate(nets.items()):
            cpu = seeded_(torch, ctor(), 10 + i).eval()
            card = copy.deepcopy(cpu).to("cuda")
            with torch.no_grad():
                ref = pick(cpu(torch.from_numpy(np.ascontiguousarray(xin))))
                reset_launches(A, Cv, Gn)
                got = pick(card(torch.from_numpy(np.ascontiguousarray(xin)).cuda()))
                torch.cuda.synchronize()
            moved = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
            err = rel_err(got.float().cpu(), ref)
            n = sum(p.numel() for p in cpu.parameters())
            print(f"annotators: {name} ({n / 1e6:.2f} M parameters) on {tuple(xin.shape)}: card vs CPU max rel err "
                  f"{err:.3e} (tolerance {NET_REL}), kernel launches {moved}")
            check(err <= NET_REL and not moved, f"{name}: card vs CPU {err:.3e}, launches {moved}")
            out["nets"][name] = {"parameters": n, "card_vs_cpu": err}
            cards[name] = card
            del cpu, ref, got
        soft = TAnn.Annotator.make("softedge", {})
        soft._hed = cards["hed"]
        pidi = TAnn.Annotator.make("pidi", {})
        pidi._net = cards["pidi"]
        ms["softedge"] = host_ms(lambda: soft.annotate(image))
        ms["pidi"] = host_ms(lambda: pidi.annotate(image))
        if has_cv2:
            mlsd = TAnn.Annotator.make("mlsd", {})
            mlsd._net = cards["mlsd"]
            pose = TAnn.Annotator.make("pose", {})
            pose._net = cards["openpose_body"]
            ms["mlsd"] = host_ms(lambda: mlsd.annotate(image))
            ms["pose"] = host_ms(lambda: pose.annotate(image))
            ms["hand_peaks"] = host_ms(lambda: TP.detect_hand_peaks(cards["openpose_hand"], image[:HAND_BOX, :HAND_BOX]))
        print(f"annotators: host ms an image at {ANNOTATOR_SIDE}² [{card_line()}]: {json.dumps(ms)}"
              + ("" if has_cv2 else "; mlsd, pose and the hand peaks: not measured (no cv2)"))
        out["host_ms"] = ms
        del cards, soft, pidi
        torch.cuda.empty_cache()

        # (c) get_hint_of("depth") -> sample_with_control, SD-1.5 with one full-width ControlNet
        capi = cflearn_torch.ControlledDiffusionAPI.from_sd("v1", device="cuda", seed=0)
        redraw_zero_init(capi.m, seed=1)
        seen = watch(capi.m)
        cn = cflearn_torch.build(cflearn_torch.ControlNet, device="cuda", dtype=torch.bfloat16, seed=2)
        redraw_zero_init(cn, seed=3)
        capi.prepare_control("depth", cn)
        capi.prepare_annotator("depth", ckpt=ckpt)
        del depth
        torch.cuda.empty_cache()
        want = serving(API_STEPS, controls=1)
        want["flash_attention"] += DPT_FLASH
        censuses = {}
        controlled, rec = drive_path(
            torch, A, Cv, Gn, "controlled", "depth",
            lambda: capi.sample_with_control(1, {"depth": capi.get_hint_of("depth", image)}, cond=PROMPT,
                                             num_steps=API_STEPS, seed=0), seen, want, censuses)
        check(controlled.shape == (1, 512, 512, 3) and [s[0] for s in seen["unet"]] == [2] * API_STEPS,
              f"controlled: image {controlled.shape}, UNet batches {[s[0] for s in seen['unet']]}")
        out["controlled"] = rec
        del capi, cn, seen, censuses
        torch.cuda.empty_cache()

    # (d) compile, bit for bit and launch for launch against the eager txt2img
    out["compile"] = compile_configs(torch, np, cflearn_torch, A, Cv, Gn)
    return out



# 24. pretrained weights from the cache: SD-1.5 and a depth ControlNet written as seeded upstream-layout files,
# served by the zoo's download cache, converted, loaded strictly, and sampled from
PRETRAINED_SEED = 24
PRETRAINED_FREE_BYTES = 12e9  # SD-1.5 f32 and its converted cache (4.27 GB each), the ControlNet's two (1.45 GB)


@contextlib.contextmanager
def no_network():
    """`urllib.request.urlretrieve` refused inside the block, the URLs asked for kept: a file that is not in the
    cache, or fails its sha, raises where the loader would reach for the network."""
    import urllib.request

    saved = urllib.request.urlretrieve
    tried = []

    def refuse(url, *args, **kwargs):
        tried.append(url)
        raise OSError(f"no network here: {url} is not fetched")

    urllib.request.urlretrieve = refuse
    try:
        yield tried
    finally:
        urllib.request.urlretrieve = saved


@contextlib.contextmanager
def timed_calls(torch, spans, targets):
    """Wrap each (module, attribute, span) of `targets` so that its host seconds (after a synchronize) add up in
    `spans[span]` = [seconds, calls]."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def wrap(fn, span):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans.setdefault(span, [0.0, 0])
            spans[span][0] += time.perf_counter() - t0
            spans[span][1] += 1
            return result

        return call

    for (mod, attr, fn), (_, _, span) in zip(saved, targets):
        setattr(mod, attr, wrap(fn, span))
    try:
        yield spans
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def phase_pretrained(torch, np, cflearn_torch, A, Cv, Gn) -> dict:
    """SD-1.5 from a 4.3 GB f32 `.safetensors` file in the upstream layout (seeded; the real file's dropped keys
    beside it) under a temporary `OPT.cache_dir`: `DiffusionAPI.from_sd("v1", pretrained=True)` (first use pins
    its sha) with every parameter bit for bit its source cast to bf16, txt2img at 512², 20 DDIM steps, CFG 7.5 with
    phase 12's launches and the image bit for bit that of the same weights given by `load_state_dict`, a second
    load from the converted cache; an f16 ControlNet under `control_v11f1p_sd15_depth.pth` refused by the entry's
    `min_size`, the f32 one loaded by `load_control_net("depth", pretrained=True)` and sampled with exactly phase
    12's controlled launches; one changed byte refused against its pin. No fetch is allowed: `no_network`. The host
    seconds and GB/s of the sha, the read, the convert, the move to the card, the converted cache's write and a
    load from it; the files go at the end."""
    import shutil
    import tempfile

    from cflearn_torch.modules.common import redraw_zero_init
    from cflearn_torch.parameters import OPT
    from cflearn_torch.toolkit import misc as M
    from cflearn_torch.zoo import common as Z
    from cflearn_torch.zoo import convert as C

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"pretrained: {msg}")

    out = {}
    root = tempfile.mkdtemp(prefix=".chip_smoke_pretrained_", dir=HERE)
    try:
        free = shutil.disk_usage(root).free
        print(f"pretrained: {free / 1e9:.1f} GB free under {root} ({PRETRAINED_FREE_BYTES / 1e9:.0f} GB needed)")
        check(free >= PRETRAINED_FREE_BYTES, f"{free / 1e9:.1f} GB free, {PRETRAINED_FREE_BYTES / 1e9:.0f} GB needed")
        try:
            import safetensors  # noqa: F401

            out["safetensors_package"] = True
        except ImportError:
            out["safetensors_package"] = False
        print(f"pretrained: `import safetensors` {'works' if out['safetensors_package'] else 'fails'} here")
        with OPT.opt_context({"cache_dir": root}), no_network() as tried:
            out.update(_pretrained_sd(torch, np, cflearn_torch, A, Cv, Gn, M, Z, C, redraw_zero_init, tried))
        print(f"pretrained: done, {json.dumps(out)}")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _pretrained_sd(torch, np, cflearn_torch, A, Cv, Gn, M, Z, C, redraw_zero_init, tried) -> dict:
    def check(ok, msg):
        if not ok:
            raise AssertionError(f"pretrained: {msg}")

    out = {}
    index = Z.get_available()["checkpoints"]
    download = M.get_download_cache_dir()
    # the source: SD-1.5 with seeded weights (the zero-initialised convs redrawn), f32 on the card
    src = cflearn_torch.zoo.load_sd("v1", device="cuda", dtype=torch.float32, seed=PRETRAINED_SEED)
    redraw_zero_init(src, seed=PRETRAINED_SEED + 1)
    source = {k: p.detach() for k, p in src.named_parameters()}
    schedule = {k: b.detach() for k, b in src.named_buffers() if k in C.SD_SCHEDULE_KEYS}
    del src
    upstream = C.invert(C.build_sd_mapping("v1"), source)
    # keys of the real file that no parameter takes: the noise schedule, the EMA's counters, CLIP's position ids
    upstream.update(schedule)
    upstream["model_ema.decay"] = torch.tensor(0.9999, device="cuda")
    upstream["model_ema.num_updates"] = torch.tensor(1000, dtype=torch.int32, device="cuda")
    upstream["cond_stage_model.transformer.text_model.embeddings.position_ids"] = torch.arange(
        77, device="cuda")[None]
    entry = index["sd_v1.5"]
    sd_path = download / entry["url"].split("/")[-1]
    t0 = time.perf_counter()
    C.write_safetensors(sd_path, upstream)
    write_s = time.perf_counter() - t0
    size = sd_path.stat().st_size
    print(f"pretrained: wrote {sd_path.name}, {len(upstream)} tensors, {size / 1e9:.3f} GB in {write_s:.1f} s "
          f"(the entry's min_size {entry['min_size'] / 1e9:.1f} GB)")
    check(size >= entry["min_size"], f"the seeded file is {size} bytes, under the entry's min_size")
    del upstream
    out["sd_file_bytes"] = size

    spans = {}
    targets = [(M, "compute_sha", "sha"), (C, "load_torch_state_dict", "read"), (Z, "convert_checkpoint", "convert"),
               (Z, "materialize", "materialize"), (Z, "load_into", "move"), (C, "write_safetensors", "cache_write"),
               (C, "read_safetensors", "safetensors_read")]
    t0 = time.perf_counter()
    with timed_calls(torch, spans, targets):
        api = cflearn_torch.DiffusionAPI.from_sd("v1", pretrained=True, device="cuda", seed=0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check(not tried, f"a fetch was asked for: {tried}")
    check(M._tofu_get(download, sd_path.name) is not None, "the first use pinned no sha")
    nbytes = sum(t.numel() * t.element_size() for t in source.values())
    wrong = [k for k, p in api.m.named_parameters() if not torch.equal(p, source[k].to(torch.bfloat16))]
    check(not wrong and len(source) == len(list(api.m.parameters())), f"parameters not bit for bit: {wrong[:5]}")
    readings = {"first_load_s": first_s, "file_gb": size / 1e9, "converted_gb": nbytes / 1e9}
    for span, (s, n) in spans.items():
        gb = size if span in ("sha", "read") else nbytes
        readings[span] = {"s": s, "calls": n, "gb_per_s": gb / 1e9 / s if s > 0 else None}
    print(f"pretrained: from_sd('v1', pretrained=True) {first_s:.2f} s, every parameter bit for bit; host s "
          f"(GB/s): " + ", ".join(f"{k} {v['s']:.3f} ({v['gb_per_s'] or 0:.2f})" for k, v in readings.items()
                                   if isinstance(v, dict)) + " (the file read from a warm page cache)")

    # txt2img: phase 12's default path, its launches exact, bit for bit the same weights given by load_state_dict
    reset_launches(A, Cv, Gn)
    t0 = time.perf_counter()
    image = api.txt2img(PROMPT, num_steps=API_STEPS, seed=0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
    want = serving(API_STEPS)
    check(api.sampler_name == "ddim", f"the default sampler is {api.sampler_name}")
    check(got == want, f"txt2img launches {got} != phase 12's {want}")
    check(image.shape == (1, 512, 512, 3) and image.dtype == np.uint8, f"image {image.shape} {image.dtype}")
    ref = cflearn_torch.DiffusionAPI.from_sd("v1", device="cuda", seed=0)
    result = ref.m.load_state_dict(source, strict=False)
    buffers = {k for k, _ in ref.m.named_buffers()}
    check(not result.unexpected_keys and set(result.missing_keys) <= buffers, "load_state_dict: keys differ")
    ref_image = ref.txt2img(PROMPT, num_steps=API_STEPS, seed=0)
    same = bool(np.array_equal(image, ref_image))
    print(f"pretrained: txt2img {ms:.1f} ms (its first call), launches {json.dumps(got)} = phase 12's, image bit for "
          f"bit the load_state_dict one: {same} (std {image.std():.2f})")
    txt2img_launches = got
    check(same, "the image differs from the one of the same weights given by load_state_dict")
    del ref, ref_image
    # the converter script on the same file: `scripts.sd.convert` -> `inject` into an API of other weights -> txt2img
    from cflearn_torch.scripts import sd as S

    t0 = time.perf_counter()
    states = S.convert(str(sd_path))
    convert_s = time.perf_counter() - t0
    script_api = cflearn_torch.DiffusionAPI.from_sd("v1", device="cuda", seed=1)
    S.inject(script_api, states)
    del states
    reset_launches(A, Cv, Gn)
    script_image = script_api.txt2img(PROMPT, num_steps=API_STEPS, seed=0)
    got = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
    script_same = bool(np.array_equal(script_image, image))
    print(f"pretrained: scripts.sd convert {convert_s:.2f} s -> inject -> txt2img, launches {json.dumps(got)}, the "
          f"image bit for bit the pretrained load's: {script_same}")
    check(got == want and script_same, "the converter script's image differs from the pretrained load's")
    del script_api, script_image
    torch.cuda.empty_cache()
    out["sd"] = dict(readings, txt2img_ms=ms, launches=txt2img_launches, image_bit_for_bit=same,
                     script_convert_s=convert_s, script_image_bit_for_bit=script_same)

    # a second load: from the converted cache, neither hashed nor converted again
    spans.clear()
    t0 = time.perf_counter()
    with timed_calls(torch, spans, targets):
        api2 = cflearn_torch.DiffusionAPI.from_sd("v1", pretrained=True, device="cuda", seed=0)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    check("sha" not in spans and "convert" not in spans and "read" not in spans, f"the second load ran {sorted(spans)}")
    check(all(torch.equal(a, b) for a, b in zip(api.m.parameters(), api2.m.parameters())), "second load differs")
    cache_read = spans.get("safetensors_read", [0.0, 0])[0] + spans.get("move", [0.0, 0])[0]
    print(f"pretrained: second load from the converted cache {second_s:.2f} s (its read and move {cache_read:.3f} s, "
          f"{nbytes / 1e9 / max(cache_read, 1e-9):.2f} GB/s), bit for bit the first")
    out["sd"]["converted_cache_load"] = {"s": second_s, "read_and_move_s": cache_read,
                                         "gb_per_s": nbytes / 1e9 / max(cache_read, 1e-9)}
    del api2, source
    torch.cuda.empty_cache()

    # the depth ControlNet: an f16 file falls under the entry's min_size; the f32 one loads and drives control
    cn_entry = index["controlnet_v11_depth"]
    cn_path = download / cn_entry["url"].split("/")[-1]
    src = cflearn_torch.zoo.load_control_net("depth", device="cuda", dtype=torch.float32, seed=PRETRAINED_SEED + 2)
    redraw_zero_init(src, seed=PRETRAINED_SEED + 3)
    cn_source = {k: p.detach() for k, p in src.named_parameters()}
    del src
    upstream = {k: v.cpu() for k, v in C.invert(C.build_controlnet_mapping(), cn_source).items()}
    torch.save({k: v.half() for k, v in upstream.items()}, cn_path)
    half = cn_path.stat().st_size
    try:
        cflearn_torch.zoo.load_control_net("depth", pretrained=True, device="cuda", dtype=torch.bfloat16)
        refused = False
    except OSError as e:
        refused = "smaller than the recorded minimum" in str(e)
    print(f"pretrained: an f16 ControlNet ({half / 1e9:.3f} GB, min_size {cn_entry['min_size'] / 1e9:.1f} GB) "
          f"refused: {refused}")
    check(refused and not tried, "the f16 ControlNet was not refused by its min_size")
    t0 = time.perf_counter()
    torch.save(upstream, cn_path)
    cn_write_s = time.perf_counter() - t0
    del upstream
    t0 = time.perf_counter()
    cn = cflearn_torch.zoo.load_control_net("depth", pretrained=True, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    cn_s = time.perf_counter() - t0
    wrong = [k for k, p in cn.named_parameters() if not torch.equal(p, cn_source[k].to(torch.bfloat16))]
    check(not wrong and not tried, f"ControlNet parameters not bit for bit: {wrong[:5]}")
    capi = cflearn_torch.ControlledDiffusionAPI(api.m, device="cuda")
    capi.prepare_control("depth", cn)
    gen = torch.Generator(device="cuda").manual_seed(PRETRAINED_SEED)
    hint = torch.randint(0, 256, (512, 512, 3), generator=gen, device="cuda").to(torch.uint8).cpu().numpy()
    reset_launches(A, Cv, Gn)
    t0 = time.perf_counter()
    controlled = capi.sample_with_control(1, {"depth": hint}, cond=PROMPT, num_steps=API_STEPS, seed=0,
                                          hint_starts={"depth": 0.1}, hint_ends={"depth": 0.9})
    torch.cuda.synchronize()
    cms = (time.perf_counter() - t0) * 1e3
    got = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
    want = serving(API_STEPS, controls=1)
    check(got == want, f"controlled launches {got} != phase 12's {want}")
    check(controlled.shape == (1, 512, 512, 3) and not np.array_equal(controlled, image), "controlled image")
    print(f"pretrained: ControlNet written ({cn_path.stat().st_size / 1e9:.3f} GB, {cn_write_s:.1f} s), loaded in "
          f"{cn_s:.2f} s bit for bit; sample_with_control {cms:.1f} ms (its first call), launches {json.dumps(got)} = "
          f"phase 12's")
    out["controlnet"] = {"file_gb": cn_path.stat().st_size / 1e9, "f16_refused": refused, "load_s": cn_s,
                         "controlled_ms": cms, "launches": got}
    del capi, cn, cn_source, api

    # one changed byte against the pin: the load falls through to a fetch, which is refused here
    (Z.converted_cache_path("controlnet_v11_depth")).unlink()
    M._verified_downloads.clear()
    with open(cn_path, "r+b") as f:
        f.seek(cn_path.stat().st_size // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    try:
        cflearn_torch.zoo.load_control_net("depth", pretrained=True, device="cuda")
        changed = False
    except OSError as e:
        changed = "put the file at" in str(e) and set(tried) == {cn_entry["url"]}
    print(f"pretrained: one changed byte refused against its pin: {changed} (the fetch asked for: {tried})")
    check(changed, "a changed byte was not refused")
    tried.clear()
    out["changed_byte_refused"] = changed
    return out


# 25. the mesh on one card: a one-rank NCCL group (`torch.distributed`, `parallel.mesh`) under the `Trainer` and
# `DiffusionAPI.use_mesh`, and the ring of context-parallel attention at SD-1.5's 64^2 self-attention shape, its
# ranks run one after another in one process (no second card: a multi-rank NCCL ring cannot run here)
MESH_REMATS = (False, True, "dots_saveable")
RING_SHAPE = (8, 8, 4096, 40)  # B, H, L, d: SD-1.5's 64^2 self-attention at the finetune batch
RING_CPS = (2, 4)
# The ring's gate holds each sequence position to `flash_rel` of its own largest magnitude (over B, H and d), plus
# this share of the whole tensor's: under causal masking the magnitudes fall along the sequence (key 0 is attended
# by every query), so a gate by the whole tensor's largest value is as large as most values past the first few
# hundred positions; the share keeps positions whose exact values are 0 (dq of query 0) from a gate of 0.
RING_FLOOR = 2.0**-4


class OneProcessRing:
    """One rank's ring as `ops.ring_attention.ring_forward` / `ring_backward` take it (`index`, `size`, `start`,
    `wait`), for cp ranks run one after another in this process (no second card): the shards of every rank are
    known, so `wait` hands over the kv block the previous rank would have sent. Gradients cannot wait for the
    previous rank's sums here, so in the backward (`phase="bwd"`) each rank receives zeros with a block and every
    dk / dv it sends on is added to that block's owner in `sums` (f32, what the owner's would hold)."""

    def __init__(self, index: int, ks, vs, phase: str, sums=None):
        self.index, self.size = index, len(ks)
        self.ks, self.vs, self.phase, self.sums = ks, vs, phase, sums
        self.step = 0

    def start(self, tensors):
        if self.phase == "bwd":
            owner = (self.index - self.step) % self.size  # the block this rank held at this step
            for acc, g in zip(self.sums[owner], tensors[-2:]):
                acc += g
        return self.step

    def wait(self, step):
        self.step += 1
        if self.phase == "fwd":
            owner = (self.index - step - 1) % self.size
            return [self.ks[owner], self.vs[owner]]
        zeros = [t.new_zeros(t.shape) for t in self.sums[0]]
        if step == self.size - 1:  # the gradients come home: in `sums`
            return zeros
        owner = (self.index - step - 1) % self.size
        return [self.ks[owner], self.vs[owner], *zeros]


def ring_in_one_process(q, k, v, do, cp: int, *, causal: bool, plain: bool = False):
    """The ring of cp ranks over whole (B, H, L, D) tensors, each rank running the library's own loops
    (`ring_forward`, then `ring_backward` for `do`) on its L/cp shard over a `OneProcessRing`:
    (o, [each rank's lse], (dq, dk, dv))."""
    import torch

    from cflearn_torch.ops.ring_attention import ring_backward, ring_forward

    scale = 1.0 / math.sqrt(q.shape[-1])
    qs, ks, vs, dos = (t.chunk(cp, dim=2) for t in (q, k, v, do))
    outs = [ring_forward(qs[r], ks[r], vs[r], OneProcessRing(r, ks, vs, "fwd"), causal=causal, sm_scale=scale,
                         plain=plain) for r in range(cp)]
    sums = [[t.new_zeros(t.shape, dtype=torch.float32) for t in (ks[r], vs[r])] for r in range(cp)]
    dq = [ring_backward(qs[r], ks[r], vs[r], *outs[r], dos[r], OneProcessRing(r, ks, vs, "bwd", sums),
                        causal=causal, sm_scale=scale, plain=plain)[0] for r in range(cp)]
    o = torch.cat([out[0] for out in outs], dim=2)
    grads = (torch.cat(dq, dim=2), *(torch.cat([s[i] for s in sums], dim=2).to(k.dtype) for i in range(2)))
    return o, [out[1] for out in outs], grads


def ring_gate(got, want, rel: float):
    """(largest |got - want|, largest ratio of an error to its position's tolerance; at most 1 passes) of
    (B, H, L, D) tensors, each position held to `rel` of its own largest magnitude plus RING_FLOOR of the
    whole tensor's."""
    w = want.float()
    err = (got.float() - w).abs()
    mag = w.abs()
    tol = rel * (mag.amax(dim=(0, 1, 3), keepdim=True) + RING_FLOOR * mag.max())
    return err.max().item(), (err / tol).max().item()


def mesh_step_launches(remat, steps: int) -> dict:
    """The launches of `steps` finetune steps through the Trainer: with `remat` the whole forward runs again in the
    backward (every flash forward with lse and every GroupNorm twice; dots_saveable keeps neither output)."""
    again = 2 if remat else 1
    return {"flash_fwd_lse": FLASH_PER_UNET * again * steps, "flash_bwd_fused": FLASH_PER_UNET * steps,
            "group_norm": GN_PER_UNET * again * steps}


def ring_visits(cp: int, causal: bool) -> int:
    """Blocks attended by the cp ranks of a ring: every (q, kv) pair of blocks, only kv <= q with causal masking."""
    return cp * (cp + 1) // 2 if causal else cp * cp


def phase_mesh(torch, np, cflearn_torch, A, Cv, Gn, build_unet) -> dict:
    """(a) A one-rank NCCL group and its 1 x 1 x 1 x 1 x 1 mesh: the SD-1.5 UNet finetune step (phase 15's batch 8,
    inputs and reference) through `Trainer.fit` with `shard_optimizer_states=True`, under `remat` False, True and
    "dots_saveable": the first step's loss and gradients (the Trainer fed the reference's t and noise) against
    the unchecked `make_train_step` step within phase 15's gates, then TRAIN_STEPS steps through the Trainer's
    step with exact launches, ms per step and peak memory. (b) `DiffusionAPI.use_mesh` on that mesh: txt2img bit
    for bit the unmeshed image, with phase 12's launches. (c) The ring of `ops.ring_attention`, its cp ranks run in
    turn in this process through the library's loops (`ring_in_one_process`), at RING_SHAPE, bf16, cp 2 and 4, causal and
    not, forward and backward: the kernels' ring against rows 3 and 4 over the whole sequence and against the
    plain ring, each position within its own gate (`ring_gate`), a dropped block failing it, exact launches (cp^2
    blocks of each row, cp(cp + 1)/2 with causal masking), device ms beside the whole-sequence kernels'."""
    import gc
    import shutil
    import socket
    import tempfile

    import torch.distributed as dist

    import cflearn_torch.models.cv.diffusion as D
    from cflearn_torch.data import ArrayData
    from cflearn_torch.monitors import LazyMonitor
    from cflearn_torch.parallel.mesh import make_mesh, maybe_initialize_distributed, set_mesh
    from cflearn_torch.schema import DLConfig
    from cflearn_torch.schema.data import DataConfig
    from cflearn_torch.trainer import Trainer, make_train_step

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"mesh: {msg}")

    out = {"trainer": {}, "use_mesh": {}, "ring": {}}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    workspace = tempfile.mkdtemp(prefix="mesh_phase_")
    try:
        check(maybe_initialize_distributed(force_cpu=False), "no process group formed")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, f"backend {dist.get_backend()}")
        print(f"mesh: one-rank {dist.get_backend()} group on {torch.cuda.get_device_name(0)}")

        # (a) the reference step: phase 15's inputs and its unchecked step's drift gates
        gen = torch.Generator(device="cuda").manual_seed(2)
        x0 = torch.randn((TRAIN_BATCH, 64, 64, 4), generator=gen, device="cuda")
        ctx = torch.randn((TRAIN_BATCH, 77, 768), generator=gen, device="cuda")
        t_fix = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device="cuda")
        noise = torch.randn(x0.shape, generator=gen, device="cuda")
        x0_b = x0.to(torch.bfloat16).float()
        tmodel = build_unet()
        init = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
        step = make_train_step(tmodel, lr=1e-5, compute_dtype=torch.bfloat16)

        def ref_step(x):
            loss = step.loss_and_grads({D.INPUT_KEY: x, "cond": ctx}, t=t_fix, noise=noise)[D.LOSS_KEY].item()
            grads, step.grads = step.grads, {}
            return loss, grads

        loss_0, grads_0 = ref_step(x0_b)
        # the bare step (`make_train_step`, no Trainer, no mesh) in this run, for the Trainer's cost on the mesh
        bare = make_train_step(tmodel, lr=1e-5, compute_dtype=torch.bfloat16)
        bare_batch = {D.INPUT_KEY: x0_b, "cond": ctx}
        bare.step(bare_batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            bare.step(bare_batch)
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        bare_peak = torch.cuda.max_memory_allocated() / 2**30
        del bare
        with torch.no_grad():
            for k, v in tmodel.state_dict().items():
                v.copy_(init[k])
        out["bare_step"] = {"step_ms": bare_ms, "peak_memory_gib": bare_peak}
        print(f"mesh: the bare step (make_train_step, off the mesh) {bare_ms:.1f} ms, peak memory {bare_peak:.2f} GiB")
        up = bump_ulp(torch, x0_b)
        drift_loss = drift_global = 0.0
        for x in (up, x0_b - (up - x0_b)):
            loss_u, grads_u = ref_step(x)
            drift_loss = max(drift_loss, abs(loss_u - loss_0))
            drift_global = max(drift_global, grad_errors(grads_u, grads_0)["global_rel"])
            del grads_u
        del step
        tol_loss = max(AE_PARITY_FACTOR * drift_loss, 2.0**-10 * abs(loss_0))
        tol_global = AE_PARITY_FACTOR * drift_global
        out["drift"] = {"loss": drift_loss, "global_rel": drift_global, "loss_tolerance": tol_loss}
        print(f"mesh: reference step loss {loss_0:.6f}; gates: loss {tol_loss:.3e}, global {tol_global:.3e}")
        data = ArrayData.init(DataConfig(batch_size=TRAIN_BATCH, shuffle_train=False)).fit(
            x0_b.cpu().numpy(), train_others={"cond": ctx.cpu().numpy()}
        )
        batch = {D.INPUT_KEY: x0_b, "cond": ctx}
        draws = D.global_randint, D.global_randn
        for remat in MESH_REMATS:
            with torch.no_grad():
                for k, v in tmodel.state_dict().items():
                    v.copy_(init[k])
            config = DLConfig(
                model="ddpm", workspace=workspace, fixed_steps=1, callback_names=[], mesh={"data": 1},
                shard_optimizer_states=True, remat=remat, mixed_precision="bf16", optimizer_name="adamw", lr=1e-5,
                scheduler_name="none", async_checkpointing=False, save_on_preemption=False,
            )
            trainer = Trainer(config, monitors=[LazyMonitor()])
            trainer.save_checkpoint = lambda score, *a, **k: None  # the step is under test, not a 3.4 GB write
            # the reference's draws (a recomputation under remat draws them again, and gets the same)
            D.global_randint, D.global_randn = (lambda *a, **k: t_fix), (lambda *a, **k: noise)
            first = []
            train_step = trainer._train_step
            trainer._train_step = lambda b, s: first.append(train_step(b, s)) or first[-1]
            try:
                trainer.fit(data, tmodel, skip_final_evaluation=True)
            finally:
                D.global_randint, D.global_randn = draws
                trainer._train_step = train_step
            fn = trainer.step_fn.steps["all"]
            check(fn.mesh_step is not None and fn.mesh_step.zero and fn.remat == remat, f"{remat}: not on the mesh")
            loss = float(first[0][D.LOSS_KEY])
            err = grad_errors(fn.grads, grads_0)
            print(f"mesh trainer[remat={remat}]: first step loss {loss:.6f} (off {abs(loss - loss_0):.3e}), gradients "
                  f"against the unchecked step {json.dumps(err)}")
            check(abs(loss - loss_0) <= tol_loss, f"remat={remat}: the loss moved from the reference step's")
            check(err["global_rel"] <= tol_global, f"remat={remat}: the gradients moved (global norm)")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches(A, Cv, Gn)
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                trainer.state.step += 1
                trainer._train_step(batch, trainer.state)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            launches = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
            want = mesh_step_launches(remat, TRAIN_STEPS)
            print(f"mesh trainer[remat={remat}]: {step_ms:.1f} ms per step through the Trainer on the mesh, peak memory "
                  f"{peak:.2f} GiB, launches {json.dumps(launches)}")
            check(launches == want, f"remat={remat}: launches {launches} != {want}")
            # the forward + backward alone (no optimizer update), from what stays between steps: under `remat` one
            # checkpoint holds the whole forward and the loss, so the backward builds every activation again first
            fn.grads = {}
            gc.collect()
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            fn.loss_and_grads(batch)
            torch.cuda.synchronize()
            fb_peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"mesh trainer[remat={remat}]: forward + backward alone: peak memory {fb_peak:.2f} GiB over "
                  f"{resident:.2f} GiB resident ({fb_peak - resident:.2f} GiB of activations and gradients)")
            out["trainer"][str(remat)] = {"loss_err": abs(loss - loss_0), "global_rel": err["global_rel"],
                                          "leaf_max_rel": err["leaf_max_rel"], "step_ms": step_ms,
                                          "peak_memory_gib": peak, "fwd_bwd_peak_gib": fb_peak,
                                          "resident_gib": resident, "launches_per_step": mesh_step_launches(remat, 1)}
            # a Trainer and its inference refer to each other: collect the cycle, so that the next run's peak
            # holds no state of this one
            del trainer, fn, train_step, first
            gc.collect()
            torch.cuda.empty_cache()
        del tmodel, init, grads_0
        gc.collect()
        torch.cuda.empty_cache()

        # (b) use_mesh on the one-rank mesh: txt2img bit for bit, phase 12's launches
        api = cflearn_torch.DiffusionAPI.from_sd("v1", device="cuda", seed=0)
        from cflearn_torch.modules.common import redraw_zero_init

        redraw_zero_init(api.m, seed=1)
        base = api.txt2img("a photo of a cat", seed=0)  # the warm-up, unmeshed
        same = True
        # in turns (off, on, on, off): the host clock of one call spreads widely from call to call
        for i, meshed in enumerate((False, True, True, False)):
            api.use_mesh(make_mesh() if meshed else None)
            reset_launches(A, Cv, Gn)
            t0 = time.perf_counter()
            image = api.txt2img("a photo of a cat", seed=0)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
            print(f"mesh use_mesh[{meshed}]: txt2img {ms:.1f} ms, launches {json.dumps(launches)}")
            check(launches == serving(STEPS), f"use_mesh={meshed}: launches {launches} != {serving(STEPS)}")
            out["use_mesh"].setdefault(str(meshed), {"ms": [], "launches": launches})["ms"].append(ms)
            same = same and bool(np.array_equal(image, base))
        api.use_mesh(None)
        print(f"mesh use_mesh: the meshed image equals the unmeshed one bit for bit: {same}")
        check(same, "the meshed txt2img differs from the unmeshed one")
        out["use_mesh"]["bit_for_bit"] = same
        del api
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        set_mesh(None)
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(workspace, ignore_errors=True)

    # (c) the ring at SD-1.5's 64^2 self-attention, its ranks run in turn in this process
    b, h, seq, d = RING_SHAPE
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(RING_SHAPE, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    do = torch.randn((b, seq, h, d), generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
    rel = flash_rel(2)
    for causal in (False, True):
        whole_o, whole_lse = A.flash_fwd_lse(q, k, v, causal=causal)
        whole_g = A.flash_bwd_fused(q, k, v, whole_o, whole_lse, do, causal=causal)
        whole_ms = device_ms(torch, lambda: A.flash_bwd_fused(q, k, v, *A.flash_fwd_lse(q, k, v, causal=causal), do,
                                                               causal=causal), calls=2, replays=3)
        for cp in RING_CPS:
            key = f"cp{cp}_{'causal' if causal else 'full'}"
            reset_launches(A, Cv, Gn)
            o, lses, grads = ring_in_one_process(q, k, v, do, cp, causal=causal)
            torch.cuda.synchronize()
            launches = {kk: vv for kk, vv in read_launches(A, Cv, Gn).items() if vv}
            want = {"flash_fwd_lse": ring_visits(cp, causal), "flash_bwd_fused": ring_visits(cp, causal)}
            check(launches == want, f"ring {key}: launches {launches} != {want}")
            o_p, _, grads_p = ring_in_one_process(q, k, v, do, cp, causal=causal, plain=True)
            errs = {"o_vs_whole": ring_gate(o, whole_o, rel), "o_vs_plain": ring_gate(o, o_p, rel)}
            for name, got, w, p in zip(("dq", "dk", "dv"), grads, whole_g, grads_p):
                errs[f"{name}_vs_whole"] = ring_gate(got, w, rel)
                errs[f"{name}_vs_plain"] = ring_gate(got, p, rel)
            bad = {n: e for n, e in errs.items() if not e[1] <= 1.0}
            planted = {}
            if cp == RING_CPS[-1]:
                # the gate's power: the last rank's whole block against the first rank's keys (attended under
                # causal masking too) dropped from dk and dv must fail it
                n = seq // cp
                last = slice((cp - 1) * n, seq)
                _, dk_b, dv_b = A.flash_bwd_fused(q[:, :, last], k[:, :, :n], v[:, :, :n], o[:, :, last], lses[-1],
                                                  do[:, :, last].contiguous(), causal=False)
                for name, got, w, blk in (("dk", grads[1], whole_g[1], dk_b), ("dv", grads[2], whole_g[2], dv_b)):
                    dropped = got.clone()
                    dropped[:, :, :n] -= blk
                    planted[name] = ring_gate(dropped, w, rel)
                check(all(e[1] > 1.0 for e in planted.values()), f"ring {key}: a dropped block passes: {planted}")
            ring_ms = device_ms(torch, lambda: ring_in_one_process(q, k, v, do, cp, causal=causal), calls=2, replays=3)
            plain_ms = time_ms(torch, lambda: ring_in_one_process(q, k, v, do, cp, causal=causal, plain=True), 20.0)
            print(f"mesh ring[{key}]: launches {json.dumps(launches)}; errors (largest, largest share of its "
                  f"position's gate) {json.dumps(errs)}; a dropped block (dk, dv) {json.dumps(planted)}; ms forward + "
                  f"backward {ring_ms:.3f} device (whole-sequence rows 3 + 4 {whole_ms:.3f}); plain ring {plain_ms:.3f} ms")
            check(not bad, f"ring {key}: {bad}")
            out["ring"][key] = {"launches": launches, "max_abs_err": max(e[0] for e in errs.values()),
                                "max_gate_share": max(e[1] for e in errs.values()), "dropped_block": planted,
                                "ms": ring_ms, "whole_ms": whole_ms, "plain_ms": plain_ms}
            del o, lses, grads, o_p, grads_p
        del whole_o, whole_lse, whole_g
    torch.cuda.empty_cache()
    return out


# 26 (a): every kernel of the `kernels` line launched from the main thread, from a new thread after it, and from two
# threads at once. A launch from a thread that has made no CUDA call needing a context must not fail: every entry
# point binds its pointer's device and context first (`csrc/host.cuh` `DeviceOf`).
THREAD_SEED = 26
# a call from each way: the main thread, one new thread, two threads at once
THREAD_CALLS = {"main": 1, "thread": 1, "two_at_once": 2}
# the launches one call of each case makes (the W8A8 conv quantises first: two kernels)
THREAD_PER_CALL = {"conv3x3_w8a8": {"conv3x3_w8a8": 1, "quantize_w8a8": 1}}


def thread_cases(torch, A, Cv, Gn) -> list:
    """(kernel, call, plain, check) for each kernel of the `kernels` line at a shape of its path; check(out, ref)
    -> (error, tolerance), the tolerance phase 2 holds the row to (0.0: bit for bit). The flash rows at SD-1.5's
    64^2 self-attention at the finetune batch (B8 H8 d40 bf16), q a 2048-row chunk of an L 4096 tensor and k, v the
    other tensor's halves (the ring's blocks, where a second thread's launch first failed); the convs at the VAE
    decoder's 64^2 x 512 level; the weight gradient at the autoencoder step's 128^2 x 128; GroupNorm + SiLU at the
    UNet's 64^2 x 320 (CFG batch 2)."""
    gen = torch.Generator(device="cuda").manual_seed(THREAD_SEED)

    def randn(*shape, scale: float = 1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    q_all, kv_all = randn(8, 8, 4096, 40), randn(2, 8, 8, 4096, 40)
    q, k, v = q_all[:, :, :2048], kv_all[0][:, :, 2048:], kv_all[1][:, :, :2048]
    o, lse = A.flash_fwd_with_lse_plain(q, k, v)
    do = randn(*o.shape)
    grads = A.flash_bwd_plain(q, k, v, o, lse, do)
    x, w = randn(1, 64, 64, 512), randn(512, 3, 3, 512, scale=(9 * 512) ** -0.5)
    xa, dya = randn(8, 128, 128, 128), randn(8, 128, 128, 128)
    xg, gw, gb = randn(2, 64, 64, 320), randn(320), randn(320)

    def gate(rel):
        return lambda ref: rel * ref.float().abs().max().item()

    def each(*gates):
        def check(outs, refs):
            errs = [(max_err(out, ref), g(ref)) for out, ref, g in zip(outs, refs, gates)]
            return max(errs, key=lambda e: e[0] / e[1])

        return check

    def exact(outs, refs):
        same = all(torch.equal(out, ref) for out, ref in zip(outs, refs))
        return (0.0 if same else max(max_err(out, ref) for out, ref in zip(outs, refs))), 0.0

    flash = gate(FLASH_REL)
    return [
        ("flash_attention", lambda: (A.flash_attention(q, k, v),), lambda: (A.flash_attention_plain(q, k, v),),
         each(flash)),
        ("flash_fwd_lse", lambda: A.flash_fwd_lse(q, k, v), lambda: (o, lse), each(flash, lambda ref: LSE_TOL[2])),
        ("flash_bwd_fused", lambda: A.flash_bwd_fused(q, k, v, o, lse, do), lambda: grads, each(flash, flash, flash)),
        ("flash_bwd_dq", lambda: (A.flash_bwd_dq(q, k, v, o, lse, do),), lambda: grads[:1], each(flash)),
        ("flash_bwd_dkv", lambda: A.flash_bwd_dkv(q, k, v, o, lse, do), lambda: grads[1:], each(flash, flash)),
        ("conv3x3", lambda: (Cv.conv3x3(x, w),), lambda: (Cv.conv3x3_plain(x, w),), each(gate(CONV_REL))),
        ("conv3x3_fold", lambda: (Cv.conv3x3_fold(x, w),), lambda: (Cv.conv3x3_fold_plain(x, w),),
         each(gate(CONV_REL))),
        ("conv3x3_wgrad", lambda: (Cv.conv3x3_wgrad(xa, dya),), lambda: (Cv.conv3x3_wgrad_plain(xa, dya),),
         each(gate(WGRAD_REL))),
        ("group_norm", lambda: (Gn.group_norm_silu(xg, gw, gb, apply_silu=True),),
         lambda: (Gn.group_norm_silu_plain(xg, gw, gb, apply_silu=True),), each(gate(GN_REL))),
        ("quantize_w8a8", lambda: Cv.quantize_w8a8(x, w), lambda: Cv.w8a8_operands(x, w), exact),
        ("conv3x3_w8a8", lambda: (Cv.conv3x3_w8a8(x, w),), lambda: (Cv.conv3x3_w8a8_plain(x, w),), exact),
    ]


def thread_launches(torch, A, Cv, Gn) -> list:
    """Each case of `thread_cases` called from the main thread, then from a new `threading.Thread`, then from two
    threads at once (started together behind a barrier): a row each with every call's error against the plain
    version, the tolerance, whether each thread's output is the main thread's bit for bit, and the launches counted
    against THREAD_CALLS x the case's launches a call. A call that raises in a thread is raised here."""
    import threading

    rows = []
    for name, call, plain, check in thread_cases(torch, A, Cv, Gn):
        ref = plain()

        def attempt(slot, out, barrier=None):
            try:
                if barrier is not None:
                    barrier.wait()
                out[slot] = call()
                torch.cuda.current_stream().synchronize()
            except Exception as e:  # noqa: BLE001 (raised below, on the main thread)
                out[slot] = e

        def in_threads(n):
            out, barrier = {}, threading.Barrier(n) if n > 1 else None
            threads = [threading.Thread(target=attempt, args=(f"t{i}", out, barrier)) for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return [out[f"t{i}"] for i in range(n)]

        reset_launches(A, Cv, Gn)
        got = {"main": [call()]}
        torch.cuda.synchronize()
        got["thread"] = in_threads(1)
        got["two_at_once"] = in_threads(2)
        launches = read_launches(A, Cv, Gn)
        per_call = THREAD_PER_CALL.get(name, {name: 1})
        calls = sum(THREAD_CALLS.values())
        want = {k: calls * per_call.get(k, 0) for k in launches}
        row = dict(kernel=name, launches=launches[name], want=want[name], launches_exact=launches == want)
        ok = launches == want
        for way, outs in got.items():
            errs = []
            for i, out in enumerate(outs):
                if isinstance(out, Exception):
                    raise AssertionError(f"{name} from {way} (call {i}): {out!r}")
                err, tol = check(out, ref)
                errs.append(err)
                row["tol"] = tol
                ok = ok and err <= tol
                if way != "main":
                    row.setdefault("same_as_main", []).append(
                        all(torch.equal(a, b) for a, b in zip(out, got["main"][0])))
            row[way] = errs
        row["ok"] = ok
        rows.append(row)
        del got, ref
    return rows


# 26 (b)-(d): txt2img requests served from worker threads, the zoo's `diffusion/ddpm` preset, repeat_ml / run_multiple
THREAD_REQUESTS = ((PROMPT, 0), ("a watercolor painting of a lighthouse on a cliff at dawn", 1))
DDPM_SAMPLES = 16
DDPM_STEPS = 20
# the preset's launches a UNet call: its 16^2 self-attentions (2 input-level, 3 output-level; B16 H4 L256 d64) take
# row 1 and its 51 GroupNorms row 8; the 8^2 mid-block's L 64 is below the flash predicate's q >= 128 (SDPA), and
# every 3x3 conv is below the conv predicate's 128^2 (cuDNN)
DDPM_PER_UNET = {"flash_attention": 5, "group_norm": 51}
REPEAT_ROWS = 8192  # phase 21's MNIST-shaped table, cut to these rows
REPEAT_STEPS = 4
REPEAT_PREDICT = 1024
# a task's predictions against the same fit in this process: the f32 fused backward sums dq by atomics, in an order
# that varies from run to run, so 4 Adam steps may move the weights by a few f32 ulps
REPEAT_REL = 1e-3


@contextlib.contextmanager
def captured_output(path: str):
    """This process's and its children's standard output and error sent to `path` inside the block; if the block
    raises, the file's last lines are printed after the streams are back."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = os.dup(1), os.dup(2)
    failed = False
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
        try:
            yield
        except BaseException:
            failed = True
            raise
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            os.dup2(saved[0], 1)
            os.dup2(saved[1], 2)
            os.close(saved[0])
            os.close(saved[1])
            if failed:
                print("".join(open(path).readlines()[-40:]), flush=True)


def tasks_on(log: str) -> list:
    """The devices the tasks of a captured `dist.ml` run fitted on (`runs/basic.py` prints one line a task)."""
    return re.findall(r"^task .*: fitting on (\S+)$", log, flags=re.M)


def phase_surface(torch, np, F, cflearn_torch, A, Cv, Gn) -> dict:
    """(a) Each kernel of the `kernels` line from the main thread, a new thread and two threads at once
    (`thread_launches`). (b) Phase 12's txt2img (SD-1.5, 512², 20 DDIM steps, CFG 7.5) as two requests on a
    two-worker `ThreadPoolExecutor`: each image bit for bit the same request served from the main thread, launches
    exact. (c) `zoo.load_module("diffusion/ddpm")` at its published width in bf16 (seed 0, zero-initialised convs
    redrawn): one UNet call's launches exact and within PARITY_FACTOR x the plain path's one-ulp drift (phase 4's
    rule), each of its distinct kernel calls (flash and GroupNorm) against its plain version (phase 2's tolerances)
    and timed beside the library call with its bound, `sample(16, num_steps=20)`'s launches, ms and peak memory.
    (d) `repeat_ml` (2 tasks) of the tabular "transformer" on phase 21's MNIST-shaped table (cut to REPEAT_ROWS
    rows) with the tasks on the card, each task's loaded pipeline against the same config fitted here; then
    `run_multiple(is_fix=True)` after one task's pipeline folder is removed: that task alone, on the card."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from cflearn_torch.api import repeat_ml, run_multiple
    from cflearn_torch.api.api import _ml_config
    from cflearn_torch.data import MLData
    from cflearn_torch.dist.ml import Experiment
    from cflearn_torch.modules.common import redraw_zero_init
    from cflearn_torch.pipeline.api import MLTrainingPipeline
    from cflearn_torch.toolkit.misc import seed_everything

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"surface: {msg}")

    out = {}
    # (a) kernels launched from threads
    rows = thread_launches(torch, A, Cv, Gn)
    for r in rows:
        print(f"surface[threads] {json.dumps(r)}")
    bad = [r["kernel"] for r in rows if not (r["ok"] and r["launches_exact"])]
    check(not bad, f"kernels wrong or miscounted from threads: {bad}")
    out["threads"] = rows

    # (b) txt2img requests from worker threads, bit for bit the main thread's
    api = cflearn_torch.DiffusionAPI.from_sd("v1", device="cuda", seed=0)
    redraw_zero_init(api.m, seed=1)
    api.txt2img(PROMPT, num_steps=API_STEPS, seed=0)  # warm-up
    torch.cuda.synchronize()
    serial, serial_ms = [], []
    for prompt, seed in THREAD_REQUESTS:
        reset_launches(A, Cv, Gn)
        t0 = time.perf_counter()
        serial.append(api.txt2img(prompt, num_steps=API_STEPS, seed=seed))
        torch.cuda.synchronize()
        serial_ms.append((time.perf_counter() - t0) * 1e3)
        got = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
        check(got == serving(API_STEPS), f"main-thread txt2img launches {got} != {serving(API_STEPS)}")
    reset_launches(A, Cv, Gn)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(api.txt2img, prompt, num_steps=API_STEPS, seed=seed) for prompt, seed in THREAD_REQUESTS]
        threaded = [f.result() for f in futures]
    torch.cuda.synchronize()
    threaded_ms = (time.perf_counter() - t0) * 1e3
    got = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
    want = {k: 2 * v for k, v in serving(API_STEPS).items()}
    same = [bool(np.array_equal(a, b)) for a, b in zip(serial, threaded)]
    print(f"surface[serving]: two requests from the main thread {[round(m, 1) for m in serial_ms]} ms, on two "
          f"worker threads {threaded_ms:.1f} ms together, launches {json.dumps(got)}, images bit for bit: {same}")
    check(got == want, f"threaded txt2img launches {got} != {want}")
    check(all(same) and not np.array_equal(serial[0], serial[1]), "a threaded image differs from the main thread's")
    out["serving"] = {"serial_ms": serial_ms, "threaded_ms": threaded_ms, "launches": got, "bit_for_bit": same}
    del api, serial, threaded
    torch.cuda.empty_cache()

    # (c) the diffusion/ddpm preset at its published width
    m = cflearn_torch.zoo.load_module("diffusion/ddpm", device="cuda", dtype=torch.bfloat16, seed=0)
    redraw_zero_init(m, seed=1)
    n_params = sum(p.numel() for p in m.parameters())
    gen = torch.Generator(device="cuda").manual_seed(26)
    x = torch.randn((DDPM_SAMPLES, m.img_size, m.img_size, m.out_channels), generator=gen, device="cuda")
    x = x.to(torch.bfloat16)
    t = torch.randint(0, 1000, (DDPM_SAMPLES,), generator=gen, device="cuda")
    counts = {}
    with torch.no_grad():
        with census(A, Cv, Gn, counts):
            m.denoise(x, t)
        torch.cuda.synchronize()
        reset_launches(A, Cv, Gn)
        eps_k = m.denoise(x, t).float()
        torch.cuda.synchronize()
        got = {k: v for k, v in read_launches(A, Cv, Gn).items() if v}
        with plain_kernels(A, Cv, Gn):
            eps_p = m.denoise(x, t).float()
            eps_u = m.denoise(bump_ulp(torch, x), t).float()
    drift, err = rel_err(eps_u, eps_p), rel_err(eps_k, eps_p)
    keys = sorted(counts)
    print(f"surface[ddpm]: {n_params} parameters (bf16), one UNet call at batch {DDPM_SAMPLES}: launches "
          f"{json.dumps(got)}, distinct calls {[(k[0], [a[1] for a in k[1][:3]]) for k in keys]}; kernels vs plain "
          f"max rel {err:.3e} (tolerance {PARITY_FACTOR * drift:.3e}: {PARITY_FACTOR} x the one-ulp drift {drift:.3e})")
    check(got == DDPM_PER_UNET, f"ddpm UNet launches {got} != {DDPM_PER_UNET}")
    by_kernel = {name: sum(n for key, n in counts.items() if key[0] == name) for name in got}
    check(by_kernel == got, f"the census {by_kernel} disagrees with the counters {got}")
    check(err <= PARITY_FACTOR * drift, "the ddpm UNet through the kernels disagrees with the plain path")
    # every distinct kernel call of the UNet call against its plain version (phase 2's tolerances), timed
    calls = []
    for key in keys:
        row = check_call(torch, F, A, Cv, Gn, key, gen, host_ms=True)
        row.update(case=f"ddpm_{'x'.join(map(str, row['shape']))}", per={"ddpm": counts[key] * DDPM_STEPS})
        calls.append(row)
        print(f"surface[ddpm] call: {json.dumps(row)}")
    with torch.no_grad():
        m.sample(DDPM_SAMPLES, num_steps=DDPM_STEPS, generator=torch.Generator(device="cuda").manual_seed(0))  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(A, Cv, Gn)
        t0 = time.perf_counter()
        samples = m.sample(DDPM_SAMPLES, num_steps=DDPM_STEPS, generator=torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
    sample_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    sample_launches = read_launches(A, Cv, Gn)
    want = {k: DDPM_STEPS * v for k, v in DDPM_PER_UNET.items()}
    sample_got = {k: v for k, v in sample_launches.items() if v}
    print(f"surface[ddpm]: sample({DDPM_SAMPLES}, num_steps={DDPM_STEPS}) {sample_ms:.1f} ms, peak {peak:.2f} GiB, "
          f"{tuple(samples.shape)} {samples.dtype}, launches {json.dumps(sample_got)}")
    check(sample_got == want, f"sample launches {sample_got} != {want}")
    check(tuple(samples.shape) == (DDPM_SAMPLES, 64, 64, 3) and bool(torch.isfinite(samples).all()), "samples")
    out["ddpm"] = {"params": n_params, "unet_launches": got, "unet_rel_err": err, "unet_drift": drift,
                   "sample_ms": sample_ms, "peak_gib": peak, "sample_launches": sample_launches, "calls": calls}
    del m, x, eps_k, eps_p, eps_u, samples
    torch.cuda.empty_cache()

    # (d) repeat_ml / run_multiple: tasks as processes on the card
    x, y = mnist_table(np, 52)
    x, y = x[:REPEAT_ROWS], y[:REPEAT_ROWS]
    config = cflearn_torch.MLConfig(module_name="transformer", fixed_steps=REPEAT_STEPS, callback_names=[], seed=0)
    root = tempfile.mkdtemp(prefix=".chip_smoke_repeat_", dir=HERE)
    try:
        workspace, log = os.path.join(root, "repeat"), os.path.join(root, "tasks.log")
        np.random.seed(1)  # the splitter's draws, made where repeat_ml fits the data
        t0 = time.perf_counter()
        with captured_output(log):
            results = repeat_ml(x, y, config=config, workspace=workspace, num_repeat=2)
        repeat_s = time.perf_counter() - t0
        devices = tasks_on(open(log).read())
        np.random.seed(1)
        data = MLData.init().fit(x, y)
        seed_everything(0)
        local = _ml_config(config)
        local.workspace = os.path.join(root, "here")
        here = MLTrainingPipeline.init(local).fit(data).predict(x[:REPEAT_PREDICT])["predictions"]
        pipelines = results.load_pipelines()
        errs = [rel_err(torch.from_numpy(pipelines[key].predict(x[:REPEAT_PREDICT])["predictions"]),
                        torch.from_numpy(here)) for key in sorted(pipelines)]
        print(f"surface[repeat_ml]: 2 tasks in {repeat_s:.1f} s on {devices}, their predictions against the same fit "
              f"here: max rel {[f'{e:.3e}' for e in errs]} (tolerance {REPEAT_REL})")
        check(devices == ["cuda:0", "cuda:0"], f"the tasks fitted on {devices}")
        check(sorted(pipelines) == [("transformer", 0), ("transformer", 1)], f"pipelines {sorted(pipelines)}")
        check(all(e <= REPEAT_REL for e in errs), "a task's predictions disagree with the fit here")
        kept = os.path.join(workspace, "transformer", "0", "pipeline")
        stamp = os.stat(kept).st_mtime_ns
        shutil.rmtree(os.path.join(workspace, "transformer", "1", "pipeline"))
        t0 = time.perf_counter()
        with captured_output(log):
            fixed = run_multiple(config, data, workspace=workspace, num_multiple=2, is_fix=True)
        fix_s = time.perf_counter() - t0
        fixed_devices = tasks_on(open(log).read())
        fix_err = rel_err(torch.from_numpy(fixed.load_pipelines()[("transformer", 1)].predict(
            x[:REPEAT_PREDICT])["predictions"]), torch.from_numpy(here))
        print(f"surface[run_multiple]: is_fix reran {sorted(fixed.checkpoint_folders)} in {fix_s:.1f} s on "
              f"{fixed_devices}, max rel {fix_err:.3e}; task 0's pipeline untouched: "
              f"{os.stat(kept).st_mtime_ns == stamp}")
        check(sorted(fixed.checkpoint_folders) == [("transformer", 1)] and fixed_devices == ["cuda:0"],
              "run_multiple(is_fix=True) did not rerun the one buggy task on the card")
        check(os.stat(kept).st_mtime_ns == stamp and not Experiment.is_buggy(os.path.dirname(kept)), "task 0")
        check(fix_err <= REPEAT_REL, "the rerun task's predictions disagree with the fit here")
        out["repeat_ml"] = {"rows": REPEAT_ROWS, "steps": REPEAT_STEPS, "repeat_s": repeat_s, "devices": devices,
                            "rel_errs": errs, "is_fix_s": fix_s, "is_fix_rel_err": fix_err}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"surface: done, {json.dumps({k: v for k, v in out.items() if k != 'threads'})}")
    return out


# 27. the last modules at the JAX package's defaults, seeded random weights: ChineseCLIP through `CLIPExtractor`,
# BLIP captioning, the GPT-2 prompt sampler, and LaMa, ISNet and iharm from seeded upstream-layout checkpoints
LAST_SEED = 27
CCLIP_BATCH = 8
CCLIP_FLASH = 24  # ViT-L/14 at 224 px: one routed self-attention a layer (B8 H16 L257 d64); the BERT tower (52) none
CCLIP_TEXTS = ["一只猫的照片", "一辆红色的跑车", "桌子上的一碗水果", "在月球上骑马的宇航员", "悬崖上的灯塔, 黎明",
               "雪山下的湖泊", "在草地上奔跑的狗", "城市夜景, 霓虹灯"]
BLIP_FLASH = 12  # ViT-B/16 at 384 px: one routed self-attention a layer (B1 H12 L577 d64); the decoder none
BLIP_PROMPT = (30522, 1037, 3861, 1997)  # [DEC] "a picture of" in bert-base-uncased's ids
BLIP_MAX_LENGTH = 30
GPT2_PROMPT = (64, 4286, 286, 257)  # four ids of GPT-2's vocabulary
GPT2_SEQUENCES = 4
LAMA_SIDE = 512
ISNET_HW = (768, 1024)
ISNET_SIZE = 1024
IHARM_HW = (300, 200)  # padded to 384 x 256


def upstream_values(np, shapes: dict, seed: int) -> dict:
    """Seeded numpy values for a state dict of `shapes` in an upstream layout: weights of rank >= 2 ~ N(0, 1 /
    their other axes' size), norm weights and running variances in [0.5, 1.5), a `ScaleLayer`'s scale 0.1, the
    rest (biases, running means) ~ N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, shape in shapes.items():
        if len(shape) >= 2:
            v = rng.randn(*shape) / math.sqrt(max(1, int(np.prod(shape[1:]))))
        elif k.endswith("running_var") or (k.endswith("weight") and len(shape) == 1):
            v = rng.rand(*shape) + 0.5
        elif k.endswith(".scale"):
            v = np.full(shape, 0.1)
        else:
            v = rng.randn(*shape) * 0.1
        out[k] = v.astype(np.float32)
    return out


def lama_upstream_names(names, n_blocks: int) -> dict:
    """{big-lama's `generator.model.{i}` key: the port's name} for the port's `LaMaGenerator` names: `convert_lama`
    run backwards (the layout the zoo's "lama" converter reads)."""
    base = 5 + n_blocks + 1

    def ffc(rest: str) -> str:
        return (rest.replace("ffc.convg2g.conv1.", "ffc.convg2g.conv1.0.").replace("ffc.convg2g.bn1.", "ffc.convg2g.conv1.1.")
                .replace("ffc.convg2g.fu.conv.", "ffc.convg2g.fu.conv_layer."))

    out = {}
    for k in names:
        top, rest = k.split(".", 1)
        if top == "stem":
            u = f"1.{ffc(rest)}"
        elif top in ("downs", "blocks"):
            i, rest = rest.split(".", 1)
            u = f"{(2 if top == 'downs' else 5) + int(i)}.{ffc(rest)}"
        elif top == "ups":
            i, part, leaf = rest.split(".", 2)
            u = f"{base + 3 * int(i) + (part == 'bn')}.{leaf}"
        else:
            u = f"{base + 10}.{rest}"
        out[f"generator.model.{u}"] = k
    return out


def phase_last_modules(torch, np, F, cflearn_torch, A, Cv, Gn) -> dict:
    """The last modules of the JAX package, at its defaults, seeded random weights.

    (a) `zoo.chinese_clip()` (ViT-L/14 at 224 px and a 24-layer BERT) through `CLIPExtractor`, which picks
    `ChineseCLIPTokenizer`: the image embeddings of 8 images in f32 and under `use_bf16` (f32 images, and bf16
    images straight into `encode_image`), exactly 24 flash launches a batch; the text embeddings of 8 Chinese
    strings, no launch; the image embeddings through the kernels against the plain versions within PARITY_FACTOR
    x the plain path's drift (f32: the larger of a one-f32-ulp move of the images and the same forward with the
    library's f32 attention, phase 23's rule; bf16: a one-bf16-ulp move); host ms a batch.
    (b) `BLIPCaptioner` (ViT-B/16 at 384 px, 12 + 12 layers, 30,524 ids) in `BLIPAPI`: `generate_caption_tokens`
    on one image (resized by `BLIPAPI.preprocess`) with the prompt [DEC] "a picture of" to 30 ids, exactly 12
    flash launches; the vision features against the plain path (phase 23's rule); the decoder's logits over the
    plain path's tokens against the same call on the CPU (NET_REL); how many greedy ids agree with the CPU's
    (printed); `caption` raising RuntimeError without a tokenizer; host ms a caption.
    (c) `GPT2LMHead` at distilgpt2's width (6 x 768, 50,257 ids): `sample_tokens` at the `PromptConfig` defaults,
    4 sequences, `top_k=1`: the ids equal to the CPU's, no launch; at the defaults (top-k 8) from a seeded
    generator; host ms a sequence.
    (d) LaMa (big-lama: ngf 64, 9 blocks), ISNet and iharm (`hrnet32_idih256`), each from a seeded state dict in
    its upstream layout through the zoo's converter (strict), no launch: `LaMaAPI.inpaint` at 512²,
    `ISNetAPI.segment` at `infer_size` 1024 on a 768 x 1024 image, `ImageHarmonizationAPI.run` on 300 x 200
    (padded to 384 x 256), each on the card against the same API on the CPU (NET_REL; iharm's uint8 image within
    one level on 0.1% of the values); the net on its inputs in f64 on the card against the same on the CPU
    (NET_REL), and each side's f32 output against the CPU's f64 one, printed (the seeded iharm's f32 forward is
    1.7e-4 to 3.5e-4 from its f64 one on the CPU itself, 4.1e-4 on the card: HRNet's residual sums grow its
    features to ~1e5, so no f32 comparison of it can be held to NET_REL); host ms an image.
    The tokenizers' vocabularies: where `transformers` loads them, `caption` and `enhance` also run whole, and the
    tokenizer's class and module are printed."""
    from cflearn_torch.api import CLIPExtractor
    from cflearn_torch.api.cv import third_party as TP
    from cflearn_torch.api.multimodal.clip import CLIP_MEAN, CLIP_STD
    from cflearn_torch.api.multimodal.third_party import blip as TB
    from cflearn_torch.api.nlp.third_party import prompt as TPR
    from cflearn_torch.modules.layers import resize
    from cflearn_torch.modules.nlp.tokenizers import ChineseCLIPTokenizer

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"last modules: {msg}")

    def launches_of(fn, want, counts):
        """fn under the census (into `counts`), then with the counters at 0: exact launches, and the census's
        launches equal to them. Returns fn's result and the counters."""
        with census(A, Cv, Gn, counts):
            fn()
        torch.cuda.synchronize()
        reset_launches(A, Cv, Gn)
        result = fn()
        torch.cuda.synchronize()
        got = read_launches(A, Cv, Gn)
        moved = {k: v for k, v in got.items() if v}
        check(moved == want, f"launches {moved} != {want}")
        by_kernel = {k: sum(n for key, n in counts.items() if key[0] == k) for k in want}
        check(by_kernel == want, f"the census {by_kernel} disagrees with the counters {want}")
        return result, got

    def host_ms(fn, runs=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / runs * 1e3

    def parity(label, fn, x):
        """fn through the kernels against the plain versions within PARITY_FACTOR x the plain path's drift: under a
        one-bf16-ulp move of bf16 x; for f32 x the larger of a one-f32-ulp move and the distance from the same
        forward with the library's f32 attention (phase 23's rule)."""
        with torch.no_grad():
            y_k = fn(x).float()
            with plain_kernels(A, Cv, Gn):
                y_p = fn(x).float()
                if x.dtype == torch.bfloat16:
                    drifts = {"input_one_bf16_ulp": rel_err(fn(bump_ulp(torch, x)).float(), y_p)}
                else:
                    drifts = {"input_one_f32_ulp": rel_err(fn(bump_ulp_f32(torch, x)).float(), y_p)}
                    A.flash_attention = lambda q, k, v, causal=False, sm_scale=None: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, scale=sm_scale)
                    drifts["library_f32_attention"] = rel_err(fn(x).float(), y_p)
        drift = max(drifts.values())
        rel = rel_err(y_k, y_p)
        print(f"last modules parity: {label}, kernels vs plain max rel err {rel:.3e} (tolerance "
              f"{PARITY_FACTOR * drift:.3e}: {PARITY_FACTOR} x the drift, the larger of {json.dumps(drifts)})")
        check(bool(torch.isfinite(y_k).all()) and rel <= PARITY_FACTOR * drift,
              f"{label} through the kernels disagrees with the plain path")
        return {"kernels_vs_plain": rel, "drifts": drifts}

    def smooth_image(seed, h, w):
        rng = np.random.RandomState(seed)
        low = rng.uniform(0, 255, (h // 32 + 1, w // 32 + 1, 3))
        big = np.kron(low, np.ones((32, 32, 1)))[:h, :w]
        return np.clip(big + rng.uniform(-20, 20, (h, w, 3)), 0, 255).astype(np.uint8)

    out = {"launches": {}}
    censuses = {}
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(LAST_SEED)

    # (a) ChineseCLIP through CLIPExtractor
    t0 = time.perf_counter()
    m = cflearn_torch.chinese_clip(device="cuda", seed=LAST_SEED)
    api = CLIPExtractor(m, device="cuda")
    n_params = sum(p.numel() for p in m.parameters())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(isinstance(api.tokenizer, ChineseCLIPTokenizer), f"the extractor's tokenizer is {type(api.tokenizer)}")
    pixels = torch.randint(0, 256, (CCLIP_BATCH, 224, 224, 3), generator=gen, device="cuda").to(torch.uint8)
    images = pixels.cpu().numpy()
    mean, std = (torch.as_tensor(v, device="cuda") for v in (CLIP_MEAN, CLIP_STD))
    normed = (pixels.float() / 255.0 - mean) / std
    want = {"flash_attention": CCLIP_FLASH}
    rec = {"parameters": n_params, "build_s": build_s}
    img, out["launches"]["chinese_clip"] = launches_of(lambda: api.get_image_latent(images), want,
                                                       censuses.setdefault("chinese_clip", {}))
    txt, _ = launches_of(lambda: api.get_text_latent(CCLIP_TEXTS), {}, {})
    ids = api.tokenizer.tokenize(CCLIP_TEXTS)
    norms = [float(np.abs(np.linalg.norm(e.astype(np.float64), axis=-1) - 1.0).max()) for e in (img, txt)]
    check(img.shape == (CCLIP_BATCH, 768) and txt.shape == (len(CCLIP_TEXTS), 768), f"{img.shape} {txt.shape}")
    check(np.isfinite(img).all() and np.isfinite(txt).all() and max(norms) <= 1e-5, f"norms off one by {norms}")
    rec.update(tokenizer="transformers" if api.tokenizer._tok != "char" else "characters", ids_shape=list(ids.shape),
               image_norm_err=norms[0], text_norm_err=norms[1],
               f32_image_batch_ms=host_ms(lambda: api.get_image_latent(images)),
               f32_text_batch_ms=host_ms(lambda: api.get_text_latent(CCLIP_TEXTS)),
               parity_f32=parity("chinese_clip image embeddings, f32", api.m.encode_image, normed))
    api.to_bf16()  # use_bf16: f32 images meet bf16 weights in f32 (the kernel's f32 route)
    img16, _ = launches_of(lambda: api.get_image_latent(images), want, {})  # the f32 route's calls again
    txt16, _ = launches_of(lambda: api.get_text_latent(CCLIP_TEXTS), {}, {})
    xb = normed.to(torch.bfloat16)  # bf16 images straight into the bf16 module: the wgmma route
    with torch.no_grad():
        emb, out["launches"]["chinese_clip_bf16"] = launches_of(lambda: api.m.encode_image(xb), want,
                                                                censuses.setdefault("chinese_clip_bf16", {}))
    norms16 = [float(np.abs(np.linalg.norm(e.astype(np.float64), axis=-1) - 1.0).max()) for e in (img16, txt16)]
    check(emb.dtype == torch.bfloat16 and bool(torch.isfinite(emb).all()), "bf16 embeddings")
    check(norms16[0] <= 1e-5 and norms16[1] <= TEXT_NORM_TOL, f"use_bf16 norms off one by {norms16}")
    rec.update(bf16_image_norm_err=norms16[0], bf16_text_norm_err=norms16[1],
               bf16_weights_image_batch_ms=host_ms(lambda: api.get_image_latent(images)),
               bf16_image_batch_ms=host_ms(lambda: api.m.encode_image(xb)),
               parity_bf16=parity("chinese_clip image embeddings, bf16", api.m.encode_image, xb))
    print(f"last[chinese_clip]: {n_params:,} parameters built in {build_s:.1f} s; tokenizer {rec['tokenizer']} "
          f"{tuple(ids.shape)}; {CCLIP_FLASH} flash launches an image batch of {CCLIP_BATCH} (f32, use_bf16, bf16), "
          f"none for the text; host ms [{card}]: f32 images {rec['f32_image_batch_ms']:.1f}, under use_bf16 "
          f"{rec['bf16_weights_image_batch_ms']:.1f}, bf16 images {rec['bf16_image_batch_ms']:.1f}, texts "
          f"{rec['f32_text_batch_ms']:.1f}; norms off one by {norms} (f32), {norms16} (use_bf16)")
    out["chinese_clip"] = rec
    del api, m, img, txt, img16, txt16, emb, normed, xb, pixels
    torch.cuda.empty_cache()

    # (b) BLIP captioning
    t0 = time.perf_counter()
    bapi = TB.BLIPAPI(device="cuda")
    seeded_(torch, bapi.m, LAST_SEED + 1)
    n_params = sum(p.numel() for p in bapi.m.parameters())
    build_s = time.perf_counter() - t0
    image = smooth_image(LAST_SEED, 480, 640)
    x = bapi.preprocess(image)
    prompt = np.asarray(BLIP_PROMPT)

    def caption_ids(model, xin):
        return TB.generate_caption_tokens(model, xin, prompt, max_length=BLIP_MAX_LENGTH)

    torch.cuda.reset_peak_memory_stats()
    ids_k, out["launches"]["blip"] = launches_of(lambda: caption_ids(bapi.m, x), {"flash_attention": BLIP_FLASH},
                                                 censuses.setdefault("blip", {}))
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(ids_k.shape == (1, BLIP_MAX_LENGTH) and list(ids_k[0, :4]) == list(BLIP_PROMPT)
          and 0 <= ids_k.min() and ids_k.max() < 30524, f"caption ids {ids_k}")
    rec = {"parameters": n_params, "build_s": build_s, "peak_gib": peak,
           "caption_ms": host_ms(lambda: caption_ids(bapi.m, bapi.preprocess(image))),
           "parity_vision": parity("blip vision features, f32", bapi.m.visual_encoder, x)}
    with torch.no_grad(), plain_kernels(A, Cv, Gn):
        ids_p = caption_ids(bapi.m, x)
        enc_p = bapi.m.visual_encoder(x)
    cpu = copy.deepcopy(bapi.m).cpu()
    tokens_p = torch.as_tensor(ids_p, dtype=torch.long)
    with torch.no_grad():
        logits = bapi.m.text_decoder(tokens_p.cuda(), enc_p).float().cpu()
        logits_cpu = cpu.text_decoder(tokens_p, enc_p.cpu())
    rec["decoder_card_vs_cpu"] = rel_err(logits, logits_cpu)
    t0 = time.perf_counter()
    ids_cpu = caption_ids(cpu, x.cpu())
    rec["cpu_caption_s"] = time.perf_counter() - t0
    new = slice(len(BLIP_PROMPT), BLIP_MAX_LENGTH)
    rec["greedy_ids_agreeing_with_cpu"] = int((ids_k[0, new] == ids_cpu[0, new]).sum())
    rec["plain_ids_agreeing"] = int((ids_k[0, new] == ids_p[0, new]).sum())
    check(rec["decoder_card_vs_cpu"] <= NET_REL, f"blip decoder card vs CPU {rec['decoder_card_vs_cpu']:.3e}")
    tok, bapi.tokenizer = bapi.tokenizer, None
    try:
        bapi.caption(image)
        raised = False
    except RuntimeError:
        raised = True
    bapi.tokenizer = tok
    check(raised, "caption did not raise without a tokenizer")
    rec["tokenizer_loaded"] = tok is not None
    rec["tokenizer"] = f"{type(tok).__module__}.{type(tok).__qualname__}"
    if tok is not None:  # a cached bert-base-uncased: the whole API, ids decoded
        rec["caption"] = bapi.caption(image)
        rec["api_caption_ms"] = host_ms(lambda: bapi.caption(image))
    print(f"last[blip]: {n_params:,} parameters; {BLIP_FLASH} flash launches a caption of {BLIP_MAX_LENGTH} ids; ids "
          f"{ids_k[0].tolist()}; the decoder's logits over the plain path's ids card vs CPU max rel "
          f"{rec['decoder_card_vs_cpu']:.3e} (tolerance {NET_REL}); greedy ids agreeing with the CPU's "
          f"{rec['greedy_ids_agreeing_with_cpu']} / {BLIP_MAX_LENGTH - len(BLIP_PROMPT)}, with the plain path's "
          f"{rec['plain_ids_agreeing']}; host ms a caption [{card}] {rec['caption_ms']:.1f} (CPU "
          f"{rec['cpu_caption_s']:.1f} s), peak {peak:.2f} GiB; a bert-base-uncased tokenizer loaded: "
          f"{rec['tokenizer_loaded']} ({rec['tokenizer']})"
          + (f" (caption {rec['caption']!r}, {rec['api_caption_ms']:.1f} ms)" if tok else "")
          + f"; caption without one raises: {raised}")
    out["blip"] = rec
    del bapi, cpu, x, enc_p, logits, logits_cpu
    torch.cuda.empty_cache()

    # (c) the GPT-2 prompt sampler at distilgpt2's width
    gpt = seeded_(torch, TPR.load_gpt2(device="cuda"), LAST_SEED + 2)
    config = TPR.PromptConfig(num_return_sequences=GPT2_SEQUENCES)
    kw = dict(max_length=config.max_length, temperature=config.temperature, repetition_penalty=config.repitition_penalty,
              num_return_sequences=config.num_return_sequences)
    prompt = np.asarray(GPT2_PROMPT)
    (greedy, _) = launches_of(lambda: TPR.sample_tokens(gpt, prompt, top_k=1, **kw), {}, {})
    cpu = copy.deepcopy(gpt).cpu()
    t0 = time.perf_counter()
    greedy_cpu = TPR.sample_tokens(cpu, prompt, top_k=1, **kw)
    cpu_s = time.perf_counter() - t0
    sampled = TPR.sample_tokens(gpt, prompt, top_k=config.top_k, generator=torch.Generator(device="cuda").manual_seed(0),
                                **kw)
    rec = {"parameters": sum(p.numel() for p in gpt.parameters()), "top_k_1_equal_to_cpu": bool(
        np.array_equal(greedy, greedy_cpu)), "cpu_s": cpu_s,
        "distinct_sampled_rows": len({tuple(r) for r in sampled}),
        "ms_a_sequence_top_k_1": host_ms(lambda: TPR.sample_tokens(gpt, prompt, top_k=1, **kw), 2) / GPT2_SEQUENCES,
        "ms_a_sequence": host_ms(lambda: TPR.sample_tokens(gpt, prompt, top_k=config.top_k, **kw), 2) / GPT2_SEQUENCES}
    check(greedy.shape == sampled.shape == (GPT2_SEQUENCES, config.max_length), f"{greedy.shape} {sampled.shape}")
    check(rec["top_k_1_equal_to_cpu"], f"top_k=1 ids differ from the CPU's: {greedy[0].tolist()} / {greedy_cpu[0].tolist()}")
    print(f"last[gpt2]: {rec['parameters']:,} parameters; sample_tokens at the PromptConfig defaults, "
          f"{GPT2_SEQUENCES} sequences of {config.max_length}: top_k=1 ids equal to the CPU's: "
          f"{rec['top_k_1_equal_to_cpu']} (CPU {cpu_s:.1f} s), no launch; top-k {config.top_k}: "
          f"{rec['distinct_sampled_rows']} distinct rows; host ms a sequence [{card}] top_k=1 "
          f"{rec['ms_a_sequence_top_k_1']:.1f}, top-k {config.top_k} {rec['ms_a_sequence']:.1f}")
    papi = TPR.PromptEnhanceAPI(device="cuda")
    seeded_(torch, papi.m, LAST_SEED + 2)
    rec["tokenizer_loaded"] = papi.tokenizer is not None
    rec["tokenizer"] = f"{type(papi.tokenizer).__module__}.{type(papi.tokenizer).__qualname__}"
    if papi.tokenizer is not None:  # a cached distilgpt2: the whole API
        rec["enhanced"] = papi.enhance("a cat sitting on a chair", config)
        rec["enhance_ms"] = host_ms(lambda: papi.enhance("a cat sitting on a chair", config), 2)
        check(len(rec["enhanced"]) == GPT2_SEQUENCES, f"enhance gave {rec['enhanced']}")
    else:
        try:
            papi.enhance("a cat")
            rec["enhance_raises"] = False
        except RuntimeError:
            rec["enhance_raises"] = True
        check(rec["enhance_raises"], "enhance did not raise without a tokenizer")
    print(f"last[gpt2]: a distilgpt2 tokenizer loaded: {rec['tokenizer_loaded']} ({rec['tokenizer']})"
          + (f"; enhance {rec['enhance_ms']:.1f} ms for {GPT2_SEQUENCES}: {rec['enhanced']!r}" if papi.tokenizer
             else "; enhance raises"))
    out["gpt2"] = rec
    del gpt, cpu, papi
    torch.cuda.empty_cache()

    # (d) LaMa, ISNet and iharm from seeded upstream-layout checkpoints through the zoo's converters
    def shapes_of(ctor):
        with torch.device("meta"):
            net = ctor()
        return {k: tuple(v.shape) for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")}

    lama_shapes = shapes_of(TP.LaMaGenerator)
    names = lama_upstream_names(lama_shapes, 9)
    lama_image = smooth_image(LAST_SEED + 6, LAMA_SIDE, LAMA_SIDE)
    lama_mask = np.zeros((LAMA_SIDE, LAMA_SIDE), np.uint8)
    lama_mask[160:352, 128:384] = 255
    isnet_image = smooth_image(LAST_SEED + 7, *ISNET_HW)
    iharm_image = smooth_image(LAST_SEED + 8, *IHARM_HW)
    iharm_mask = np.zeros(IHARM_HW, np.float32)
    iharm_mask[80:220, 50:150] = 1.0
    pads = [((-n) % 128 // 2, (-n) % 128 - (-n) % 128 // 2) for n in IHARM_HW]
    # each API's call, and its net's inputs as the API hands them over
    nets = {
        "lama": (TP.LaMaAPI, upstream_values(np, {u: lama_shapes[k] for u, k in names.items()}, LAST_SEED + 3),
                 lambda a: a.inpaint(lama_image, lama_mask),
                 (lama_image[None] / np.float32(255.0), (lama_mask[None, ..., None] > 0).astype(np.float32))),
        "isnet": (TP.ISNetAPI, upstream_values(np, shapes_of(TP.ISNetDIS), LAST_SEED + 4),
                  lambda a: a.segment(isnet_image, infer_size=ISNET_SIZE),
                  (resize(torch.as_tensor(isnet_image[None], dtype=torch.float32), (ISNET_SIZE, ISNET_SIZE),
                          "bilinear").numpy() / 255.0 - 0.5,)),
        "iharm": (TP.ImageHarmonizationAPI, upstream_values(np, shapes_of(TP.HRNetIHModel), LAST_SEED + 5),
                  lambda a: a.run(iharm_image, iharm_mask),
                  (((np.pad(iharm_image, pads + [(0, 0)]).astype(np.float32) / 255.0 - TP.iharm.IMAGENET_MEAN)
                    / TP.iharm.IMAGENET_STD)[None], np.pad(iharm_mask, pads)[None, ..., None])),
    }
    out["nets"] = {}
    for name, (cls, sd, call, inputs) in nets.items():
        t0 = time.perf_counter()
        capi = cls(state_dict=sd, device="cuda")
        load_s = time.perf_counter() - t0
        hapi = cls(state_dict=sd, device="cpu")
        (got, _) = launches_of(lambda: call(capi), {}, {})
        t0 = time.perf_counter()
        ref = call(hapi)
        cpu_s = time.perf_counter() - t0
        if name == "iharm":  # uint8: within one level on 0.1% of the values
            diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
            api_err = float((diff > 0).mean())
            check(got.shape == ref.shape == IHARM_HW + (3,) and got.dtype == np.uint8 and diff.max() <= 1
                  and api_err <= 1e-3, f"iharm uint8: max {diff.max()}, share {api_err}")
        else:
            api_err = rel_err(torch.from_numpy(np.asarray(got, np.float32)), torch.from_numpy(np.asarray(ref, np.float32)))
            check(np.isfinite(got).all() and got.shape == ref.shape and api_err <= NET_REL,
                  f"{name}: {got.shape}, card vs CPU {api_err:.3e}")
        # the net on its inputs in f64 on both sides: the same computation, whatever f32 rounding makes of it; and
        # each side's f32 output against the CPU's f64 one
        xs = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)) for a in inputs]
        with torch.no_grad():
            first = (lambda y: y[0]) if name == "isnet" else (lambda y: y)
            y_card = first(capi.m(*(t.cuda() for t in xs))).cpu().double()
            y_cpu = first(hapi.m(*xs)).double()
            y64 = first(copy.deepcopy(hapi.m).double()(*(t.double() for t in xs)))
            card64 = copy.deepcopy(capi.m).double()
            y64_card = first(card64(*(t.cuda().double() for t in xs))).cpu()
            del card64
        err64, err_card, err_cpu = rel_err(y64_card, y64), rel_err(y_card, y64), rel_err(y_cpu, y64)
        ms = host_ms(lambda: call(capi))
        n = sum(p.numel() for p in capi.m.parameters())
        print(f"last[{name}]: {n:,} parameters from {len(sd)} upstream-layout tensors loaded strictly in {load_s:.2f} s; "
              f"output {np.asarray(got).shape} {np.asarray(got).dtype}, card vs CPU "
              + (f"differing on {api_err:.2e} of the values" if name == "iharm" else f"max rel {api_err:.3e}")
              + f"; the net in f64, card vs CPU max rel {err64:.3e} (tolerance {NET_REL}); f32 against the CPU's f64: "
              f"card {err_card:.3e}, CPU {err_cpu:.3e}; no kernel launched; host ms an image [{card}] {ms:.1f} (CPU "
              f"{cpu_s:.1f} s)")
        check(err64 <= NET_REL, f"{name}: the net in f64, card vs CPU {err64:.3e}")
        out["nets"][name] = {"parameters": n, "api_card_vs_cpu": api_err, "f64_card_vs_cpu": err64,
                             "f32_card_vs_f64": err_card, "f32_cpu_vs_f64": err_cpu, "host_ms": ms, "cpu_s": cpu_s,
                             "load_s": load_s}
        del capi, hapi, y_card, y_cpu, y64, y64_card
        torch.cuda.empty_cache()

    # every distinct kernel call of (a) and (b) against its plain version (phase 2's tolerances), timed
    calls_out = []
    keys = sorted({key for counts in censuses.values() for key in counts}, key=str)
    for key in keys:
        row = check_call(torch, F, A, Cv, Gn, key, gen, host_ms=True)
        row.update(case=f"{'_'.join(p for p, c in censuses.items() if key in c)}_{'x'.join(map(str, row['shape']))}",
                   per={p: c[key] for p, c in censuses.items() if key in c})
        calls_out.append(row)
        print(f"last call: {json.dumps(row)}")
    out["calls"] = calls_out
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
            if r["case"].startswith("v2_") and name in ("flash_fwd_lse", "flash_bwd_fused"):
                r["per"]["v2_finetune"] = 5
            if r["case"] == "vit384_f32":
                if name == "flash_attention":
                    r["per"]["vit_classify"] = VIT_LAYERS
                elif name in ("flash_fwd_lse", "flash_bwd_fused"):
                    r["per"]["vit_train"] = VIT_LAYERS
            if r["case"] == "ldm_enc_mid" and name == "flash_attention":
                r["per"]["ldm"] = ENCODER_FLASH
            if r["case"] == "dpt_large_f32" and name == "flash_attention":
                r["per"]["depth"] = DPT_FLASH
            if r["case"] == "tab785_f32":
                if name == "flash_attention":
                    r["per"]["tab_predict"] = TAB_LAYERS
                elif name in ("flash_fwd_lse", "flash_bwd_fused"):
                    r["per"]["tab_train"] = TAB_LAYERS
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
            elif r["case"] == "dpt_large_f32":
                print(f"yardstick {name} {r['case']} (B1 H16 L1025 d64 f32, {r['kernel']}): device ms {r['device_ms']:.4f} "
                      f"(host {r['ms']:.4f}), bound {r['bound_ms']:.4f} ({r['bound_by']}), SDPA device "
                      f"{r['library_device_ms']:.4f}, plain {r['plain_ms']:.4f} [{card_line()}]")
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
    # non-reentrant checkpointing runs the first forward with a graph too, so each routed attention
    # takes the forward-with-lse kernel twice per step, and each checkpointed block's norms run twice
    # (the forward's norms; their backward recomputes the plain version)
    want = {
        "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_attention": 0, "conv3x3": 0, "conv3x3_wgrad": 0,
        "conv3x3_w8a8": 0, "quantize_w8a8": 0, "conv3x3_fold": 0, **policy_launches(use_checkpoint, TRAIN_STEPS),
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

    # 14. CLIP embeddings and ESRGAN
    clip_out = phase_clip_esrgan(torch, np, F, cflearn_torch, A, Cv, Gn)
    print(f"clip and esrgan: done at {time.perf_counter() - t_start:.0f} s")

    # 15. the finetune step under each checkpoint policy
    policies_out = phase_checkpoint_policies(torch, cflearn_torch, A, Cv, Gn, build_unet)
    print(f"checkpoint policies: done at {time.perf_counter() - t_start:.0f} s")

    # 16. style reference and tiling through DiffusionAPI
    style_out = phase_style_tiling(torch, np, F, cflearn_torch, A, Cv, Gn)
    print(f"style and tiling: done at {time.perf_counter() - t_start:.0f} s")

    # 17. SD v2 / v2_v served through DiffusionAPI
    v2_out = phase_sd_v2(torch, np, F, cflearn_torch, A, Cv, Gn)
    print(f"sd v2: done at {time.perf_counter() - t_start:.0f} s")

    # 18. the v2_v finetune step through the model core
    v2_train_out = phase_v2_finetune(torch, cflearn_torch, A, Cv, Gn)
    print(f"v2 finetune: done at {time.perf_counter() - t_start:.0f} s")

    # 19. the CV models through the model core
    cv_out = phase_cv_models(torch, np, cflearn_torch, A, Cv, Gn)
    print(f"cv models: done at {time.perf_counter() - t_start:.0f} s")

    # 20. the framework: fit_array, the Trainer, save / load_inference / predict
    fw_out = phase_framework(torch, np, cflearn_torch, A, Cv, Gn, cv_out["clf_vit_384"]["step_ms"])
    print(f"framework: done at {time.perf_counter() - t_start:.0f} s")

    # 21. the tabular side: fit_ml, the ML block stack, ml.common / the transformer, save / load / predict
    tab_out = phase_tabular(torch, np, F, cflearn_torch, A, Cv, Gn)
    print(f"tabular: done at {time.perf_counter() - t_start:.0f} s")

    # 22. the rest of the framework: image folders, the CV blocks, ensembles, export, aot_compile, VQVAEInference
    cvf_out = phase_cv_framework(torch, np, cflearn_torch, A, Cv, Gn, fw_out["ae_kl"]["saved_model"])
    print(f"cv framework: done at {time.perf_counter() - t_start:.0f} s")

    # 23. the ControlNet annotators, get_hint_of -> sample_with_control, DiffusionAPI.compile
    ann_out = phase_annotators_compile(torch, np, F, cflearn_torch, A, Cv, Gn)
    print(f"annotators and compile: done at {time.perf_counter() - t_start:.0f} s")

    # 24. pretrained weights from the cache: SD-1.5 and a ControlNet from upstream-layout files
    pre_out = phase_pretrained(torch, np, cflearn_torch, A, Cv, Gn)
    print(f"pretrained: done at {time.perf_counter() - t_start:.0f} s")

    # 25. the mesh on one card: the Trainer and use_mesh on a one-rank NCCL group, the ring in one process
    mesh_out = phase_mesh(torch, np, cflearn_torch, A, Cv, Gn, build_unet)
    print(f"mesh: done at {time.perf_counter() - t_start:.0f} s")

    # 26. the public surface: kernels from threads, threaded serving, the ddpm preset, repeat_ml / run_multiple
    surface_out = phase_surface(torch, np, F, cflearn_torch, A, Cv, Gn)
    for row in surface_out["ddpm"]["calls"]:
        rows[row["kernel"]].append(row)
    print(f"surface: done at {time.perf_counter() - t_start:.0f} s")

    # 27. the last modules: ChineseCLIP, BLIP captioning, the GPT-2 prompt sampler, LaMa, ISNet, iharm
    last_out = phase_last_modules(torch, np, F, cflearn_torch, A, Cv, Gn)
    for row in last_out["calls"]:
        rows[row["kernel"]].append(row)
    print(f"last modules: done at {time.perf_counter() - t_start:.0f} s")

    # 28. summary
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
                     "ae_defaults": aed_launches, "ae_vq": vq_launches, "v2_finetune": v2_train_out["launches"],
                     "vit_classify": cv_out["clf_vit_384"]["classify_launches"],
                     "vit_train": cv_out["clf_vit_384"]["launches"],
                     "tab_predict": tab_out["transformer"]["predict_launches_all"],
                     "tab_train": tab_out["transformer"]["launches_all"], "depth": ann_out["depth"]["launches"],
                     "ddpm": surface_out["ddpm"]["sample_launches"], **last_out["launches"]}
    path_unit = {"txt2img": "one txt2img", "finetune": "one finetune step", "ae": "one autoencoder train step",
                 "w8a8": "one W8A8 VAE decode", "fold": "one dj-folded VAE decode",
                 "faithful": "one faithful txt2img", "accelerated": "one accelerated txt2img",
                 "ldm": "one finetune step on 512px images", "ae_defaults": "one autoencoder train step at the defaults",
                 "ae_vq": "one ae_vq train step", "v2_finetune": "one v2_v finetune step (batch 4, 96x96 latents)",
                 "vit_classify": f"one ViT-S/16 classify of {CV_BATCH} images at 384 px (f32)",
                 "vit_train": f"one ViT-S/16 train step at 384 px, batch {VIT_TRAIN_BATCH} (f32)",
                 "tab_predict": f"one tabular transformer predict batch of {TAB_BATCH} rows at {TAB_TOKENS} tokens (f32)",
                 "tab_train": f"one tabular transformer train step at batch {TAB_BATCH}, {TAB_TOKENS} tokens (f32)",
                 "depth": f"one DPT-Large depth forward on a {ANNOTATOR_SIDE}x{ANNOTATOR_SIDE} image (f32)",
                 "ddpm": f"one diffusion/ddpm sample of {DDPM_SAMPLES} images at 64 px, {DDPM_STEPS} DDIM steps (bf16)",
                 "chinese_clip": f"one ChineseCLIP image batch of {CCLIP_BATCH} at 224 px through CLIPExtractor (f32)",
                 "chinese_clip_bf16": f"one ChineseCLIP encode_image of {CCLIP_BATCH} bf16 images at 224 px (bf16)",
                 "blip": f"one BLIP caption of {BLIP_MAX_LENGTH} ids at 384 px (f32)"}
    path_run = dict(path_unit, finetune=f"{TRAIN_STEPS} finetune steps", ae=f"{AE_STEPS} autoencoder train steps",
                    ldm=f"{TRAIN_STEPS} finetune steps on 512px images",
                    ae_defaults=f"{AE_STEPS} autoencoder train steps at the defaults", ae_vq=f"{AE_STEPS} ae_vq train steps",
                    v2_finetune=f"{TRAIN_STEPS} v2_v finetune steps",
                    vit_train=f"{2 * CV_STEPS} ViT-S/16 train steps at 384 px (two windows)",
                    tab_predict=f"one tabular transformer predict of {TAB_PREDICT_ROWS} rows",
                    tab_train=f"one tabular transformer fit_ml: {TAB_TF_STEPS} steps and its evaluation batches")
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
        threads = next(r for r in surface_out["threads"] if r["kernel"] == name)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, path=main_path,
            max_abs_err=max(r["max_abs_err"] for r in cases), **totals(main_path),
            other_paths={p: totals(p) for p in paths if p != main_path},
            threads={k: threads[k] for k in ("ok", "launches", "tol", "main", "thread", "two_at_once")},
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
                   "vq_api": vq_api_out, "clip_esrgan": clip_out, "checkpoint_policies": policies_out,
                   "style_tiling": style_out, "sd_v2": v2_out, "v2_finetune": v2_train_out, "cv_models": cv_out,
                   "framework": fw_out, "tabular": tab_out, "cv_framework": cvf_out, "annotators_compile": ann_out,
                   "pretrained": pre_out, "mesh": mesh_out, "surface": surface_out, "last_modules": last_out,
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
    print(json.dumps({"clip_esrgan": clip_out}))
    print(json.dumps({"checkpoint_policies": policies_out}))
    print(json.dumps({"style_tiling": {k: v for k, v in style_out.items() if k != "calls"}}))
    print(json.dumps({"sd_v2": {k: v for k, v in v2_out.items() if k != "calls"},
                      "v2_finetune": {k: v for k, v in v2_train_out.items() if k != "calls"}}))
    print(json.dumps({"cv_models": cv_out}))
    print(json.dumps({"framework": {k: {kk: vv for kk, vv in v.items() if kk != "losses"} for k, v in fw_out.items()}}))
    print(json.dumps({"tabular": {k: {kk: vv for kk, vv in v.items() if kk not in ("calls", "launches_all",
                                                                                   "predict_launches_all")}
                                  for k, v in tab_out.items()}}))
    print(json.dumps({"cv_framework": cvf_out}))
    print(json.dumps({"annotators_compile": ann_out}))
    print(json.dumps({"pretrained": pre_out}))
    print(json.dumps({"mesh": mesh_out}))
    print(json.dumps({"surface": {k: v for k, v in surface_out.items() if k != "threads"}}))
    print(json.dumps({"last_modules": {k: v for k, v in last_out.items() if k != "calls"}}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
