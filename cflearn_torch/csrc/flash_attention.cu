// Flash-attention forward (inference): bf16 / fp16 / f32 in, f32 softmax state.
//
// Replaces: cflearn_tpu/ops/attention.py `_flash_kernel` (launched by
// `flash_attention`). The kernels and the notes on what bounds them are in
// `flash_fwd_sm90.cuh` (wgmma + TMA: bf16 / fp16, d <= 256) and
// `flash_fwd.cuh` (mma.sync: f32, d >= 512); this build leaves the
// logsumexp output out.

#define CFLEARN_FLASH_LSE 0
#define CFLEARN_FLASH_ENTRY cflearn_flash_attention_fwd
#include "flash_fwd_sm90.cuh"
