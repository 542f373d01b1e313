// Flash-attention backward, dq, dk and dv in one pass over the (kv tile, q tile) pairs: five
// products per pair. dq is summed across kv tiles in an f32 buffer by bulk reduce-adds of whole
// 64-row tiles (the wgmma kernel) or by f32 atomicAdd (the mma.sync kernel).
//
// Replaces: cflearn_tpu/ops/attention.py `_flash_bwd_fused_kernel` (launched by
// `_flash_train_bwd`). The kernels, their arithmetic and what bounds them on the
// H100 (tensor-core operations at the UNet shapes) are in `flash_bwd_sm90.cuh`
// (wgmma + TMA: bf16 / fp16, d <= 128) and `flash_bwd.cuh` (mma.sync).

#define CFLEARN_BWD_MODE CFLEARN_MODE_FUSED
#define CFLEARN_BWD_ENTRY cflearn_flash_bwd_fused
#include "flash_bwd_sm90.cuh"
