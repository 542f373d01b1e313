// Flash-attention backward, dk and dv: one CTA per kv tile looping over the q
// tiles. With `flash_bwd_dq.cu` the split, bit-reproducible backward.
//
// Replaces: cflearn_tpu/ops/attention.py `_flash_bwd_dkv_kernel` (launched by
// `_flash_train_bwd`). The kernels, their arithmetic and what bounds them on the
// H100 (tensor-core operations at the UNet shapes) are in `flash_bwd_sm90.cuh`
// (wgmma + TMA: bf16 / fp16, d <= 128) and `flash_bwd.cuh` (mma.sync).

#define CFLEARN_BWD_MODE CFLEARN_MODE_DKV
#define CFLEARN_BWD_ENTRY cflearn_flash_bwd_dkv
#include "flash_bwd_sm90.cuh"
