// Flash-attention backward, dq alone: one CTA per q tile looping over the kv
// tiles. With `flash_bwd_dkv.cu` the split, bit-reproducible backward.
//
// Replaces: cflearn_tpu/ops/attention.py `_flash_bwd_dq_kernel` (launched by
// `_flash_train_bwd`). The kernels, their arithmetic and what bounds them on the
// H100 (tensor-core operations at the UNet shapes) are in `flash_bwd_sm90.cuh`
// (wgmma + TMA: bf16 / fp16, d <= 192) and `flash_bwd.cuh` (mma.sync).

#define CFLEARN_BWD_MODE CFLEARN_MODE_DQ
#define CFLEARN_BWD_ENTRY cflearn_flash_bwd_dq
#include "flash_bwd_sm90.cuh"
