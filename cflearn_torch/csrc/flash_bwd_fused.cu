// Flash-attention backward, dq, dk and dv in one pass over the (kv tile, q tile) pairs: five
// products per pair. dq is summed across kv tiles by f32 atomicAdd.
//
// Replaces: cflearn_tpu/ops/attention.py `_flash_bwd_fused_kernel` (launched by
// `_flash_train_bwd`). The kernel, its arithmetic and what bounds it on the
// H100 (tensor-core operations at the UNet shapes) are in `flash_bwd.cuh`.

#define CFLEARN_BWD_MODE CFLEARN_MODE_FUSED
#define CFLEARN_BWD_ENTRY cflearn_flash_bwd_fused
#include "flash_bwd.cuh"
