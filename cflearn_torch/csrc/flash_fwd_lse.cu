// Flash-attention forward that also writes the per-row logsumexp
// lse = m + log(max(l, 1e-30)) in f32, (B, H, Lq): the residual that the
// backward kernels (`flash_bwd.cuh`) recompute P from.
//
// Replaces: cflearn_tpu/ops/attention.py `_flash_fwd_kernel` (launched by
// `_flash_fwd_with_lse`). It is the forward of `flash_fwd_sm90.cuh` and
// `flash_fwd.cuh` with its LSE template flag on: same tiles, same bounds
// (the exponentials at d = 40, the products at d = 80 and 160), 4 more bytes
// written per q row.

#define CFLEARN_FLASH_LSE 1
#define CFLEARN_FLASH_ENTRY cflearn_flash_fwd_lse
#include "flash_fwd_sm90.cuh"
