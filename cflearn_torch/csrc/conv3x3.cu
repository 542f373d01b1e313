// 3x3 stride-1 SAME convolution over NHWC bf16 / fp16 as an implicit GEMM on
// the tensor cores (mma.sync m16n8k16, f32 accumulation), for Hopper
// (sm_90a). The GEMM body is `conv3x3_igemm.cuh` with the 9-tap K layout.
//
// Replaces: cflearn_tpu/ops/conv.py `_conv3x3_kernel` (launched by
// `conv3x3_pallas`, fold=False), which computes the conv as 9 shifted
// matmuls over halo'd row tiles of a pre-padded input.
//
// Here: M = B*H*W output pixels, N = Co, K = 9*C (tap-major, then channel),
// 128 x 128 output tiles, 32-channel K slices through a 3-stage cp.async ring.
// The bias is added in f32 in the epilogue.
//
// What bounds it on the H100: at the VAE decoder shapes the conv does
// 2*9*C FLOPs per output element against ~(C + Co)*2 bytes per pixel, i.e.
// several hundred FLOPs per byte -> tensor-core bound; the ring keeps the
// loads in flight behind the mma.sync stream (wgmma / TMA are later work).
//
// Layout: x (B, H, W, C) contiguous, w (Co, 3, 3, C) contiguous (OHWI: each
// output channel's K vector is contiguous), bias (Co,) or null, y (B, H, W,
// Co) contiguous. C % 8 == 0 and Co % 8 == 0.

#include "conv3x3_igemm.cuh"

namespace {

template <typename T>
cudaError_t run(const void* x, const void* w, const void* bias, void* y, int B, int H, int W, int C,
                int Co, cudaStream_t s) {
  using namespace cflearn::igemm;
  const EpiBias<T> epi{static_cast<T*>(y), static_cast<const T*>(bias), Co};
  return launch<T, Taps::kNine>(static_cast<const T*>(x), static_cast<const T*>(w), epi, B, H, W, C,
                                Co, s);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16. `bias` may be null. Returns a cudaError_t.
extern "C" int cflearn_conv3x3_fwd(int dtype, const void* x, const void* w, const void* bias,
                                   void* y, int B, int H, int W, int C, int Co, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C % 8 != 0 || Co % 8 != 0 || C <= 0 || Co <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<__nv_bfloat16>(x, w, bias, y, B, H, W, C, Co, s);
  if (dtype == 1) return run<__half>(x, w, bias, y, B, H, W, C, Co, s);
  return cudaErrorInvalidValue;
}
