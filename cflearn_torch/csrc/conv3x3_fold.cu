// The dj-folded 3x3 stride-1 SAME convolution over NHWC bf16 / fp16: an
// implicit GEMM whose K loop runs over the 3 row taps, each 3C deep over
// (dj, channel), on the tensor cores (mma.sync m16n8k16, f32 accumulation),
// for Hopper (sm_90a). The GEMM body is `conv3x3_igemm.cuh` with the folded
// K layout.
//
// Replaces: cflearn_tpu/ops/conv.py `_conv3x3_kernel_fold` (launched by
// `conv3x3_pallas(fold=True)`), which concatenates the 3 horizontal taps on
// the lanes and runs 3 matmuls 3C deep against w.reshape(3, 3C, Co).
//
// Here: for output pixel (i, j) and row tap di the A row is the contiguous
// 3C-element span x[b, i+di-1, j-1 : j+2, :] (NHWC keeps neighbouring pixels
// of a row adjacent), zero-filled where it leaves the image; the B column is
// w[co, di, :, :], contiguous over (dj, c) in the (Co, 3, 3, C) layout, the
// counterpart of the JAX package's w.reshape(3, 3C, Co). Each (pixel, row)
// costs one 3C-long read where the 9-tap kernel makes three C-long ones, and
// K is padded to the 32-channel slice once per row instead of once per tap.
// The bias is added in f32 in the epilogue, as in `conv3x3.cu`.
//
// What bounds it on the H100: as `conv3x3.cu` (the same FLOPs and bytes):
// tensor-core bound at the SD shapes.
//
// Layout: x (B, H, W, C) contiguous, w (Co, 3, 3, C) contiguous, bias (Co,)
// or null, y (B, H, W, Co) contiguous. C % 8 == 0 and Co % 8 == 0.

#include "conv3x3_igemm.cuh"

namespace {

template <typename T>
cudaError_t run(const void* x, const void* w, const void* bias, void* y, int B, int H, int W, int C,
                int Co, cudaStream_t s) {
  using namespace cflearn::igemm;
  const EpiBias<T> epi{static_cast<T*>(y), static_cast<const T*>(bias), Co};
  return launch<T, Taps::kFold>(static_cast<const T*>(x), static_cast<const T*>(w), epi, B, H, W, C,
                                Co, s);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16. `bias` may be null. Returns a cudaError_t.
extern "C" int cflearn_conv3x3_fold_fwd(int dtype, const void* x, const void* w, const void* bias,
                                        void* y, int B, int H, int W, int C, int Co, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C % 8 != 0 || Co % 8 != 0 || C <= 0 || Co <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<__nv_bfloat16>(x, w, bias, y, B, H, W, C, Co, s);
  if (dtype == 1) return run<__half>(x, w, bias, y, B, H, W, C, Co, s);
  return cudaErrorInvalidValue;
}
