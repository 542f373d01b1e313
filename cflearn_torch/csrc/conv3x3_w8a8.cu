// W8A8 3x3 stride-1 SAME convolution: int8 activations x int8 weights on the
// tensor cores (mma.sync m16n8k32 s8.s8 -> s32, exact int32 sums),
// dequantised in the epilogue, for Hopper (sm_90a). The GEMM body is
// `conv3x3_igemm.cuh` with the 9-tap K layout and 64-channel K slices.
//
// Replaces: cflearn_tpu/ops/conv.py `_conv3x3_kernel_q` (launched by
// `conv3x3_w8a8`): 9 int8 matmuls with int32 accumulation, scaled by
// s_x * s_w[co] in-kernel so that the output leaves at its final dtype.
//
// Here: the quantised input and weights and the combined per-channel scale
// come from the wrapper (the JAX package also quantises outside its kernel).
// The halo is zero-filled, as the JAX package pads the int8 input with 0.
// The int32 sum is exact: |sum| <= 127^2 * 9 * C, 7.4e7 at C = 512, far below
// 2^31. The epilogue keeps the JAX package's order and rounding:
// f32(acc) * scale[co] in f32 (round to nearest, no fused multiply-add), one
// cast to the output dtype, then + bias in the output dtype (the f32 sum of
// the two values rounded once, as PyTorch adds two bf16 / fp16 tensors).
// Built without --use_fast_math, so it matches the plain version bit for bit.
//
// What bounds it on the H100: 2*9*C int8 operations per output element at
// 1,979 TOP/s against (C + 2*Co) bytes per pixel: tensor-core bound at the VAE
// decoder shapes, at twice the bf16 rate. The same tiles as the bf16 kernel
// carry twice the channels per 64-byte K slice, so the loads per mma halve.
//
// Layout: x (B, H, W, C) int8 contiguous, w (Co, 3, 3, C) int8 contiguous,
// scale (Co,) f32, bias (Co,) in the output dtype or null, y (B, H, W, Co) in
// the output dtype. C % 16 == 0 and Co % 8 == 0.

#include "conv3x3_igemm.cuh"

namespace {

template <typename T>
struct EpiDequant {
  T* y;
  const float* scale;
  const T* bias;
  int Co;
  struct Col {
    float s0, s1, b0, b1;
  };
  __device__ __forceinline__ Col col(int c) const {
    using M = cflearn::Mma<T>;
    return Col{scale[c], scale[c + 1], bias ? M::to_float(bias[c]) : 0.f,
               bias ? M::to_float(bias[c + 1]) : 0.f};
  }
  __device__ __forceinline__ float dequant(int acc, float s, float b) const {
    using M = cflearn::Mma<T>;
    float v = M::to_float(M::from_float(__fmul_rn(__int2float_rn(acc), s)));
    if (bias) v = M::to_float(M::from_float(__fadd_rn(v, b)));
    return v;  // a value of T, exactly
  }
  __device__ __forceinline__ void store(int r, int c, const Col& st, int a0, int a1) const {
    *reinterpret_cast<uint32_t*>(y + size_t(r) * Co + c) =
        cflearn::Mma<T>::pack(dequant(a0, st.s0, st.b0), dequant(a1, st.s1, st.b1));
  }
};

template <typename T>
cudaError_t run(const void* x, const void* w, const void* scale, const void* bias, void* y, int B,
                int H, int W, int C, int Co, cudaStream_t s) {
  using namespace cflearn::igemm;
  const EpiDequant<T> epi{static_cast<T*>(y), static_cast<const float*>(scale),
                          static_cast<const T*>(bias), Co};
  return launch<int8_t, Taps::kNine>(static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                                     epi, B, H, W, C, Co, s);
}

}  // namespace

// out_dtype: 0 = bf16, 1 = fp16. `bias` may be null. Returns a cudaError_t.
extern "C" int cflearn_conv3x3_w8a8(int out_dtype, const void* x, const void* w, const void* scale,
                                    const void* bias, void* y, int B, int H, int W, int C, int Co,
                                    void* stream) {
  // the int32 sum must stay exact: 127 * 127 * 9 * C < 2^31
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 16 != 0 || Co % 8 != 0 ||
      C > 14793)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return run<__nv_bfloat16>(x, w, scale, bias, y, B, H, W, C, Co, s);
  if (out_dtype == 1) return run<__half>(x, w, scale, bias, y, B, H, W, C, Co, s);
  return cudaErrorInvalidValue;
}
