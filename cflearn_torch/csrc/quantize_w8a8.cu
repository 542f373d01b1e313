// The W8A8 conv's operands in one launch: the per-tensor int8 quantisation of
// the activation, the per-output-channel int8 quantisation of the weight, and
// their combined scale, for Hopper (sm_90a).
//
// Replaces: the quantisation lines of cflearn_tpu/ops/conv.py `conv3x3_w8a8`
// (:263-267), which XLA computes outside the Pallas kernel `_conv3x3_kernel_q`
// (no Pallas kernel of its own):
//   s_x = max|x| / 127 + 1e-12,           x8 = clip(round(x / s_x), -127, 127)
//   s_w[co] = max over (di, dj, c) of |w| / 127 + 1e-12,
//                                         w8 = clip(round(w / s_w), -127, 127)
//   scale[co] = s_x * s_w[co]
// bit for bit as the plain version, `ops/conv.py::w8a8_operands`, computes
// them: the maximum exact in x's dtype; each scale the f32 rounding of the f64
// amax * f32(1/127) + f32(1e-12) (`_quant_scale`; the f64 product of two f32
// values is exact); an IEEE f32 division rounded half to even; one f32
// product for the combined scale. Built without --use_fast_math.
//
// One cooperative launch: every CTA resident, one grid barrier. Before the
// barrier each CTA takes the largest |x| over its 16-byte chunks of x into a
// slot of its own (with the sign bit cleared, the 16-bit patterns of
// non-negative bf16 / fp16 values order as the values do, so an integer
// maximum of the patterns, two a word, is the maximum, in any order), and
// quantises whole weight rows: each output channel's 9C contiguous values,
// their maximum, their scale, their int8 values. After the barrier every CTA
// reduces the slots to the same s_x and quantises its chunks of x, walking
// them in the reverse order of the first pass, so that the chunks read last,
// which still sit in L2, come first; then it writes the combined scales of
// its rows. No memset and no atomics: the same bits on every launch.
//
// What bounds it on the H100: bytes. x read and x8 written (1.5 bytes an
// element of a 16-bit x), w read and w8 written; x is read a second time
// after the barrier, from L2 where it fits (the VAE decoder's 64^2 and 128^2
// inputs, 4-16 MB), else from device memory. Loads are 16 bytes a thread,
// four in flight.
//
// Layout: x (n,) bf16 / fp16 contiguous, n = 8 * chunks; w (Co, 9C) of the
// same dtype, 9C = 8 * row_chunks; x8 (n,) and w8 (Co, 9C) int8; scale (Co,)
// f32; partial: one u32 slot a CTA. x and w 16-byte aligned, x8 and w8
// 8-byte aligned.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "host.cuh"

namespace cflearn {
namespace {

constexpr int QT = 512;  // threads a CTA; two CTAs an SM
constexpr int WARPS = QT / 32;
constexpr int UNROLL = 4;                  // 16-byte loads in flight a thread
constexpr float INV_127 = 0x1.020408p-7f;  // f32(1 / 127)
constexpr float EPS = 0x1.197998p-40f;     // f32(1e-12)

// amax / 127 + 1e-12 as `_quant_scale` computes it: the f64 product of two f32 values (exact), the f64 sum,
// one rounding to f32
__device__ __forceinline__ float quant_scale(float amax) {
  return __double2float_rn(__dadd_rn(__dmul_rn(double(amax), double(INV_127)), double(EPS)));
}

template <typename T>
struct Bits;

template <>
struct Bits<__nv_bfloat16> {
  static __device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
  static __device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
};

template <>
struct Bits<__half> {
  static __device__ __forceinline__ float lo(uint32_t v) { return __half2float(__ushort_as_half(uint16_t(v))); }
  static __device__ __forceinline__ float hi(uint32_t v) { return __half2float(__ushort_as_half(uint16_t(v >> 16))); }
};

// the packed maxima of |v| (two 16-bit patterns a word, sign bits cleared) folded into m
__device__ __forceinline__ uint32_t max_chunk(uint32_t m, uint4 v) {
  m = __vmaxu2(m, v.x & 0x7fff7fffu);
  m = __vmaxu2(m, v.y & 0x7fff7fffu);
  m = __vmaxu2(m, v.z & 0x7fff7fffu);
  return __vmaxu2(m, v.w & 0x7fff7fffu);
}

// the larger of the two halves of the packed maxima of every thread of the CTA, in every thread
__device__ __forceinline__ uint32_t block_max(uint32_t packed, uint32_t* red) {
  const uint32_t v = __reduce_max_sync(0xffffffffu, max(packed & 0xffffu, packed >> 16));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) m = max(m, red[i]);
  __syncthreads();  // `red` is free again
  return m;
}

// round(v / s) clipped to +-127: an IEEE division, rounded half to even
__device__ __forceinline__ uint32_t q1(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return uint32_t(__float2int_rn(q)) & 0xffu;
}

// eight 16-bit values -> eight int8 values
template <typename T>
__device__ __forceinline__ uint2 quantize8(uint4 v, float s) {
  using B = Bits<T>;
  const uint32_t lo = q1(B::lo(v.x), s) | q1(B::hi(v.x), s) << 8 | q1(B::lo(v.y), s) << 16 | q1(B::hi(v.y), s) << 24;
  const uint32_t hi = q1(B::lo(v.z), s) | q1(B::hi(v.z), s) << 8 | q1(B::lo(v.w), s) << 16 | q1(B::hi(v.w), s) << 24;
  return make_uint2(lo, hi);
}

template <typename T>
__global__ void __launch_bounds__(QT, 2)
    quantize_w8a8_kernel(const uint4* __restrict__ x, const uint4* __restrict__ w, uint2* __restrict__ x8,
                         uint2* __restrict__ w8, float* __restrict__ scale, uint32_t* __restrict__ partial,
                         long long chunks, int Co, int row_chunks) {
  __shared__ uint32_t red[WARPS];
  const long long stride = (long long)gridDim.x * QT;
  const long long first = (long long)blockIdx.x * QT + threadIdx.x;

  // 1. the largest |x| over this CTA's chunks into its slot
  uint32_t m = 0;
  long long i = first;
  for (; i + (UNROLL - 1) * stride < chunks; i += UNROLL * stride) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) m = max_chunk(m, v[u]);
  }
  for (; i < chunks; i += stride) m = max_chunk(m, __ldg(x + i));
  m = block_max(m, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;

  // the weight rows of this CTA: a row's maximum, its scale (kept in `scale` until after the barrier, by the
  // thread that reads it back), its int8 values (the second read of the row hits L1 / L2)
  for (int co = blockIdx.x; co < Co; co += gridDim.x) {
    const uint4* row = w + (long long)co * row_chunks;
    uint32_t mw = 0;
    for (int k = threadIdx.x; k < row_chunks; k += QT) mw = max_chunk(mw, __ldg(row + k));
    const uint32_t amax = block_max(mw, red);
    const float s_w = quant_scale(Bits<T>::lo(amax));
    uint2* out = w8 + (long long)co * row_chunks;
    for (int k = threadIdx.x; k < row_chunks; k += QT) out[k] = quantize8<T>(__ldg(row + k), s_w);
    if (threadIdx.x == 0) scale[co] = s_w;
  }

  cooperative_groups::this_grid().sync();

  // 2. s_x from every CTA's slot (written in this launch: read through L2, not the read-only path), the same
  // value in every CTA
  uint32_t mx = 0;
  for (int k = threadIdx.x; k < int(gridDim.x); k += QT) mx = max(mx, __ldcg(partial + k));
  const float s_x = quant_scale(Bits<T>::lo(block_max(mx, red)));

  // x's chunks in the reverse order of step 1: the last ones read are the first quantised
  i = first;
  for (; i + (UNROLL - 1) * stride < chunks; i += UNROLL * stride) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(x + (chunks - 1 - (i + u * stride)));
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) x8[chunks - 1 - (i + u * stride)] = quantize8<T>(v[u], s_x);
  }
  for (; i < chunks; i += stride) x8[chunks - 1 - i] = quantize8<T>(__ldg(x + (chunks - 1 - i)), s_x);

  if (threadIdx.x == 0)
    for (int co = blockIdx.x; co < Co; co += gridDim.x) scale[co] = __fmul_rn(s_x, scale[co]);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* x8, void* w8, void* scale, void* partial, long long chunks,
                   int Co, int row_chunks, int ctas, cudaStream_t stream) {
  // every CTA must be resident at once (the grid barrier): the launch refuses a grid larger than the card holds
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(ctas));
  cfg.blockDim = dim3(QT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, quantize_w8a8_kernel<T>, static_cast<const uint4*>(x),
                                       static_cast<const uint4*>(w), static_cast<uint2*>(x8), static_cast<uint2*>(w8),
                                       static_cast<float*>(scale), static_cast<uint32_t*>(partial), chunks, Co,
                                       row_chunks);
  return err;
}

}  // namespace
}  // namespace cflearn

// dtype: 0 = bf16, 1 = fp16 (x and w). x holds 8 * chunks values, w Co rows of 8 * row_chunks; `partial` one u32
// a CTA; ctas: the cooperative grid (at most what the card holds at once, two CTAs an SM). Returns a cudaError_t.
extern "C" int cflearn_quantize_w8a8(int dtype, const void* x, const void* w, void* x8, void* w8, void* scale,
                                     void* partial, long long chunks, int Co, int row_chunks, int ctas,
                                     void* stream) {
  const cflearn::DeviceOf device(x);  // the device of `x`, its context bound to this thread
  if (device.error() != cudaSuccess) return device.error();
  const auto misaligned = [](const void* p, uintptr_t a) { return (reinterpret_cast<uintptr_t>(p) & (a - 1)) != 0; };
  if (chunks <= 0 || Co <= 0 || row_chunks <= 0 || ctas <= 0 || misaligned(x, 16) || misaligned(w, 16) ||
      misaligned(x8, 8) || misaligned(w8, 8) || misaligned(scale, 4) || misaligned(partial, 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return cflearn::launch<__nv_bfloat16>(x, w, x8, w8, scale, partial, chunks, Co, row_chunks, ctas, s);
  if (dtype == 1) return cflearn::launch<__half>(x, w, x8, w8, scale, partial, chunks, Co, row_chunks, ctas, s);
  return cudaErrorInvalidValue;
}
