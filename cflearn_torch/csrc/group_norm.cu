// GroupNorm with an optional SiLU over channel-last (B, S, C) bf16 / fp16 /
// f32, for Hopper (sm_90a).
//
// Replaces: cflearn_tpu/ops/group_norm.py `_gn_silu_kernel` (launched by
// `_group_norm_pallas`), which holds one sample's whole (S, C) activation in
// VMEM and computes statistics, normalisation, affine and SiLU in one pass.
//
// One sample does not fit a CTA's shared memory here (256^2 x 128 bf16 is
// 16 MB), and with 32 groups a group is only a few contiguous channels, so
// one CTA per (sample, group) would read a few bytes per row. Instead the
// work is split by rows, in three launches:
//   1. stats: a CTA takes a slab of rows across all C channels, each thread
//      owns a 16-byte chunk of channels and sums x and x^2 down its rows in
//      f32; the per-channel sums are folded into groups in a fixed order and
//      written as partial sums (B, slabs, G, 2). More than 256 chunks of
//      channels go by in tiles, the groups' sums growing tile after tile;
//   2. finalize: one warp per group adds the slabs' partial sums (lanes
//      stride over the slabs, then a shuffle tree: a fixed order) and writes
//      mean and rstd = rsqrt(max(E[x^2] - mean^2, 0) + eps) per (sample, group);
//   3. apply: the same slabs again: y = (x - mean) * rstd * w + b, SiLU,
//      all in f32, one cast to x's type.
// No atomics: the result is bit-reproducible.
//
// What bounds it on the H100: bytes. x is read twice and y written once, a
// few operations per element. The loads are 16 bytes per thread, neighbouring
// threads on neighbouring addresses, and the slabs are sized so that a few
// hundred CTAs are in flight.
//
// x and y are contiguous (B, S, C) of one type; w and b are (C,) of any of the
// three types. C % G == 0; C, S and B are otherwise free.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cflearn {
namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ void from_f(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float v) { d = __float2bfloat16_rn(v); }
__device__ __forceinline__ void from_f(__half& d, float v) { d = __float2half_rn(v); }

// dtype: 0 = bf16, 1 = fp16, 2 = f32
__device__ __forceinline__ float load_param(const void* p, int dtype, int i) {
  if (dtype == 0) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dtype == 1) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// threads as (ty, tx): tx owns channel chunks tx, tx + TX, ...; ty strides the rows
struct Tiling {
  int cv, tx_n, ty_n;
};
__host__ __device__ inline Tiling tiling(int C, int V) {
  Tiling t;
  t.cv = C / V;
  t.tx_n = t.cv < THREADS ? t.cv : THREADS;
  t.ty_n = THREADS / t.tx_n;
  return t;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, long long S, int C, int G,
                    int slabs, long long rows_per) {
  extern __shared__ float sums[];  // [ty_n][ct][2]: one tile of ct channels
  const Tiling t = tiling(C, V);
  const int tid = threadIdx.x, tx = tid % t.tx_n, ty = tid / t.tx_n;
  const int b = blockIdx.x / slabs, slab = blockIdx.x % slabs;
  const long long r0 = slab * rows_per;
  const long long r1 = r0 + rows_per < S ? r0 + rows_per : S;
  const T* xb = x + size_t(b) * S * C;
  float* dst = partial + size_t(blockIdx.x) * G * 2;
  const int cg = C / G;
  // the channels go by in tiles of one chunk per tx (all of C when it has at
  // most THREADS chunks), so the shared sums stay at 16 KB whatever C is
  const int ct = t.tx_n * V;
  for (int c0 = 0; c0 < C; c0 += ct) {
    const int c = c0 + tx * V;
    if (ty < t.ty_n && c < C) {
      float s1[V], s2[V];
#pragma unroll
      for (int v = 0; v < V; ++v) s1[v] = s2[v] = 0.f;
#pragma unroll 4
      for (long long r = r0 + ty; r < r1; r += t.ty_n) {
        const Vec<T, V> in = *reinterpret_cast<const Vec<T, V>*>(xb + size_t(r) * C + c);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float f = to_f(in.v[v]);
          s1[v] += f;
          s2[v] += f * f;
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sums[(ty * ct + tx * V + v) * 2] = s1[v];
        sums[(ty * ct + tx * V + v) * 2 + 1] = s2[v];
      }
    }
    __syncthreads();
    // fold the tile's channels into their groups; a group that began in an
    // earlier tile is added to (by this CTA alone, tile after tile: a fixed order)
    const int c1 = c0 + ct < C ? c0 + ct : C;
    for (int g = c0 / cg + tid; g * cg < c1; g += THREADS) {
      const int lo = g * cg > c0 ? g * cg : c0;
      const int hi = (g + 1) * cg < c1 ? (g + 1) * cg : c1;
      float a = 0.f, q = 0.f;
      for (int y = 0; y < t.ty_n; ++y)
        for (int k = lo; k < hi; ++k) {
          a += sums[(y * ct + k - c0) * 2];
          q += sums[(y * ct + k - c0) * 2 + 1];
        }
      if (g * cg < c0) {
        a += dst[g * 2];
        q += dst[g * 2 + 1];
      }
      dst[g * 2] = a;
      dst[g * 2 + 1] = q;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
    gn_finalize_kernel(const float* __restrict__ partial, float* __restrict__ stats, int slabs,
                       int G, float count, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.x;
  for (int g = warp; g < G; g += THREADS / 32) {
    float a = 0.f, q = 0.f;
    for (int s = lane; s < slabs; s += 32) {
      const float* src = partial + ((size_t(b) * slabs + s) * G + g) * 2;
      a += src[0];
      q += src[1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      q += __shfl_down_sync(0xffffffffu, q, off);
    }
    if (lane == 0) {
      const float mean = a / count;
      const float var = fmaxf(q / count - mean * mean, 0.f);
      stats[(size_t(b) * G + g) * 2] = mean;
      stats[(size_t(b) * G + g) * 2 + 1] = rsqrtf(var + eps);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    gn_apply_kernel(const T* __restrict__ x, const void* __restrict__ w, const void* __restrict__ bias,
                    int pdtype, const float* __restrict__ stats, T* __restrict__ y, long long S, int C,
                    int G, int slabs, long long rows_per, int silu) {
  const Tiling t = tiling(C, V);
  const int tid = threadIdx.x, tx = tid % t.tx_n, ty = tid / t.tx_n;
  if (ty >= t.ty_n) return;
  const int b = blockIdx.x / slabs, cg = C / G;
  const long long r0 = (blockIdx.x % slabs) * rows_per;
  const long long r1 = r0 + rows_per < S ? r0 + rows_per : S;
  const T* xb = x + size_t(b) * S * C;
  T* yb = y + size_t(b) * S * C;
  for (int cc = tx; cc < t.cv; cc += t.tx_n) {
    float mean[V], rstd[V], wv[V], bv[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = cc * V + v;
      mean[v] = stats[(size_t(b) * G + c / cg) * 2];
      rstd[v] = stats[(size_t(b) * G + c / cg) * 2 + 1];
      wv[v] = load_param(w, pdtype, c);
      bv[v] = load_param(bias, pdtype, c);
    }
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += t.ty_n) {
      const Vec<T, V> in = *reinterpret_cast<const Vec<T, V>*>(xb + size_t(r) * C + cc * V);
      Vec<T, V> out;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float f = (to_f(in.v[v]) - mean[v]) * rstd[v] * wv[v] + bv[v];
        if (silu) f = f / (1.f + expf(-f));
        from_f(out.v[v], f);
      }
      *reinterpret_cast<Vec<T, V>*>(yb + size_t(r) * C + cc * V) = out;
    }
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* w, const void* bias, int pdtype, void* y,
                   float* partial, float* stats, int B, long long S, int C, int G, float eps,
                   int silu, int slabs, long long rows_per, cudaStream_t stream) {
  const Tiling t = tiling(C, V);
  const size_t smem = size_t(t.ty_n) * t.tx_n * V * 2 * sizeof(float);  // at most 16 KB
  const unsigned grid = unsigned(B) * unsigned(slabs);
  gn_stats_kernel<T, V><<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), partial, S, C, G,
                                                         slabs, rows_per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float count = static_cast<float>(static_cast<double>(S) * (C / G));
  gn_finalize_kernel<<<B, THREADS, 0, stream>>>(partial, stats, slabs, G, count, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_kernel<T, V><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x), w, bias, pdtype, stats,
                                                      static_cast<T*>(y), S, C, G, slabs, rows_per, silu);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cflearn

// xdtype / pdtype: 0 = bf16, 1 = fp16, 2 = f32 (x and y; w and bias).
// `partial` holds B * slabs * G * 2 floats, `stats` B * G * 2. The slabs of
// `rows_per` rows cover S. Threads own 16-byte channel chunks where C and the
// addresses of x and y allow it, else single channels. Returns a cudaError_t.
extern "C" int cflearn_group_norm(int xdtype, int pdtype, const void* x, const void* w,
                                  const void* bias, void* y, void* partial, void* stats, int B,
                                  long long S, int C, int G, float eps, int silu, int slabs,
                                  long long rows_per, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || G <= 0 || C % G != 0 || slabs <= 0 || rows_per <= 0 ||
      static_cast<long long>(slabs) * rows_per < S || pdtype < 0 || pdtype > 2 ||
      static_cast<long long>(B) * slabs > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* st = static_cast<float*>(stats);
#define CFLEARN_GN(T, V) \
  return cflearn::launch<T, V>(x, w, bias, pdtype, y, p, st, B, S, C, G, eps, silu, slabs, rows_per, s)
  if (xdtype == 0) {
    if (vec && C % 8 == 0) CFLEARN_GN(__nv_bfloat16, 8);
    CFLEARN_GN(__nv_bfloat16, 1);
  }
  if (xdtype == 1) {
    if (vec && C % 8 == 0) CFLEARN_GN(__half, 8);
    CFLEARN_GN(__half, 1);
  }
  if (xdtype == 2) {
    if (vec && C % 4 == 0) CFLEARN_GN(float, 4);
    CFLEARN_GN(float, 1);
  }
#undef CFLEARN_GN
  return cudaErrorInvalidValue;
}
