// GroupNorm with an optional SiLU over channel-last (B, S, C) bf16 / fp16 /
// f32, for Hopper (sm_90a), in one launch per call.
//
// Replaces: cflearn_tpu/ops/group_norm.py `_gn_silu_kernel` (launched by
// `_group_norm_pallas`), which holds one sample's whole (S, C) activation in
// VMEM and computes statistics, normalisation, affine and SiLU in one pass.
//
// What bounds it on the H100: bytes. x is read and y written, a few
// operations per element; at the UNet's shapes a call moves 0.3-16 MB, a few
// microseconds at 3.35 TB/s, so the launch, the ramp of the grid and the
// chain of dependent steps count as much as the bytes.
//
// One launch, a cooperative grid: at most one CTA per SM, all resident, one
// grid barrier between the statistics and the output of each wave of
// samples. Each sample's rows are cut into slabs (the planner,
// `ops/group_norm.py::gn_plan`); a CTA takes whole rows, so its slab is one
// contiguous span of x and every load is a full line. Per wave, each CTA
//   1. for its first slab, starts one bulk copy (`cp.async.bulk`) of as many
//      rows as its shared memory holds beside the sums, and meanwhile reads
//      the rest of the slab into registers; sums x and x^2 per channel in f32
//      (each thread its rows in order), then per group in a fixed order (JG
//      threads a group, then the JG in order), and writes the slab's group
//      sums to global memory;
//   2. after the grid barrier adds its sample's slab sums in a fixed order
//      (thread j of JG over the slabs j, j + JG, ..., then the JG in order), so
//      every CTA of a sample holds the same mean and rstd =
//      rsqrt(max(E[x^2] - mean^2, 0) + eps);
//   3. writes y = x * (rstd w) + (b - mean rstd w), SiLU (one
//      special-function operation an element), one rounding; the rows last read first: those
//      past the kept ones again from global memory (mostly L2), then the kept
//      ones from shared memory.
// "on_chip": every CTA keeps its whole slab, x is read from HBM once (every
// UNet norm of txt2img); "streamed": the rest is read again (the 512^2
// decoder levels, the autoencoder's 256^2 ones). Waves of fewer samples keep
// more of a large batch on chip, or in L2, at a barrier each. A batch larger
// than the grid gives a CTA several slabs, all but the first streamed.
// Nothing is allocated here (the wrapper hands in the slab sums) and no
// atomics are used: the result is bit-reproducible, and the launch can be
// captured in a CUDA graph.
//
// `cflearn_group_norm_slabs` keeps the previous design, three launches per
// call (stats, finalize, apply; x read twice), as the yardstick that
// `gn_plan(kernel="slabs")` names.
//
// x and y are contiguous (B, S, C) of one type; w and b are (C,) of any of the
// three types. C % G == 0; C, S and B are otherwise free.

#include <cooperative_groups.h>

#include <type_traits>

#include "sm90.cuh"

namespace cflearn {
namespace {

constexpr int THREADS = 256;
constexpr int U = 4;              // rows a thread has in flight
constexpr int SMEM_MAX = 232448;  // the most dynamic shared memory a block can have on sm_90

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

// ---- the previous design, three launches (the yardstick) ----------------------
// 1. stats: a CTA takes a slab of rows across all C channels and writes its
//    groups' partial sums (B, slabs, G, 2), channels in tiles of one 16-byte
//    chunk a thread; 2. finalize: one warp per group adds the slabs' partial
//    sums and writes mean and rstd; 3. apply: the same slabs again.

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
cudaError_t launch_slabs(const void* x, const void* w, const void* bias, int pdtype, void* y,
                   float* partial, float* stats, int B, long long S, int C, int G, float eps,
                   int silu, int slabs, long long rows_per, cudaStream_t stream) {
  const Tiling t = tiling(C, V);
  const size_t smem = size_t(t.ty_n) * t.tx_n * V * 2 * sizeof(float);  // at most 16 KB
  const unsigned grid = unsigned(B) * unsigned(slabs);
  cudaError_t err = launch_kernel(gn_stats_kernel<T, V>, grid, THREADS, smem, stream, static_cast<const T*>(x),
                                  partial, S, C, G, slabs, rows_per);
  if (err != cudaSuccess) return err;
  const float count = static_cast<float>(static_cast<double>(S) * (C / G));
  err = launch_kernel(gn_finalize_kernel, B, THREADS, 0, stream, partial, stats, slabs, G, count, eps);
  if (err != cudaSuccess) return err;
  return launch_kernel(gn_apply_kernel<T, V>, grid, THREADS, 0, stream, static_cast<const T*>(x), w, bias, pdtype,
                       stats, static_cast<T*>(y), S, C, G, slabs, rows_per, silu);
}


// ---- one launch: a cooperative grid, whole rows per CTA --------------------

constexpr int GT = 512;        // threads of a CTA of the one-launch kernel; one CTA per SM
constexpr int BULK_PIECE = 32768;  // bytes per bulk copy of the kept rows

// a chunk of V values to f32 and back, 16-bit pairs converted together
template <typename T, int V>
__device__ __forceinline__ void unpack(const Vec<T, V>& in, float* f) {
  if constexpr (V % 2 == 0 && std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int v = 0; v < V; v += 2) {
      const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in.v[v]));
      f[v] = p.x;
      f[v + 1] = p.y;
    }
  } else if constexpr (V % 2 == 0 && std::is_same<T, __half>::value) {
#pragma unroll
    for (int v = 0; v < V; v += 2) {
      const float2 p = __half22float2(*reinterpret_cast<const __half2*>(&in.v[v]));
      f[v] = p.x;
      f[v + 1] = p.y;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = to_f(in.v[v]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void pack(Vec<T, V>& out, const float* f) {
  if constexpr (V % 2 == 0 && std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int v = 0; v < V; v += 2)
      *reinterpret_cast<__nv_bfloat162*>(&out.v[v]) = __floats2bfloat162_rn(f[v], f[v + 1]);
  } else if constexpr (V % 2 == 0 && std::is_same<T, __half>::value) {
#pragma unroll
    for (int v = 0; v < V; v += 2) *reinterpret_cast<__half2*>(&out.v[v]) = __floats2half2_rn(f[v], f[v + 1]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) from_f(out.v[v], f[v]);
  }
}

// x * sigmoid(x) in f32: d = 1 + 2^(-x log2 e) from the special-function unit (the exponent capped at 80:
// below x = -55 the result is 0 to f32 precision either way), 1 / d by three Newton steps from an integer
// first guess on the FMA pipe (12% -> 1.4% -> 2e-4 -> 4e-8), so one special-function operation per element
__device__ __forceinline__ float silu_f(float f) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(fminf(f * -1.4426950408889634f, 80.f)));
  const float d = 1.f + e;
  float r = __int_as_float(0x7EF311C7 - __float_as_int(d));
  r *= fmaf(-d, r, 2.f);
  r *= fmaf(-d, r, 2.f);
  r *= fmaf(-d, r, 2.f);
  return f * r;
}

// threads as (ty, tx) over a row of C channels: tx owns chunks tx, tx + tx_n, ...; ty strides the rows
__host__ __device__ inline Tiling grid_tiling(int C, int V) {
  Tiling t;
  t.cv = C / V;
  t.tx_n = t.cv < GT ? t.cv : GT;
  t.ty_n = GT / t.tx_n;
  return t;
}

// byte offsets of a CTA's shared memory: the kept rows (keep x C values), the
// per-thread channel sums [ty_n][V][C / V], w and b in f32 (16-byte aligned),
// the gathered group sums [JG][G], mean and rstd per group, the bulk copy's
// barrier. `gn_plan` computes the same total.
struct Layout {
  size_t sums, wb, gath, stat, bar, total;
};
__host__ __device__ inline Layout layout(int C, int G, int V, int item, int keep, int jg) {
  const Tiling t = grid_tiling(C, V);
  Layout l;
  l.sums = (size_t(keep) * C * item + 127) / 128 * 128;
  l.wb = (l.sums + size_t(t.ty_n) * C * sizeof(float2) + 15) / 16 * 16;
  l.gath = l.wb + size_t(2) * C * sizeof(float);
  l.stat = l.gath + size_t(jg) * G * sizeof(float2);
  l.bar = l.stat + size_t(G) * sizeof(float2);
  l.total = l.bar + 8;
  return l;
}

// threads per group in the two reductions to group sums (over a slab's channels, over a sample's slabs): at
// most 32, so that the final sum over them stays short
__host__ __device__ inline int group_threads(int G) {
  const int j = GT / G > 0 ? GT / G : 1;
  return j < 32 ? j : 32;
}

// group g's JG partial sums [JG][G] added in order
__device__ __forceinline__ float2 sum_group(const float2* gath, int g, int G, int JG) {
  float2 a = make_float2(0.f, 0.f);
  for (int j = 0; j < JG; ++j) {
    a.x += gath[j * G + g].x;
    a.y += gath[j * G + g].y;
  }
  return a;
}

// V consecutive f32 values of shared memory, 16 bytes at a time where V allows it
template <int V>
__device__ __forceinline__ void load_f(const float* p, float* f) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int v = 0; v < V; v += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + v);
      f[v] = q.x;
      f[v + 1] = q.y;
      f[v + 2] = q.z;
      f[v + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = p[v];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(GT, 1)
    gn_grid_kernel(const T* __restrict__ x, const void* __restrict__ w, const void* __restrict__ bias, int pdtype,
                   T* __restrict__ y, float2* __restrict__ partial, int B, long long S, int C, int G, float eps,
                   int silu, int per_sample, int rows, int keep, int spw) {
  // the kept rows of a CTA are contiguous in x: one bulk copy where they are whole 16-byte chunks
  constexpr bool BULK = sizeof(T) * V == 16;
  using Vt = Vec<T, V>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int cg = C / G;
  const int JG = group_threads(G);
  const Layout lay = layout(C, G, V, sizeof(T), keep, JG);
  T* xs = reinterpret_cast<T*>(smem);
  float2* sums = reinterpret_cast<float2*>(smem + lay.sums);
  float* ws = reinterpret_cast<float*>(smem + lay.wb);
  float* bs = ws + C;
  float2* gath = reinterpret_cast<float2*>(smem + lay.gath);
  float2* stat = reinterpret_cast<float2*>(smem + lay.stat);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  const Tiling t = grid_tiling(C, V);
  const int tid = threadIdx.x, tx = tid % t.tx_n, ty = tid / t.tx_n;
  const bool active = ty < t.ty_n;
  if (BULK && tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  uint32_t phase = 0;
  const float count = static_cast<float>(static_cast<double>(S) * cg);

  // waves of `spw` samples: statistics, one grid barrier, output; the next wave's bulk copy refills the kept rows
  for (int s0 = 0; s0 < B; s0 += spw) {
    const int units = (B - s0 < spw ? B - s0 : spw) * per_sample;
    // 1. each unit (sample b, slab k of `rows` rows) the CTA owns: its rows read once, x and x^2 summed per
    // channel in f32, then per group; the first unit's first `keep` rows stay in shared memory
    for (int u = blockIdx.x, first = 1; u < units; u += gridDim.x, first = 0) {
      const int b = s0 + u / per_sample, k = u % per_sample;
      const long long r0 = (long long)k * rows;
      const int nr = S - r0 < rows ? int(S - r0 > 0 ? S - r0 : 0) : rows;
      const int kept = first ? (nr < keep ? nr : keep) : 0;
      const T* xb = x + (size_t(b) * S + r0) * C;
      if (BULK && tid == 0 && kept > 0) {
        const uint32_t bytes = uint32_t(kept) * C * sizeof(T);
        sm90::fence_proxy_async();  // the last wave's reads of these rows come before the copy overwrites them
        sm90::mbar_expect_tx(bar, bytes);
        for (uint32_t off = 0; off < bytes; off += BULK_PIECE)
          sm90::bulk_load(reinterpret_cast<unsigned char*>(xs) + off,
                          reinterpret_cast<const unsigned char*>(xb) + off,
                          bytes - off < BULK_PIECE ? bytes - off : BULK_PIECE, bar);
      }
      // per thread and chunk a fixed order: the rows past `kept` (from registers, while the bulk copy is in
      // flight), then the kept ones, each in row order. The sums go to shared memory as [ty][v][chunk], so that
      // neighbouring threads write neighbouring words.
      if (active) {
        for (int cc = tx; cc < t.cv; cc += t.tx_n) {
          float s1[V], s2[V], f[V];
#pragma unroll
          for (int v = 0; v < V; ++v) s1[v] = s2[v] = 0.f;
          for (int lr = (BULK ? kept : 0) + ty; lr < nr; lr += U * t.ty_n) {
            Vt in[U];
#pragma unroll
            for (int u2 = 0; u2 < U; ++u2)
              if (lr + u2 * t.ty_n < nr)
                in[u2] = *reinterpret_cast<const Vt*>(xb + size_t(lr + u2 * t.ty_n) * C + cc * V);
#pragma unroll
            for (int u2 = 0; u2 < U; ++u2) {
              const int r = lr + u2 * t.ty_n;
              if (r < nr) {
                if (!BULK && r < kept) *reinterpret_cast<Vt*>(xs + size_t(r) * C + cc * V) = in[u2];
                unpack(in[u2], f);
#pragma unroll
                for (int v = 0; v < V; ++v) {
                  s1[v] += f[v];
                  s2[v] = fmaf(f[v], f[v], s2[v]);
                }
              }
            }
          }
          if (BULK && kept > 0) {
            sm90::mbar_wait(bar, phase);  // at once after the first chunk: the phase has completed
            for (int lr = ty; lr < kept; lr += t.ty_n) {
              unpack(*reinterpret_cast<const Vt*>(xs + size_t(lr) * C + cc * V), f);
#pragma unroll
              for (int v = 0; v < V; ++v) {
                s1[v] += f[v];
                s2[v] = fmaf(f[v], f[v], s2[v]);
              }
            }
          }
#pragma unroll
          for (int v = 0; v < V; ++v) sums[(ty * V + v) * t.cv + cc] = make_float2(s1[v], s2[v]);
        }
      }
      if (BULK && kept > 0) phase ^= 1;
      __syncthreads();
      // each channel over the row strides (entry i = v x chunks + chunk is channel chunk x V + v), then each
      // group over its channels: this unit's partial sums
      for (int i = tid; i < C; i += GT) {
        float2 a = sums[i];
#pragma unroll 4
        for (int r = 1; r < t.ty_n; ++r) {
          a.x += sums[r * C + i].x;
          a.y += sums[r * C + i].y;
        }
        sums[i] = a;
      }
      __syncthreads();
      for (int i = tid; i < G * JG; i += GT) {
        const int g = i % G, j = i / G;
        float a = 0.f, q = 0.f;
        for (int c = g * cg + j; c < (g + 1) * cg; c += JG) {
          const float2 p = sums[(c % V) * t.cv + c / V];
          a += p.x;
          q += p.y;
        }
        gath[i] = make_float2(a, q);
      }
      __syncthreads();
      for (int g = tid; g < G; g += GT) partial[(size_t(b) * per_sample + k) * G + g] = sum_group(gath, g, G, JG);
      __syncthreads();
    }

    cooperative_groups::this_grid().sync();
    // w and b in f32, once, beside the first wave's gather
    if (s0 == 0)
      for (int c = tid; c < C; c += GT) {
        ws[c] = load_param(w, pdtype, c);
        bs[c] = load_param(bias, pdtype, c);
      }

    // 2. per unit: its sample's slab sums added in a fixed order (thread j of a group's JG over the slabs j,
    // j + JG, ..., then the JG in order), mean and rstd; then y = x * (rstd w) + (b - mean rstd w), SiLU, one
    // rounding, the rows last read first: past `kept` from global memory (mostly L2), then the kept ones
    for (int u = blockIdx.x, first = 1; u < units; u += gridDim.x, first = 0) {
      const int b = s0 + u / per_sample, k = u % per_sample;
      const long long r0 = (long long)k * rows;
      const int nr = S - r0 < rows ? int(S - r0 > 0 ? S - r0 : 0) : rows;
      const int kept = first ? (nr < keep ? nr : keep) : 0;
      const T* xb = x + (size_t(b) * S + r0) * C;
      T* yb = y + (size_t(b) * S + r0) * C;
      // JG threads a group, the groups fastest, so that a warp reads neighbouring slab sums
      for (int i = tid; i < G * JG; i += GT) {
        const int g = i % G, j = i / G;
        const float2* p = partial + size_t(b) * per_sample * G + g;
        float a = 0.f, q = 0.f;
#pragma unroll 4
        for (int s = j; s < per_sample; s += JG) {
          const float2 v = __ldcg(p + size_t(s) * G);
          a += v.x;
          q += v.y;
        }
        gath[i] = make_float2(a, q);
      }
      __syncthreads();
      for (int g = tid; g < G; g += GT) {
        const float2 a = sum_group(gath, g, G, JG);
        const float mean = a.x / count;
        const float var = fmaxf(a.y / count - mean * mean, 0.f);
        stat[g] = make_float2(mean, rsqrtf(var + eps));
      }
      __syncthreads();
      if (active && nr > ty) {
        const int last = ty + (nr - 1 - ty) / t.ty_n * t.ty_n;
        for (int cc = tx; cc < t.cv; cc += t.tx_n) {
          float scale[V], shift[V], f[V];
          load_f<V>(ws + cc * V, scale);
          load_f<V>(bs + cc * V, shift);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float2 st = stat[(cc * V + v) / cg];
            scale[v] *= st.y;
            shift[v] -= st.x * scale[v];
          }
          for (int lr = last; lr >= 0; lr -= U * t.ty_n) {
            Vt in[U];
#pragma unroll
            for (int u2 = 0; u2 < U; ++u2) {
              const int r = lr - u2 * t.ty_n;
              if (r >= 0)
                in[u2] = r < kept ? *reinterpret_cast<const Vt*>(xs + size_t(r) * C + cc * V)
                                  : *reinterpret_cast<const Vt*>(xb + size_t(r) * C + cc * V);
            }
#pragma unroll
            for (int u2 = 0; u2 < U; ++u2) {
              const int r = lr - u2 * t.ty_n;
              if (r >= 0) {
                unpack(in[u2], f);
#pragma unroll
                for (int v = 0; v < V; ++v) {
                  f[v] = fmaf(f[v], scale[v], shift[v]);
                  if (silu) f[v] = silu_f(f[v]);
                }
                Vt out;
                pack(out, f);
                *reinterpret_cast<Vt*>(yb + size_t(r) * C + cc * V) = out;
              }
            }
          }
        }
      }
      __syncthreads();  // stat is the next unit's, the kept rows the next wave's
    }
  }
}

template <typename T, int V>
cudaError_t launch_grid(const void* x, const void* w, const void* bias, int pdtype, void* y, void* partial, int B,
                        long long S, int C, int G, float eps, int silu, int per_sample, int rows, int keep, int spw,
                        int ctas, cudaStream_t stream) {
  const Layout lay = layout(C, G, V, sizeof(T), keep, group_threads(G));
  if (lay.total > size_t(SMEM_MAX)) return cudaErrorInvalidValue;
  auto kernel = gn_grid_kernel<T, V>;
  cudaError_t err = set_smem<gn_grid_kernel<T, V>>(SMEM_MAX);
  if (err != cudaSuccess) return err;
  // every CTA must be resident at once (the grid barrier): the launch refuses a grid larger than the card holds
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(ctas));
  cfg.blockDim = dim3(GT);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), w, bias, pdtype, static_cast<T*>(y),
                           static_cast<float2*>(partial), B, S, C, G, eps, silu, per_sample, rows, keep, spw);
  return err;
}

}  // namespace
}  // namespace cflearn

// xdtype / pdtype: 0 = bf16, 1 = fp16, 2 = f32 (x and y; w and bias). The
// plan (`gn_plan`): each sample's rows in `per_sample` slabs of `rows` rows
// (units), the samples in waves of `spw`, `ctas` CTAs (at most one per SM,
// all resident: a cooperative launch) each walking a wave's units ctas
// apart, the first `keep` rows of a CTA's first unit of a wave kept in shared
// memory; `partial` holds B * per_sample * G float2. Threads own 16-byte channel chunks where C and the addresses of x
// and y allow it, else single channels. Returns a cudaError_t.
extern "C" int cflearn_group_norm(int xdtype, int pdtype, const void* x, const void* w, const void* bias, void* y,
                                  void* partial, int B, long long S, int C, int G, float eps, int silu,
                                  int per_sample, long long rows, long long keep, int spw, int ctas, void* stream) {
  const cflearn::DeviceOf device(x);  // the device of `x`, its context bound to this thread
  if (device.error() != cudaSuccess) return device.error();
  if (B <= 0 || S <= 0 || C <= 0 || G <= 0 || C % G != 0 || per_sample <= 0 || rows <= 0 ||
      rows > 0x7fffffffLL || static_cast<long long>(per_sample) * rows < S || keep < 0 || keep > rows ||
      spw <= 0 || ctas <= 0 || ctas > (spw < B ? spw : B) * per_sample || pdtype < 0 || pdtype > 2 ||
      static_cast<long long>(B) * per_sample > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CFLEARN_GN(T, V)                                                                                         \
  return cflearn::launch_grid<T, V>(x, w, bias, pdtype, y, partial, B, S, C, G, eps, silu, per_sample, int(rows), \
                                    int(keep), spw, ctas, s)
  if (xdtype == 0) {
    if (aligned && C % 8 == 0) CFLEARN_GN(__nv_bfloat16, 8);
    CFLEARN_GN(__nv_bfloat16, 1);
  }
  if (xdtype == 1) {
    if (aligned && C % 8 == 0) CFLEARN_GN(__half, 8);
    CFLEARN_GN(__half, 1);
  }
  if (xdtype == 2) {
    if (aligned && C % 4 == 0) CFLEARN_GN(float, 4);
    CFLEARN_GN(float, 1);
  }
#undef CFLEARN_GN
  return cudaErrorInvalidValue;
}

// the previous design, three launches: the yardstick. `partial` holds
// B * slabs * G * 2 floats, `stats` B * G * 2; the slabs of `rows_per` rows
// cover S. Returns a cudaError_t.
extern "C" int cflearn_group_norm_slabs(int xdtype, int pdtype, const void* x, const void* w, const void* bias,
                                        void* y, void* partial, void* stats, int B, long long S, int C, int G,
                                        float eps, int silu, int slabs, long long rows_per, void* stream) {
  const cflearn::DeviceOf device(x);  // the device of `x`, its context bound to this thread
  if (device.error() != cudaSuccess) return device.error();
  if (B <= 0 || S <= 0 || C <= 0 || G <= 0 || C % G != 0 || slabs <= 0 || rows_per <= 0 ||
      static_cast<long long>(slabs) * rows_per < S || pdtype < 0 || pdtype > 2 ||
      static_cast<long long>(B) * slabs > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* st = static_cast<float*>(stats);
#define CFLEARN_GN(T, V) \
  return cflearn::launch_slabs<T, V>(x, w, bias, pdtype, y, p, st, B, S, C, G, eps, silu, slabs, rows_per, s)
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
