// Flash-attention forward on mma.sync tensor-core products (sm_90a): the
// kernels that `flash_fwd_sm90.cuh`'s entry point runs for what its wgmma +
// TMA kernels do not take (f32 inputs and d > 512; the planner
// `ops/attention.py::flash_plan` decides), and on request for any shape, as
// the yardstick of those kernels (at d = 512, of `flash_fwd_sm90_wide.cuh`). Built into `flash_attention.cu` (inference
// forward) and `flash_fwd_lse.cu` (the same forward that also writes the
// per-row logsumexp, the residual of the backward) through that header.
//
// Same algebra as the TPU kernels: scores in f32, masked positions set to
// -1e30 (kv tail and, with `causal`, k > q), a running row max m, row sum l
// and accumulator in f32, P cast to the value dtype before P.V, the output
// acc / max(l, 1e-30), and lse = m + log(max(l, 1e-30)). Causal CTAs stop at
// the last kv block that touches the diagonal.
//
// What bounds it on the H100: the two products do 4*L*L*d FLOPs per head
// against (3+1)*L*d*2 bytes, hundreds of FLOPs per byte, and the softmax
// L*L exponentials: the tensor cores at d = 80 and above, the exponentials
// at d = 40 (`flash_fwd_sm90.cuh`).
// The bf16 / fp16 kernel keeps S and P in registers (the m16n8k16 accumulator
// layout is the A-operand layout of the next product), streams K/V through a
// double-buffered cp.async ring, and never writes S to device memory.
// Not-power-of-two head dims are padded to a multiple of 16 in shared
// memory only (zero columns), and ragged q / kv tails are zero-filled by
// the copy and masked in the kernel, so no padded copy is staged in device
// memory. d = 512 (the VAE mid-block) does not fit a 64-row q tile: there a
// CTA owns 16 q rows and its four warps split the kv columns of S and the
// head-dim columns of O, exchanging S through shared memory. f32 inputs and
// 512 < d <= 1024 take the chunked kernel below.
//
// Layout: q/k/v/o are (B, H, L, D) with arbitrary B/H/L strides (in
// elements, multiples of 8) and a contiguous D, D % 8 == 0, D <= 1024.

#pragma once

#include <type_traits>

#include "mma_common.cuh"
#include "sm90.cuh"

namespace cflearn {
namespace {

constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Lq) contiguous f32, written by the LSE kernels only
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int heads, q_len, kv_len, d, causal;
  float scale;
};

// DP: head dim padded to a multiple of 16. WQ x WD warps: WQ groups of 16 q
// rows, each split WD ways over S columns and O columns. BK: kv rows per
// block. STAGES: 2 = double-buffered K/V, 1 = single buffer (d = 512).
template <typename T, int DP, int WQ, int WD, int BK, int STAGES>
struct FlashCfg {
  static constexpr int THREADS = WQ * WD * 32;
  static constexpr int BQ = 16 * WQ;
  static constexpr int LD = DP + 8;  // padded row: conflict-free ldmatrix
  static constexpr int SCOLS = BK / WD;
  static constexpr int OCOLS = DP / WD;
  static constexpr int LDS = BK + 4;
  static constexpr size_t Q_BYTES = size_t(BQ) * LD * sizeof(T);
  static constexpr size_t KV_BYTES = size_t(BK) * LD * sizeof(T);
  static constexpr size_t S_BYTES = WD > 1 ? size_t(BQ) * LDS * sizeof(float) : 0;
  static constexpr size_t SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + S_BYTES;
  static_assert(DP % 16 == 0 && SCOLS % 16 == 0 && OCOLS % 16 == 0, "tile shape");
  static_assert(STAGES == 1 || STAGES == 2, "stages");
};

// rows [row0, row0 + nrows) of a (len, d) matrix -> shared tile (nrows, LD);
// rows >= len and columns >= d are zero-filled.
template <typename T, int LD, int DP>
__device__ __forceinline__ void load_rows(T* dst, const T* base, long long row_stride, int row0,
                                          int nrows, int len, int d, int tid, int nthreads) {
  constexpr int CH = DP / 8;
  for (int i = tid; i < nrows * CH; i += nthreads) {
    const int r = i / CH, c = i % CH;
    const int row = row0 + r;
    const bool ok = row < len && c * 8 < d;
    const T* src = ok ? base + row * row_stride + c * 8 : base;
    cp_async16(dst + r * LD + c * 8, src, ok ? 16 : 0);
  }
}

template <typename T, int DP, int WQ, int WD, int BK, int STAGES, bool LSE>
__global__ void __launch_bounds__(WQ* WD * 32) flash_fwd_kernel(const FlashArgs a) {
  using Cfg = FlashCfg<T, DP, WQ, WD, BK, STAGES>;
  constexpr int LD = Cfg::LD;
  constexpr int NS = Cfg::SCOLS / 8;  // S n-tiles per warp
  constexpr int NF = BK / 8;          // S n-tiles of a full row
  constexpr int NO = Cfg::OCOLS / 8;  // O n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = reinterpret_cast<T*>(smem_raw + Cfg::Q_BYTES);
  T* Vs = Ks + STAGES * BK * LD;
  float* Ss = reinterpret_cast<float*>(smem_raw + Cfg::Q_BYTES + 2 * STAGES * Cfg::KV_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wq = warp / WD, wd = warp % WD;
  const int g = lane >> 2, cq = lane & 3;
  const int q0 = blockIdx.x * Cfg::BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  int n_kb = (a.kv_len + BK - 1) / BK;
  if (a.causal) n_kb = min(n_kb, (q0 + Cfg::BQ - 1) / BK + 1);

  load_rows<T, LD, DP>(Qs, q, a.q_sl, q0, Cfg::BQ, a.q_len, a.d, tid, Cfg::THREADS);
  load_rows<T, LD, DP>(Ks, k, a.k_sl, 0, BK, a.kv_len, a.d, tid, Cfg::THREADS);
  load_rows<T, LD, DP>(Vs, v, a.v_sl, 0, BK, a.kv_len, a.d, tid, Cfg::THREADS);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float scale = a.scale * kLog2e;  // softmax in base 2: exp(x) = exp2(x * log2 e)
  const int row_a = q0 + wq * 16 + g, row_b = row_a + 8;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = STAGES == 2 ? (kb & 1) : 0;
    if (STAGES == 2 && kb + 1 < n_kb) {
      const int nst = (kb + 1) & 1;
      load_rows<T, LD, DP>(Ks + nst * BK * LD, k, a.k_sl, (kb + 1) * BK, BK, a.kv_len, a.d, tid,
                           Cfg::THREADS);
      load_rows<T, LD, DP>(Vs + nst * BK * LD, v, a.v_sl, (kb + 1) * BK, BK, a.kv_len, a.d, tid,
                           Cfg::THREADS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + st * BK * LD;
    const T* Vt = Vs + st * BK * LD;

    // S = Q K^T over this warp's 16 rows x SCOLS kv columns
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, Qs + (wq * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4(bf, Kt + (wd * Cfg::SCOLS + jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        Mma<T>::run(s[2 * jp], af, bf);
        Mma<T>::run(s[2 * jp + 1], af, bf + 2);
      }
    }
    // scale (base-2 domain) and mask
    const int col0 = kb * BK + wd * Cfg::SCOLS;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + j * 8 + cq * 2 + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool ok = col < a.kv_len && (!a.causal || col <= row);
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
      }
    }
    // full rows of S: with WD > 1 the warps of a row group exchange their
    // column slices through shared memory
    float sf[NF][4];
    if constexpr (WD == 1) {
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sf[j][e] = s[j][e];
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int c = wd * Cfg::SCOLS + j * 8 + cq * 2;
        Ss[(wq * 16 + g) * Cfg::LDS + c] = s[j][0];
        Ss[(wq * 16 + g) * Cfg::LDS + c + 1] = s[j][1];
        Ss[(wq * 16 + g + 8) * Cfg::LDS + c] = s[j][2];
        Ss[(wq * 16 + g + 8) * Cfg::LDS + c + 1] = s[j][3];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int c = j * 8 + cq * 2;
        sf[j][0] = Ss[(wq * 16 + g) * Cfg::LDS + c];
        sf[j][1] = Ss[(wq * 16 + g) * Cfg::LDS + c + 1];
        sf[j][2] = Ss[(wq * 16 + g + 8) * Cfg::LDS + c];
        sf[j][3] = Ss[(wq * 16 + g + 8) * Cfg::LDS + c + 1];
      }
    }
    // online softmax: m_new = max(m, rowmax), p = exp(s - m_new),
    // alpha = exp(m - m_new), l = alpha * l + rowsum(p)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sf[j][0], sf[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sf[j][2], sf[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      sf[j][0] = exp2f(sf[j][0] - m0);
      sf[j][1] = exp2f(sf[j][1] - m0);
      sf[j][2] = exp2f(sf[j][2] - m1);
      sf[j][3] = exp2f(sf[j][3] - m1);
      rs0 += sf[j][0] + sf[j][1];
      rs1 += sf[j][2] + sf[j][3];
    }
    // per-thread partial row sums; the quad is summed once at the end
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }
    // O += P V over this warp's OCOLS head-dim columns; P in the value dtype
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = Mma<T>::pack(sf[2 * kk][0], sf[2 * kk][1]);
      pf[1] = Mma<T>::pack(sf[2 * kk][2], sf[2 * kk][3]);
      pf[2] = Mma<T>::pack(sf[2 * kk + 1][0], sf[2 * kk + 1][1]);
      pf[3] = Mma<T>::pack(sf[2 * kk + 1][2], sf[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < NO / 2; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  wd * Cfg::OCOLS + jp * 16 + (lane >> 4) * 8);
        Mma<T>::run(acc[2 * jp], pf, bf);
        Mma<T>::run(acc[2 * jp + 1], pf, bf + 2);
      }
    }
    __syncthreads();  // this stage (and Ss) may be overwritten from here on
    if (STAGES == 1 && kb + 1 < n_kb) {
      load_rows<T, LD, DP>(Ks, k, a.k_sl, (kb + 1) * BK, BK, a.kv_len, a.d, tid, Cfg::THREADS);
      load_rows<T, LD, DP>(Vs, v, a.v_sl, (kb + 1) * BK, BK, a.kv_len, a.d, tid, Cfg::THREADS);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = wd * Cfg::OCOLS + n * 8 + cq * 2;
    if (col >= a.d) continue;
    if (row_a < a.q_len)
      *reinterpret_cast<uint32_t*>(o + row_a * a.o_sl + col) =
          Mma<T>::pack(acc[n][0] * inv0, acc[n][1] * inv0);
    if (row_b < a.q_len)
      *reinterpret_cast<uint32_t*>(o + row_b * a.o_sl + col) =
          Mma<T>::pack(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  // logsumexp per q row, lse = m + log(max(l, 1e-30)); m is kept in the
  // base-2 domain, so it is scaled back by ln 2
  if constexpr (LSE) {
    if (wd == 0 && cq == 0) {
      float* lse = a.lse + (size_t(b) * a.heads + h) * a.q_len;
      if (row_a < a.q_len) lse[row_a] = m0 * kLn2 + logf(fmaxf(l0, 1e-30f));
      if (row_b < a.q_len) lse[row_b] = m1 * kLn2 + logf(fmaxf(l1, 1e-30f));
    }
  }
}

// The chunked kernel: every dtype and every head dim up to 1024, for what the
// kernel above does not take (f32 tiles, which have no ldmatrix path and no
// register-resident P; and D > 512, whose accumulator does not fit a CTA).
// A CTA owns 64 q rows and ONE chunk of DC output columns. It sweeps the head
// dim in chunks of DC to build S = Q K^T (so S is recomputed by each of the
// ceil(D / DC) CTAs of a q tile), runs the same online softmax, passes P to
// the P.V product through shared memory, and accumulates O[:, chunk]. f32
// operands go through the 3xTF32 product of `Frag<float>`; sums stay f32.
template <typename T, int DC>
struct ChunkCfg {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
  static constexpr int LD = DC + Frag<T>::PAD;
  static constexpr int LDP = BK + Frag<T>::PAD;
  static constexpr size_t TILE = size_t(64) * LD * sizeof(T);
  static constexpr size_t SMEM = 3 * TILE + size_t(BQ) * LDP * sizeof(T);
};

template <typename T, int DC, bool LSE>
__global__ void __launch_bounds__(128) flash_fwd_chunked_kernel(const FlashArgs a) {
  using Cfg = ChunkCfg<T, DC>;
  using F = Frag<T>;
  constexpr int LD = Cfg::LD, LDP = Cfg::LDP, BK = Cfg::BK;
  constexpr int NS = BK / 8;  // S n-tiles of a warp's 16 rows
  constexpr int NO = DC / 8;  // O n-tiles of a warp's 16 rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + 64 * LD;
  T* Vs = Ks + 64 * LD;
  T* Ps = Vs + 64 * LD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int q0 = blockIdx.x * Cfg::BQ;
  const int chunk = blockIdx.y;
  const int b = blockIdx.z / a.heads, h = blockIdx.z % a.heads;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  const int n_chunks = (a.d + DC - 1) / DC;
  const bool single = n_chunks == 1;
  const int col_out = chunk * DC;

  int n_kb = (a.kv_len + BK - 1) / BK;
  if (a.causal) n_kb = min(n_kb, (q0 + Cfg::BQ - 1) / BK + 1);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float scale = a.scale * kLog2e;
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;

  for (int kb = 0; kb < n_kb; ++kb) {
    load_tile<T, 64, DC, LD>(Vs, v, a.v_sl, kb * BK, a.kv_len, col_out, a.d, tid, Cfg::THREADS);
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int j = 0; j < n_chunks; ++j) {
      if (!single || kb == 0)
        load_tile<T, 64, DC, LD>(Qs, q, a.q_sl, q0, a.q_len, j * DC, a.d, tid, Cfg::THREADS);
      load_tile<T, 64, DC, LD>(Ks, k, a.k_sl, kb * BK, a.kv_len, j * DC, a.d, tid, Cfg::THREADS);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int k0 = 0; k0 < DC; k0 += F::KS) {
        uint32_t af[F::AR];
        F::load_a(af, Qs, LD, warp * 16, k0, lane);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          uint32_t bf[F::BR];
          F::load_b(bf, Ks, LD, n * 8, k0, lane);
          F::mma(s[n], af, bf);
        }
      }
      if (!single) __syncthreads();  // Qs / Ks are overwritten by the next chunk
    }
    // scale (base-2 domain) and mask
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kb * BK + j * 8 + cq * 2 + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool ok = col < a.kv_len && (!a.causal || col <= row);
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = exp2f(s[j][0] - m0);
      s[j][1] = exp2f(s[j][1] - m0);
      s[j][2] = exp2f(s[j][2] - m1);
      s[j][3] = exp2f(s[j][3] - m1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
      // P in the value dtype, handed to the P.V product through shared memory
      F::store2(Ps + (warp * 16 + g) * LDP + j * 8 + cq * 2, s[j][0], s[j][1]);
      F::store2(Ps + (warp * 16 + g + 8) * LDP + j * 8 + cq * 2, s[j][2], s[j][3]);
    }
    l0 = l0 * al0 + rs0;  // per-thread partial row sums; the quad is summed at the end
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }
    __syncthreads();
    // f32: this block's P.V in fresh registers, added to acc by the FP32 unit, so that the tensor core's
    // accumulation runs over one block's products and not over the whole kv range (its error grew with L)
    float pv[std::is_same<T, float>::value ? NO : 1][4];
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int n = 0; n < NO; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
    }
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += F::KS) {
      uint32_t pf[F::AR];
      F::load_a(pf, Ps, LDP, warp * 16, k0, lane);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bf[F::BR];
        F::load_b_t(bf, Vs, LD, n * 8, k0, lane);
        if constexpr (std::is_same<T, float>::value) {
          F::mma(pv[n], pf, bf);
        } else {
          F::mma(acc[n], pf, bf);
        }
      }
    }
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] += pv[n][0];
        acc[n][1] += pv[n][1];
        acc[n][2] += pv[n][2];
        acc[n][3] += pv[n][3];
      }
    }
    __syncthreads();  // Ks, Vs and Ps may be overwritten from here on
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = col_out + n * 8 + cq * 2;
    if (col >= a.d) continue;
    if (row_a < a.q_len) F::store2(o + row_a * a.o_sl + col, acc[n][0] * inv0, acc[n][1] * inv0);
    if (row_b < a.q_len) F::store2(o + row_b * a.o_sl + col, acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if constexpr (LSE) {
    if (chunk == 0 && cq == 0) {
      float* lse = a.lse + size_t(blockIdx.z) * a.q_len;
      if (row_a < a.q_len) lse[row_a] = m0 * kLn2 + logf(fmaxf(l0, 1e-30f));
      if (row_b < a.q_len) lse[row_b] = m1 * kLn2 + logf(fmaxf(l1, 1e-30f));
    }
  }
}

template <typename T, int DP, int WQ, int WD, int BK, int STAGES, bool LSE>
cudaError_t launch(const FlashArgs& a, int batch, int bq, int bk, cudaStream_t stream) {
  using Cfg = FlashCfg<T, DP, WQ, WD, BK, STAGES>;
  if (bq != Cfg::BQ || bk != BK) return cudaErrorInvalidValue;  // the planner's tiles are not these
  auto kernel = flash_fwd_kernel<T, DP, WQ, WD, BK, STAGES, LSE>;
  cudaError_t err = sm90::set_smem<flash_fwd_kernel<T, DP, WQ, WD, BK, STAGES, LSE>>(static_cast<int>(Cfg::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.q_len + Cfg::BQ - 1) / Cfg::BQ, a.heads, batch);
  return launch_kernel(kernel, grid, Cfg::THREADS, Cfg::SMEM, stream, a);
}

template <typename T, int DC, bool LSE>
cudaError_t launch_chunked(const FlashArgs& a, int batch, int bq, int bk, cudaStream_t stream) {
  using Cfg = ChunkCfg<T, DC>;
  if (bq != Cfg::BQ || bk != Cfg::BK) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_chunked_kernel<T, DC, LSE>;
  cudaError_t err = sm90::set_smem<flash_fwd_chunked_kernel<T, DC, LSE>>(static_cast<int>(Cfg::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.q_len + Cfg::BQ - 1) / Cfg::BQ, (a.d + DC - 1) / DC, batch * a.heads);
  return launch_kernel(kernel, grid, Cfg::THREADS, Cfg::SMEM, stream, a);
}

// the mma.sync kernel for head dim d and dtype T; (bq, bk) must be its tiles
template <typename T, bool LSE>
cudaError_t dispatch(const FlashArgs& a, int batch, int bq, int bk, cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {
    if (a.d <= 64) return launch_chunked<T, 64, LSE>(a, batch, bq, bk, s);
    return launch_chunked<T, 128, LSE>(a, batch, bq, bk, s);
  } else {
    if (a.d <= 32) return launch<T, 32, 4, 1, 64, 2, LSE>(a, batch, bq, bk, s);
    if (a.d <= 48) return launch<T, 48, 4, 1, 64, 2, LSE>(a, batch, bq, bk, s);
    if (a.d <= 64) return launch<T, 64, 4, 1, 64, 2, LSE>(a, batch, bq, bk, s);
    if (a.d <= 80) return launch<T, 80, 4, 1, 64, 2, LSE>(a, batch, bq, bk, s);
    if (a.d <= 128) return launch<T, 128, 4, 1, 64, 2, LSE>(a, batch, bq, bk, s);
    if (a.d <= 160) return launch<T, 160, 4, 1, 64, 2, LSE>(a, batch, bq, bk, s);
    if (a.d <= 256) return launch<T, 256, 2, 2, 64, 2, LSE>(a, batch, bq, bk, s);
    if (a.d <= 512) return launch<T, 512, 1, 4, 64, 1, LSE>(a, batch, bq, bk, s);
    return launch_chunked<T, 128, LSE>(a, batch, bq, bk, s);
  }
}

}  // namespace
}  // namespace cflearn
