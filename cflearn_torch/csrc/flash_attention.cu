// Flash-attention forward for Hopper (sm_90a), bf16 / fp16 in, f32 softmax
// state.
//
// Replaces: cflearn_tpu/ops/attention.py `_flash_kernel` (launched by
// `flash_attention`). Same algebra: scores in f32, masked positions set to
// -1e30 (kv tail and, with `causal`, k > q), a running row max m, row sum l
// and accumulator in f32, P cast to the value dtype before P.V, and the
// output acc / max(l, 1e-30). Causal CTAs stop at the last kv block that
// touches the diagonal, as the TPU kernel skips the blocks above it.
//
// What bounds it on the H100: at the UNet shapes (L = 4096 / 1024 / 256,
// d = 40 / 80 / 160) the two products do 4*L*L*d FLOPs per head against
// (3+1)*L*d*2 bytes, i.e. hundreds of FLOPs per byte -> tensor-core bound.
// The design keeps S and P in registers (the m16n8k16 accumulator layout is
// the A-operand layout of the next product), streams K/V through a
// double-buffered cp.async ring, and never writes S to device memory.
// Not-power-of-two head dims are padded to a multiple of 16 in shared
// memory only (zero columns), and ragged q / kv tails are zero-filled by
// the copy and masked in the kernel, so no padded copy is staged in device
// memory. d = 512 (the VAE mid-block) does not fit a 64-row q tile: there a
// CTA owns 16 q rows and its four warps split the kv columns of S and the
// head-dim columns of O, exchanging S through shared memory.
//
// Layout: q/k/v/o are (B, H, L, D) with arbitrary B/H/L strides (in
// elements, multiples of 8) and a contiguous D, D % 8 == 0, D <= 512.

#include "mma_common.cuh"

namespace cflearn {
namespace {

constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int q_len, kv_len, d, causal;
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

template <typename T, int DP, int WQ, int WD, int BK, int STAGES>
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
}

template <typename T, int DP, int WQ, int WD, int BK, int STAGES>
cudaError_t launch(const FlashArgs& a, int batch, int heads, cudaStream_t stream) {
  using Cfg = FlashCfg<T, DP, WQ, WD, BK, STAGES>;
  auto kernel = flash_fwd_kernel<T, DP, WQ, WD, BK, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Cfg::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.q_len + Cfg::BQ - 1) / Cfg::BQ, heads, batch);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const FlashArgs& a, int batch, int heads, cudaStream_t s) {
  if (a.d <= 32) return launch<T, 32, 4, 1, 64, 2>(a, batch, heads, s);
  if (a.d <= 48) return launch<T, 48, 4, 1, 64, 2>(a, batch, heads, s);
  if (a.d <= 64) return launch<T, 64, 4, 1, 64, 2>(a, batch, heads, s);
  if (a.d <= 80) return launch<T, 80, 4, 1, 64, 2>(a, batch, heads, s);
  if (a.d <= 128) return launch<T, 128, 4, 1, 64, 2>(a, batch, heads, s);
  if (a.d <= 160) return launch<T, 160, 4, 1, 64, 2>(a, batch, heads, s);
  if (a.d <= 256) return launch<T, 256, 2, 2, 64, 2>(a, batch, heads, s);
  if (a.d <= 512) return launch<T, 512, 1, 4, 64, 1>(a, batch, heads, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cflearn

// dtype: 0 = bf16, 1 = fp16. Strides are in elements. Returns a cudaError_t.
extern "C" int cflearn_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                           void* o, long long q_sb, long long q_sh, long long q_sl,
                                           long long k_sb, long long k_sh, long long k_sl,
                                           long long v_sb, long long v_sh, long long v_sl,
                                           long long o_sb, long long o_sh, long long o_sl,
                                           int batch, int heads, int q_len, int kv_len, int d,
                                           int causal, float scale, void* stream) {
  cflearn::FlashArgs a{q,    k,    v,    o,    q_sb,  q_sh,   q_sl, k_sb, k_sh, k_sl, v_sb,
                       v_sh, v_sl, o_sb, o_sh, o_sl,  q_len,  kv_len, d,  causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0 || q_len <= 0 || kv_len <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return cflearn::dispatch<__nv_bfloat16>(a, batch, heads, s);
  if (dtype == 1) return cflearn::dispatch<__half>(a, batch, heads, s);
  return cudaErrorInvalidValue;
}
