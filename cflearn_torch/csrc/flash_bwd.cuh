// Flash-attention backward on mma.sync (m16n8k16, and m16n8k8 3xTF32 for f32):
// one kernel template in three modes. It is the path for f32, for head dims
// the wgmma + TMA kernels of `flash_bwd_sm90.cuh` cannot hold in registers
// (d > 128 for dk.dv and the fused backward, d > 192 for dq: the UNet's
// d = 160, the VAE's d = 512, d = 640), and the yardstick those kernels are
// timed against (`kernel="mma_sync"`). `flash_bwd_sm90.cuh` includes it and
// holds the C entry of `flash_bwd_fused.cu`, `flash_bwd_dq.cu` and
// `flash_bwd_dkv.cu`.
//
// Replaces, in cflearn_tpu/ops/attention.py (launched by `_flash_train_bwd`):
//   MODE_FUSED -> `_flash_bwd_fused_kernel`  (dq, dk, dv in one pass)
//   MODE_DQ    -> `_flash_bwd_dq_kernel`     (dq; q tiles outer)
//   MODE_DKV   -> `_flash_bwd_dkv_kernel`    (dk, dv; kv tiles outer)
//
// The arithmetic of the TPU kernels, per (q tile, kv tile) pair:
//   s  = q k^T * scale (f32)           p  = mask ? exp(s - lse) : 0
//   dv += cast(p)^T dO                 dp = dO v^T
//   ds = p * (dp - delta)              dk += scale * cast(ds)^T q
//   dq += scale * cast(ds) k
// with p and ds cast to the input dtype before their products, every sum in
// f32, and delta = rowsum(dO * O) computed by the caller.
//
// What bounds it on the H100: 10 * L^2 * d FLOPs per head (fused; the split
// pair recomputes s, p, dp, ds and does 14) against a few L * d reads and
// writes, hundreds of FLOPs per byte at the UNet shapes -> tensor-core bound.
// The design keeps everything but the gradients out of device memory: a CTA
// of 8 warps owns one 64-row tile of its outer axis and one chunk of DC head
// dim columns, and loops over the 64-row tiles of the inner axis. s and dp
// live in registers; p and ds go through shared memory, because the
// m16n8k16 accumulator fragment is laid out for P.V and the transposed
// products (p^T dO, ds^T q) contract over the q rows: `ldmatrix.trans` reads
// them back as A^T. Head dims that are not a power of two are padded with
// zero columns in shared memory only; ragged tiles are zero-filled by the copy
// and masked (p = 0), so rows beyond Lq add nothing to dk and dv.
//
// A tile pair recomputes s and dp over the whole head dim. With D <= 160
// (bf16 / fp16) or D <= 128 (f32) that is one chunk, and the outer tiles stay
// in shared memory for the whole loop. Larger D is swept in chunks of 128:
// the grid gets one CTA per output chunk, each recomputes s and dp from all
// chunks and produces its own columns of the gradients.
//
// dq in MODE_FUSED: kv tiles run in parallel CTAs, so each adds its
// scale * ds k into a zeroed f32 (B, H, Lq, D) buffer with atomicAdd; the
// caller casts the buffer to the input dtype. The order of those additions
// changes from run to run, so dq is not bit-reproducible; MODE_DQ + MODE_DKV
// sum in a fixed order and are.
//
// f32 inputs: tiles stay f32 in shared memory and the tensor-core products
// run 3xTF32 (`Frag<float>` in `mma_common.cuh`); sums stay f32.
//
// Layout: q/k/v/dO are (B, H, L, D) with arbitrary B/H/L strides (elements,
// multiples of 8) and contiguous D, D % 8 == 0, D <= 1024. lse and delta are
// (B, H, Lq) contiguous f32; dq/dk/dv are contiguous (B, H, L, D).

#pragma once

#include "mma_common.cuh"

#define CFLEARN_MODE_FUSED 0
#define CFLEARN_MODE_DQ 1
#define CFLEARN_MODE_DKV 2

namespace cflearn {
namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dO;
  const float* lse;
  const float* delta;
  void* dq;  // MODE_DQ: input dtype; MODE_FUSED: zeroed f32; MODE_DKV: unused
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int heads, q_len, kv_len, d, causal;
  float scale;
};

template <typename T, int DC>
struct BwdCfg {
  static constexpr int BT = 64;  // rows of a q tile and of a kv tile
  static constexpr int THREADS = 256;
  static constexpr int LD = DC + Frag<T>::PAD;
  static constexpr int LDP = BT + Frag<T>::PAD;
  static constexpr size_t TILE = size_t(BT) * LD * sizeof(T);
  static constexpr size_t PTILE = size_t(BT) * LDP * sizeof(T);
  static constexpr size_t SMEM = 4 * TILE + 2 * PTILE + 2 * BT * sizeof(float);
  static_assert(DC % 16 == 0, "chunk width");
};

template <typename T, int DC, int MODE>
__global__ void __launch_bounds__(256) flash_bwd_kernel(const BwdArgs a) {
  using Cfg = BwdCfg<T, DC>;
  using F = Frag<T>;
  constexpr int BT = Cfg::BT, LD = Cfg::LD, LDP = Cfg::LDP, NTH = Cfg::THREADS;
  constexpr int NS = 4;        // s / dp n-tiles per warp: 32 of the 64 columns
  constexpr int NO = DC / 16;  // gradient n-tiles per warp: DC / 2 columns
  constexpr bool KV_OUTER = MODE != CFLEARN_MODE_DQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BT * LD;
  T* Vs = Ks + BT * LD;
  T* dOs = Vs + BT * LD;
  T* Ps = dOs + BT * LD;
  T* dSs = Ps + BT * LDP;
  float* lse_s = reinterpret_cast<float*>(dSs + BT * LDP);
  float* delta_s = lse_s + BT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, cq = lane & 3;
  const int outer0 = blockIdx.x * BT;
  const int chunk = blockIdx.y;
  const int b = blockIdx.z / a.heads, h = blockIdx.z % a.heads;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dO = static_cast<const T*>(a.dO) + b * a.o_sb + h * a.o_sh;
  const float* lse = a.lse + size_t(blockIdx.z) * a.q_len;
  const float* delta = a.delta + size_t(blockIdx.z) * a.q_len;
  const int n_chunks = (a.d + DC - 1) / DC;
  const bool single = n_chunks == 1;
  const int col_out = chunk * DC;
  const float scale2 = a.scale * kLog2e;  // exp(x) = exp2(x * log2 e)

  // the inner tiles this CTA visits; causal skips the pairs above the diagonal
  int in_begin = 0, in_end;
  if (KV_OUTER) {
    in_end = (a.q_len + BT - 1) / BT;
    if (a.causal) in_begin = outer0 / BT;  // q tiles that reach this kv tile
  } else {
    in_end = (a.kv_len + BT - 1) / BT;
    if (a.causal) in_end = min(in_end, (outer0 + BT - 1) / BT + 1);
  }

  // f32 accumulators of this warp's 16 rows x DC / 2 columns
  float acc_k[NO][4], acc_v[NO][4], acc_q[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = acc_q[n][e] = 0.f;

  for (int it = in_begin; it < in_end; ++it) {
    const int q0 = KV_OUTER ? it * BT : outer0;
    const int k0 = KV_OUTER ? outer0 : it * BT;
    const bool first = it == in_begin;
    // lse (pre-scaled to base 2) and delta of the q tile; rows beyond Lq read 0
    if (tid < BT && (KV_OUTER || first)) {
      const int row = q0 + tid;
      lse_s[tid] = row < a.q_len ? lse[row] * kLog2e : 0.f;
      delta_s[tid] = row < a.q_len ? delta[row] : 0.f;
    }

    // phase 1: s = q k^T and dp = dO v^T over the whole head dim
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    for (int j = 0; j < n_chunks; ++j) {
      // with one chunk the outer tiles (k, v; in MODE_DQ q, dO) are loaded once
      const bool load_outer = !single || first;
      if (KV_OUTER || load_outer) {
        load_tile<T, BT, DC, LD>(Qs, q, a.q_sl, q0, a.q_len, j * DC, a.d, tid, NTH);
        load_tile<T, BT, DC, LD>(dOs, dO, a.o_sl, q0, a.q_len, j * DC, a.d, tid, NTH);
      }
      if (!KV_OUTER || load_outer) {
        load_tile<T, BT, DC, LD>(Ks, k, a.k_sl, k0, a.kv_len, j * DC, a.d, tid, NTH);
        load_tile<T, BT, DC, LD>(Vs, v, a.v_sl, k0, a.kv_len, j * DC, a.d, tid, NTH);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < DC; kk += F::KS) {
        uint32_t aq[F::AR], ao[F::AR];
        F::load_a(aq, Qs, LD, wm * 16, kk, lane);
        F::load_a(ao, dOs, LD, wm * 16, kk, lane);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          uint32_t bk[F::BR], bv[F::BR];
          F::load_b(bk, Ks, LD, wn * 32 + n * 8, kk, lane);
          F::load_b(bv, Vs, LD, wn * 32 + n * 8, kk, lane);
          F::mma(s[n], aq, bk);
          F::mma(dp[n], ao, bv);
        }
      }
      if (!single) __syncthreads();  // the tiles are overwritten by the next chunk
    }

    // p = exp(s - lse) where unmasked, ds = p * (dp - delta); both to shared
    // memory in the input dtype, as (q row, kv column)
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm * 16 + g + (e >= 2 ? 8 : 0);
        const int c = wn * 32 + n * 8 + cq * 2 + (e & 1);
        const int qi = q0 + r, ki = k0 + c;
        const bool ok = qi < a.q_len && ki < a.kv_len && (!a.causal || ki <= qi);
        pv[e] = ok ? exp2f(s[n][e] * scale2 - lse_s[r]) : 0.f;
        dsv[e] = pv[e] * (dp[n][e] - delta_s[r]);
      }
      const int r0 = wm * 16 + g, c0 = wn * 32 + n * 8 + cq * 2;
      F::store2(Ps + r0 * LDP + c0, pv[0], pv[1]);
      F::store2(Ps + (r0 + 8) * LDP + c0, pv[2], pv[3]);
      F::store2(dSs + r0 * LDP + c0, dsv[0], dsv[1]);
      F::store2(dSs + (r0 + 8) * LDP + c0, dsv[2], dsv[3]);
    }

    // phase 2: this CTA's chunk of the gradients. With several chunks the
    // tiles hold the last chunk now: fetch the ones this chunk needs.
    if (!single) {
      if (MODE != CFLEARN_MODE_DQ) {
        load_tile<T, BT, DC, LD>(Qs, q, a.q_sl, q0, a.q_len, col_out, a.d, tid, NTH);
        load_tile<T, BT, DC, LD>(dOs, dO, a.o_sl, q0, a.q_len, col_out, a.d, tid, NTH);
      }
      if (MODE != CFLEARN_MODE_DKV)
        load_tile<T, BT, DC, LD>(Ks, k, a.k_sl, k0, a.kv_len, col_out, a.d, tid, NTH);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();

    if (MODE != CFLEARN_MODE_DQ) {
      // dv += p^T dO, dk += ds^T q: rows are kv, the contraction runs over q
#pragma unroll
      for (int kk = 0; kk < BT; kk += F::KS) {
        uint32_t ap[F::AR], ad[F::AR];
        F::load_a_t(ap, Ps, LDP, wm * 16, kk, lane);
        F::load_a_t(ad, dSs, LDP, wm * 16, kk, lane);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t bo[F::BR], bq[F::BR];
          F::load_b_t(bo, dOs, LD, wn * (DC / 2) + n * 8, kk, lane);
          F::load_b_t(bq, Qs, LD, wn * (DC / 2) + n * 8, kk, lane);
          F::mma(acc_v[n], ap, bo);
          F::mma(acc_k[n], ad, bq);
        }
      }
    }
    if (MODE != CFLEARN_MODE_DKV) {
      // dq += ds k: rows are q, the contraction runs over kv
      if (MODE == CFLEARN_MODE_FUSED) {
#pragma unroll
        for (int n = 0; n < NO; ++n) acc_q[n][0] = acc_q[n][1] = acc_q[n][2] = acc_q[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < BT; kk += F::KS) {
        uint32_t ad[F::AR];
        F::load_a(ad, dSs, LDP, wm * 16, kk, lane);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t bk[F::BR];
          F::load_b_t(bk, Ks, LD, wn * (DC / 2) + n * 8, kk, lane);
          F::mma(acc_q[n], ad, bk);
        }
      }
      if (MODE == CFLEARN_MODE_FUSED) {
        // this kv tile's share of dq, added to the f32 buffer
        float* dq = static_cast<float*>(a.dq) + size_t(blockIdx.z) * a.q_len * a.d;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const int col = col_out + wn * (DC / 2) + n * 8 + cq * 2;
          if (col >= a.d) continue;
          const int ra = q0 + wm * 16 + g, rb = ra + 8;
          // two neighbouring columns per atomic (8-byte aligned: col and D are even)
          if (ra < a.q_len)
            atomicAdd(reinterpret_cast<float2*>(dq + size_t(ra) * a.d + col),
                      make_float2(acc_q[n][0] * a.scale, acc_q[n][1] * a.scale));
          if (rb < a.q_len)
            atomicAdd(reinterpret_cast<float2*>(dq + size_t(rb) * a.d + col),
                      make_float2(acc_q[n][2] * a.scale, acc_q[n][3] * a.scale));
        }
      }
    }
    __syncthreads();  // tiles, Ps, dSs, lse_s may be overwritten from here on
  }

  // epilogue: cast and store this warp's rows of the outer tile
  const int ra = outer0 + wm * 16 + g, rb = ra + 8;
  if (MODE != CFLEARN_MODE_DQ) {
    T* dk = static_cast<T*>(a.dk) + size_t(blockIdx.z) * a.kv_len * a.d;
    T* dv = static_cast<T*>(a.dv) + size_t(blockIdx.z) * a.kv_len * a.d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = col_out + wn * (DC / 2) + n * 8 + cq * 2;
      if (col >= a.d) continue;
      if (ra < a.kv_len) {
        F::store2(dk + size_t(ra) * a.d + col, acc_k[n][0] * a.scale, acc_k[n][1] * a.scale);
        F::store2(dv + size_t(ra) * a.d + col, acc_v[n][0], acc_v[n][1]);
      }
      if (rb < a.kv_len) {
        F::store2(dk + size_t(rb) * a.d + col, acc_k[n][2] * a.scale, acc_k[n][3] * a.scale);
        F::store2(dv + size_t(rb) * a.d + col, acc_v[n][2], acc_v[n][3]);
      }
    }
  } else {
    T* dq = static_cast<T*>(a.dq) + size_t(blockIdx.z) * a.q_len * a.d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = col_out + wn * (DC / 2) + n * 8 + cq * 2;
      if (col >= a.d) continue;
      if (ra < a.q_len)
        F::store2(dq + size_t(ra) * a.d + col, acc_q[n][0] * a.scale, acc_q[n][1] * a.scale);
      if (rb < a.q_len)
        F::store2(dq + size_t(rb) * a.d + col, acc_q[n][2] * a.scale, acc_q[n][3] * a.scale);
    }
  }
}

template <typename T, int DC, int MODE>
cudaError_t launch(const BwdArgs& a, int batch, cudaStream_t stream) {
  using Cfg = BwdCfg<T, DC>;
  auto kernel = flash_bwd_kernel<T, DC, MODE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Cfg::SMEM));
  if (err != cudaSuccess) return err;
  const int outer_len = MODE == CFLEARN_MODE_DQ ? a.q_len : a.kv_len;
  const dim3 grid((outer_len + Cfg::BT - 1) / Cfg::BT, (a.d + DC - 1) / DC, batch * a.heads);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t dispatch(const BwdArgs& a, int batch, cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {
    if (a.d <= 64) return launch<T, 64, MODE>(a, batch, s);
    return launch<T, 128, MODE>(a, batch, s);
  } else {
    if (a.d <= 32) return launch<T, 32, MODE>(a, batch, s);
    if (a.d <= 48) return launch<T, 48, MODE>(a, batch, s);
    if (a.d <= 64) return launch<T, 64, MODE>(a, batch, s);
    if (a.d <= 80) return launch<T, 80, MODE>(a, batch, s);
    if (a.d <= 128) return launch<T, 128, MODE>(a, batch, s);
    if (a.d <= 160) return launch<T, 160, MODE>(a, batch, s);
    return launch<T, 128, MODE>(a, batch, s);
  }
}

}  // namespace
}  // namespace cflearn
