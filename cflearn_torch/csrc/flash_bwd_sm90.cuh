// Flash-attention backward on Hopper's warpgroup MMA fed by TMA (sm_90a), and
// the C entry shared by `flash_bwd_fused.cu`, `flash_bwd_dq.cu` and
// `flash_bwd_dkv.cu` (each defines CFLEARN_BWD_MODE and CFLEARN_BWD_ENTRY).
// The entry runs the kernel the host's planner chose
// (`ops/attention.py::flash_bwd_plan`): these for bf16 / fp16 with 8 | d <= 128
// (dk.dv and the fused backward) or 8 | d <= 192 (dq), or the mma.sync kernel
// of `flash_bwd.cuh` (f32, larger head dims), which a caller may also ask for
// by name.
//
// Replaces, in cflearn_tpu/ops/attention.py (launched by `_flash_train_bwd`):
//   MODE_FUSED -> `_flash_bwd_fused_kernel` (dq, dk, dv in one pass; kv outer)
//   MODE_DKV   -> `_flash_bwd_dkv_kernel`   (dk, dv; kv outer)
//   MODE_DQ    -> `_flash_bwd_dq_kernel`    (dq; q outer)
// whose grids walk the inner axis in order with the sums in VMEM scratch;
// here a loop inside the CTA walks it.
//
// The same function as the TPU kernels and `flash_bwd_plain`, per (q, kv)
// pair: p = exp(s * scale - lse) (0 where masked: the ragged q and kv tails,
// and k > q with `causal`), dv += cast(p)^T dO, dp = dO v^T,
// ds = p (dp - delta), dk += scale cast(ds)^T q, dq += scale cast(ds) k; p and
// ds cast to the input dtype before their products, every sum in f32,
// delta = rowsum(dO * O) from the caller.
//
// What bounds it on the H100: tensor-core operations. The fused backward
// does 10 L^2 d operations a head (s, dp, dv, dk, dq), the split pair 14,
// against a few L d bytes: hundreds of operations a byte at the UNet's
// shapes. The design keeps p and ds out of device memory and, for dk and
// dv, out of shared memory too:
//   * kv outer (MODE_DKV, MODE_FUSED): a CTA owns 64 kv rows per consumer
//     warpgroup (one or two), K and V loaded once by TMA. A producer thread
//     streams 64-row q tiles of Q and dO, with their lse and delta rows (1-D
//     tensor maps), through a ring of stages with full and empty barriers.
//     Per q tile each consumer computes, transposed so that the kv rows are
//     wgmma's M: S^T = K Q^T and dP^T = V dO^T (both operands K-major in
//     shared memory), P^T = exp2(S^T scale log2 e - lse log2 e) in registers,
//     dV += P^T dO (RS: P^T packed from the accumulator as the A fragment, dO
//     MN-major), dS^T = P^T (dP^T - delta) in registers, dK += dS^T Q (RS, Q
//     MN-major). The q tiles are summed in a fixed order, so dk and dv are
//     bit-reproducible.
//   * MODE_FUSED also writes dS^T to shared memory in the input dtype (the
//     128-byte swizzle, conflict-free) and computes the warpgroup's share of
//     dQ for the q tile, dS K over its 64 kv rows (SS, both MN-major). Each
//     consumer writes its share to an f32 tile of its own in shared memory
//     (two, used in turn), and its first thread adds the tile to the f32 dq
//     buffer with one bulk reduce-add (`cp.reduce.async.bulk...add.f32`): no
//     per-element atomics. The reduce-add runs on while the next q tiles'
//     products do; the consumer waits for it to have read a tile only before
//     it writes that tile again, two q tiles later. (Summing the consumers'
//     shares in one tile first would halve the reduce traffic, but it ties
//     the consumers together at every q tile, and the kernel ran slower so.)
//     The order in which the kv tiles' CTAs add into dq varies from run to
//     run, so the fused dq is not bit-reproducible; the split pair is.
//   * At one box of head dim (d <= 64) the registers leave room to
//     software-pipeline the q tiles: iteration t issues S_t and dP_t together
//     with dK_{t-1} (and dQ_{t-1}), the exponentials of S_t run while those
//     do, and every product is done by the end of the iteration (a wgmma in
//     flight across the loop's back edge makes ptxas serialise them all).
//   * q outer (MODE_DQ): `flash_fwd_sm90.cuh`'s shape with a third product. A
//     CTA owns 64 q rows per consumer (Q, dO, lse, delta loaded once); K and V
//     blocks come through the ring. Per block: S = Q K^T, dP = dO V^T (SS),
//     P and dS in registers, dQ += dS K (RS, K MN-major, as the forward's
//     P V takes V). The blocks are summed in a fixed order.
// Registers set the head-dim limits: a kv-outer consumer holds dV and dK
// (32 f32 each a 64-column box) and S^T, dP^T (32 each), with P^T and dS^T
// packed (16 each) only once dP^T is done: 192 at d = 128 under the 240 that
// `setmaxnreg` gives each of two consumers. At d = 160 that is 256, so the
// planner keeps dk.dv and the fused backward there on mma.sync. The dq
// kernel holds dQ (32 a box), S, dP and dS packed: d <= 192.
//
// What the per-tile loop keeps out (`PERF.md`, the forward's lessons): no
// division by the runtime stage count (ring counters), barrier arrivals and
// bulk operations as predicated PTX, not branches, and loops around wgmma
// unrolled over compile-time counts.
//
// Layout: q/k/v/dO (B, H, L, D) views with B/H/L strides that are multiples
// of 8 elements and a contiguous D, read through 4-D tensor maps over
// (D, L, H, B) (dO as autograd hands it over, a transposed (B, L, H, D) view,
// qualifies); the head dim past d and the ragged tails are TMA's zero fill.
// lse and delta are (B, H, Lq) contiguous f32; dq / dk / dv are contiguous
// (B, H, L, D), dq f32 and zeroed by the caller in MODE_FUSED.

#pragma once

#include "flash_bwd.cuh"
#include "sm90.cuh"

namespace cflearn {
namespace {

using sm90::ROW_BYTES;
constexpr int kBwdMaxStages = 4;
constexpr int kBwdSmemMax = 232448;  // the most dynamic shared memory a block can have on sm_90
constexpr int kBwdBarrierBytes = 8 * (1 + 2 * kBwdMaxStages);
constexpr int kQT = 64;               // q rows of a kv-outer kernel's q tile
constexpr int kRowStatBytes = 2 * kQT * 4;  // lse and delta of one q tile

struct BwdSm90Args {
  const float* lse;    // MODE_DQ: read directly; kv outer: through the 1-D maps
  const float* delta;
  void* dq;  // MODE_DQ: input dtype; MODE_FUSED: zeroed f32
  void* dk;
  void* dv;
  int heads, q_len, kv_len, d, causal, stages;
  float scale, scale2;  // scale2 = scale * log2(e): exponentials in base 2
};

// kv rows a block of the q-outer kernel: 128 where S, dP (BK / 2 f32 each) and P (BK / 4) fit beside dQ
template <int SLABS>
__host__ __device__ constexpr int dq_block_rows() {
  return SLABS == 1 ? 128 : 64;
}

// dynamic shared memory of a kv-outer launch: alignment slack, K and V, the Q and dO rings, (fused:
// dS^T and two dq tiles), the lse / delta ring, barriers
inline size_t kv_outer_smem(int slabs, int ks, int bkv, int stages, bool fused) {
  size_t bytes = size_t(sm90::SWIZZLE_ATOM) + size_t(slabs) * ROW_BYTES * (2 * bkv + 2 * stages * kQT) +
                 size_t(stages) * kRowStatBytes + kBwdBarrierBytes;
  if (fused) bytes += size_t(bkv) * ROW_BYTES + 2 * size_t(bkv / 64) * kQT * 16 * ks * 4;
  return bytes;
}

// of a q-outer launch: alignment slack, Q and dO, the K and V rings, barriers
inline size_t q_outer_smem(int slabs, int bq, int bk, int stages) {
  return size_t(sm90::SWIZZLE_ATOM) + size_t(slabs) * ROW_BYTES * (2 * bq + 2 * stages * bk) + kBwdBarrierBytes;
}

__device__ __forceinline__ unsigned char* align_atom(unsigned char* p) {
  // the swizzle pattern repeats every 1024 bytes: tiles start on such a boundary
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + sm90::SWIZZLE_ATOM - 1) &
                                          ~uintptr_t(sm90::SWIZZLE_ATOM - 1));
}

template <typename T, int N>
__device__ __forceinline__ void pack_all(uint32_t* out, const float* x) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) out[i] = Mma<T>::pack(x[2 * i], x[2 * i + 1]);
}

// ---- kv outer: MODE_DKV and MODE_FUSED ----------------------------------------

// KS: steps of 16 over the head dim in S^T and dP^T (a compile-time count, so the product loops unroll);
// NC: consumer warpgroups of 64 kv rows
template <typename T, int KS, int NC, int MODE>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_bwd_kv_outer_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                              const __grid_constant__ CUtensorMap lmap, const __grid_constant__ CUtensorMap dmap,
                              const BwdSm90Args a) {
  constexpr bool FUSED = MODE == CFLEARN_MODE_FUSED;
  constexpr int SLABS = (KS + 3) / 4, NV = 64 * SLABS, BKV = 64 * NC;
  static_assert(SLABS <= 2, "a kv-outer consumer holds dK and dV of at most two boxes");
  constexpr int KV_BYTES = SLABS * BKV * ROW_BYTES, QT_BYTES = SLABS * kQT * ROW_BYTES;
  constexpr int DQ_TILE_FLOATS = kQT * 16 * KS;  // one 64 x d f32 tile (d <= 16 KS)
  constexpr int DQ_TILE_BYTES = FUSED ? 2 * NC * DQ_TILE_FLOATS * 4 : 0;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_atom(smem_raw);
  const int S = a.stages;
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + KV_BYTES;
  unsigned char* Qs = Vs + KV_BYTES;
  unsigned char* Os = Qs + S * QT_BYTES;
  unsigned char* dSs = Os + S * QT_BYTES;  // fused: dS^T, BKV kv rows of 64 q values
  // fused: two 64 x d f32 tiles a consumer
  float* dq_tile = reinterpret_cast<float*>(dSs + (FUSED ? BKV * ROW_BYTES : 0));
  float* stats = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(dq_tile) + DQ_TILE_BYTES);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + S * 2 * kQT);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + kBwdMaxStages;

  const int k0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.heads + h;
  const int n_qt = (a.q_len + kQT - 1) / kQT;
  const int t_begin = a.causal ? k0 / kQT : 0;  // causal: the q tiles that reach this kv tile
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&q_full[s], 1);
      sm90::mbar_init(&q_empty[s], 4 * NC);  // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (NC == 2) sm90::regs_dec<24>();
    if (threadIdx.x == 0) {
      sm90::prefetch_map(&qmap);
      sm90::prefetch_map(&omap);
      sm90::prefetch_map(&kmap);
      sm90::prefetch_map(&vmap);
      sm90::mbar_expect_tx(kv_full, 2 * KV_BYTES);
      for (int s = 0; s < SLABS; ++s) {
        sm90::tma_load_4d(Ks + s * BKV * ROW_BYTES, &kmap, kv_full, s * sm90::BOX_C, k0, h, b);
        sm90::tma_load_4d(Vs + s * BKV * ROW_BYTES, &vmap, kv_full, s * sm90::BOX_C, k0, h, b);
      }
      int st = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < n_qt; ++t) {
        sm90::mbar_wait(&q_empty[st], phase ^ 1);
        sm90::mbar_expect_tx(&q_full[st], 2 * QT_BYTES + kRowStatBytes);
        for (int s = 0; s < SLABS; ++s) {
          sm90::tma_load_4d(Qs + st * QT_BYTES + s * kQT * ROW_BYTES, &qmap, &q_full[st], s * sm90::BOX_C, t * kQT,
                            h, b);
          sm90::tma_load_4d(Os + st * QT_BYTES + s * kQT * ROW_BYTES, &omap, &q_full[st], s * sm90::BOX_C, t * kQT,
                            h, b);
        }
        // rows past this head's q_len read the next head's (or, at the end, zeros): they are masked
        sm90::tma_load_1d(stats + st * 2 * kQT, &lmap, &q_full[st], bh * a.q_len + t * kQT);
        sm90::tma_load_1d(stats + st * 2 * kQT + kQT, &dmap, &q_full[st], bh * a.q_len + t * kQT);
        if (++st == S) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    if constexpr (NC == 2) sm90::regs_inc<240>();
    const int cw = wg - 1, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, c = lane % 4;
    const int kr0 = k0 + cw * 64;  // this warpgroup's first kv row
    const int kv_a = kr0 + warp * 16 + g, kv_b = kv_a + 8;
    const bool issuer = FUSED && t == 0;  // the thread that issues the warpgroup's bulk reduce-adds of dq

    float dv[NV / 2], dk[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) dv[i] = dk[i] = 0.f;
    float s[32];    // S^T (kv rows x 64 q), then P^T; fused, two boxes: then a chunk of dQ's share
    float dp[32];   // dP^T, then dS^T
    uint32_t pp[16];  // P^T in the input dtype: the A fragments of dV
    uint32_t pk[16];  // dS^T in the input dtype: the A fragments of dK (fused: also stored for dQ)

    // descriptors of stage 0, as their low words (`sm90::desc_lo`; the K-major ones with the unused leading
    // offset of 16 bytes); a stage, a box or a step of K is a constant number of 16-byte units further
    const uint32_t k_desc = sm90::desc_lo(Ks + cw * 64 * ROW_BYTES, 16);
    const uint32_t v_desc = sm90::desc_lo(Vs + cw * 64 * ROW_BYTES, 16);
    const uint32_t q_desc = sm90::desc_lo(Qs, 16), o_desc = sm90::desc_lo(Os, 16);
    const uint32_t qt_desc = sm90::desc_lo(Qs, kQT * ROW_BYTES);
    const uint32_t ot_desc = sm90::desc_lo(Os, kQT * ROW_BYTES);
    unsigned char* dSw = dSs + cw * 64 * ROW_BYTES;  // this warpgroup's kv rows of dS^T
    const uint32_t ds_desc = sm90::desc_lo(dSw, 64 * ROW_BYTES);
    const uint32_t kc_desc = sm90::desc_lo(Ks + cw * 64 * ROW_BYTES, BKV * ROW_BYTES);
    constexpr uint32_t K16 = 16 * ROW_BYTES >> 4;  // 16 rows of an MN-major operand

    // S^T = K Q^T and dP^T = V dO^T over stage `st`: KS steps of 16, four to a box, +32 bytes a step
    auto issue_s_dp = [&](int st) {
      const uint32_t qd = q_desc + st * (QT_BYTES >> 4), od = o_desc + st * (QT_BYTES >> 4);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t ka = ((kk >> 2) * BKV * ROW_BYTES >> 4) + (kk & 3) * 2;
        const uint32_t qb = ((kk >> 2) * kQT * ROW_BYTES >> 4) + (kk & 3) * 2;
        sm90::wgmma<T, 64, 0, 0>(s, sm90::desc_of(k_desc + ka), sm90::desc_of(qd + qb), kk > 0);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t ka = ((kk >> 2) * BKV * ROW_BYTES >> 4) + (kk & 3) * 2;
        const uint32_t qb = ((kk >> 2) * kQT * ROW_BYTES >> 4) + (kk & 3) * 2;
        sm90::wgmma<T, 64, 0, 0>(dp, sm90::desc_of(v_desc + ka), sm90::desc_of(od + qb), kk > 0);
      }
      sm90::wgmma_commit();
    };
    // acc += A . B over the q tile's 64 rows, A from registers (P^T or dS^T packed), B (dO or Q of stage
    // `st`) MN-major: the next box one q tile on, 16 q rows = 2048 bytes a step; the caller commits
    auto issue_rs = [&](float* acc, const uint32_t* areg, uint32_t desc, int st) {
      const uint32_t bd = desc + st * (QT_BYTES >> 4);
#pragma unroll
      for (int kk = 0; kk < kQT / 16; ++kk) sm90::wgmma_rs<T, NV, 1>(acc, areg + 4 * kk, sm90::desc_of(bd + kk * K16));
    };
    // fused: chunk j (64 columns of the head dim) of this warpgroup's share of dQ = dS K over its 64 kv rows,
    // into acc; both operands MN-major; the caller commits
    auto issue_dq = [&](float* acc, int j) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma<T, 64, 1, 1>(acc, sm90::desc_of(ds_desc + kk * K16),
                                 sm90::desc_of(kc_desc + j * (BKV * ROW_BYTES >> 4) + kk * K16), kk > 0);
    };
    // keep the compiler from moving reads or writes of these registers across the wgmma that owns them;
    // each phase fences only what is live in it, so that the registers of S^T and dP^T are free while dK's
    // product runs
    auto fence_sdp = [&]() {
      sm90::fence_regs<32>(s);
      sm90::fence_regs<32>(dp);
    };
    auto fence_rs = [&](uint32_t* areg, float* acc) {
      sm90::fence_regs<16>(areg);
      sm90::fence_regs<NV / 2>(acc);
    };
    auto release = [&](uint64_t* bar) { sm90::mbar_arrive(bar, lane == 0); };
    // the accumulator layout: s[4i + e] is kv row (e < 2 ? kv_a : kv_b), q column 8i + 2c + (e & 1)
    auto probabilities = [&](int st, int q0) {
      const float* lse = stats + st * 2 * kQT;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 l = *reinterpret_cast<const float2*>(lse + 8 * i + 2 * c);
        const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
        s[4 * i] = sm90::ex2(fmaf(s[4 * i], a.scale2, -l0));
        s[4 * i + 1] = sm90::ex2(fmaf(s[4 * i + 1], a.scale2, -l1));
        s[4 * i + 2] = sm90::ex2(fmaf(s[4 * i + 2], a.scale2, -l0));
        s[4 * i + 3] = sm90::ex2(fmaf(s[4 * i + 3], a.scale2, -l1));
      }
      const bool edge = q0 + kQT > a.q_len || kr0 + 64 > a.kv_len || (a.causal && kr0 + 63 > q0);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = q0 + 8 * i + 2 * c + (e & 1);
            const int row = e < 2 ? kv_a : kv_b;
            const bool ok = col < a.q_len && row < a.kv_len && (!a.causal || row <= col);
            if (!ok) s[4 * i + e] = 0.f;
          }
        }
      }
    };
    auto grad_scores = [&](int st) {
      const float* delta = stats + st * 2 * kQT + kQT;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * i + 2 * c);
        dp[4 * i] = s[4 * i] * (dp[4 * i] - dl.x);
        dp[4 * i + 1] = s[4 * i + 1] * (dp[4 * i + 1] - dl.y);
        dp[4 * i + 2] = s[4 * i + 2] * (dp[4 * i + 2] - dl.x);
        dp[4 * i + 3] = s[4 * i + 3] * (dp[4 * i + 3] - dl.y);
      }
    };
    // fused: dS^T to shared memory as the A operand of dS K, kv rows of 64 q values under the 128-byte
    // swizzle (16-byte chunk j of row r at j ^ (r & 7); r & 7 = g): conflict-free 4-byte stores
    auto store_ds = [&]() {
      const int r = warp * 16 + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(dSw + r * ROW_BYTES + ((j ^ g) << 4) + 4 * c) = pk[2 * j];
        *reinterpret_cast<uint32_t*>(dSw + (r + 8) * ROW_BYTES + ((j ^ g) << 4) + 4 * c) = pk[2 * j + 1];
      }
    };
    // fused: scale * chunk j of this warpgroup's dQ share (in acc) into a 64 x d f32 tile
    auto tile_dq = [&](float* tile, int j, const float* acc) {
      const int r = warp * 16 + g;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * j + 8 * i + 2 * c;
        if (col >= a.d) continue;
        float2* lo = reinterpret_cast<float2*>(tile + r * a.d + col);
        float2* hi = reinterpret_cast<float2*>(tile + (r + 8) * a.d + col);
        *lo = make_float2(acc[4 * i] * a.scale, acc[4 * i + 1] * a.scale);
        *hi = make_float2(acc[4 * i + 2] * a.scale, acc[4 * i + 3] * a.scale);
      }
    };

    // fused: each consumer's share of a q tile's dQ goes to an f32 tile of its own (two in turn), and its
    // first thread adds the tile into dq with one bulk reduce-add, which runs on while the next q tiles'
    // products do; a tile is written again once the reduce-add of two tiles ago has read it
    auto dq_acquire = [&](int buf) {
      sm90::bulk_wait_read<1>(issuer);
      sm90::bar_sync(2 + cw, 128);
      return dq_tile + (2 * cw + buf) * DQ_TILE_FLOATS;
    };
    auto dq_release = [&](const float* tile, int q0) {
      sm90::fence_proxy_async();
      sm90::bar_sync(2 + cw, 128);  // the share is in the tile
      sm90::bulk_reduce_add_f32(static_cast<float*>(a.dq) + (size_t(bh) * a.q_len + q0) * a.d, tile,
                                uint32_t(min(kQT, a.q_len - q0) * a.d * 4), issuer);
    };
    auto ds_to_smem = [&]() {
      store_ds();
      sm90::fence_proxy_async();
      sm90::bar_sync(2 + cw, 128);  // the warpgroup's dS^T is in shared memory
    };

    sm90::mbar_wait(kv_full, 0);
    if constexpr (SLABS == 1) {
      // One box of head dim leaves the registers for a second packed operand and, fused, dQ's share: the
      // q tiles are software-pipelined. Iteration t issues S_t and dP_t with dK_{t-1} (and dQ_{t-1}); the
      // exponentials of S_t run while those do, dS_t while dV_t does, and every product is done by the
      // end of the iteration (no wgmma in flight across the loop's back edge).
      float dqa[32];     // fused: this warpgroup's share of dQ for the previous q tile
      auto fence_dqa = [&]() {
        if constexpr (FUSED) sm90::fence_regs<32>(dqa);
      };
      if (t_begin < n_qt) {
        // tile t_begin: all but dK and dQ
        sm90::mbar_wait(&q_full[0], 0);
        sm90::wgmma_fence();
        fence_sdp();
        issue_s_dp(0);
        fence_sdp();
        sm90::wgmma_wait<1>();
        sm90::fence_regs<32>(s);
        probabilities(0, t_begin * kQT);
        sm90::wgmma_wait<0>();
        sm90::fence_regs<32>(dp);
        grad_scores(0);
        pack_all<T, 32>(pp, s);
        sm90::wgmma_fence();
        fence_rs(pp, dv);
        issue_rs(dv, pp, ot_desc, 0);
        sm90::wgmma_commit();
        fence_rs(pp, dv);
        sm90::wgmma_wait<0>();
        fence_rs(pp, dv);
        pack_all<T, 32>(pk, dp);
        if constexpr (FUSED) ds_to_smem();
        int st = 0, pst = 0;
        uint32_t ph = 0;
        for (int qt = t_begin + 1; qt < n_qt; ++qt) {
          const int q0 = qt * kQT;
          pst = st;
          if (++st == S) {
            st = 0;
            ph ^= 1;
          }
          sm90::mbar_wait(&q_full[st], ph);
          sm90::wgmma_fence();
          fence_sdp();
          fence_rs(pk, dk);
          fence_dqa();
          issue_s_dp(st);
          issue_rs(dk, pk, qt_desc, pst);  // dK += dS^T_{t-1} Q_{t-1}
          if constexpr (FUSED) issue_dq(dqa, 0);
          sm90::wgmma_commit();
          fence_sdp();
          fence_rs(pk, dk);
          fence_dqa();
          sm90::wgmma_wait<2>();  // S^T_t is done; dP^T_t, dK and dQ may still run
          sm90::fence_regs<32>(s);
          probabilities(st, q0);
          sm90::wgmma_wait<1>();  // dP^T_t is done
          sm90::fence_regs<32>(dp);
          grad_scores(st);  // before P^T is packed: the two packed operands are never live beside S^T, dP^T
          pack_all<T, 32>(pp, s);
          sm90::wgmma_fence();
          fence_rs(pp, dv);
          issue_rs(dv, pp, ot_desc, st);  // dV += P^T_t dO_t
          sm90::wgmma_commit();
          fence_rs(pp, dv);
          sm90::wgmma_wait<0>();
          fence_rs(pp, dv);
          fence_rs(pk, dk);
          fence_dqa();
          release(&q_empty[pst]);  // Q_{t-1} and dO_{t-1} are read
          if constexpr (FUSED) {
            float* tile = dq_acquire((qt - 1 - t_begin) & 1);
            tile_dq(tile, 0, dqa);
            dq_release(tile, q0 - kQT);
          }
          pack_all<T, 32>(pk, dp);
          if constexpr (FUSED) ds_to_smem();
        }
        // the last tile's dK and dQ
        sm90::wgmma_fence();
        fence_rs(pk, dk);
        fence_dqa();
        issue_rs(dk, pk, qt_desc, st);
        if constexpr (FUSED) issue_dq(dqa, 0);
        sm90::wgmma_commit();
        fence_rs(pk, dk);
        fence_dqa();
        sm90::wgmma_wait<0>();
        fence_rs(pk, dk);
        fence_dqa();
        if constexpr (FUSED) {
          float* tile = dq_acquire((n_qt - 1 - t_begin) & 1);
          tile_dq(tile, 0, dqa);
          dq_release(tile, (n_qt - 1) * kQT);
        }
      }
    } else {
      int st = 0;
      uint32_t ph = 0;
      for (int qt = t_begin; qt < n_qt; ++qt) {
        const int q0 = qt * kQT;
        sm90::mbar_wait(&q_full[st], ph);
        sm90::wgmma_fence();
        fence_sdp();
        issue_s_dp(st);
        fence_sdp();
        sm90::wgmma_wait<1>();  // S^T is done; dP^T may still run
        sm90::fence_regs<32>(s);
        probabilities(st, q0);
        sm90::wgmma_wait<0>();
        sm90::fence_regs<32>(dp);
        // dS^T before P^T is packed and dV's product issued: the packed operands are never live beside
        // S^T and dP^T, and dV and dK run back to back
        grad_scores(st);
        pack_all<T, 32>(pp, s);
        sm90::wgmma_fence();
        fence_rs(pp, dv);
        issue_rs(dv, pp, ot_desc, st);  // dV += P^T dO
        sm90::wgmma_commit();
        fence_rs(pp, dv);
        pack_all<T, 32>(pk, dp);
        sm90::wgmma_fence();
        fence_rs(pk, dk);
        issue_rs(dk, pk, qt_desc, st);  // dK += dS^T Q
        sm90::wgmma_commit();
        fence_rs(pk, dk);
        if constexpr (FUSED) ds_to_smem();
        sm90::wgmma_wait<0>();
        fence_rs(pp, dv);
        fence_rs(pk, dk);
        release(&q_empty[st]);
        if constexpr (FUSED) {
          // the share a 64-column chunk at a time, in the registers of S^T (free from here on)
          float* tile = dq_acquire((qt - t_begin) & 1);
#pragma unroll
          for (int j = 0; j < SLABS; ++j) {
#pragma unroll
            for (int i = 0; i < 32; ++i) s[i] = 0.f;
            sm90::wgmma_fence();
            sm90::fence_regs<32>(s);
            issue_dq(s, j);
            sm90::wgmma_commit();
            sm90::fence_regs<32>(s);
            sm90::wgmma_wait<0>();
            sm90::fence_regs<32>(s);
            tile_dq(tile, j, s);
          }
          dq_release(tile, q0);
        }
        if (++st == S) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    if constexpr (FUSED) sm90::bulk_wait(issuer);

    // dk = scale * dK, dv = dV, one cast; rows >= kv_len and columns >= d are not stored
    T* dk_out = static_cast<T*>(a.dk) + size_t(bh) * a.kv_len * a.d;
    T* dv_out = static_cast<T*>(a.dv) + size_t(bh) * a.kv_len * a.d;
#pragma unroll
    for (int i = 0; i < NV / 8; ++i) {
      const int col = 8 * i + 2 * c;
      if (col >= a.d) continue;
      if (kv_a < a.kv_len) {
        *reinterpret_cast<uint32_t*>(dk_out + size_t(kv_a) * a.d + col) =
            Mma<T>::pack(dk[4 * i] * a.scale, dk[4 * i + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dv_out + size_t(kv_a) * a.d + col) = Mma<T>::pack(dv[4 * i], dv[4 * i + 1]);
      }
      if (kv_b < a.kv_len) {
        *reinterpret_cast<uint32_t*>(dk_out + size_t(kv_b) * a.d + col) =
            Mma<T>::pack(dk[4 * i + 2] * a.scale, dk[4 * i + 3] * a.scale);
        *reinterpret_cast<uint32_t*>(dv_out + size_t(kv_b) * a.d + col) =
            Mma<T>::pack(dv[4 * i + 2], dv[4 * i + 3]);
      }
    }
  }
}

// ---- q outer: MODE_DQ ------------------------------------------------------------

template <typename T, int KS, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_bwd_q_outer_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                             const BwdSm90Args a) {
  constexpr int SLABS = (KS + 3) / 4, NV = 64 * SLABS, BQ = 64 * NC, BK = dq_block_rows<SLABS>();
  constexpr int Q_BYTES = SLABS * BQ * ROW_BYTES, KV = SLABS * BK * ROW_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_atom(smem_raw);
  const int S = a.stages;
  unsigned char* Qs = smem;
  unsigned char* Os = Qs + Q_BYTES;
  unsigned char* Ks = Os + Q_BYTES;
  unsigned char* Vs = Ks + S * KV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + S * KV);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + kBwdMaxStages;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.heads + h;
  int n_kb = (a.kv_len + BK - 1) / BK;
  if (a.causal) n_kb = min(n_kb, (q0 + BQ - 1) / BK + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&kv_full[s], 1);
      sm90::mbar_init(&kv_empty[s], 4 * NC);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (NC == 2) sm90::regs_dec<24>();
    if (threadIdx.x == 0) {
      sm90::prefetch_map(&qmap);
      sm90::prefetch_map(&omap);
      sm90::prefetch_map(&kmap);
      sm90::prefetch_map(&vmap);
      sm90::mbar_expect_tx(q_full, 2 * Q_BYTES);
      for (int s = 0; s < SLABS; ++s) {
        sm90::tma_load_4d(Qs + s * BQ * ROW_BYTES, &qmap, q_full, s * sm90::BOX_C, q0, h, b);
        sm90::tma_load_4d(Os + s * BQ * ROW_BYTES, &omap, q_full, s * sm90::BOX_C, q0, h, b);
      }
      int st = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_kb; ++j) {
        sm90::mbar_wait(&kv_empty[st], phase ^ 1);
        sm90::mbar_expect_tx(&kv_full[st], 2 * KV);
        for (int s = 0; s < SLABS; ++s) {
          sm90::tma_load_4d(Ks + st * KV + s * BK * ROW_BYTES, &kmap, &kv_full[st], s * sm90::BOX_C, j * BK, h, b);
          sm90::tma_load_4d(Vs + st * KV + s * BK * ROW_BYTES, &vmap, &kv_full[st], s * sm90::BOX_C, j * BK, h, b);
        }
        if (++st == S) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    if constexpr (NC == 2) sm90::regs_inc<240>();
    const int cw = wg - 1, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, c = lane % 4;
    const int row_lo = q0 + cw * 64;
    const int row_a = row_lo + warp * 16 + g, row_b = row_a + 8;
    const float* lse = a.lse + size_t(bh) * a.q_len;
    const float* delta = a.delta + size_t(bh) * a.q_len;
    const float lse_a = row_a < a.q_len ? lse[row_a] * kLog2e : 0.f;
    const float lse_b = row_b < a.q_len ? lse[row_b] * kLog2e : 0.f;
    const float del_a = row_a < a.q_len ? delta[row_a] : 0.f;
    const float del_b = row_b < a.q_len ? delta[row_b] : 0.f;

    float dq[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) dq[i] = 0.f;
    float s[BK / 2], dp[BK / 2];
    uint32_t pk[BK / 4];  // dS in the input dtype: the A fragments of dQ += dS K

    // descriptors of stage 0 as their low words (`sm90::desc_lo`), as in the kv-outer kernel
    const uint32_t q_desc = sm90::desc_lo(Qs + cw * 64 * ROW_BYTES, 16);
    const uint32_t o_desc = sm90::desc_lo(Os + cw * 64 * ROW_BYTES, 16);
    const uint32_t k_desc = sm90::desc_lo(Ks, 16), v_desc = sm90::desc_lo(Vs, 16);
    const uint32_t kt_desc = sm90::desc_lo(Ks, BK * ROW_BYTES);
    auto issue_s_dp = [&](int st) {
      const uint32_t kd = k_desc + st * (KV >> 4), vd = v_desc + st * (KV >> 4);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t qa = ((kk >> 2) * BQ * ROW_BYTES >> 4) + (kk & 3) * 2;
        const uint32_t kb = ((kk >> 2) * BK * ROW_BYTES >> 4) + (kk & 3) * 2;
        sm90::wgmma<T, BK, 0, 0>(s, sm90::desc_of(q_desc + qa), sm90::desc_of(kd + kb), kk > 0);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t qa = ((kk >> 2) * BQ * ROW_BYTES >> 4) + (kk & 3) * 2;
        const uint32_t kb = ((kk >> 2) * BK * ROW_BYTES >> 4) + (kk & 3) * 2;
        sm90::wgmma<T, BK, 0, 0>(dp, sm90::desc_of(o_desc + qa), sm90::desc_of(vd + kb), kk > 0);
      }
      sm90::wgmma_commit();
    };
    // dQ += dS K over stage `st`: K MN-major, the next 64 columns one box on, 16 kv rows = 2048 bytes a step
    auto issue_dq = [&](int st) {
      const uint32_t kd = kt_desc + st * (KV >> 4);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::wgmma_rs<T, NV, 1>(dq, pk + 4 * kk, sm90::desc_of(kd + kk * (16 * ROW_BYTES >> 4)));
      sm90::wgmma_commit();
    };
    // dQ_{j-1}'s product runs on while block j's S and dP are issued: its registers (dq, pk) are fenced
    // only once it is done, or ptxas serialises every wgmma (an instruction that defines the accumulator
    // of a wgmma in flight)
    auto fence_sdp = [&]() {
      sm90::fence_regs<BK / 2>(s);
      sm90::fence_regs<BK / 2>(dp);
    };
    auto fence_dq = [&]() {
      sm90::fence_regs<BK / 4>(pk);
      sm90::fence_regs<NV / 2>(dq);
    };
    // s[4i + e] is q row (e < 2 ? row_a : row_b), kv column j BK + 8i + 2c + (e & 1)
    auto probabilities = [&](int j) {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        s[4 * i] = sm90::ex2(fmaf(s[4 * i], a.scale2, -lse_a));
        s[4 * i + 1] = sm90::ex2(fmaf(s[4 * i + 1], a.scale2, -lse_a));
        s[4 * i + 2] = sm90::ex2(fmaf(s[4 * i + 2], a.scale2, -lse_b));
        s[4 * i + 3] = sm90::ex2(fmaf(s[4 * i + 3], a.scale2, -lse_b));
      }
      const bool edge = (j + 1) * BK > a.kv_len || (a.causal && (j + 1) * BK - 1 > row_lo);
      if (edge) {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * BK + 8 * i + 2 * c + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            const bool ok = col < a.kv_len && (!a.causal || col <= row);
            if (!ok) s[4 * i + e] = 0.f;
          }
        }
      }
    };
    auto grad_scores = [&]() {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        dp[4 * i] = s[4 * i] * (dp[4 * i] - del_a);
        dp[4 * i + 1] = s[4 * i + 1] * (dp[4 * i + 1] - del_a);
        dp[4 * i + 2] = s[4 * i + 2] * (dp[4 * i + 2] - del_b);
        dp[4 * i + 3] = s[4 * i + 3] * (dp[4 * i + 3] - del_b);
      }
    };

    sm90::mbar_wait(q_full, 0);
    // block 0: S and dP alone
    sm90::mbar_wait(&kv_full[0], 0);
    sm90::wgmma_fence();
    fence_sdp();
    issue_s_dp(0);
    fence_sdp();
    sm90::wgmma_wait<1>();
    sm90::fence_regs<BK / 2>(s);
    probabilities(0);
    sm90::wgmma_wait<0>();
    sm90::fence_regs<BK / 2>(dp);
    grad_scores();
    pack_all<T, BK / 2>(pk, dp);
    // block j: S_j and dP_j with dQ_{j-1} += dS_{j-1} K_{j-1}; the exponentials of S_j while the other two
    // run, and every product done by the end of the iteration (no wgmma in flight across the loop's back
    // edge, where ptxas would serialise them all)
    // ring positions: block j's stage `st` in round parity `ph`, block j - 1's `pst`
    int st = 0, pst = 0;
    uint32_t ph = 0;
    for (int j = 1; j < n_kb; ++j) {
      pst = st;
      if (++st == S) {
        st = 0;
        ph ^= 1;
      }
      sm90::mbar_wait(&kv_full[st], ph);
      sm90::wgmma_fence();
      fence_sdp();
      fence_dq();
      issue_s_dp(st);
      issue_dq(pst);
      fence_sdp();
      fence_dq();
      sm90::wgmma_wait<2>();  // S_j is done; dP_j and dQ_{j-1} may still run
      sm90::fence_regs<BK / 2>(s);
      probabilities(j);
      sm90::wgmma_wait<0>();
      fence_sdp();
      fence_dq();
      sm90::mbar_arrive(&kv_empty[pst], lane == 0);  // K_{j-1} and V_{j-1} are read
      grad_scores();
      pack_all<T, BK / 2>(pk, dp);
    }
    sm90::wgmma_fence();
    fence_dq();
    issue_dq(st);
    fence_dq();
    sm90::wgmma_wait<0>();
    fence_dq();

    // dq = scale * dQ, one cast; rows >= q_len and columns >= d are not stored
    T* out = static_cast<T*>(a.dq) + size_t(bh) * a.q_len * a.d;
#pragma unroll
    for (int i = 0; i < NV / 8; ++i) {
      const int col = 8 * i + 2 * c;
      if (col >= a.d) continue;
      if (row_a < a.q_len)
        *reinterpret_cast<uint32_t*>(out + size_t(row_a) * a.d + col) =
            Mma<T>::pack(dq[4 * i] * a.scale, dq[4 * i + 1] * a.scale);
      if (row_b < a.q_len)
        *reinterpret_cast<uint32_t*>(out + size_t(row_b) * a.d + col) =
            Mma<T>::pack(dq[4 * i + 2] * a.scale, dq[4 * i + 3] * a.scale);
    }
  }
}

// ---- host ---------------------------------------------------------------------------

// outer: kv rows (kv outer) or q rows (q outer) a CTA, 64 a consumer; inner: q rows a tile (64) or kv rows
// a block; both must be those of the kernel the planner named
template <typename T, int KS, int NC, int MODE>
cudaError_t launch_bwd_sm90(const BwdArgs& ba, int batch, int outer, int inner, int stages, cudaStream_t stream) {
  constexpr int SLABS = (KS + 3) / 4;
  constexpr bool Q_OUTER = MODE == CFLEARN_MODE_DQ;
  constexpr int INNER = Q_OUTER ? dq_block_rows<SLABS>() : kQT;
  if (outer != 64 * NC || inner != INNER || stages < 2 || stages > kBwdMaxStages || 16 * KS < ba.d)
    return cudaErrorInvalidValue;
  const size_t smem = Q_OUTER ? q_outer_smem(SLABS, outer, inner, stages)
                              : kv_outer_smem(SLABS, KS, outer, stages, MODE == CFLEARN_MODE_FUSED);
  if (smem > size_t(kBwdSmemMax)) return cudaErrorInvalidValue;
  const int q_rows = Q_OUTER ? outer : inner, kv_rows = Q_OUTER ? inner : outer;
  CUtensorMap qmap, kmap, vmap, omap;
  cudaError_t err = sm90::encode_bhld<T>(&qmap, ba.q, batch, ba.heads, ba.q_len, ba.d, ba.q_sb, ba.q_sh, ba.q_sl, q_rows);
  if (err == cudaSuccess)
    err = sm90::encode_bhld<T>(&omap, ba.dO, batch, ba.heads, ba.q_len, ba.d, ba.o_sb, ba.o_sh, ba.o_sl, q_rows);
  if (err == cudaSuccess)
    err = sm90::encode_bhld<T>(&kmap, ba.k, batch, ba.heads, ba.kv_len, ba.d, ba.k_sb, ba.k_sh, ba.k_sl, kv_rows);
  if (err == cudaSuccess)
    err = sm90::encode_bhld<T>(&vmap, ba.v, batch, ba.heads, ba.kv_len, ba.d, ba.v_sb, ba.v_sh, ba.v_sl, kv_rows);
  if (err != cudaSuccess) return err;
  const BwdSm90Args args{ba.lse,    ba.delta, ba.dq, ba.dk,     ba.dv,  ba.heads,
                         ba.q_len,  ba.kv_len, ba.d, ba.causal, stages, ba.scale, ba.scale * kLog2e};
  if constexpr (Q_OUTER) {
    auto kernel = flash_bwd_q_outer_kernel<T, KS, NC>;
    err = sm90::set_smem<flash_bwd_q_outer_kernel<T, KS, NC>>(kBwdSmemMax);
    if (err != cudaSuccess) return err;
    const dim3 grid((ba.q_len + outer - 1) / outer, ba.heads, batch);
    return launch_kernel(kernel, grid, 128 * (NC + 1), smem, stream, qmap, kmap, vmap, omap, args);
  } else {
    CUtensorMap lmap, dmap;
    const long long rows = (long long)batch * ba.heads * ba.q_len;
    err = sm90::encode_rows_f32(&lmap, ba.lse, rows, kQT);
    if (err == cudaSuccess) err = sm90::encode_rows_f32(&dmap, ba.delta, rows, kQT);
    if (err != cudaSuccess) return err;
    auto kernel = flash_bwd_kv_outer_kernel<T, KS, NC, MODE>;
    err = sm90::set_smem<flash_bwd_kv_outer_kernel<T, KS, NC, MODE>>(kBwdSmemMax);
    if (err != cudaSuccess) return err;
    const dim3 grid((ba.kv_len + outer - 1) / outer, ba.heads, batch);
    return launch_kernel(kernel, grid, 128 * (NC + 1), smem, stream, qmap, kmap, vmap, omap, lmap, dmap, args);
  }
}

// the instantiated (K steps, consumer warpgroups): K steps 2..6 and 8 (d <= 128) with one or two
// consumers, and for dq also 10 and 12 (d <= 192); `flash_bwd_plan` rounds ceil(d / 16) up to one of these.
// The fused kernel past 5 steps has one consumer: two consumers' f32 dq tiles do not fit in shared memory.
template <typename T, int MODE>
cudaError_t dispatch_bwd_sm90(const BwdArgs& a, int batch, int ks, int outer, int inner, int stages, cudaStream_t s) {
#define CFLEARN_BWD_CASE(KS, NC) \
  if (ks == KS && outer == 64 * NC) return launch_bwd_sm90<T, KS, NC, MODE>(a, batch, outer, inner, stages, s);
#define CFLEARN_BWD_CASES(KS) CFLEARN_BWD_CASE(KS, 1) CFLEARN_BWD_CASE(KS, 2)
  CFLEARN_BWD_CASES(2)
  CFLEARN_BWD_CASES(3)
  CFLEARN_BWD_CASES(4)
  CFLEARN_BWD_CASES(5)
  CFLEARN_BWD_CASE(6, 1)
  CFLEARN_BWD_CASE(8, 1)
  if constexpr (MODE != CFLEARN_MODE_FUSED) {
    CFLEARN_BWD_CASE(6, 2)
    CFLEARN_BWD_CASE(8, 2)
  }
  if constexpr (MODE == CFLEARN_MODE_DQ) {
    CFLEARN_BWD_CASES(10)
    CFLEARN_BWD_CASES(12)
  }
#undef CFLEARN_BWD_CASES
#undef CFLEARN_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cflearn

// dtype: 0 = bf16, 1 = fp16, 2 = f32. Strides are in elements. Outputs this
// mode does not produce are ignored (may be null). kernel: 0 = the mma.sync
// kernel of `flash_bwd.cuh` (outer = inner = 64), 1 = the wgmma + TMA kernels
// above (bf16 / fp16, d <= 128, or d <= 192 for dq; strides multiples of 8
// elements). outer, inner: rows of a CTA's own tile and of the tiles its loop
// walks; stages: the ring's; ksteps: steps of 16 over the head dim. Returns a
// cudaError_t.
extern "C" int CFLEARN_BWD_ENTRY(int dtype, const void* q, const void* k, const void* v, const void* dO,
                                 const void* lse, const void* delta, void* dq, void* dk, void* dv, long long q_sb,
                                 long long q_sh, long long q_sl, long long k_sb, long long k_sh, long long k_sl,
                                 long long v_sb, long long v_sh, long long v_sl, long long o_sb, long long o_sh,
                                 long long o_sl, int batch, int heads, int q_len, int kv_len, int d, int causal,
                                 float scale, int kernel, int outer, int inner, int stages, int ksteps,
                                 void* stream) {
  const cflearn::DeviceOf device(q);  // the device of `q`, its context bound to this thread
  if (device.error() != cudaSuccess) return device.error();
  cflearn::BwdArgs a{q,    k,    v,    dO,   static_cast<const float*>(lse), static_cast<const float*>(delta),
                     dq,   dk,   dv,   q_sb, q_sh,
                     q_sl, k_sb, k_sh, k_sl, v_sb,
                     v_sh, v_sl, o_sb, o_sh, o_sl,
                     heads, q_len, kv_len, d, causal,
                     scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kMode = CFLEARN_BWD_MODE;
  if (d <= 0 || d % 8 != 0 || d > 1024 || q_len <= 0 || kv_len <= 0 || batch <= 0 || heads <= 0)
    return cudaErrorInvalidValue;
  if (kernel == 1) {
    using cflearn::sm90::aligned16;
    const long long strides[12] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, o_sb, o_sh, o_sl};
    for (long long st : strides)
      if (st <= 0 || st % 8 != 0) return cudaErrorInvalidValue;
    if (d > (kMode == CFLEARN_MODE_DQ ? 192 : 128) || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
        !aligned16(dO) || !aligned16(lse) || !aligned16(delta) || (kMode == CFLEARN_MODE_FUSED && !aligned16(dq)))
      return cudaErrorInvalidValue;
    if (dtype == 0) return cflearn::dispatch_bwd_sm90<__nv_bfloat16, kMode>(a, batch, ksteps, outer, inner, stages, s);
    if (dtype == 1) return cflearn::dispatch_bwd_sm90<__half, kMode>(a, batch, ksteps, outer, inner, stages, s);
    return cudaErrorInvalidValue;
  }
  if (kernel != 0 || outer != 64 || inner != 64) return cudaErrorInvalidValue;
  if (dtype == 0) return cflearn::dispatch<__nv_bfloat16, kMode>(a, batch, s);
  if (dtype == 1) return cflearn::dispatch<__half, kMode>(a, batch, s);
  if (dtype == 2) return cflearn::dispatch<float, kMode>(a, batch, s);
  return cudaErrorInvalidValue;
}
