// Flash-attention forward on Hopper's warpgroup MMA fed by TMA (sm_90a), and
// the C entry point shared by `flash_attention.cu` (inference forward) and
// `flash_fwd_lse.cu` (the same forward that also writes the per-row
// logsumexp). The including file defines CFLEARN_FLASH_LSE (0 / 1) and
// CFLEARN_FLASH_ENTRY (the exported C symbol). The entry runs the kernel the
// host's planner chose (`ops/attention.py::flash_plan`): this one for bf16 /
// fp16 with 8 | d <= 256, the wide-head kernel of `flash_fwd_sm90_wide.cuh`
// for bf16 / fp16 with 8 | d, 256 < d <= 512, or the mma.sync kernels of
// `flash_fwd.cuh` (f32 and d > 512), which a caller may also ask for by name.
//
// Replaces: cflearn_tpu/ops/attention.py `_flash_kernel` (launched by
// `flash_attention`) and `_flash_fwd_kernel` (launched by
// `_flash_fwd_with_lse`), whose grid walks kv blocks in order with m, l and
// acc in VMEM scratch; here a loop inside the CTA walks them.
//
// Same function as the TPU kernels and `flash_fwd.cuh`: scores in f32,
// masked positions at -1e30 (the kv tail and, with `causal`, k > q), a
// running row max m, row sum l and accumulator in f32, P cast to the value
// dtype before P.V, o = acc / max(l, 1e-30) with one cast, and
// lse = m + log(max(l, 1e-30)).
//
// What bounds it on the H100: at the UNet's d = 40 a (q, k) pair costs 4 d =
// 160 tensor operations and one exponential. The special-function units do
// 16 exponentials a clock on each SM against the tensor cores' ~3,800 bf16
// operations (989 TF/s over 132 SMs at 1,980 MHz), 16 pairs a clock against
// 24, so at d = 40 the exponentials, not the products, set the floor; at
// d = 80 and 160 the products do. Either way the floor is reached
// only if the softmax of one tile runs while the tensor cores multiply
// another, so the design overlaps the two twice over:
//   * ping-pong: two (or three) consumer warpgroups own 64 q rows each and
//     take turns at the tensor cores through named barriers, one a
//     warpgroup. A warpgroup issues its products, hands the turn on and runs
//     its softmax while the next warpgroup's products run;
//   * within a warpgroup, the products of block j (S_j = Q K_j^T) are issued
//     together with P_{j-1} V_{j-1}, and the exponentials of S_j run while
//     P_{j-1} V_{j-1} is still in flight; the accumulator is rescaled by
//     alpha_j only after that product has completed.
// Where the grid of 128-row tiles would leave more than half the SMs idle
// (B2 H8 L256 d160: 32 CTAs on 132 SMs) the planner takes one consumer
// warpgroup of 64 rows; only the second overlap is left then. At d <= 64
// (the UNet's d = 40) three consumers (192 rows, 160 registers each) hide
// the softmax's latencies better than two, where the grid's waves allow.
//
// Warp-specialised CTA: warpgroup 0 gives its registers away and one of its
// threads loads, by TMA, the Q tile once and then K and V blocks into a ring
// of `stages` stages with full and empty barriers for K and V apart, so a K
// stage is refilled as soon as its S product is done while P.V still reads
// the V stage. The consumer warpgroups run
//   * S = Q K^T by wgmma with both operands in shared memory, K-major (d
//     contiguous). Tiles are boxes of 64 head-dim columns under the 128-byte
//     swizzle; the tensor map's inner extent is d, so the columns past d are
//     TMA's zero fill (no padded copy in device memory) and the product runs
//     ceil(d / 16) steps of K, rounded up to an instantiated count;
//   * P.V by wgmma with A from registers: the f32 S accumulator, exponentiated
//     and packed in pairs to the value dtype, is the m16n8k16 A fragment of
//     each warp's 16 rows as it stands (the accumulator's columns 8i + 2c,
//     2c + 1 of rows g and g + 8 are the A registers' element pairs). V stays
//     in shared memory, MN-major (the transpose bit); N is the head dim padded
//     to whole 64-column swizzle atoms (d = 40 -> 64, 80 -> 128, 160 -> 192),
//     whose extra columns are zeros and are not stored.
// The kv tail that TMA zero-fills is masked to -1e30 like any other masked
// position: a zero score would otherwise weigh exp(0 - m). The epilogue
// stores the rows < q_len and the columns < d from registers (predicated
// 4-byte stores into whatever strides the caller's output has).
//
// What the per-block loop keeps out, each of which cost the kernel a
// measurable share of its time on the H100: an integer division by the
// runtime stage count (ring counters instead), a branch around a barrier
// arrival or a loop around wgmma that does not unroll (ptxas then
// serialises every wgmma, C7515 / C7520), and a softmax pass that scales S
// before its max (the max of the raw scores, then one FFMA into exp2).
//
// Layout: q/k/v (B, H, L, D) views with B/H/L strides that are multiples of
// 8 elements and a contiguous D (the UNet's transposed (B, L, H, D) views
// qualify); the tensor maps are 4-D over (D, L, H, B).

#pragma once

#include "flash_fwd.cuh"
#include "sm90.cuh"

namespace cflearn {
namespace {

constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448;  // the most dynamic shared memory a block can have on sm_90
constexpr int kBarrierBytes = 8 * (1 + 4 * kMaxStages);

// SLABS 64-column boxes cover the head dim. BK: kv rows a block; 128 where
// S (BK / 2 f32 a thread) and P.V's accumulator (32 SLABS) both fit the
// registers beside each other, else 64.
template <int SLABS>
struct Sm90Tile {
  static constexpr int BK = SLABS <= 2 ? 128 : 64;
  static constexpr int NV = 64 * SLABS;  // P.V's N
  static constexpr int KV_BYTES = SLABS * BK * sm90::ROW_BYTES;  // one K (or V) stage
};

// dynamic shared memory of a launch: alignment slack, Q, the K and V rings, barriers
inline size_t sm90_smem(int slabs, int bq, int bk, int stages) {
  return size_t(sm90::SWIZZLE_ATOM) + size_t(slabs) * sm90::ROW_BYTES * (bq + 2 * stages * bk) + kBarrierBytes;
}

struct Sm90Args {
  void* o;
  float* lse;  // (B, H, Lq) contiguous f32, written by the LSE build only
  long long o_sb, o_sh, o_sl;
  int heads, q_len, kv_len, d, causal, stages;
  float scale2;  // the softmax scale times log2(e): exponentials in base 2
};

using sm90::ex2;

// KS: steps of 16 over the head dim in S = Q K^T (the head dim rounded up to
// a planned multiple of 16; TMA's zero fill supplies the columns past d), a
// compile-time count so that the product's loop unrolls.
template <typename T, int KS, int NC, bool LSE>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const Sm90Args a) {
  constexpr int SLABS = (KS + 3) / 4;
  using Tile = Sm90Tile<SLABS>;
  using sm90::ROW_BYTES;
  constexpr int BK = Tile::BK, NV = Tile::NV, BQ = 64 * NC, KV = Tile::KV_BYTES;
  constexpr int Q_BYTES = SLABS * BQ * ROW_BYTES;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on such a boundary
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + sm90::SWIZZLE_ATOM - 1) & ~uintptr_t(sm90::SWIZZLE_ATOM - 1));
  const int S = a.stages;
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + Q_BYTES;
  unsigned char* Vs = Ks + S * KV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + S * KV);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kMaxStages;
  uint64_t* v_full = k_empty + kMaxStages;
  uint64_t* v_empty = v_full + kMaxStages;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  int n_kb = (a.kv_len + BK - 1) / BK;
  if (a.causal) n_kb = min(n_kb, (q0 + BQ - 1) / BK + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&k_empty[s], 4 * NC);  // one arrival per consumer warp
      sm90::mbar_init(&v_empty[s], 4 * NC);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (NC == 2) sm90::regs_dec<40>();
    if constexpr (NC == 3) sm90::regs_dec<24>();  // 24 + 3 x 160 registers a thread of each warpgroup
    if (threadIdx.x == 0) {
      sm90::prefetch_map(&qmap);
      sm90::prefetch_map(&kmap);
      sm90::prefetch_map(&vmap);
      sm90::mbar_expect_tx(q_full, Q_BYTES);
      for (int s = 0; s < SLABS; ++s)
        sm90::tma_load_4d(Qs + s * BQ * ROW_BYTES, &qmap, q_full, s * sm90::BOX_C, q0, h, b);
      int st = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_kb; ++j) {
        sm90::mbar_wait(&k_empty[st], phase ^ 1);
        sm90::mbar_expect_tx(&k_full[st], KV);
        for (int s = 0; s < SLABS; ++s)
          sm90::tma_load_4d(Ks + st * KV + s * BK * ROW_BYTES, &kmap, &k_full[st], s * sm90::BOX_C, j * BK, h, b);
        sm90::mbar_wait(&v_empty[st], phase ^ 1);
        sm90::mbar_expect_tx(&v_full[st], KV);
        for (int s = 0; s < SLABS; ++s)
          sm90::tma_load_4d(Vs + st * KV + s * BK * ROW_BYTES, &vmap, &v_full[st], s * sm90::BOX_C, j * BK, h, b);
        if (++st == S) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    if constexpr (NC == 2) sm90::regs_inc<232>();
    if constexpr (NC == 3) sm90::regs_inc<160>();
    const int cw = wg - 1, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, c = lane % 4;
    const int row_lo = q0 + cw * 64;  // this warpgroup's first q row
    const int row_a = row_lo + warp * 16 + g, row_b = row_a + 8;
    const unsigned char* Qw = Qs + cw * 64 * ROW_BYTES;

    float acc[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;
    float s[BK / 2];     // S of the current block, then its exponentials
    uint32_t p[BK / 4];  // P in the value dtype: the A fragments of P.V
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

    // descriptors of stage 0; a stage, a box or a step of K is a constant
    // number of 16-byte units further (the start address field holds any
    // shared-memory address: no carry leaves it)
    const uint64_t q_desc = sm90::desc_k_major(Qw), k_desc = sm90::desc_k_major(Ks);
    const uint64_t v_desc = sm90::desc_mn_major(Vs, BK * ROW_BYTES);
    // S = Q K^T over stage `st`: KS steps of 16, four to a 64-column box, +32 bytes a step inside a box
    auto issue_s = [&](int st) {
      const uint64_t kd = k_desc + uint64_t(st) * (KV >> 4);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint64_t da = q_desc + ((kk >> 2) * BQ * ROW_BYTES >> 4) + (kk & 3) * 2;
        const uint64_t db = kd + ((kk >> 2) * BK * ROW_BYTES >> 4) + (kk & 3) * 2;
        sm90::wgmma<T, BK, 0, 0>(s, da, db, kk > 0);
      }
      sm90::wgmma_commit();
    };
    // acc += P V over stage `st`: V MN-major, the next 64 columns one box on, 16 kv rows = 2048 bytes a step
    auto issue_pv = [&](int st) {
      const uint64_t vd = v_desc + uint64_t(st) * (KV >> 4);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) sm90::wgmma_rs<T, NV, 1>(acc, p + 4 * kk, vd + kk * (16 * ROW_BYTES >> 4));
      sm90::wgmma_commit();
    };
    auto fence_all = [&]() {
      sm90::fence_regs<BK / 2>(s);
      sm90::fence_regs<BK / 4>(p);
      sm90::fence_regs<NV / 2>(acc);
    };
    // the ping-pong: warpgroup w waits at barrier 1 + w for its turn at the
    // tensor cores and hands the turn on to the next warpgroup's barrier
    constexpr bool kTurns = NC > 1;
    auto turn_begin = [&]() {
      if constexpr (kTurns) sm90::bar_sync(1 + cw, 256);
    };
    auto turn_end = [&](bool last) {
      // the last warpgroup began with a turn given ahead (below): it gives none after its last
      if constexpr (kTurns) {
        sm90::bar_arrive(1 + (cw + 1) % NC, 256, !(last && cw == NC - 1));
      }
    };
    // one arrival a warp, predicated: a branch around it would put a divergent
    // path between wgmma instructions, and ptxas then serialises them
    auto release = [&](uint64_t* bar) { sm90::mbar_arrive(bar, lane == 0); };
    // mask block j of S (raw scores), then the online softmax in base 2 with
    // scale2 = scale * log2(e) > 0: m_new = max(m, scale2 * rowmax(s)),
    // s = exp2(scale2 * s - m_new) in one FFMA, l = alpha l + rowsum(s) with
    // alpha = exp2(m - m_new). Row maxima are reduced over the quad of
    // threads that holds a row, each thread's in four independent chains;
    // row sums stay per-thread partial sums until the epilogue.
    auto softmax = [&](int j, float& al_a, float& al_b) {
      const bool edge = (j + 1) * BK > a.kv_len || (a.causal && (j + 1) * BK - 1 > row_lo);
      if (edge) {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * BK + 8 * i + 2 * c + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            const bool ok = col < a.kv_len && (!a.causal || col <= row);
            if (!ok) s[4 * i + e] = kNegInf;
          }
        }
      }
      float xa[4] = {kNegInf, kNegInf, kNegInf, kNegInf}, xb[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        xa[i & 3] = fmaxf(xa[i & 3], fmaxf(s[4 * i], s[4 * i + 1]));
        xb[i & 3] = fmaxf(xb[i & 3], fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
      float mx_a = fmaxf(fmaxf(xa[0], xa[1]), fmaxf(xa[2], xa[3]));
      float mx_b = fmaxf(fmaxf(xb[0], xb[1]), fmaxf(xb[2], xb[3]));
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      mx_a = fmaxf(m_a, mx_a * a.scale2);
      mx_b = fmaxf(m_b, mx_b * a.scale2);
      al_a = ex2(m_a - mx_a);
      al_b = ex2(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      float ra[4] = {0.f, 0.f, 0.f, 0.f}, rb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        s[4 * i] = ex2(fmaf(s[4 * i], a.scale2, -m_a));
        s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], a.scale2, -m_a));
        s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], a.scale2, -m_b));
        s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], a.scale2, -m_b));
        ra[i & 3] += s[4 * i] + s[4 * i + 1];
        rb[i & 3] += s[4 * i + 2] + s[4 * i + 3];
      }
      l_a = l_a * al_a + ((ra[0] + ra[1]) + (ra[2] + ra[3]));
      l_b = l_b * al_b + ((rb[0] + rb[1]) + (rb[2] + rb[3]));
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) p[i] = Mma<T>::pack(s[2 * i], s[2 * i + 1]);
    };

    sm90::mbar_wait(q_full, 0);
    if constexpr (kTurns) {
      if (cw == NC - 1) sm90::bar_arrive(1, 256);  // warpgroup 0 takes the first turn
    }
    // block 0: S alone
    sm90::mbar_wait(&k_full[0], 0);
    turn_begin();
    sm90::wgmma_fence();
    fence_all();
    issue_s(0);
    fence_all();
    turn_end(n_kb == 1);
    sm90::wgmma_wait<0>();
    fence_all();
    release(&k_empty[0]);
    float al_a, al_b;
    softmax(0, al_a, al_b);
    pack_p();
    // block j: S_j with P_{j-1} V_{j-1}; the exponentials of S_j while P V runs
    // ring positions: block j's stage `st` in round parity `ph`, block j - 1's in `pst`, `pph`
    int st = 0, pst = 0;
    uint32_t ph = 0, pph = 0;
    for (int j = 1; j < n_kb; ++j) {
      pst = st;
      pph = ph;
      if (++st == S) {
        st = 0;
        ph ^= 1;
      }
      sm90::mbar_wait(&k_full[st], ph);
      sm90::mbar_wait(&v_full[pst], pph);
      turn_begin();
      sm90::wgmma_fence();  // p and acc were written by this thread since the last wgmma
      fence_all();
      issue_s(st);
      issue_pv(pst);
      fence_all();
      turn_end(j == n_kb - 1);
      sm90::wgmma_wait<1>();  // S_j is done; P V may still run
      sm90::fence_regs<BK / 2>(s);
      release(&k_empty[st]);
      softmax(j, al_a, al_b);
      sm90::wgmma_wait<0>();  // P V is done: acc may be rescaled, p rewritten
      fence_all();
      release(&v_empty[pst]);
#pragma unroll
      for (int i = 0; i < NV / 8; ++i) {
        acc[4 * i] *= al_a;
        acc[4 * i + 1] *= al_a;
        acc[4 * i + 2] *= al_b;
        acc[4 * i + 3] *= al_b;
      }
      pack_p();
    }
    const int last = st;
    sm90::mbar_wait(&v_full[last], ph);
    sm90::wgmma_fence();
    fence_all();
    issue_pv(last);
    fence_all();
    sm90::wgmma_wait<0>();
    fence_all();

    // o = acc / max(l, 1e-30), one cast; rows >= q_len and columns >= d are not stored
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
    T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int i = 0; i < NV / 8; ++i) {
      const int col = 8 * i + 2 * c;
      if (col >= a.d) continue;
      if (row_a < a.q_len)
        *reinterpret_cast<uint32_t*>(o + row_a * a.o_sl + col) = Mma<T>::pack(acc[4 * i] * inv_a, acc[4 * i + 1] * inv_a);
      if (row_b < a.q_len)
        *reinterpret_cast<uint32_t*>(o + row_b * a.o_sl + col) =
            Mma<T>::pack(acc[4 * i + 2] * inv_b, acc[4 * i + 3] * inv_b);
    }
    // logsumexp per q row; m is kept in the base-2 domain, so it is scaled back by ln 2
    if constexpr (LSE) {
      if (c == 0) {
        float* lse = a.lse + (size_t(b) * a.heads + h) * a.q_len;
        if (row_a < a.q_len) lse[row_a] = m_a * kLn2 + logf(fmaxf(l_a, 1e-30f));
        if (row_b < a.q_len) lse[row_b] = m_b * kLn2 + logf(fmaxf(l_b, 1e-30f));
      }
    }
  }
}

using sm90::encode_bhld;

template <typename T, int KS, int NC, bool LSE>
cudaError_t launch_sm90(const FlashArgs& fa, int batch, int bq, int bk, int stages, cudaStream_t stream) {
  constexpr int SLABS = (KS + 3) / 4;
  if (bq != 64 * NC || bk != Sm90Tile<SLABS>::BK || stages < 2 || stages > kMaxStages || 16 * KS < fa.d)
    return cudaErrorInvalidValue;
  const size_t smem = sm90_smem(SLABS, bq, bk, stages);
  if (smem > size_t(kSmemMax)) return cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = encode_bhld<T>(&qmap, fa.q, batch, fa.heads, fa.q_len, fa.d, fa.q_sb, fa.q_sh, fa.q_sl, bq);
  if (err == cudaSuccess)
    err = encode_bhld<T>(&kmap, fa.k, batch, fa.heads, fa.kv_len, fa.d, fa.k_sb, fa.k_sh, fa.k_sl, bk);
  if (err == cudaSuccess)
    err = encode_bhld<T>(&vmap, fa.v, batch, fa.heads, fa.kv_len, fa.d, fa.v_sb, fa.v_sh, fa.v_sl, bk);
  if (err != cudaSuccess) return err;
  err = sm90::set_smem<flash_fwd_sm90_kernel<T, KS, NC, LSE>>(kSmemMax);
  if (err != cudaSuccess) return err;
  const Sm90Args args{fa.o,     fa.lse,    fa.o_sb,   fa.o_sh, fa.o_sl, fa.heads,
                      fa.q_len, fa.kv_len, fa.d,      fa.causal, stages, fa.scale * kLog2e};
  const dim3 grid((fa.q_len + bq - 1) / bq, fa.heads, batch);
  return launch_kernel(flash_fwd_sm90_kernel<T, KS, NC, LSE>, grid, 128 * (NC + 1), smem, stream, qmap, kmap, vmap,
                       args);
}

// the instantiated (K steps, consumer warpgroups): K steps 2..6, 8, 10, 12 with one or two consumers (64
// or 128 q rows), 16 with one, and 2..4 (one 64-column box) with three (192 q rows); `flash_plan` rounds
// ceil(d / 16) up to one of these
template <typename T, bool LSE>
cudaError_t dispatch_sm90(const FlashArgs& a, int batch, int ks, int bq, int bk, int stages, cudaStream_t s) {
#define CFLEARN_SM90_CASE(KS, NC) \
  if (ks == KS && bq == 64 * NC) return launch_sm90<T, KS, NC, LSE>(a, batch, bq, bk, stages, s);
#define CFLEARN_SM90_CASES(KS) CFLEARN_SM90_CASE(KS, 1) CFLEARN_SM90_CASE(KS, 2)
  CFLEARN_SM90_CASES(2)
  CFLEARN_SM90_CASES(3)
  CFLEARN_SM90_CASES(4)
  CFLEARN_SM90_CASES(5)
  CFLEARN_SM90_CASES(6)
  CFLEARN_SM90_CASES(8)
  CFLEARN_SM90_CASES(10)
  CFLEARN_SM90_CASES(12)
  CFLEARN_SM90_CASE(16, 1)
  CFLEARN_SM90_CASE(2, 3)
  CFLEARN_SM90_CASE(3, 3)
  CFLEARN_SM90_CASE(4, 3)
#undef CFLEARN_SM90_CASES
#undef CFLEARN_SM90_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cflearn

#include "flash_fwd_sm90_wide.cuh"

// dtype: 0 = bf16, 1 = fp16, 2 = f32. Strides are in elements. `lse` is read
// by the LSE build only. kernel: 0 = the mma.sync kernels of `flash_fwd.cuh`
// (which of them by d and dtype), 1 = the wgmma + TMA kernel above (bf16 /
// fp16, 8 | d <= 256, strides multiples of 8 elements), 2 = the wide-head
// wgmma + TMA kernel of `flash_fwd_sm90_wide.cuh` (bf16 / fp16, 8 | d, 256 <
// d <= 512, the same strides). bq, bk: q rows a CTA and kv rows a block,
// which must be those of the kernel the entry launches; stages: the wgmma
// kernels' K / V ring; ksteps: their steps of 16 over the head dim; splits:
// the wide kernel's parts of the kv blocks, combined by a second launch from
// the f32 workspace `work` of splits x B x H x Lq x (head_pad + 2) values
// (unused where splits = 1). Returns a cudaError_t.
extern "C" int CFLEARN_FLASH_ENTRY(int dtype, const void* q, const void* k, const void* v, void* o,
                                   void* lse, long long q_sb, long long q_sh, long long q_sl,
                                   long long k_sb, long long k_sh, long long k_sl, long long v_sb,
                                   long long v_sh, long long v_sl, long long o_sb, long long o_sh,
                                   long long o_sl, int batch, int heads, int q_len, int kv_len,
                                   int d, int causal, float scale, int kernel, int bq, int bk, int stages,
                                   int ksteps, int splits, void* work, void* stream) {
  const cflearn::DeviceOf device(q);  // the device of `q`, its context bound to this thread
  if (device.error() != cudaSuccess) return device.error();
  cflearn::FlashArgs a{q,    k,    v,    o,    static_cast<float*>(lse),
                       q_sb, q_sh, q_sl, k_sb, k_sh,
                       k_sl, v_sb, v_sh, v_sl, o_sb,
                       o_sh, o_sl, heads, q_len, kv_len,
                       d,    causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool kLse = CFLEARN_FLASH_LSE != 0;
  if (d <= 0 || d % 8 != 0 || d > 1024 || q_len <= 0 || kv_len <= 0 || batch <= 0 || heads <= 0)
    return cudaErrorInvalidValue;
  if (kLse && lse == nullptr) return cudaErrorInvalidValue;
  if (kernel == 1 || kernel == 2) {
    using cflearn::sm90::aligned16;
    const long long strides[9] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl};
    for (long long st : strides)
      if (st <= 0 || st % 8 != 0) return cudaErrorInvalidValue;
    // the softmax takes the row max of the raw scores: it needs a positive scale
    if (!(scale > 0.f) || !aligned16(q) || !aligned16(k) || !aligned16(v)) return cudaErrorInvalidValue;
    if (kernel == 1) {
      if (d > 256) return cudaErrorInvalidValue;
      if (dtype == 0) return cflearn::dispatch_sm90<__nv_bfloat16, kLse>(a, batch, ksteps, bq, bk, stages, s);
      if (dtype == 1) return cflearn::dispatch_sm90<__half, kLse>(a, batch, ksteps, bq, bk, stages, s);
      return cudaErrorInvalidValue;
    }
    // the combining launch stores 8 values (16 bytes) at a time
    if (d <= 256 || d > 512 ||
        (splits > 1 && (!aligned16(o) || o_sb % 8 != 0 || o_sh % 8 != 0 || o_sl % 8 != 0 || !aligned16(work))))
      return cudaErrorInvalidValue;
    float* ws = static_cast<float*>(work);
    if (dtype == 0) return cflearn::dispatch_wide<__nv_bfloat16, kLse>(a, batch, ksteps, bq, bk, stages, splits, ws, s);
    if (dtype == 1) return cflearn::dispatch_wide<__half, kLse>(a, batch, ksteps, bq, bk, stages, splits, ws, s);
    return cudaErrorInvalidValue;
  }
  if (kernel != 0) return cudaErrorInvalidValue;
  if (dtype == 0) return cflearn::dispatch<__nv_bfloat16, kLse>(a, batch, bq, bk, s);
  if (dtype == 1) return cflearn::dispatch<__half, kLse>(a, batch, bq, bk, s);
  if (dtype == 2) return cflearn::dispatch<float, kLse>(a, batch, bq, bk, s);
  return cudaErrorInvalidValue;
}
