// Flash-attention forward for wide heads, 256 < d <= 512 (bf16 / fp16), on
// Hopper's warpgroup MMA fed by TMA (sm_90a): the autoencoders' mid-block
// attention, one head of 512 channels (the SD VAE's decode, the ldm path's
// frozen encoder, the ae / ae_vq steps' forward with the logsumexp, the f4
// VQ decoder). Included by `flash_fwd_sm90.cuh` after its own kernel, whose
// shared-memory limit, helpers and C entry point it shares; the planner
// (`ops/attention.py::flash_plan`) names it `sm90_wide`.
//
// Replaces: cflearn_tpu/ops/attention.py `_flash_kernel` (launched by
// `flash_attention`) and `_flash_fwd_kernel` (launched by
// `_flash_fwd_with_lse`) at d_pad = 512, where the TPU kernels take 256-row
// q blocks; it takes over from the mma.sync kernel of `flash_fwd.cuh` at
// d = 512 (16 q rows a CTA, one cp.async K / V buffer), which stays
// reachable by name (`kernel="mma_sync"`) as the yardstick. The same
// function as the other forward kernels: f32 scores, masked positions at
// -1e30, running m, l and accumulator in f32, P cast to the value dtype
// before P.V, o = acc / max(l, 1e-30) with one cast, lse = m + log(max(l,
// 1e-30)).
//
// What binds it on the H100. A 64-row O accumulator at d = 512 is 256 f32 a
// thread of one warpgroup, more than the 255 registers a thread can have;
// a 64 x 512 Q tile is 64 KB and a K or V block of 64 rows another 64 KB
// each of the 227 KB of shared memory; and 64 q rows make 64 operations per
// byte of K and V that a CTA reads, about half of what the tensor cores
// need at their rate from the L2 cache, so the L2 -> SM traffic, not the
// products nor device memory, is what should hold it below its bound (every
// CTA of a head streams all of that head's K and V). The design:
//   * two consumer warpgroups share the same 64 q rows and split the head
//     dim in halves: consumer c owns the 64-column boxes [c HALF, (c + 1)
//     HALF) of Q, K, V and O. Each runs its half of S = Q K^T (wgmma, both
//     operands in shared memory, K-major), the two partial S tiles (64 x BK
//     f32) are summed through shared memory behind named barriers (each
//     consumer adds the other's partial to its own: a + b == b + a in IEEE
//     arithmetic, so both hold the same bits, run the same softmax and keep
//     the same m and l), and each runs P.V on its half of V (wgmma N = 256
//     at d = 512, A = P from registers, V MN-major): 128 accumulator
//     registers a thread. The producer warpgroup gives its registers away
//     (setmaxnreg 24 against the consumers' 240: 2 x 128 x 240 + 128 x 24 =
//     64,512 of the 65,536);
//   * K and V have their own full and empty barriers, so K_{j+1} loads as
//     soon as S_j is done while P_j V_j still reads V_j. Blocks of 64 kv rows
//     leave room for one K and one V buffer (Q 64 KB + K 64 KB + V 64 KB +
//     the two partial S tiles 32 KB); S_{j+1} is issued behind P_j V_j, and
//     V_j goes back to the producer as soon as that product is done. (Blocks
//     of 32 rows in a ring of two ran slower on the H100 at every d = 512
//     shape);
//   * where the grid's 64-row tiles fill less than one wave of SMs (one head
//     of 4096 rows: 64 tiles on 132 SMs, the VAE decode on the serving
//     path), the planner splits the kv blocks into `splits` parts: each CTA
//     writes its unnormalised accumulator, m and l (f32) to a workspace, and
//     a second launch of this source combines the parts in a fixed order
//     (the same bits on every run) into o and lse.
// The lessons of `flash_fwd_sm90.cuh` hold here: no integer division in the
// block loop, no branch around a barrier arrival (predicated arrivals), no
// wgmma in a loop that does not unroll, and the max of the raw scores, then
// one FFMA into exp2.

#pragma once

namespace cflearn {
namespace {

// KH: steps of 16 over the head dim in each consumer's half of S = Q K^T (12: d <= 384, 16: d <= 512)
template <int KH>
struct WideTile {
  static constexpr int HALF = KH / 4;  // 64-column boxes in a consumer's half of the head dim
  static constexpr int SLABS = 2 * HALF;
  static constexpr int NV = 64 * HALF;  // a consumer's columns of O: P.V's N
  static constexpr int BQ = 64;
  // kv rows a block. BK == BQ also keeps every row of a split's part from being masked throughout: a part's
  // first block starts at or before each row of the tile (causal parts end at the diagonal block), so each row
  // sees a key; a row that saw none would take its exponentials against m = round(-1e30 scale2), where the
  // FFMA leaves that product's rounding error (~1e21) and exp2 overflows
  static constexpr int BK = BQ;
  static constexpr int Q_BYTES = SLABS * BQ * sm90::ROW_BYTES;
  static constexpr int KV_BYTES = SLABS * BK * sm90::ROW_BYTES;  // one K (or V) block
  static constexpr int X_FLOATS = BQ * BK;  // one consumer's partial S
  static_assert(KH % 4 == 0, "wide tile: each half is whole 64-column boxes");
};

// dynamic shared memory of a launch: alignment slack, Q, K, V, the two partial S tiles, five barriers
inline size_t wide_smem(int slabs) {
  return size_t(sm90::SWIZZLE_ATOM) + size_t(slabs) * sm90::ROW_BYTES * 64 * 3 + size_t(2 * 64 * 64) * sizeof(float) +
         5 * sizeof(uint64_t);
}

struct WideArgs {
  void* o;
  float* lse;   // (B, H, Lq) contiguous f32, written by the LSE build only
  float* part;  // splits > 1: (splits, B, H, Lq, head_pad) f32 unnormalised accumulators
  float* ml;    // splits > 1: (splits, B, H, Lq, 2) f32 m (base 2) and l
  long long o_sb, o_sh, o_sl;
  int heads, q_len, kv_len, d, causal, splits, head_pad;
  float scale2;  // the softmax scale times log2(e): exponentials in base 2
};

// named barriers of the consumer pair (0 is __syncthreads): both partials written; consumer c's partial read
constexpr int kWideFull = 1, kWideFree = 2;

template <typename T, int KH, bool LSE>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const WideArgs a) {
  using Tile = WideTile<KH>;
  using sm90::ROW_BYTES;
  constexpr int HALF = Tile::HALF, SLABS = Tile::SLABS, NV = Tile::NV, BQ = Tile::BQ, BK = Tile::BK;
  constexpr int KV = Tile::KV_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + sm90::SWIZZLE_ATOM - 1) & ~uintptr_t(sm90::SWIZZLE_ATOM - 1));
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + Tile::Q_BYTES;
  unsigned char* Vs = Ks + KV;
  float* Xs = reinterpret_cast<float*>(Vs + KV);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Xs + 2 * Tile::X_FLOATS);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = q_full + 2;
  uint64_t* v_full = q_full + 3;
  uint64_t* v_empty = q_full + 4;

  // blockIdx.z = batch x splits: this CTA's kv blocks are part `sp` of the tile's blocks
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z / a.splits, sp = blockIdx.z - b * a.splits;
  int n_kb = (a.kv_len + BK - 1) / BK;
  if (a.causal) n_kb = min(n_kb, (q0 + BQ - 1) / BK + 1);
  const int per = (n_kb + a.splits - 1) / a.splits;
  const int kb0 = sp * per, kb1 = min(n_kb, kb0 + per);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(k_full, 1);
    sm90::mbar_init(v_full, 1);
    sm90::mbar_init(k_empty, 8);  // one arrival per consumer warp
    sm90::mbar_init(v_empty, 8);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::regs_dec<24>();
    if (threadIdx.x == 0) {
      sm90::prefetch_map(&qmap);
      sm90::prefetch_map(&kmap);
      sm90::prefetch_map(&vmap);
      sm90::mbar_expect_tx(q_full, Tile::Q_BYTES);
      for (int s = 0; s < SLABS; ++s)
        sm90::tma_load_4d(Qs + s * BQ * ROW_BYTES, &qmap, q_full, s * sm90::BOX_C, q0, h, b);
      // block j's K and V go into the one buffer each once the consumers have released block j - 1's
      uint32_t phase = 0;
      for (int j = kb0; j < kb1; ++j, phase ^= 1) {
        sm90::mbar_wait(k_empty, phase ^ 1);
        sm90::mbar_expect_tx(k_full, KV);
        for (int s = 0; s < SLABS; ++s)
          sm90::tma_load_4d(Ks + s * BK * ROW_BYTES, &kmap, k_full, s * sm90::BOX_C, j * BK, h, b);
        sm90::mbar_wait(v_empty, phase ^ 1);
        sm90::mbar_expect_tx(v_full, KV);
        for (int s = 0; s < SLABS; ++s)
          sm90::tma_load_4d(Vs + s * BK * ROW_BYTES, &vmap, v_full, s * sm90::BOX_C, j * BK, h, b);
      }
    }
  } else {
    sm90::regs_inc<240>();
    const int cw = wg - 1, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, c = lane % 4;
    const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;

    float acc[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;
    float s[BK / 2];     // this consumer's partial S of the current block, then the whole S, then its exponentials
    uint32_t p[BK / 4];  // P in the value dtype: the A fragments of P.V
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

    // this consumer's half of the head dim: boxes [cw HALF, (cw + 1) HALF) of Q, of each K stage and of each V
    // stage; a stage, a box or a step of K is a constant number of 16-byte units further
    const uint64_t q_desc = sm90::desc_k_major(Qs + cw * HALF * BQ * ROW_BYTES);
    const uint64_t k_desc = sm90::desc_k_major(Ks + cw * HALF * BK * ROW_BYTES);
    const uint64_t v_desc = sm90::desc_mn_major(Vs + cw * HALF * BK * ROW_BYTES, BK * ROW_BYTES);
    // the partial S tiles, in the accumulator's own register order: float4 i of thread t at 128 i + t
    float4* x_mine = reinterpret_cast<float4*>(Xs) + cw * (Tile::X_FLOATS / 4);
    const float4* x_other = reinterpret_cast<const float4*>(Xs) + (1 - cw) * (Tile::X_FLOATS / 4);

    // this consumer's half of S = Q K^T: KH steps of 16, four to a 64-column box
    auto issue_s = [&]() {
#pragma unroll
      for (int kk = 0; kk < KH; ++kk) {
        const uint64_t da = q_desc + ((kk >> 2) * BQ * ROW_BYTES >> 4) + (kk & 3) * 2;
        const uint64_t db = k_desc + ((kk >> 2) * BK * ROW_BYTES >> 4) + (kk & 3) * 2;
        sm90::wgmma<T, BK, 0, 0>(s, da, db, kk > 0);
      }
      sm90::wgmma_commit();
    };
    // acc += P V over this consumer's NV columns: the next 64 one box on, 16 kv rows = 2048 bytes a step
    auto issue_pv = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) sm90::wgmma_rs<T, NV, 1>(acc, p + 4 * kk, v_desc + kk * (16 * ROW_BYTES >> 4));
      sm90::wgmma_commit();
    };
    auto fence_all = [&]() {
      sm90::fence_regs<BK / 2>(s);
      sm90::fence_regs<BK / 4>(p);
      sm90::fence_regs<NV / 2>(acc);
    };
    // one arrival a warp, predicated: a branch around it would put a divergent path between wgmma instructions
    auto release = [&](uint64_t* bar, bool pred) { sm90::mbar_arrive(bar, pred && lane == 0); };
    // S = S_0 + S_1. Barrier kWideFree + c: consumer c may overwrite its partial (the other consumer has read
    // it; given once ahead for the first block); kWideFull: both partials are written. After its last block a
    // consumer gives no kWideFree arrival, so no barrier is left half-arrived when the CTA exits.
    auto exchange = [&](bool more) {
      sm90::bar_sync(kWideFree + cw, 256);
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) x_mine[128 * i + t] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      sm90::bar_sync(kWideFull, 256);
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const float4 o = x_other[128 * i + t];
        s[4 * i] += o.x;
        s[4 * i + 1] += o.y;
        s[4 * i + 2] += o.z;
        s[4 * i + 3] += o.w;
      }
      sm90::bar_arrive(kWideFree + 1 - cw, 256, more);
    };
    // the online softmax of `flash_fwd_sm90.cuh` over block j: mask the raw scores, m_new = max(m, scale2
    // rowmax(s)), s = exp2(scale2 s - m_new) in one FFMA, l = alpha l + rowsum(s), alpha = exp2(m - m_new)
    auto softmax = [&](int j, float& al_a, float& al_b) {
      const bool edge = (j + 1) * BK > a.kv_len || (a.causal && (j + 1) * BK - 1 > q0);
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

    sm90::bar_arrive(kWideFree + 1 - cw, 256, kb0 < kb1);  // the other consumer may write its first partial
    sm90::mbar_wait(q_full, 0);
    // block j's K and V buffers hold their data in phase parity `ph`
    uint32_t ph = 0;
    for (int j = kb0; j < kb1; ++j, ph ^= 1) {
      sm90::mbar_wait(k_full, ph);
      sm90::wgmma_fence();  // p and acc were written by this thread since the last wgmma
      fence_all();
      issue_s();
      fence_all();
      sm90::wgmma_wait<1>();  // P_{j-1} V_{j-1} is done: the V buffer goes back to the producer
      fence_all();
      release(v_empty, j > kb0);
      sm90::wgmma_wait<0>();  // this consumer's half of S_j is done
      fence_all();
      release(k_empty, true);
      exchange(j + 1 < kb1);
      float al_a, al_b;
      softmax(j, al_a, al_b);
#pragma unroll
      for (int i = 0; i < NV / 8; ++i) {
        acc[4 * i] *= al_a;
        acc[4 * i + 1] *= al_a;
        acc[4 * i + 2] *= al_b;
        acc[4 * i + 3] *= al_b;
      }
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) p[i] = Mma<T>::pack(s[2 * i], s[2 * i + 1]);
      sm90::mbar_wait(v_full, ph);
      sm90::wgmma_fence();
      fence_all();
      issue_pv();
      fence_all();
    }
    sm90::wgmma_wait<0>();
    fence_all();

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    if (a.splits > 1) {
      // this part's unnormalised accumulator, its m (base 2) and l, for the combining launch
      const int batch = gridDim.z / a.splits;
      const size_t rows = (size_t(sp) * batch + b) * a.heads + h;
      float* part = a.part + rows * a.q_len * a.head_pad;
#pragma unroll
      for (int i = 0; i < NV / 8; ++i) {
        const int col = cw * NV + 8 * i + 2 * c;
        if (row_a < a.q_len)
          *reinterpret_cast<float2*>(part + size_t(row_a) * a.head_pad + col) = make_float2(acc[4 * i], acc[4 * i + 1]);
        if (row_b < a.q_len)
          *reinterpret_cast<float2*>(part + size_t(row_b) * a.head_pad + col) =
              make_float2(acc[4 * i + 2], acc[4 * i + 3]);
      }
      if (cw == 0 && c == 0) {
        float* ml = a.ml + rows * a.q_len * 2;
        if (row_a < a.q_len) *reinterpret_cast<float2*>(ml + 2 * row_a) = make_float2(m_a, l_a);
        if (row_b < a.q_len) *reinterpret_cast<float2*>(ml + 2 * row_b) = make_float2(m_b, l_b);
      }
      return;
    }
    // o = acc / max(l, 1e-30), one cast; rows >= q_len and columns >= d are not stored
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
    T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int i = 0; i < NV / 8; ++i) {
      const int col = cw * NV + 8 * i + 2 * c;
      if (col >= a.d) continue;
      if (row_a < a.q_len)
        *reinterpret_cast<uint32_t*>(o + row_a * a.o_sl + col) = Mma<T>::pack(acc[4 * i] * inv_a, acc[4 * i + 1] * inv_a);
      if (row_b < a.q_len)
        *reinterpret_cast<uint32_t*>(o + row_b * a.o_sl + col) =
            Mma<T>::pack(acc[4 * i + 2] * inv_b, acc[4 * i + 3] * inv_b);
    }
    if constexpr (LSE) {
      if (cw == 0 && c == 0) {
        float* lse = a.lse + (size_t(b) * a.heads + h) * a.q_len;
        if (row_a < a.q_len) lse[row_a] = m_a * kLn2 + logf(fmaxf(l_a, 1e-30f));
        if (row_b < a.q_len) lse[row_b] = m_b * kLn2 + logf(fmaxf(l_b, 1e-30f));
      }
    }
  }
}

// The combining launch of a split: 64 threads a q row, 8 columns a thread, 4 rows a block. With M = max_s m_s
// and w_s = exp2(m_s - M): l = sum_s w_s l_s, o = (sum_s w_s acc_s) / max(l, 1e-30) in one cast and lse = M ln 2
// + log(max(l, 1e-30)), the parts summed in order s = 0, 1, ... A part with no kv block (causal) has m = -1e30
// and l = acc = 0: its weight is 0.
template <typename T, bool LSE>
__global__ void __launch_bounds__(256) flash_fwd_wide_combine(const WideArgs a, int batch) {
  const long long rows = (long long)batch * a.heads * a.q_len;
  const long long r = (long long)blockIdx.x * 4 + threadIdx.x / 64;
  const int col = (threadIdx.x % 64) * 8;
  if (r >= rows || col >= a.d) return;
  const int row = int(r % a.q_len), bh = int(r / a.q_len), h = bh % a.heads, b = bh / a.heads;
  float mx = kNegInf;
  for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, a.ml[2 * (s * rows + r)]);
  float l = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < a.splits; ++s) {
    const float w = ex2(a.ml[2 * (s * rows + r)] - mx);
    l += w * a.ml[2 * (s * rows + r) + 1];
    const float4* part = reinterpret_cast<const float4*>(a.part + (s * rows + r) * a.head_pad + col);
    const float4 lo = part[0], hi = part[1];
    acc[0] += w * lo.x;
    acc[1] += w * lo.y;
    acc[2] += w * lo.z;
    acc[3] += w * lo.w;
    acc[4] += w * hi.x;
    acc[5] += w * hi.y;
    acc[6] += w * hi.z;
    acc[7] += w * hi.w;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  uint4 out;
  out.x = Mma<T>::pack(acc[0] * inv, acc[1] * inv);
  out.y = Mma<T>::pack(acc[2] * inv, acc[3] * inv);
  out.z = Mma<T>::pack(acc[4] * inv, acc[5] * inv);
  out.w = Mma<T>::pack(acc[6] * inv, acc[7] * inv);
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh + row * a.o_sl + col;
  *reinterpret_cast<uint4*>(o) = out;
  if constexpr (LSE) {
    if (col == 0) a.lse[r] = mx * kLn2 + logf(fmaxf(l, 1e-30f));
  }
}

template <typename T, int KH, bool LSE>
cudaError_t launch_wide(const FlashArgs& fa, int batch, int splits, float* work, cudaStream_t stream) {
  using Tile = WideTile<KH>;
  if (32 * KH < fa.d || splits < 1 || (splits > 1 && work == nullptr)) return cudaErrorInvalidValue;
  const size_t smem = wide_smem(Tile::SLABS);
  if (smem > size_t(kSmemMax)) return cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = encode_bhld<T>(&qmap, fa.q, batch, fa.heads, fa.q_len, fa.d, fa.q_sb, fa.q_sh, fa.q_sl, Tile::BQ);
  if (err == cudaSuccess)
    err = encode_bhld<T>(&kmap, fa.k, batch, fa.heads, fa.kv_len, fa.d, fa.k_sb, fa.k_sh, fa.k_sl, Tile::BK);
  if (err == cudaSuccess)
    err = encode_bhld<T>(&vmap, fa.v, batch, fa.heads, fa.kv_len, fa.d, fa.v_sb, fa.v_sh, fa.v_sl, Tile::BK);
  if (err != cudaSuccess) return err;
  err = sm90::set_smem<flash_fwd_wide_kernel<T, KH, LSE>>(kSmemMax);
  if (err != cudaSuccess) return err;
  const int head_pad = 64 * Tile::SLABS;
  const size_t rows = size_t(splits) * batch * fa.heads * fa.q_len;
  const WideArgs args{fa.o,     fa.lse,   work,      splits > 1 ? work + rows * head_pad : nullptr,
                      fa.o_sb,  fa.o_sh,  fa.o_sl,   fa.heads,
                      fa.q_len, fa.kv_len, fa.d,     fa.causal,
                      splits,   head_pad,  fa.scale * kLog2e};
  const dim3 grid((fa.q_len + Tile::BQ - 1) / Tile::BQ, fa.heads, batch * splits);
  err = launch_kernel(flash_fwd_wide_kernel<T, KH, LSE>, grid, 384, smem, stream, qmap, kmap, vmap, args);
  if (err != cudaSuccess || splits == 1) return err;
  const long long out_rows = (long long)batch * fa.heads * fa.q_len;
  return launch_kernel(flash_fwd_wide_combine<T, LSE>, unsigned((out_rows + 3) / 4), 256, 0, stream, args, batch);
}

// the instantiated K steps of each half: `flash_plan` takes ksteps = 2 KH, the fewest that cover d
template <typename T, bool LSE>
cudaError_t dispatch_wide(const FlashArgs& a, int batch, int ksteps, int bq, int bk, int stages, int splits,
                          float* work, cudaStream_t s) {
  if (bq != 64 || bk != 64 || stages != 1) return cudaErrorInvalidValue;
  if (ksteps == 24) return launch_wide<T, 12, LSE>(a, batch, splits, work, s);
  if (ksteps == 32) return launch_wide<T, 16, LSE>(a, batch, splits, work, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cflearn
