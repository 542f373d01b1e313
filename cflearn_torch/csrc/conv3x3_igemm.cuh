// The implicit-GEMM body shared by the 3x3 stride-1 SAME conv kernels
// (`conv3x3.cu`, `conv3x3_fold.cu`, `conv3x3_w8a8.cu`), for Hopper (sm_90a).
//
// M = B*H*W output pixels, N = Co, K = the taps' input channels. A CTA owns a
// 128 x 128 output tile; 8 warps each own 64 x 32. The K loop walks 64-byte
// slices of K (32 bf16 / fp16 channels, or 64 int8 ones) through a 3-stage
// cp.async ring. Each A row is one output pixel's input span: the SAME halo is
// a bounds check that zero-fills the copy, so no padded input is staged in
// device memory. Tiles are addressed in bytes, so one body serves 16-bit
// operands (mma.sync m16n8k16, f32 sums) and int8 ones (m16n8k32, int32 sums):
// both take their fragments from the same ldmatrix loads of 16-byte rows.
//
// The K layout is a template argument:
//   Taps::kNine : 9 taps, each C deep (tap-major, then channel);
//   Taps::kFold : 3 row taps, each 3C deep over (dj, channel): for output
//                 pixel (i, j) and row tap di the A row is the contiguous span
//                 x[b, i+di-1, j-1 : j+2, :], zero where it leaves the image,
//                 and the B column is w[co, di, :, :], contiguous in the
//                 (Co, 3, 3, C) layout. One 3C-long read per (pixel, row)
//                 where kNine makes three C-long ones.
// The epilogue is a functor: `col(c)` reads what column pair (c, c+1) needs,
// `store(row, c, state, a0, a1)` writes the pair.
//
// Layout: x (B, H, W, C) contiguous, w (Co, 3, 3, C) contiguous, C a multiple
// of the 16-byte chunk (8 16-bit or 16 int8 values), Co % 8 == 0.
#pragma once

#include "host.cuh"
#include "mma_common.cuh"

namespace cflearn {
namespace igemm {

constexpr int BM = 128, BN = 128, STAGES = 3, THREADS = 256;
constexpr int ROW_BYTES = 64;           // bytes of K per tile row and stage
constexpr int PITCH = ROW_BYTES + 16;   // padded row pitch in bytes
constexpr size_t SMEM = size_t(STAGES) * (BM + BN) * PITCH;

enum class Taps { kNine, kFold };

// the tensor-core product for operand type In: d(16x8) += a(16 x 32 bytes) * b(32 bytes x 8)
template <typename In>
struct Op {
  using Acc = float;
  static __device__ __forceinline__ void run(float* d, const uint32_t* a, const uint32_t* b) {
    Mma<In>::run(d, a, b);
  }
};

template <>
struct Op<int8_t> {
  using Acc = int;
  static __device__ __forceinline__ void run(int* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <typename In, Taps TAPS, typename Epi>
__global__ void __launch_bounds__(THREADS)
    conv3x3_igemm(const In* __restrict__ x, const In* __restrict__ w, Epi epi, int B, int H, int W,
                  int C, int Co) {
  using Acc = typename Op<In>::Acc;
  constexpr int E = 16 / sizeof(In);           // elements per 16-byte chunk
  constexpr int BK = ROW_BYTES / sizeof(In);   // elements of K per stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* As = smem_raw;                 // [STAGES][BM][PITCH]
  unsigned char* Bs = As + STAGES * BM * PITCH;  // [STAGES][BN][PITCH]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int M = B * H * W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // K slices per tap (kNine: C deep) or per row tap (kFold: 3C deep)
  const int span = TAPS == Taps::kNine ? C : 3 * C;
  const int kc = (span + BK - 1) / BK;
  const int KT = (TAPS == Taps::kNine ? 9 : 3) * kc;

  // each thread copies two 16-byte chunks of the A tile and two of the B
  // tile per stage: rows idx / 4, chunk idx % 4 (4 chunks = 64 bytes)
  int a_b[2], a_y[2], a_x[2], r_row[2], r_chk[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS;
    r_row[i] = idx >> 2;
    r_chk[i] = idx & 3;
    const int m = m0 + r_row[i];
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    a_x[i] = mm % W;
    a_y[i] = (mm / W) % H;
    a_b[i] = mm / (W * H);
  }

  auto load = [&](int stage, int kt) {
    const int tap = kt / kc, k0 = (kt % kc) * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = k0 + r_chk[i] * E;  // position in the tap's (or row's) span
      int dy, dx, c, wk;
      if (TAPS == Taps::kNine) {
        dy = tap / 3 - 1;
        dx = tap % 3 - 1;
        c = k;
        wk = tap * C + k;
      } else {
        const int dj = k / C;  // a chunk never straddles two dj: C % E == 0
        dy = tap - 1;
        dx = dj - 1;
        c = k - dj * C;
        wk = tap * 3 * C + k;
      }
      const int yy = a_y[i] + dy, xx = a_x[i] + dx;
      const bool ok = a_ok[i] && k < span && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const In* src = ok ? x + ((size_t(a_b[i]) * H + yy) * W + xx) * C + c : x;
      cp_async16(As + (stage * BM + r_row[i]) * PITCH + r_chk[i] * 16, src, ok ? 16 : 0);
      const int co = n0 + r_row[i];
      const bool okw = co < Co && k < span;
      const In* wsrc = okw ? w + size_t(co) * 9 * C + wk : w;
      cp_async16(Bs + (stage * BN + r_row[i]) * PITCH + r_chk[i] * 16, wsrc, okw ? 16 : 0);
    }
  };

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt-1 is free for the next copy
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(nk % STAGES, nk);
    cp_async_commit();
    const unsigned char* At = As + (kt % STAGES) * BM * PITCH;
    const unsigned char* Bt = Bs + (kt % STAGES) * BN * PITCH;
#pragma unroll
    for (int kk = 0; kk < ROW_BYTES / 32; ++kk) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], At + (wm * 64 + mt * 16 + (lane & 15)) * PITCH + kk * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(bf[np], Bt + (wn * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * PITCH +
                                kk * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) Op<In>::run(acc[mt][nt], af[mt], &bf[nt >> 1][(nt & 1) * 2]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + cq * 2;
    if (col >= Co) continue;
    const typename Epi::Col st = epi.col(col);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int r = m0 + wm * 64 + mt * 16 + g;
      if (r < M) epi.store(r, col, st, acc[mt][nt][0], acc[mt][nt][1]);
      if (r + 8 < M) epi.store(r + 8, col, st, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// y = T(acc + bias), the bias added in f32 before the one rounding
template <typename T>
struct EpiBias {
  T* y;
  const T* bias;
  int Co;
  struct Col {
    float b0, b1;
  };
  __device__ __forceinline__ Col col(int c) const {
    return bias ? Col{Mma<T>::to_float(bias[c]), Mma<T>::to_float(bias[c + 1])} : Col{0.f, 0.f};
  }
  __device__ __forceinline__ void store(int r, int c, const Col& s, float a0, float a1) const {
    *reinterpret_cast<uint32_t*>(y + size_t(r) * Co + c) = Mma<T>::pack(a0 + s.b0, a1 + s.b1);
  }
};

template <typename In, Taps TAPS, typename Epi>
cudaError_t launch(const In* x, const In* w, const Epi& epi, int B, int H, int W, int C, int Co,
                   cudaStream_t stream) {
  auto kernel = conv3x3_igemm<In, TAPS, Epi>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, (Co + BN - 1) / BN);
  return launch_kernel(kernel, grid, THREADS, SMEM, stream, x, w, epi, B, H, W, C, Co);
}

}  // namespace igemm
}  // namespace cflearn
