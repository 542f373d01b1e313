// The dj-folded 3x3 stride-1 SAME convolution over NHWC bf16 / fp16 as an
// implicit GEMM on Hopper's warpgroup MMA (wgmma, f32 accumulation) fed by
// TMA, for sm_90a.
//
// Replaces: cflearn_tpu/ops/conv.py `_conv3x3_kernel_fold` (launched by
// `conv3x3_pallas(fold=True)`), which concatenates the 3 horizontal taps on
// the lanes and runs 3 matmuls 3C deep against w.reshape(3, 3C, Co):
//   y[b,i,j] = sum over di of [x[b,i+di-1,j-1], x[b,i+di-1,j], x[b,i+di-1,j+1]]
//              . w[:, di].reshape(Co, 3C)^T + bias.
//
// GEMM: M = output pixels, N = Co, K = 3 row taps x 3C over (dj, channel). An
// output tile is a box of th x tw = 128 pixels of one image with tw = 128 or
// 64 (the host's planner, `ops/conv.py::conv3x3_fold_plan`), by BN = 128 or
// 256 output channels. What the fold buys on this card is reuse of the loaded
// x rows across the three dj taps: for row tap di and channels [c0, c0 + 64)
// one TMA box of th x (tw + 2) pixels at (c0, j0 - 1, i0 + di - 1, b) holds
// the A operands of all three dj. A consumer warpgroup's 64 tile rows lie in
// one image row of the box (tw >= 64), so its operand for tap dj is 64
// consecutive box rows starting dj rows (dj x 128 bytes) later: the same box,
// a descriptor moved by dj rows. The box starts on a 1024-byte boundary, so
// the 128-byte swizzle that TMA wrote follows the shared-memory address, and
// a descriptor that starts mid-atom reads it as written. TMA's zero fill
// outside the image is the SAME halo, pixel by pixel: column j0 - 1 at the
// left edge and j0 + tw at the right one are zero for the one tap that reads
// them. The B tiles are boxes of the weight seen as (C, 9, Co), one per
// (di, dj, 64 channels), so K past C reads zeros in both operands: each dj
// tap is padded to whole 64-channel slices on its own, and at C % 64 != 0 no
// slice straddles two taps.
//
// The K loop walks (di, 64-channel slice, dj): the three products of one x
// box run back to back, then the box is handed back. Two rings: x boxes
// (3 stages) and weight tiles (10 stages at BN = 128, 5 at 256), since a
// weight tile lives for one dj and an x box for three.
//
// Warp-specialised and persistent, as `conv3x3.cu`: warpgroup 0 gives its
// registers away and one thread of it keeps both rings full; warpgroups 1
// and 2 each run wgmma m64nBNk16 on 64 of the tile's rows with both operands
// read from shared memory, keep one wgmma group (one dj) in flight and hand
// a stage back once the group that read it has completed. Output tiles never
// overlap and every sum is taken in a fixed order: no atomics, the result is
// the same bits on every launch. The epilogue adds the f32 bias to the f32
// sum and rounds once, and stores only the pixels of the box inside the image.
//
// What bounds it on the H100: 2 * 9 * C * Co operations per pixel against
// 2 * (C + Co) bytes, several hundred per byte at the VAE's widths: the
// tensor cores. Per (di, slice) a 128 x BN tile loads one 16.6 KB x box and
// three weight tiles for 3 x 128 x BN x 64 x 2 operations: 97 operations
// per byte from L2 at BN = 128 and 112 at BN = 256, where the 9-tap kernel's
// separate x box per tap gives 64 and 85.
//
// `cflearn_conv3x3_fold_mma_sync` keeps the previous design (the mma.sync
// implicit GEMM of `conv3x3_igemm.cuh` with the folded K layout) as the
// yardstick that `conv3x3_fold_plan(kernel="mma_sync")` names.
//
// Layout: x (B, H, W, C) contiguous, w (Co, 3, 3, C) contiguous, bias (Co,) or
// null, y (B, H, W, Co) contiguous, all 16-byte aligned. C % 8 == 0 and
// Co % 8 == 0 (TMA's 16-byte global strides).

#include "conv3x3_igemm.cuh"
#include "sm90.cuh"

namespace cflearn {
namespace fold {

using namespace sm90;

constexpr int BM = 128;                 // output pixels per tile
constexpr int THREADS = 384;            // warpgroup 0 loads, 1 and 2 multiply
constexpr int A_STRIDE = 17 * 1024;     // an x box of up to 2 x 66 or 1 x 130 pixels, rounded to the swizzle atom
constexpr int A_STAGES = 3;
constexpr int SMEM_BUDGET = 220 * 1024;

template <int BN>
struct Cfg {
  static constexpr int B_BYTES = BN * ROW_BYTES;
  static constexpr int B_STAGES = (SMEM_BUDGET - A_STAGES * A_STRIDE) / B_BYTES;  // 10 at BN = 128, 5 at 256
  static constexpr int BARRIERS = 2 * (A_STAGES + B_STAGES);
  static constexpr int SMEM = A_STAGES * A_STRIDE + B_STAGES * B_BYTES + BARRIERS * 8 + SWIZZLE_ATOM;
};

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_fold_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                        T* __restrict__ y, const T* __restrict__ bias, int B, int H, int W, int C, int Co, int th,
                        int tw) {
  using K = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: boxes start on such a boundary
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SWIZZLE_ATOM - 1) & ~uintptr_t(SWIZZLE_ATOM - 1));
  unsigned char* a_ring = smem;
  unsigned char* b_ring = smem + A_STAGES * A_STRIDE;
  uint64_t* full_a = reinterpret_cast<uint64_t*>(b_ring + K::B_STAGES * K::B_BYTES);
  uint64_t* empty_a = full_a + A_STAGES;
  uint64_t* full_b = empty_a + A_STAGES;
  uint64_t* empty_b = full_b + K::B_STAGES;

  const int rows_t = (H + th - 1) / th, cols_t = (W + tw - 1) / tw;
  const int n_tiles = (Co + BN - 1) / BN;
  const int tiles = B * rows_t * cols_t * n_tiles;
  const int kc = (C + BOX_C - 1) / BOX_C;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < A_STAGES; ++s) {
      mbar_init(&full_a[s], 1);
      mbar_init(&empty_a[s], 8);  // one lane of each consumer warp arrives
    }
    for (int s = 0; s < K::B_STAGES; ++s) {
      mbar_init(&full_b[s], 1);
      mbar_init(&empty_b[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_dec<40>();
    if (threadIdx.x == 0) {
      prefetch_map(&xmap);
      prefetch_map(&wmap);
      const uint32_t a_bytes = uint32_t(th) * (tw + 2) * ROW_BYTES;
      int sa = 0, sb = 0;
      uint32_t pa = 0, pb = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % n_tiles) * BN, m = tile / n_tiles;
        const int j0 = (m % cols_t) * tw, i0 = (m / cols_t % rows_t) * th, b = m / (cols_t * rows_t);
        for (int di = 0; di < 3; ++di) {
          for (int kk = 0; kk < kc; ++kk) {
            mbar_wait(&empty_a[sa], pa ^ 1);
            mbar_expect_tx(&full_a[sa], a_bytes);
            tma_load_4d(a_ring + sa * A_STRIDE, &xmap, &full_a[sa], kk * BOX_C, j0 - 1, i0 + di - 1, b);
            if (++sa == A_STAGES) {
              sa = 0;
              pa ^= 1;
            }
            for (int dj = 0; dj < 3; ++dj) {
              mbar_wait(&empty_b[sb], pb ^ 1);
              mbar_expect_tx(&full_b[sb], K::B_BYTES);
              tma_load_3d(b_ring + sb * K::B_BYTES, &wmap, &full_b[sb], kk * BOX_C, 3 * di + dj, n0);
              if (++sb == K::B_STAGES) {
                sb = 0;
                pb ^= 1;
              }
            }
          }
        }
      }
    }
  } else {
    regs_inc<232>();
    const int g = wg - 1, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = g * 64 + warp * 16 + lane / 4;  // this thread's tile rows r0 and r0 + 8
    // the box row of this warpgroup's first pixel at dj = 0: its 64 pixels lie in one image row of the box
    const int a_row0 = (g * 64 / tw) * (tw + 2) + (g * 64) % tw;
    float acc[BN / 2];
    int sa = 0, sb = 0, prev_a = -1, prev_b = -1;
    uint32_t pa = 0, pb = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % n_tiles) * BN, m = tile / n_tiles;
      const int j0 = (m % cols_t) * tw, i0 = (m / cols_t % rows_t) * th, b = m / (cols_t * rows_t);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int s = 0; s < 3 * kc; ++s) {
        mbar_wait(&full_a[sa], pa);
        const unsigned char* a = a_ring + sa * A_STRIDE + a_row0 * ROW_BYTES;
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          mbar_wait(&full_b[sb], pb);
          // tap dj reads the box dj rows on: the swizzle follows the address, so the base offset stays 0
          const uint64_t da = desc_k_major(a + dj * ROW_BYTES);
          const uint64_t db = desc_k_major(b_ring + sb * K::B_BYTES);
          wgmma_fence();
          fence_regs<BN / 2>(acc);
#pragma unroll
          for (int k = 0; k < BOX_C / 16; ++k) wgmma<T, BN, 0, 0>(acc, da + 2 * k, db + 2 * k);  // +32 bytes of K
          wgmma_commit();
          fence_regs<BN / 2>(acc);
          wgmma_wait<1>();  // the previous group (the previous dj) has read its stages
          if (prev_b >= 0) mbar_arrive(&empty_b[prev_b], lane == 0);
          if (dj == 0 && prev_a >= 0) mbar_arrive(&empty_a[prev_a], lane == 0);
          prev_b = sb;
          if (++sb == K::B_STAGES) {
            sb = 0;
            pb ^= 1;
          }
        }
        prev_a = sa;
        if (++sa == A_STAGES) {
          sa = 0;
          pa ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      if (prev_b >= 0) mbar_arrive(&empty_b[prev_b], lane == 0);
      if (prev_a >= 0) mbar_arrive(&empty_a[prev_a], lane == 0);
      prev_a = prev_b = -1;

      // epilogue: f32 sum + f32 bias, one rounding; pixels outside the image are not written
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + h * 8;
        const int i = i0 + r / tw, j = j0 + r % tw;
        if (i >= H || j >= W) continue;
        T* row = y + ((size_t(b) * H + i) * W + j) * Co;
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) {
          const int col = n0 + q * 8 + (lane % 4) * 2;
          if (col < Co) {
            const float b0 = bias ? Mma<T>::to_float(bias[col]) : 0.f;
            const float b1 = bias ? Mma<T>::to_float(bias[col + 1]) : 0.f;
            *reinterpret_cast<uint32_t*>(row + col) = Mma<T>::pack(acc[q * 4 + h * 2] + b0, acc[q * 4 + h * 2 + 1] + b1);
          }
        }
      }
    }
  }
}

template <typename T, int BN>
cudaError_t run(const void* x, const void* w, const void* bias, void* y, int B, int H, int W, int C, int Co, int th,
                int tw, int ctas, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  // x boxes two pixels wider than the tile: the left and right halo columns of the three taps dj
  cudaError_t err = encode_nhwc<T>(&xmap, x, B, H, W, C, th, tw + 2);
  if (err != cudaSuccess) return err;
  // the weight (Co, 3, 3, C) as (C, 9, Co): box (64 channels, one tap, BN output channels)
  const uint64_t dims[3] = {uint64_t(C), 9, uint64_t(Co)};
  const uint64_t strides[2] = {uint64_t(C) * sizeof(T), uint64_t(C) * 9 * sizeof(T)};
  const uint32_t box[3] = {uint32_t(BOX_C), 1, uint32_t(BN)};
  err = encode_map(&wmap, tma_dtype<T>(), 3, w, dims, strides, box);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_fold_kernel<T, BN>;
  err = set_smem<conv3x3_fold_kernel<T, BN>>(Cfg<BN>::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, THREADS, Cfg<BN>::SMEM, stream>>>(xmap, wmap, static_cast<T*>(y), static_cast<const T*>(bias), B,
                                                   H, W, C, Co, th, tw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* bias, void* y, int B, int H, int W, int C, int Co,
                     int th, int tw, int bn, int ctas, cudaStream_t s) {
  if (bn == 128) return run<T, 128>(x, w, bias, y, B, H, W, C, Co, th, tw, ctas, s);
  if (bn == 256) return run<T, 256>(x, w, bias, y, B, H, W, C, Co, th, tw, ctas, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run_mma_sync(const void* x, const void* w, const void* bias, void* y, int B, int H, int W, int C,
                         int Co, cudaStream_t s) {
  const igemm::EpiBias<T> epi{static_cast<T*>(y), static_cast<const T*>(bias), Co};
  return igemm::launch<T, igemm::Taps::kFold>(static_cast<const T*>(x), static_cast<const T*>(w), epi, B, H, W, C,
                                              Co, s);
}

}  // namespace fold
}  // namespace cflearn

// dtype: 0 = bf16, 1 = fp16. `bias` may be null. (th, tw): the pixel box of
// an output tile, th * tw = 128 with tw = 128 or 64; bn: output channels per
// tile (128 or 256); ctas: the persistent grid. Returns a cudaError_t.
extern "C" int cflearn_conv3x3_fold_fwd(int dtype, const void* x, const void* w, const void* bias, void* y, int B,
                                        int H, int W, int C, int Co, int th, int tw, int bn, int ctas, void* stream) {
  using cflearn::sm90::aligned16;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 8 != 0 || Co % 8 != 0 ||
      th * tw != cflearn::fold::BM || (tw != 128 && tw != 64) || ctas <= 0 || !aligned16(x) || !aligned16(w) ||
      !aligned16(y))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return cflearn::fold::dispatch<__nv_bfloat16>(x, w, bias, y, B, H, W, C, Co, th, tw, bn, ctas, s);
  if (dtype == 1) return cflearn::fold::dispatch<__half>(x, w, bias, y, B, H, W, C, Co, th, tw, bn, ctas, s);
  return cudaErrorInvalidValue;
}

// the previous design, the mma.sync implicit GEMM: the yardstick. Same arguments without the plan.
extern "C" int cflearn_conv3x3_fold_mma_sync(int dtype, const void* x, const void* w, const void* bias, void* y,
                                             int B, int H, int W, int C, int Co, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C % 8 != 0 || Co % 8 != 0 || C <= 0 || Co <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return cflearn::fold::run_mma_sync<__nv_bfloat16>(x, w, bias, y, B, H, W, C, Co, s);
  if (dtype == 1) return cflearn::fold::run_mma_sync<__half>(x, w, bias, y, B, H, W, C, Co, s);
  return cudaErrorInvalidValue;
}
