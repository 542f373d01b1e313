// 3x3 stride-1 SAME convolution over NHWC bf16 / fp16 as an implicit GEMM on
// Hopper's warpgroup MMA (wgmma, f32 accumulation) fed by TMA, for sm_90a.
//
// Replaces: cflearn_tpu/ops/conv.py `_conv3x3_kernel` (launched by
// `conv3x3_pallas`, fold=False), which computes the conv as 9 shifted
// matmuls over halo'd row tiles of a pre-padded input. The conv's dx runs
// through this kernel too (dy with the flipped weights).
//
// GEMM: M = output pixels, N = Co, K = 9 taps x C (tap-major, then channel).
// An output tile is a spatial box of th x tw = 128 pixels of one image (the
// host's planner, `ops/conv.py::conv3x3_plan`, picks the box per shape) by BN
// = 128 or 256 output channels. For tap (di, dj) and channels [c0, c0 + 64)
// the A tile is one TMA box of x at (c0, j0 + dj - 1, i0 + di - 1, b): TMA's
// zero fill outside the image is the SAME padding, so no thread computes an
// address or checks a bound. The B tile is one box of the weight seen as
// (C, 9, Co), so a K slice past C reads zeros, not the next tap's channels.
//
// Warp-specialised: warpgroup 0 gives its registers away and one thread of it
// keeps the ring of (A, B) stages full; warpgroups 1 and 2 each run wgmma
// m64nBNk16 on 64 of the tile's rows, both operands read from shared memory,
// keep one wgmma group in flight and hand a stage back once the group that
// read it has completed. CTAs are persistent: each walks tiles gridDim.x
// apart, and the producer runs ahead into the next tile while the consumers
// store the last one. Output tiles never overlap and every sum is taken in a
// fixed order: no atomics, the result is the same bits on every launch.
// The epilogue adds the f32 bias to the f32 sum and rounds once, and stores
// only the pixels of the box that lie inside the image.
//
// What bounds it on the H100: 2 * 9 * C * Co operations per pixel against
// 2 * (C + Co) bytes: several hundred per byte at the VAE's widths, so the
// tensor cores. A 128 x BN tile does 64 (BN = 128) or 85 (BN = 256) operations
// per byte it loads from L2; the planner takes BN = 256 where the grid still
// fills the card.
//
// Layout: x (B, H, W, C) contiguous, w (Co, 3, 3, C) contiguous, bias (Co,) or
// null, y (B, H, W, Co) contiguous, all 16-byte aligned. C % 8 == 0 and
// Co % 8 == 0 (TMA's 16-byte global strides).

#include "sm90.cuh"

namespace cflearn {
namespace {

using namespace sm90;

constexpr int BM = 128;       // output pixels per tile
constexpr int THREADS = 384;  // warpgroup 0 loads, 1 and 2 multiply
constexpr int SMEM_BUDGET = 200 * 1024;

template <int BN>
struct Cfg {
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int STAGE = A_BYTES + BN * ROW_BYTES;
  static constexpr int STAGES = SMEM_BUDGET / STAGE;  // 6 at BN = 128, 4 at BN = 256
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + SWIZZLE_ATOM;
};

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_fwd_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                       T* __restrict__ y, const T* __restrict__ bias, int B, int H, int W, int C, int Co,
                       int th, int tw) {
  using K = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on such a boundary
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SWIZZLE_ATOM - 1) & ~uintptr_t(SWIZZLE_ATOM - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + K::STAGES * K::STAGE);
  uint64_t* empty = full + K::STAGES;

  const int rows_t = (H + th - 1) / th, cols_t = (W + tw - 1) / tw;
  const int n_tiles = (Co + BN - 1) / BN;
  const int tiles = B * rows_t * cols_t * n_tiles;
  const int kc = (C + BOX_C - 1) / BOX_C;
  const int ksteps = 9 * kc;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < K::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_dec<40>();
    if (threadIdx.x == 0) {
      prefetch_map(&xmap);
      prefetch_map(&wmap);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % n_tiles) * BN, m = tile / n_tiles;
        const int j0 = (m % cols_t) * tw, i0 = (m / cols_t % rows_t) * th, b = m / (cols_t * rows_t);
        for (int tap = 0; tap < 9; ++tap) {
          for (int kk = 0; kk < kc; ++kk) {
            mbar_wait(&empty[stage], phase ^ 1);
            unsigned char* a = smem + stage * K::STAGE;
            mbar_expect_tx(&full[stage], K::STAGE);
            tma_load_4d(a, &xmap, &full[stage], kk * BOX_C, j0 + tap % 3 - 1, i0 + tap / 3 - 1, b);
            tma_load_3d(a + K::A_BYTES, &wmap, &full[stage], kk * BOX_C, tap, n0);
            if (++stage == K::STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    regs_inc<232>();
    const int g = wg - 1, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = g * 64 + warp * 16 + lane / 4;  // this thread's tile rows r0 and r0 + 8
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % n_tiles) * BN, m = tile / n_tiles;
      const int j0 = (m % cols_t) * tw, i0 = (m / cols_t % rows_t) * th, b = m / (cols_t * rows_t);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(&full[stage], phase);
        const unsigned char* a = smem + stage * K::STAGE;
        const uint64_t da = desc_k_major(a + g * 64 * ROW_BYTES), db = desc_k_major(a + K::A_BYTES);
        wgmma_fence();
        fence_regs<BN / 2>(acc);
#pragma unroll
        for (int k = 0; k < BOX_C / 16; ++k) wgmma<T, BN, 0, 0>(acc, da + 2 * k, db + 2 * k);  // +32 bytes of K
        wgmma_commit();
        fence_regs<BN / 2>(acc);
        wgmma_wait<1>();  // the previous step's group has read its stage
        if (prev >= 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == K::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      if (prev >= 0) mbar_arrive(&empty[prev]);

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
  cudaError_t err = encode_nhwc<T>(&xmap, x, B, H, W, C, th, tw);
  if (err != cudaSuccess) return err;
  // the weight (Co, 3, 3, C) as (C, 9, Co): box (64 channels, one tap, BN output channels)
  const uint64_t dims[3] = {uint64_t(C), 9, uint64_t(Co)};
  const uint64_t strides[2] = {uint64_t(C) * sizeof(T), uint64_t(C) * 9 * sizeof(T)};
  const uint32_t box[3] = {uint32_t(BOX_C), 1, uint32_t(BN)};
  err = encode_map(&wmap, tma_dtype<T>(), 3, w, dims, strides, box);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_fwd_kernel<T, BN>;
  err = set_smem<conv3x3_fwd_kernel<T, BN>>(Cfg<BN>::SMEM);
  if (err != cudaSuccess) return err;
  return launch_kernel(kernel, ctas, THREADS, Cfg<BN>::SMEM, stream, xmap, wmap, static_cast<T*>(y),
                       static_cast<const T*>(bias), B, H, W, C, Co, th, tw);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* bias, void* y, int B, int H, int W, int C, int Co,
                     int th, int tw, int bn, int ctas, cudaStream_t s) {
  if (bn == 128) return run<T, 128>(x, w, bias, y, B, H, W, C, Co, th, tw, ctas, s);
  if (bn == 256) return run<T, 256>(x, w, bias, y, B, H, W, C, Co, th, tw, ctas, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cflearn

// dtype: 0 = bf16, 1 = fp16. `bias` may be null. (th, tw): the pixel box of
// an output tile, th * tw = 128; bn: output channels per tile (128 or 256);
// ctas: the persistent grid. Returns a cudaError_t.
extern "C" int cflearn_conv3x3_fwd(int dtype, const void* x, const void* w, const void* bias, void* y, int B, int H,
                                   int W, int C, int Co, int th, int tw, int bn, int ctas, void* stream) {
  const cflearn::DeviceOf device(x);  // the device of `x`, its context bound to this thread
  if (device.error() != cudaSuccess) return device.error();
  using cflearn::sm90::aligned16;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 8 != 0 || Co % 8 != 0 || th <= 0 || tw <= 0 ||
      th * tw != cflearn::BM || tw > 256 || th > 256 || ctas <= 0 || !aligned16(x) || !aligned16(w) ||
      !aligned16(y))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return cflearn::dispatch<__nv_bfloat16>(x, w, bias, y, B, H, W, C, Co, th, tw, bn, ctas, s);
  if (dtype == 1) return cflearn::dispatch<__half>(x, w, bias, y, B, H, W, C, Co, th, tw, bn, ctas, s);
  return cudaErrorInvalidValue;
}
