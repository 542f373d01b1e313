// Weight gradient of the 3x3 stride-1 SAME convolution over NHWC bf16 / fp16
// on Hopper's warpgroup MMA (wgmma, f32 accumulation) fed by TMA, for sm_90a.
//
// Replaces: cflearn_tpu/ops/conv.py `_conv3x3_wgrad_kernel` (launched by
// `conv3x3_wgrad_pallas`), which walks (batch x row) tiles in grid order and
// carries one f32 accumulator of all nine taps from tile to tile.
//
// Here: per tap (di, dj), dW[co, di, dj, c] = sum over pixels p = (b, i, j) of
// dy[p, co] * x[b, i+di-1, j+dj-1, c], a GEMM with M = Co, N = C and K =
// pixels. A K step is 64 pixels of one image row, so both operands are TMA
// boxes: dy (64 channels, 64 columns, 1, 1) at (co0, j0, i, b), where columns
// past the image's edge come back zero and add nothing. Both tiles land
// pixel-major, which is MN-major for this GEMM: wgmma reads them through its
// transpose bits, with no ldmatrix.trans.
//
// A CTA owns 128 output channels x 128 input channels of one tap row di and
// all three taps dj of it: each K step loads dy once and feeds the three
// taps. x comes as one box two pixels wider, (64, 66, 1, 1) at (c0, j0 - 1,
// i + di - 1, b), and tap dj reads its 64 rows from row dj on: a descriptor
// start 128 * dj bytes into the box. The 128-byte swizzle is a function of
// the shared-memory address bits, so TMA's writes and wgmma's reads agree at
// any row, and x is loaded once per K step instead of three times (34 KB a
// stage instead of 64). TMA's zero fill outside the image (the columns -1
// and W, the rows -1 and H) is the SAME halo. Two consumer warpgroups each
// hold 64 output channels x 128 input channels x 3 taps in f32 (192
// registers a thread, after `setmaxnreg`); the producer warpgroup's one
// thread keeps the ring of stages full.
//
// Blocks run in no order, so nothing carries over between them: K is split
// across CTAs to fill the card (`ops/conv.py::wgrad_plan`), each CTA writes
// its f32 partial sums to a workspace (splits, Co, 9, C), and a second kernel
// adds them in the order of the splits and casts once. No atomics: the
// result is bit-reproducible.
//
// What bounds it on the H100: 2 * 9 * C * Co operations per pixel against
// 2 * (C + Co) bytes, several hundred per byte at the autoencoder's widths:
// the tensor cores. A K step does 189 operations per byte it loads from L2.
//
// Layout: x (B, H, W, C) and dy (B, H, W, Co) contiguous and 16-byte aligned;
// out (Co, 3, 3, C), the forward kernel's weight layout. C % 8 == 0 and
// Co % 8 == 0.

#include "sm90.cuh"

namespace cflearn {
namespace {

using namespace sm90;

constexpr int BM = 128;       // output channels per CTA, 64 per consumer warpgroup
constexpr int BN = 128;       // input channels per CTA and tap
constexpr int KP = 64;        // pixels per K step: columns of one image row
constexpr int THREADS = 384;  // warpgroup 0 loads, 1 and 2 multiply
constexpr int BOX = KP * ROW_BYTES;  // 8 KB: 64 pixels x 64 channels
constexpr int DY_BYTES = BM / BOX_C * BOX;
// one x box of KP + 2 pixels, its slot rounded up to whole swizzle atoms
constexpr int X_BOX_BYTES = (KP + 2) * ROW_BYTES;
constexpr int X_BOX = (X_BOX_BYTES + SWIZZLE_ATOM - 1) / SWIZZLE_ATOM * SWIZZLE_ATOM;
constexpr int STAGE = DY_BYTES + BN / BOX_C * X_BOX;  // 34 KB
constexpr int TX = DY_BYTES + BN / BOX_C * X_BOX_BYTES;  // bytes TMA delivers per stage
constexpr int STAGES = 5;
constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + SWIZZLE_ATOM;

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    wgrad_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
                 float* __restrict__ ws, int B, int H, int W, int C, int Co, int kt_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SWIZZLE_ATOM - 1) & ~uintptr_t(SWIZZLE_ATOM - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  // unit = (co tile, c tile, tap row di), di fastest: the three CTAs that share dy run side by side
  const int c_tiles = (C + BN - 1) / BN;
  const int di = blockIdx.x % 3, c0 = (blockIdx.x / 3 % c_tiles) * BN, co0 = (blockIdx.x / (3 * c_tiles)) * BM;
  const int split = blockIdx.y;
  const int cols_t = (W + KP - 1) / KP;
  const int KT = B * H * cols_t;
  const int kt0 = split * kt_per_split;
  const int nkt = max(min(KT, kt0 + kt_per_split) - kt0, 0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_dec<40>();
    if (threadIdx.x == 0) {
      prefetch_map(&xmap);
      prefetch_map(&dymap);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt0; kt < kt0 + nkt; ++kt) {
        const int j0 = (kt % cols_t) * KP, i = kt / cols_t % H, b = kt / (cols_t * H);
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* s = smem + stage * STAGE;
        mbar_expect_tx(&full[stage], TX);
#pragma unroll
        for (int q = 0; q < BM / BOX_C; ++q) tma_load_4d(s + q * BOX, &dymap, &full[stage], co0 + q * BOX_C, j0, i, b);
#pragma unroll
        for (int q = 0; q < BN / BOX_C; ++q)
          tma_load_4d(s + DY_BYTES + q * X_BOX, &xmap, &full[stage], c0 + q * BOX_C, j0 - 1, i + di - 1, b);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    regs_inc<232>();
    const int g = wg - 1, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    float acc[3][BN / 2];
#pragma unroll
    for (int dj = 0; dj < 3; ++dj)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[dj][i] = 0.f;
    int stage = 0, prev = -1;
    uint32_t phase = 0;
    for (int kt = 0; kt < nkt; ++kt) {
      mbar_wait(&full[stage], phase);
      const unsigned char* s = smem + stage * STAGE;
      const uint64_t da = desc_mn_major(s + g * BOX, BOX);
      wgmma_fence();
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) fence_regs<BN / 2>(acc[dj]);
#pragma unroll
      for (int k = 0; k < KP / 16; ++k) {
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          // x of tap dj: channels [c0, c0 + 64) and [c0 + 64, c0 + 128), X_BOX bytes apart, from the
          // box's row dj on
          const uint64_t db = desc_mn_major(s + DY_BYTES + dj * ROW_BYTES, X_BOX);
          wgmma<T, BN, 1, 1>(acc[dj], da + k * 128, db + k * 128);  // +16 pixel rows = 2048 bytes
        }
      }
      wgmma_commit();
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) fence_regs<BN / 2>(acc[dj]);
      wgmma_wait<1>();
      if (prev >= 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) fence_regs<BN / 2>(acc[dj]);
    if (prev >= 0) mbar_arrive(&empty[prev]);

    // partial sums of this split: ws[split][co][tap][c], c contiguous
    const int co_a = co0 + g * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co_a + h * 8;
      if (co >= Co) continue;
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        float* row = ws + ((size_t(split) * Co + co) * 9 + di * 3 + dj) * C;
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) {
          const int c = c0 + q * 8 + (lane % 4) * 2;
          if (c < C) *reinterpret_cast<float2*>(row + c) = make_float2(acc[dj][q * 4 + h * 2], acc[dj][q * 4 + h * 2 + 1]);
        }
      }
    }
  }
}

// out[i] = sum over the splits, in their order, of ws[s][i]; two elements per thread
template <typename T>
__global__ void wgrad_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out, size_t n, int splits) {
  const size_t i = (size_t(blockIdx.x) * blockDim.x + threadIdx.x) * 2;
  if (i >= n) return;
  float lo = 0.f, hi = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 v = *reinterpret_cast<const float2*>(ws + size_t(s) * n + i);
    lo += v.x;
    hi += v.y;
  }
  Frag<T>::store2(out + i, lo, hi);
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, void* ws, void* out, int B, int H, int W, int C, int Co, int splits,
                   cudaStream_t stream) {
  CUtensorMap xmap, dymap;
  cudaError_t err = encode_nhwc<T>(&xmap, x, B, H, W, C, 1, KP + 2);
  if (err != cudaSuccess) return err;
  err = encode_nhwc<T>(&dymap, dy, B, H, W, Co, 1, KP);
  if (err != cudaSuccess) return err;
  err = set_smem<wgrad_kernel<T>>(SMEM);
  if (err != cudaSuccess) return err;
  const int KT = B * H * ((W + KP - 1) / KP);
  const int per = (KT + splits - 1) / splits;
  const int units = 3 * ((Co + BM - 1) / BM) * ((C + BN - 1) / BN);
  err = launch_kernel(wgrad_kernel<T>, dim3(units, splits), THREADS, SMEM, stream, xmap, dymap,
                      static_cast<float*>(ws), B, H, W, C, Co, per);
  if (err != cudaSuccess) return err;
  const size_t n = size_t(Co) * 9 * C;
  const unsigned blocks = static_cast<unsigned>((n / 2 + 255) / 256);
  return launch_kernel(wgrad_reduce_kernel<T>, blocks, 256, 0, stream, static_cast<const float*>(ws),
                       static_cast<T*>(out), n, splits);
}

}  // namespace
}  // namespace cflearn

// dtype: 0 = bf16, 1 = fp16. `ws` holds splits * Co * 9 * C floats. Returns a
// cudaError_t.
extern "C" int cflearn_conv3x3_wgrad(int dtype, const void* x, const void* dy, void* ws, void* out, int B, int H,
                                     int W, int C, int Co, int splits, void* stream) {
  const cflearn::DeviceOf device(x);  // the device of `x`, its context bound to this thread
  if (device.error() != cudaSuccess) return device.error();
  using cflearn::sm90::aligned16;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 8 != 0 || Co % 8 != 0 || splits <= 0 ||
      splits > 65535 || !aligned16(x) || !aligned16(dy) ||
      static_cast<long long>(B) * H * ((W + cflearn::KP - 1) / cflearn::KP) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return cflearn::launch<__nv_bfloat16>(x, dy, ws, out, B, H, W, C, Co, splits, s);
  if (dtype == 1) return cflearn::launch<__half>(x, dy, ws, out, B, H, W, C, Co, splits, s);
  return cudaErrorInvalidValue;
}
