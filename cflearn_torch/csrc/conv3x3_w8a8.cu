// W8A8 3x3 stride-1 SAME convolution: int8 activations x int8 weights as an
// implicit GEMM on Hopper's warpgroup MMA (wgmma m64nNk32.s32.s8.s8, exact
// int32 sums) fed by TMA, dequantised in the epilogue, for sm_90a.
//
// Replaces: cflearn_tpu/ops/conv.py `_conv3x3_kernel_q` (launched by
// `conv3x3_w8a8`): 9 int8 matmuls with int32 accumulation, scaled by
// s_x * s_w[co] in-kernel so that the output leaves at its final dtype.
//
// Here: the quantised input and weights and the combined per-channel scale
// come from the wrapper (one launch of `quantize_w8a8.cu`; the JAX package
// also quantises outside its kernel). The int32 sum is exact: |sum| <= 127^2
// * 9 * C, 7.4e7 at C = 512, far below 2^31 (the 8-bit wgmma wraps, it does
// not saturate: the host refuses C > 14793). The epilogue keeps the JAX
// package's order and rounding: f32(acc) * scale[co] in f32 (round to
// nearest, no fused multiply-add), one cast to the output dtype, then + bias
// in the output dtype (the f32 sum of the two values rounded once, as
// PyTorch adds two bf16 / fp16 tensors). Built without --use_fast_math, so it
// matches the plain version bit for bit.
//
// GEMM: M = output pixels, N = Co, K = 9 taps x C (tap-major, then channel),
// as in `conv3x3.cu`, whose persistent, warp-specialised body this is. What
// changes for 8-bit operands: a 128-byte swizzled box row holds 128 channels,
// so a K slice is 128 channels (C = 128, 256, 512 take 1, 2, 4 slices a tap;
// TMA zero-fills a slice past C, so C % 128 != 0 needs nothing more), and a
// k32 step moves the descriptors by 32 bytes, 4 steps a slice. Both operands
// are K-major, as the 8-bit wgmma requires: x is NHWC (C innermost) and the
// weight (Co, 3, 3, C) is seen as (C, 9, Co). The tensor maps are UINT8: TMA
// copies bytes, and its zero fill outside the image is the int8 zero the JAX
// package pads with, so the SAME halo comes free.
//
// A tile is a box of th x tw = 128 pixels of one image (the host's planner,
// `ops/conv.py::conv3x3_w8a8_plan`, picks the box per shape) by 128 output
// channels. Warpgroup 0 gives its registers away and one thread of it keeps
// the ring of (A, B) stages full, tile after tile. Warpgroups 1 and 2 are
// ping-ponged consumers: each owns every other tile of its CTA, the whole
// tile (two m64n128k32 groups of 64 rows a K step, 128 int32 accumulators a
// thread), keeps one wgmma group in flight and hands a stage back once the
// group that read it has completed. The ring is filled in tile order and the
// consumers take turns at the products (a consumer hands the turn over once
// its tile's last stage has arrived), so one consumer's products run while
// the other dequantises its tile into shared memory and stores it by TMA
// (whole lines, where a register epilogue scatters 4-byte stores), and the
// epilogue leaves the tensor cores' critical path. Output tiles never overlap
// and the int32 sums are exact: the result is the same bits on every launch.
//
// What bounds it on the H100: 2 * 9 * C * Co int8 operations per pixel at
// 1,979 TOP/s against (C + 2 * Co) bytes: the tensor cores at the VAE
// decoder's widths. A 32 KB stage feeds 128 x 128 x 128 multiply-adds, 0.28
// us at the int8 rate, which the loads (mostly from L2) keep up with; the
// dequantising epilogue (128 x 128 values, 32 KB of stores a tile) would
// not, unless it overlapped the other consumer's products.
//
// `cflearn_conv3x3_w8a8_mma_sync` keeps the previous design (the mma.sync
// m16n8k32 implicit GEMM of `conv3x3_igemm.cuh`) as the yardstick that
// `conv3x3_int8(kernel="mma_sync")` launches.
//
// Layout: x (B, H, W, C) int8 contiguous, w (Co, 3, 3, C) int8 contiguous,
// scale (Co,) f32, bias (Co,) in the output dtype or null, y (B, H, W, Co) in
// the output dtype; x, w and y 16-byte aligned. C % 16 == 0 (TMA's 16-byte
// strides) and Co % 8 == 0.

#include "conv3x3_igemm.cuh"
#include "sm90.cuh"

namespace cflearn {
namespace w8a8 {
namespace {  // internal linkage: no kernel or static of this library is shared with another one loaded beside it

using namespace sm90;

constexpr int BOX_C8 = ROW_BYTES;  // int8 channels per box: one 128-byte swizzled row
constexpr int BM = 128;            // output pixels per tile
constexpr int BN = 128;            // output channels per tile
constexpr int THREADS = 384;       // warpgroup 0 loads, 1 and 2 multiply (every other tile each)
constexpr int A_BYTES = BM * ROW_BYTES;
constexpr int STAGE = A_BYTES + BN * ROW_BYTES;
constexpr int STAGES = 5;
constexpr int ACC = BM * BN / 128;    // int32 accumulators a consumer thread holds: two m64n128 groups
constexpr int OUT_BYTES = BM * BN * 2;  // a consumer's staged output tile: two 64-channel boxes of 128 pixel rows
constexpr int SMEM = STAGES * STAGE + 2 * OUT_BYTES + 2 * STAGES * 8 + SWIZZLE_ATOM;  // 230,480 bytes
constexpr int MAX_C = 14793;  // 127 * 127 * 9 * C < 2^31: the int32 sums stay exact

// f32(acc) * s in f32, rounded once to T; + b in T (the f32 sum of two values of T, rounded once); the pair packed
template <typename T>
__device__ __forceinline__ uint32_t dequant(int a0, int a1, float s0, float s1, float b0, float b1, bool has_bias) {
  using M = Mma<T>;
  float v0 = __fmul_rn(__int2float_rn(a0), s0), v1 = __fmul_rn(__int2float_rn(a1), s1);
  if (has_bias) {
    v0 = __fadd_rn(M::to_float(M::from_float(v0)), b0);
    v1 = __fadd_rn(M::to_float(M::from_float(v1)), b1);
  }
  return M::pack(v0, v1);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_w8a8_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap ymap, const float* __restrict__ scale,
                        const T* __restrict__ bias, int B, int H, int W, int C, int Co, int th, int tw) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on such a boundary
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SWIZZLE_ATOM - 1) & ~uintptr_t(SWIZZLE_ATOM - 1));
  unsigned char* staging = smem + STAGES * STAGE;  // the consumers' output tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * OUT_BYTES);
  uint64_t* empty = full + STAGES;

  const int rows_t = (H + th - 1) / th, cols_t = (W + tw - 1) / tw;
  const int n_tiles = (Co + BN - 1) / BN;
  const int tiles = B * rows_t * cols_t * n_tiles;
  const int kc = (C + BOX_C8 - 1) / BOX_C8;
  const int ksteps = 9 * kc;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);  // every thread of the one consumer that read the stage arrives
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
            unsigned char* a = smem + stage * STAGE;
            mbar_expect_tx(&full[stage], STAGE);
            tma_load_4d(a, &xmap, &full[stage], kk * BOX_C8, j0 + tap % 3 - 1, i0 + tap / 3 - 1, b);
            tma_load_3d(a + A_BYTES, &wmap, &full[stage], kk * BOX_C8, tap, n0);
            if (++stage == STAGES) {
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
    const int r0 = warp * 16 + lane / 4;  // this thread's tile rows r0 + 64 * rg + 8 * h
    int acc[ACC];
    // consumer g takes the CTA's tiles j = g, g + 2, ...: tile j's K steps start j * ksteps stages into the ring.
    // The consumers take turns at the products (named barriers 1 and 2): a consumer starts a tile once the other
    // has seen the last stage of the tile before it loaded, so that no consumer waits on a stage more than one
    // phase of its barrier ahead (a parity wait cannot tell two phases apart).
    for (int j = g, tile = blockIdx.x + g * gridDim.x; tile < tiles; j += 2, tile += 2 * gridDim.x) {
      if (j > 0) bar_sync(1 + g, 256);
      const bool hand_over = tile + int(gridDim.x) < tiles;  // the other consumer has a next tile
      const int n0 = (tile % n_tiles) * BN, m = tile / n_tiles;
      const int j0 = (m % cols_t) * tw, i0 = (m / cols_t % rows_t) * th, b = m / (cols_t * rows_t);
      const long long first = (long long)j * ksteps;
      int stage = int(first % STAGES);
      uint32_t phase = uint32_t(first / STAGES) & 1;
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = 0;
      int prev = -1;
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(&full[stage], phase);
        bar_arrive(2 - g, 256, hand_over && ks == ksteps - 1);  // the turn goes to the other consumer
        const unsigned char* a = smem + stage * STAGE;
        const uint64_t da = desc_k_major(a), db = desc_k_major(a + A_BYTES);
        wgmma_fence();
        fence_regs<ACC>(acc);
#pragma unroll
        for (int k = 0; k < BOX_C8 / 32; ++k) {  // +32 bytes of K a step; rows 64..127 sit 64 rows on
          wgmma_s8<BN>(acc, da + 2 * k, db + 2 * k);
          wgmma_s8<BN>(acc + BN / 2, da + (64 * ROW_BYTES >> 4) + 2 * k, db + 2 * k);
        }
        wgmma_commit();
        fence_regs<ACC>(acc);
        wgmma_wait<1>();  // the previous step's group has read its stage
        if (prev >= 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<ACC>(acc);
      if (prev >= 0) mbar_arrive(&empty[prev]);

      // epilogue: dequantise into this consumer's staging tile (two boxes of 64 channels by the tile's 128 pixel
      // rows, 128-byte swizzled: a warp's 4-byte stores fall in 32 different banks), then one TMA store a box,
      // which writes whole lines and only the pixels and channels inside the tensor while this consumer goes on
      unsigned char* out = staging + g * OUT_BYTES;
      bulk_wait_read<0>(t == 0);  // the stores of this consumer's previous tile have read the staging tile
      bar_sync(3 + g, 128);
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        const int col = n0 + q * 8 + (lane % 4) * 2;
        const bool in = col < Co;
        const float s0 = in ? scale[col] : 0.f, s1 = in ? scale[col + 1] : 0.f;
        const float b0 = in && bias ? Mma<T>::to_float(bias[col]) : 0.f;
        const float b1 = in && bias ? Mma<T>::to_float(bias[col + 1]) : 0.f;
        unsigned char* box = out + (q / 8) * (BM * ROW_BYTES) + (lane % 4) * 4;
#pragma unroll
        for (int rg = 0; rg < 2; ++rg) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + rg * 64 + h * 8;  // r % 8 == lane / 4
            const int* p = acc + rg * (BN / 2) + q * 4 + h * 2;
            *reinterpret_cast<uint32_t*>(box + r * ROW_BYTES + (((q % 8) ^ (lane / 4)) << 4)) =
                dequant<T>(p[0], p[1], s0, s1, b0, b1, bias != nullptr);
          }
        }
      }
      fence_proxy_async();  // the staging tile is read by the async proxy
      bar_sync(3 + g, 128);
      if (t == 0) {
#pragma unroll
        for (int bx = 0; bx < BN / 64; ++bx)
          if (n0 + bx * 64 < Co) tma_store_4d(&ymap, out + bx * BM * ROW_BYTES, n0 + bx * 64, j0, i0, b);
      }
    }
    bulk_wait(t == 0);  // the last tile's stores have completed
  }
}

template <typename T>
cudaError_t run(const void* x, const void* w, const void* scale, const void* bias, void* y, int B, int H, int W,
                int C, int Co, int th, int tw, int ctas, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  cudaError_t err = encode_nhwc<int8_t>(&xmap, x, B, H, W, C, th, tw);
  if (err != cudaSuccess) return err;
  // the weight (Co, 3, 3, C) as (C, 9, Co): box (128 channels, one tap, BN output channels)
  const uint64_t dims[3] = {uint64_t(C), 9, uint64_t(Co)};
  const uint64_t strides[2] = {uint64_t(C), uint64_t(C) * 9};
  const uint32_t box[3] = {uint32_t(BOX_C8), 1, uint32_t(BN)};
  err = encode_map(&wmap, tma_dtype<int8_t>(), 3, w, dims, strides, box);
  if (err != cudaSuccess) return err;
  // y (B, H, W, Co) as (Co, W, H, B): box (64 channels, tw, th, 1), the layout of a staging box
  CUtensorMap ymap;
  err = encode_nhwc<T>(&ymap, y, B, H, W, Co, th, tw);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_w8a8_kernel<T>;
  err = set_smem<conv3x3_w8a8_kernel<T>>(SMEM);
  if (err != cudaSuccess) return err;
  return launch_kernel(kernel, ctas, THREADS, SMEM, stream, xmap, wmap, ymap, static_cast<const float*>(scale),
                       static_cast<const T*>(bias), B, H, W, C, Co, th, tw);
}

// ---- the previous design, the mma.sync implicit GEMM: the yardstick ----------

template <typename T>
struct EpiDequant {
  T* y;
  const float* scale;
  const T* bias;
  int Co;
  struct Col {
    float s0, s1, b0, b1;
  };
  __device__ __forceinline__ Col col(int c) const {
    using M = cflearn::Mma<T>;
    return Col{scale[c], scale[c + 1], bias ? M::to_float(bias[c]) : 0.f,
               bias ? M::to_float(bias[c + 1]) : 0.f};
  }
  __device__ __forceinline__ void store(int r, int c, const Col& st, int a0, int a1) const {
    *reinterpret_cast<uint32_t*>(y + size_t(r) * Co + c) = dequant<T>(a0, a1, st.s0, st.s1, st.b0, st.b1, bias != nullptr);
  }
};

template <typename T>
cudaError_t run_mma_sync(const void* x, const void* w, const void* scale, const void* bias, void* y, int B, int H,
                         int W, int C, int Co, cudaStream_t s) {
  const EpiDequant<T> epi{static_cast<T*>(y), static_cast<const float*>(scale), static_cast<const T*>(bias), Co};
  return igemm::launch<int8_t, igemm::Taps::kNine>(static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                                                   epi, B, H, W, C, Co, s);
}

}  // namespace
}  // namespace w8a8
}  // namespace cflearn

// out_dtype: 0 = bf16, 1 = fp16. `bias` may be null. (th, tw): the pixel box
// of an output tile, th * tw = 128; ctas: the persistent grid. Returns a
// cudaError_t.
extern "C" int cflearn_conv3x3_w8a8(int out_dtype, const void* x, const void* w, const void* scale, const void* bias,
                                    void* y, int B, int H, int W, int C, int Co, int th, int tw, int ctas,
                                    void* stream) {
  const cflearn::DeviceOf device(x);  // the device of `x`, its context bound to this thread
  if (device.error() != cudaSuccess) return device.error();
  using cflearn::sm90::aligned16;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 16 != 0 || Co % 8 != 0 || C > cflearn::w8a8::MAX_C ||
      th <= 0 || tw <= 0 || th * tw != cflearn::w8a8::BM || tw > 256 || th > 256 || ctas <= 0 || !aligned16(x) ||
      !aligned16(w) || !aligned16(y))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return cflearn::w8a8::run<__nv_bfloat16>(x, w, scale, bias, y, B, H, W, C, Co, th, tw, ctas, s);
  if (out_dtype == 1) return cflearn::w8a8::run<__half>(x, w, scale, bias, y, B, H, W, C, Co, th, tw, ctas, s);
  return cudaErrorInvalidValue;
}

// the previous design: the same arguments without the plan
extern "C" int cflearn_conv3x3_w8a8_mma_sync(int out_dtype, const void* x, const void* w, const void* scale,
                                             const void* bias, void* y, int B, int H, int W, int C, int Co,
                                             void* stream) {
  const cflearn::DeviceOf device(x);  // the device of `x`, its context bound to this thread
  if (device.error() != cudaSuccess) return device.error();
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 16 != 0 || Co % 8 != 0 || C > cflearn::w8a8::MAX_C)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return cflearn::w8a8::run_mma_sync<__nv_bfloat16>(x, w, scale, bias, y, B, H, W, C, Co, s);
  if (out_dtype == 1) return cflearn::w8a8::run_mma_sync<__half>(x, w, scale, bias, y, B, H, W, C, Co, s);
  return cudaErrorInvalidValue;
}
