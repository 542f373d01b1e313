// Weight gradient of the 3x3 stride-1 SAME convolution over NHWC bf16 / fp16
// as nine implicit GEMMs on the tensor cores (mma.sync m16n8k16, f32
// accumulation), for Hopper (sm_90a).
//
// Replaces: cflearn_tpu/ops/conv.py `_conv3x3_wgrad_kernel` (launched by
// `conv3x3_wgrad_pallas`), which walks (batch x row) tiles in grid order and
// carries one f32 accumulator of all nine taps from tile to tile.
//
// Here: per tap (di, dj), dW[co, di, dj, c] = sum over pixels p = (b, i, j) of
// dy[p, co] * x[b, i+di-1, j+dj-1, c], i.e. a GEMM with M = Co, N = C and
// K = B*H*W. The contraction runs over pixels, the slow axis of both
// operands, so both tiles sit in shared memory as (pixels x channels) and are
// read transposed with ldmatrix.trans. A CTA owns one tap's 128 x 128 output
// tile and one contiguous range of K; 8 warps each own 64 x 32. Each pixel of
// a K tile finds its own image and its shifted position, and the copy
// zero-fills what falls outside, so K tiles may cross image boundaries.
//
// Blocks run in no order, so nothing carries over between them: K is split
// across CTAs to fill the card (9 output tiles at C = Co = 128), each CTA
// writes its f32 partial sum to a workspace (splits, Co, 9, C), and a second
// kernel adds the partial sums in the order of the splits and casts once.
// No atomics: the result is bit-reproducible.
//
// What bounds it on the H100: 2*9*C*Co operations per pixel against
// 2*(C + Co) bytes, several hundred per byte at the autoencoder's widths ->
// tensor-core bound. Each tap reads x and dy again (from L2 where the nine
// taps' CTAs run together); sharing one halo tile across the taps, wgmma and
// TMA are later work.
//
// Layout: x (B, H, W, C) and dy (B, H, W, Co) contiguous; out (Co, 3, 3, C),
// the forward kernel's weight layout. C % 8 == 0 and Co % 8 == 0.

#include "mma_common.cuh"

namespace cflearn {
namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, LD = BM + 8, THREADS = 256;
constexpr size_t SMEM = size_t(STAGES) * 2 * BK * LD * 2;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ ws, int B,
                 int H, int W, int C, int Co, int kt_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // [STAGES][BK][LD]: dy, pixels x co
  T* Bs = As + STAGES * BK * LD;           // [STAGES][BK][LD]: shifted x, pixels x c
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int tiles_n = (C + BN - 1) / BN, tiles_m = (Co + BM - 1) / BM;
  const int tap = blockIdx.x / (tiles_m * tiles_n);
  const int rem = blockIdx.x % (tiles_m * tiles_n);
  const int m0 = (rem / tiles_n) * BM, n0 = (rem % tiles_n) * BN;
  const int di = tap / 3 - 1, dj = tap % 3 - 1;
  const int split = blockIdx.y;
  const int HW = H * W, K = B * HW;
  const int KT = (K + BK - 1) / BK;
  const int kt0 = split * kt_per_split;
  const int kt1 = min(KT, kt0 + kt_per_split);
  const int nkt = max(kt1 - kt0, 0);

  // each thread copies two 16-byte chunks of each tile per stage: pixel rows
  // tid / 16 and tid / 16 + 16, channel chunk tid % 16 (16 chunks = 128 channels)
  const int r_row = tid >> 4, chk = (tid & 15) * 8;
  const bool ok_m = m0 + chk < Co, ok_n = n0 + chk < C;

  auto load = [&](int stage, int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r_row + i * 16;
      const int p = kt * BK + row;
      const bool ok_p = p < K;
      const int pp = ok_p ? p : 0;
      const int b = pp / HW, ij = pp % HW;
      const int yy = ij / W + di, xx = ij % W + dj;
      const bool ok_a = ok_p && ok_m;
      const T* asrc = ok_a ? dy + size_t(pp) * Co + m0 + chk : dy;
      cp_async16(As + (stage * BK + row) * LD + chk, asrc, ok_a ? 16 : 0);
      const bool ok_b = ok_p && ok_n && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const T* bsrc = ok_b ? x + ((size_t(b) * H + yy) * W + xx) * C + n0 + chk : x;
      cp_async16(Bs + (stage * BK + row) * LD + chk, bsrc, ok_b ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) load(s, kt0 + s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt-1 is free for the next copy
    const int nk = kt + STAGES - 1;
    if (nk < nkt) load(nk % STAGES, kt0 + nk);
    cp_async_commit();
    const T* At = As + (kt % STAGES) * BK * LD;
    const T* Bt = Bs + (kt % STAGES) * BK * LD;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) Frag<T>::load_a_t(af[mt], At, LD, wm * 64 + mt * 16, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) Frag<T>::load_b_t(bf[nt], Bt, LD, wn * 32 + nt * 8, kk * 16, lane);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) Frag<T>::mma(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  cp_async_wait<0>();

  // partial sums of this split: ws[split][co][tap][c], c contiguous
  const int g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + cq * 2;
    if (col >= C) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int r = m0 + wm * 64 + mt * 16 + g;
      if (r < Co)
        *reinterpret_cast<float2*>(ws + ((size_t(split) * Co + r) * 9 + tap) * C + col) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (r + 8 < Co)
        *reinterpret_cast<float2*>(ws + ((size_t(split) * Co + r + 8) * 9 + tap) * C + col) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// out[i] = sum over the splits, in their order, of ws[s][i]; two elements per thread
template <typename T>
__global__ void wgrad_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out, size_t n,
                                    int splits) {
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
cudaError_t launch(const void* x, const void* dy, void* ws, void* out, int B, int H, int W, int C,
                   int Co, int splits, cudaStream_t stream) {
  auto kernel = wgrad_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  const int KT = (B * H * W + BK - 1) / BK;
  const int per = (KT + splits - 1) / splits;
  const int tiles = 9 * ((Co + BM - 1) / BM) * ((C + BN - 1) / BN);
  kernel<<<dim3(tiles, splits), THREADS, SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<float*>(ws), B, H, W, C, Co,
      per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = size_t(Co) * 9 * C;
  const unsigned blocks = static_cast<unsigned>((n / 2 + 255) / 256);
  wgrad_reduce_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(ws),
                                                     static_cast<T*>(out), n, splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cflearn

// dtype: 0 = bf16, 1 = fp16. `ws` holds splits * Co * 9 * C floats. Returns a
// cudaError_t.
extern "C" int cflearn_conv3x3_wgrad(int dtype, const void* x, const void* dy, void* ws, void* out,
                                     int B, int H, int W, int C, int Co, int splits,
                                     void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 8 != 0 || Co % 8 != 0 || splits <= 0 ||
      splits > 65535 || static_cast<long long>(B) * H * W > 0x7fffffffLL - 64)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return cflearn::launch<__nv_bfloat16>(x, dy, ws, out, B, H, W, C, Co, splits, s);
  if (dtype == 1) return cflearn::launch<__half>(x, dy, ws, out, B, H, W, C, Co, splits, s);
  return cudaErrorInvalidValue;
}
