// 3x3 stride-1 SAME convolution over NHWC bf16 / fp16 as an implicit GEMM on
// the tensor cores (mma.sync m16n8k16, f32 accumulation), for Hopper
// (sm_90a).
//
// Replaces: cflearn_tpu/ops/conv.py `_conv3x3_kernel` (launched by
// `conv3x3_pallas`, fold=False), which computes the conv as 9 shifted
// matmuls over halo'd row tiles of a pre-padded input.
//
// Here: M = B*H*W output pixels, N = Co, K = 9*C (tap-major, then channel).
// A CTA owns a 128 x 128 output tile; 8 warps each own 64 x 32. The K loop
// walks the 9 taps x C/32 channel slices through a 3-stage cp.async ring.
// Each A row is one output pixel's shifted input pixel: the SAME halo is a
// bounds check that zero-fills the copy, so no padded input is staged in
// device memory. The bias is added in f32 in the epilogue.
//
// What bounds it on the H100: at the VAE decoder shapes the conv does
// 2*9*C FLOPs per output element against ~(C + Co)*2 bytes per pixel, i.e.
// several hundred FLOPs per byte -> tensor-core bound; the ring keeps the
// loads in flight behind the mma.sync stream (wgmma / TMA are later work).
//
// Layout: x (B, H, W, C) contiguous, w (Co, 3, 3, C) contiguous (OHWI: each
// output channel's K vector is contiguous), bias (Co,) or null, y (B, H, W,
// Co) contiguous. C % 8 == 0 and Co % 8 == 0.

#include "mma_common.cuh"

namespace cflearn {
namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, LD = BK + 8, THREADS = 256;
constexpr size_t SMEM = size_t(STAGES) * (BM + BN) * LD * 2;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                   T* __restrict__ y, int B, int H, int W, int C, int Co) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // [STAGES][BM][LD]
  T* Bs = As + STAGES * BM * LD;           // [STAGES][BN][LD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int M = B * H * W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int c_chunks = (C + BK - 1) / BK;
  const int KT = 9 * c_chunks;

  // each thread copies two 16-byte chunks of the A tile and two of the B
  // tile per stage: rows idx / 4, chunk idx % 4 (4 chunks = BK channels)
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
    const int tap = kt / c_chunks, c0 = (kt % c_chunks) * BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = c0 + r_chk[i] * 8;
      const int yy = a_y[i] + dy, xx = a_x[i] + dx;
      const bool ok = a_ok[i] && c < C && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const T* src = ok ? x + ((size_t(a_b[i]) * H + yy) * W + xx) * C + c : x;
      cp_async16(As + (stage * BM + r_row[i]) * LD + r_chk[i] * 8, src, ok ? 16 : 0);
      const int co = n0 + r_row[i];
      const bool okw = co < Co && c < C;
      const T* wsrc = okw ? w + (size_t(co) * 9 + tap) * C + c : w;
      cp_async16(Bs + (stage * BN + r_row[i]) * LD + r_chk[i] * 8, wsrc, okw ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

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
    const T* At = As + (kt % STAGES) * BM * LD;
    const T* Bt = Bs + (kt % STAGES) * BN * LD;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], At + (wm * 64 + mt * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(bf[np], Bt + (wn * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                                kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) Mma<T>::run(acc[mt][nt], af[mt], &bf[nt >> 1][(nt & 1) * 2]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + cq * 2;
    if (col >= Co) continue;
    const float b0 = bias ? Mma<T>::to_float(bias[col]) : 0.f;
    const float b1 = bias ? Mma<T>::to_float(bias[col + 1]) : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int r = m0 + wm * 64 + mt * 16 + g;
      if (r < M)
        *reinterpret_cast<uint32_t*>(y + size_t(r) * Co + col) =
            Mma<T>::pack(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
      if (r + 8 < M)
        *reinterpret_cast<uint32_t*>(y + size_t(r + 8) * Co + col) =
            Mma<T>::pack(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y, int B, int H, int W,
                   int C, int Co, cudaStream_t stream) {
  auto kernel = conv3x3_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, (Co + BN - 1) / BN);
  kernel<<<grid, THREADS, SMEM, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                          static_cast<const T*>(bias), static_cast<T*>(y), B, H, W,
                                          C, Co);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cflearn

// dtype: 0 = bf16, 1 = fp16. `bias` may be null. Returns a cudaError_t.
extern "C" int cflearn_conv3x3_fwd(int dtype, const void* x, const void* w, const void* bias,
                                   void* y, int B, int H, int W, int C, int Co, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C % 8 != 0 || Co % 8 != 0 || C <= 0 || Co <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return cflearn::launch<__nv_bfloat16>(x, w, bias, y, B, H, W, C, Co, s);
  if (dtype == 1) return cflearn::launch<__half>(x, w, bias, y, B, H, W, C, Co, s);
  return cudaErrorInvalidValue;
}
