// Shared PTX helpers for the hand-written Hopper kernels: cp.async copies,
// ldmatrix fragment loads and the m16n8k16 tensor-core product (mma.sync) in
// bf16 and fp16 with f32 accumulation; `Frag<T>` adds operand loaders for all
// four operand layouts and the m16n8k8 TF32 product for f32 tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cflearn {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `src_bytes` = 0 zero-fills the destination
// (used for halo pixels, ragged rows and padded head-dim columns).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  // d(16x8, f32) += a(16x16) * b(16x8)
  static __device__ __forceinline__ void run(float* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) { return __float2bfloat16_rn(v); }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half from_float(float v) { return __float2half_rn(v); }
};

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// Operand fragments of one warp-level product c(16x8, f32) += a(16xKS) * b(KSx8)
// read from shared-memory tiles of element type T with row pitch `ld`
// (elements). The four loaders name the stored layout:
//   load_a   : A(m, k) = s[(m0 + m) * ld + k0 + k]
//   load_a_t : A(m, k) = s[(k0 + k) * ld + m0 + m]   (the tile holds A^T)
//   load_b   : B(k, n) = s[(n0 + n) * ld + k0 + k]   (rows are n, k contiguous)
//   load_b_t : B(k, n) = s[(k0 + k) * ld + n0 + n]   (rows are k, n contiguous)
// 16-bit types use ldmatrix (plain / .trans) and m16n8k16; float uses scalar
// loads rounded to TF32 and m16n8k8. PAD is the row padding (elements) that
// keeps 16-byte row alignment and spreads rows over the banks.
template <typename T>
struct Frag {
  static constexpr int KS = 16;
  static constexpr int PAD = 8;
  static __device__ __forceinline__ void load_a(uint32_t* a, const T* s, int ld, int m0, int k0,
                                                int lane) {
    ldmatrix_x4(a, s + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
  }
  static __device__ __forceinline__ void load_a_t(uint32_t* a, const T* s, int ld, int m0, int k0,
                                                  int lane) {
    ldmatrix_x4_trans(a, s + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * ld + m0 +
                             ((lane >> 3) & 1) * 8);
  }
  static __device__ __forceinline__ void load_b(uint32_t* b, const T* s, int ld, int n0, int k0,
                                                int lane) {
    ldmatrix_x2(b, s + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
  }
  static __device__ __forceinline__ void load_b_t(uint32_t* b, const T* s, int ld, int n0, int k0,
                                                  int lane) {
    ldmatrix_x2_trans(b, s + (k0 + (lane & 15)) * ld + n0);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
    Mma<T>::run(c, a, b);
  }
  // two neighbouring columns of one row, rounded to T
  static __device__ __forceinline__ void store2(T* dst, float lo, float hi) {
    *reinterpret_cast<uint32_t*>(dst) = Mma<T>::pack(lo, hi);
  }
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

template <>
struct Frag<float> {
  static constexpr int KS = 8;
  static constexpr int PAD = 4;
  static __device__ __forceinline__ void load_a(uint32_t* a, const float* s, int ld, int m0,
                                                int k0, int lane) {
    const int g = lane >> 2, c = lane & 3;
    a[0] = to_tf32(s[(m0 + g) * ld + k0 + c]);
    a[1] = to_tf32(s[(m0 + g + 8) * ld + k0 + c]);
    a[2] = to_tf32(s[(m0 + g) * ld + k0 + c + 4]);
    a[3] = to_tf32(s[(m0 + g + 8) * ld + k0 + c + 4]);
  }
  static __device__ __forceinline__ void load_a_t(uint32_t* a, const float* s, int ld, int m0,
                                                  int k0, int lane) {
    const int g = lane >> 2, c = lane & 3;
    a[0] = to_tf32(s[(k0 + c) * ld + m0 + g]);
    a[1] = to_tf32(s[(k0 + c) * ld + m0 + g + 8]);
    a[2] = to_tf32(s[(k0 + c + 4) * ld + m0 + g]);
    a[3] = to_tf32(s[(k0 + c + 4) * ld + m0 + g + 8]);
  }
  static __device__ __forceinline__ void load_b(uint32_t* b, const float* s, int ld, int n0,
                                                int k0, int lane) {
    const int g = lane >> 2, c = lane & 3;
    b[0] = to_tf32(s[(n0 + g) * ld + k0 + c]);
    b[1] = to_tf32(s[(n0 + g) * ld + k0 + c + 4]);
  }
  static __device__ __forceinline__ void load_b_t(uint32_t* b, const float* s, int ld, int n0,
                                                  int k0, int lane) {
    const int g = lane >> 2, c = lane & 3;
    b[0] = to_tf32(s[(k0 + c) * ld + n0 + g]);
    b[1] = to_tf32(s[(k0 + c + 4) * ld + n0 + g]);
  }
  // d(16x8, f32) += a(16x8, tf32) * b(8x8, tf32)
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ void store2(float* dst, float lo, float hi) {
    *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
  }
};

// rows [row0, row0 + NROWS) x columns [col0, col0 + DC) of a (len, d) matrix
// with row pitch `row_stride` -> shared tile (NROWS, LD); rows >= len and
// columns >= d are zero-filled. d is a multiple of 8, so a 16-byte chunk is
// either wholly inside or wholly outside.
template <typename T, int NROWS, int DC, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* base, long long row_stride, int row0,
                                          int len, int col0, int d, int tid, int nthreads) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = DC / E;
  for (int i = tid; i < NROWS * CH; i += nthreads) {
    const int r = i / CH, c = i % CH;
    const int row = row0 + r, col = col0 + c * E;
    const bool ok = row < len && col < d;
    const T* src = ok ? base + row * row_stride + col : base;
    cp_async16(dst + r * LD + c * E, src, ok ? 16 : 0);
  }
}

}  // namespace cflearn
