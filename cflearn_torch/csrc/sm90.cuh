// Hopper building blocks shared by the wgmma + TMA kernels (sm_90a): the 3x3
// conv kernels `conv3x3.cu`, `conv3x3_wgrad.cu`, `conv3x3_fold.cu` and the
// int8 `conv3x3_w8a8.cu`, the
// flash-attention forwards `flash_fwd_sm90.cuh` and `flash_fwd_sm90_wide.cuh`
// and backward
// `flash_bwd_sm90.cuh`, and the bulk loads of `group_norm.cu`. TMA tile
// loads that complete on shared-memory mbarriers, bulk copies and bulk
// reduce-adds between global and shared memory, named barriers between
// warpgroups, warpgroup MMA (`wgmma.mma_async`) with A and B read from
// shared memory through matrix descriptors or A from registers, and the
// host-side encoding of the TMA tensor maps.
//
// Every operand tile is made of TMA boxes whose innermost dimension is 64
// 16-bit values (128 bytes), written with the 128-byte swizzle: rows of 128
// bytes in groups of eight (1024 bytes) whose 16-byte chunks are permuted by
// the row index. Boxes start on 1024-byte boundaries, so a descriptor's base
// offset is always 0. A row is one pixel, one output channel of a weight box,
// or one token of an attention tile, so:
//   * K-major operands (K = channels or head dim: the conv forward's x and
//     weight tiles, attention's q and k) take one descriptor per 64-row
//     group; stepping K by 16 moves its start by 32 bytes inside the swizzled
//     row, and the next 64 values of K sit one box further. A descriptor may
//     also start at any 128-byte row of a box (the fold's taps dj read one
//     box dj rows apart): the swizzle follows the address bits, so the base
//     offset stays 0;
//   * MN-major operands (K = pixels or tokens: the weight gradient's dy and x
//     tiles, attention's v) take the transpose bit; the 64 values of a row are
//     the MN extent of one swizzle atom, the next 64 sit LBO bytes further,
//     and stepping K by 16 rows moves the start by 2048 bytes.
// A box that runs past the tensor's edge (the SAME halo of the convs, the
// head dim past d, the ragged tail of a sequence) reads zeros there, and the
// whole box still counts toward the barrier's transaction bytes.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time, no -lcuda
#include <cudaTypedefs.h>

#include <type_traits>

#include "mma_common.cuh"

namespace cflearn {
namespace sm90 {

constexpr int BOX_C = 64;           // channels (or head-dim columns) per box: 128 bytes of 16-bit values
constexpr int ROW_BYTES = 128;      // bytes per box row (one pixel, or one token of an attention tile)
constexpr int SWIZZLE_ATOM = 1024;  // 8 rows of 128 bytes

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and add `bytes` to the transactions this phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrive where `pred` holds: a predicated instruction, not a branch (one
// thread of a warp can arrive for the warp without a divergent path)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
                   smem_addr(bar)),
               "r"(int(pred))
               : "memory");
}

constexpr long long WAIT_LIMIT_CYCLES = 1LL << 35;  // ~17 s at 2 GHz: a wait this long is a fault

// spin until the phase of parity `parity` has completed; a wait that never
// ends traps (an error the launch reports) rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > WAIT_LIMIT_CYCLES) {
      __trap();
    }
  }
}

// ---- TMA loads --------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a box of shared memory (laid out as the map's box, with its swizzle) to the 4-D map's box at the coordinates,
// as one bulk group of its own: TMA writes whole lines and only the elements inside the tensor
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1, int c2,
                                             int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes of global memory into shared memory as one bulk copy (no tensor map), completing
// on `bar`; both addresses 16-byte aligned, `bytes` a multiple of 16
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- bulk reduce-add (shared -> global), issued by the threads where `pred` holds ----

// make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operands, bulk copies) that reads them after a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// global[dst .. dst + bytes) += shared[src ..) in f32, as one bulk operation
// of its own bulk group; bytes and both addresses are multiples of 16
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const void* src, uint32_t bytes, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n"
      "@p cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
      "@p cp.async.bulk.commit_group;\n}\n" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes), "r"(int(pred))
      : "memory");
}

// wait until all but the newest N of this thread's bulk groups have read their shared-memory source
template <int N>
__device__ __forceinline__ void bulk_wait_read(bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p cp.async.bulk.wait_group.read %1;\n}\n" ::"r"(
                   int(pred)),
               "n"(N)
               : "memory");
}

// wait until this thread's bulk groups have completed
__device__ __forceinline__ void bulk_wait(bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p cp.async.bulk.wait_group 0;\n}\n" ::"r"(int(pred))
               : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a box of a 1-D map (`encode_rows_f32`) into shared memory
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- register rebalancing between the producer and the consumers -----------

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- named barriers between warpgroups --------------------------------------

// wait at barrier `id` until `threads` threads have arrived (this thread included)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrive at barrier `id` without waiting, where `pred` holds: a predicated
// instruction, not a branch, so no divergent path lies between a warpgroup's
// wgmma instructions
__device__ __forceinline__ void bar_arrive(int id, int threads, bool pred = true) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p bar.arrive %0, %1;\n}\n" ::"r"(id), "r"(threads),
               "r"(int(pred))
               : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// shared-memory matrix descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 = SW128
__device__ __forceinline__ uint64_t make_desc(const void* tile, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return uint64_t((smem_addr(tile) & 0x3FFFF) >> 4) | (uint64_t((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo_bytes >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

// K-major: 64-row groups of 8-row atoms, SBO = one atom (LBO unused under the swizzle)
__device__ __forceinline__ uint64_t desc_k_major(const void* tile) { return make_desc(tile, 16, SWIZZLE_ATOM); }

// MN-major: the next 64 MN elements `mn_stride` bytes on, the next 8 K rows one atom on
__device__ __forceinline__ uint64_t desc_mn_major(const void* tile, uint32_t mn_stride) {
  return make_desc(tile, mn_stride, SWIZZLE_ATOM);
}

// the same descriptors as two 32-bit words: the low word holds the start address and the leading byte
// offset, the high word the stride byte offset (one atom) and the 128-byte swizzle, which every tile here
// shares. A kernel that keeps many descriptors live holds one register each (the low words) instead of two.
constexpr uint32_t DESC_HI = (SWIZZLE_ATOM >> 4) | (1u << 30);
__device__ __forceinline__ uint32_t desc_lo(const void* tile, uint32_t lbo_bytes) {
  return ((smem_addr(tile) & 0x3FFFF) >> 4) | (((lbo_bytes >> 4) & 0x3FFF) << 16);
}
__device__ __forceinline__ uint64_t desc_of(uint32_t lo) { return (uint64_t(DESC_HI) << 32) | lo; }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma that owns the registers
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for int32 accumulators (the s8 wgmma)
template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the same for the A fragment registers of an RS wgmma: they must hold their
// values until the wgmma that reads them has completed
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d(64 x N, f32) (+)= A(64 x 16) B(16 x N) for one warpgroup. SS: A and B
// read from shared memory through descriptors, TA / TB = 1 reads A / B
// MN-major. RS: A from four 32-bit registers a thread (the m16n8k16 A
// fragment of the thread's warp's 16 rows), B through a descriptor.
// scale_d = 0 overwrites d instead of accumulating.
#define CFLEARN_WGMMA_SS_N64(NAME, TY) \
  template <int TA, int TB> \
  __device__ __forceinline__ void NAME(float* d, uint64_t a, uint64_t b, int scale_d) { \
    asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, " \
      "%32, %33, p, 1, 1, %35, %36;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB)); \
  }

#define CFLEARN_WGMMA_SS_N128(NAME, TY) \
  template <int TA, int TB> \
  __device__ __forceinline__ void NAME(float* d, uint64_t a, uint64_t b, int scale_d) { \
    asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, " \
      "%64, %65, p, 1, 1, %67, %68;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB)); \
  }

#define CFLEARN_WGMMA_SS_N256(NAME, TY) \
  template <int TA, int TB> \
  __device__ __forceinline__ void NAME(float* d, uint64_t a, uint64_t b, int scale_d) { \
    asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, " \
      "%128, %129, p, 1, 1, %131, %132;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB)); \
  }

#define CFLEARN_WGMMA_RS_N64(NAME, TY) \
  template <int TB> \
  __device__ __forceinline__ void NAME(float* d, const uint32_t* a, uint64_t b, int scale_d) { \
    asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, " \
      "{%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB)); \
  }

#define CFLEARN_WGMMA_RS_N128(NAME, TY) \
  template <int TB> \
  __device__ __forceinline__ void NAME(float* d, const uint32_t* a, uint64_t b, int scale_d) { \
    asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, " \
      "{%64,%65,%66,%67}, %68, p, 1, 1, %70;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB)); \
  }

#define CFLEARN_WGMMA_RS_N192(NAME, TY) \
  template <int TB> \
  __device__ __forceinline__ void NAME(float* d, const uint32_t* a, uint64_t b, int scale_d) { \
    asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " " \
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95}, " \
      "{%96,%97,%98,%99}, %100, p, 1, 1, %102;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB)); \
  }

#define CFLEARN_WGMMA_RS_N256(NAME, TY) \
  template <int TB> \
  __device__ __forceinline__ void NAME(float* d, const uint32_t* a, uint64_t b, int scale_d) { \
    asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, " \
      "{%128,%129,%130,%131}, %132, p, 1, 1, %134;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB)); \
  }

CFLEARN_WGMMA_SS_N64(wgmma_ss_n64_bf16, "bf16")
CFLEARN_WGMMA_SS_N64(wgmma_ss_n64_f16, "f16")
CFLEARN_WGMMA_SS_N128(wgmma_ss_n128_bf16, "bf16")
CFLEARN_WGMMA_SS_N128(wgmma_ss_n128_f16, "f16")
CFLEARN_WGMMA_SS_N256(wgmma_ss_n256_bf16, "bf16")
CFLEARN_WGMMA_SS_N256(wgmma_ss_n256_f16, "f16")
CFLEARN_WGMMA_RS_N64(wgmma_rs_n64_bf16, "bf16")
CFLEARN_WGMMA_RS_N64(wgmma_rs_n64_f16, "f16")
CFLEARN_WGMMA_RS_N128(wgmma_rs_n128_bf16, "bf16")
CFLEARN_WGMMA_RS_N128(wgmma_rs_n128_f16, "f16")
CFLEARN_WGMMA_RS_N192(wgmma_rs_n192_bf16, "bf16")
CFLEARN_WGMMA_RS_N192(wgmma_rs_n192_f16, "f16")
CFLEARN_WGMMA_RS_N256(wgmma_rs_n256_bf16, "bf16")
CFLEARN_WGMMA_RS_N256(wgmma_rs_n256_f16, "f16")

// both operands from shared memory
template <typename T, int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float* d, uint64_t a, uint64_t b, int scale_d = 1) {
  constexpr bool bf = std::is_same<T, __nv_bfloat16>::value;
  static_assert(N == 64 || N == 128 || N == 256, "wgmma SS N");
  if constexpr (N == 64) {
    if constexpr (bf) wgmma_ss_n64_bf16<TA, TB>(d, a, b, scale_d); else wgmma_ss_n64_f16<TA, TB>(d, a, b, scale_d);
  } else if constexpr (N == 128) {
    if constexpr (bf) wgmma_ss_n128_bf16<TA, TB>(d, a, b, scale_d); else wgmma_ss_n128_f16<TA, TB>(d, a, b, scale_d);
  } else {
    if constexpr (bf) wgmma_ss_n256_bf16<TA, TB>(d, a, b, scale_d); else wgmma_ss_n256_f16<TA, TB>(d, a, b, scale_d);
  }
}

// A from registers
template <typename T, int N, int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b, int scale_d = 1) {
  constexpr bool bf = std::is_same<T, __nv_bfloat16>::value;
  static_assert(N == 64 || N == 128 || N == 192 || N == 256, "wgmma RS N");
  if constexpr (N == 64) {
    if constexpr (bf) wgmma_rs_n64_bf16<TB>(d, a, b, scale_d); else wgmma_rs_n64_f16<TB>(d, a, b, scale_d);
  } else if constexpr (N == 128) {
    if constexpr (bf) wgmma_rs_n128_bf16<TB>(d, a, b, scale_d); else wgmma_rs_n128_f16<TB>(d, a, b, scale_d);
  } else if constexpr (N == 192) {
    if constexpr (bf) wgmma_rs_n192_bf16<TB>(d, a, b, scale_d); else wgmma_rs_n192_f16<TB>(d, a, b, scale_d);
  } else {
    if constexpr (bf) wgmma_rs_n256_bf16<TB>(d, a, b, scale_d); else wgmma_rs_n256_f16<TB>(d, a, b, scale_d);
  }
}

// d(64 x N, s32) (+)= A(64 x 32) B(32 x N), int8 x int8, for one warpgroup:
// both operands K-major in shared memory (the 8-bit form takes no transpose
// and no scale immediates). The int32 sums wrap, they do not saturate (no
// .satfinite): a caller keeps them exact by bounding K.
#define CFLEARN_WGMMA_S8_N128(NAME) \
  __device__ __forceinline__ void NAME(int* d, uint64_t a, uint64_t b, int scale_d) { \
    asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " \
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, " \
      "%64, %65, p;\n}\n" \
      : \
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), \
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]) \
      : "l"(a), "l"(b), "r"(scale_d)); \
  }

#define CFLEARN_WGMMA_S8_N256(NAME) \
  __device__ __forceinline__ void NAME(int* d, uint64_t a, uint64_t b, int scale_d) { \
    asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " \
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, " \
      "%128, %129, p;\n}\n" \
      : \
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), \
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), \
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), \
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), \
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), \
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), \
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), \
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), \
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), \
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127]) \
      : "l"(a), "l"(b), "r"(scale_d)); \
  }

CFLEARN_WGMMA_S8_N128(wgmma_s8_n128)
CFLEARN_WGMMA_S8_N256(wgmma_s8_n256)

template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b, int scale_d = 1) {
  static_assert(N == 128 || N == 256, "wgmma s8 N");
  if constexpr (N == 128) wgmma_s8_n128(d, a, b, scale_d); else wgmma_s8_n256(d, a, b, scale_d);
}

// ---- host: tensor maps ------------------------------------------------------

template <typename T>
constexpr CUtensorMapDataType tma_dtype() {
  if constexpr (std::is_same<T, int8_t>::value) return CU_TENSOR_MAP_DATA_TYPE_UINT8;  // TMA copies bytes
  return std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// A tensor map of `rank` dimensions (innermost first): `dims` elements,
// `strides` bytes for dimensions 1.., `box` elements, the 128-byte swizzle
// unless another is named, zeros out of bounds. `cuTensorMapEncodeTiled` is looked
// up through the runtime, so the library needs no link against libcuda.
inline cudaError_t encode_map(CUtensorMap* map, CUtensorMapDataType dtype, int rank, const void* base,
                              const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const uint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(map, dtype, rank, const_cast<void*>(base), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// (B, H, W, C) channels-last tensor as a 4-D map (C, W, H, B), box (one 128-byte row of channels: 64 16-bit or
// 128 8-bit values, tw, th, 1)
template <typename T>
cudaError_t encode_nhwc(CUtensorMap* map, const void* base, int B, int H, int W, int C, int th, int tw) {
  const uint64_t dims[4] = {uint64_t(C), uint64_t(W), uint64_t(H), uint64_t(B)};
  const uint64_t row = uint64_t(C) * sizeof(T);
  const uint64_t strides[3] = {row, row * W, row * W * H};
  const uint32_t box[4] = {uint32_t(ROW_BYTES / sizeof(T)), uint32_t(tw), uint32_t(th), 1};
  return encode_map(map, tma_dtype<T>(), 4, base, dims, strides, box);
}

// a (B, H, L, D) view as the 4-D map (D, L, H, B), box (64, rows, 1, 1)
template <typename T>
cudaError_t encode_bhld(CUtensorMap* map, const void* base, int batch, int heads, int len, int d, long long sb,
                        long long sh, long long sl, int rows) {
  const uint64_t dims[4] = {uint64_t(d), uint64_t(len), uint64_t(heads), uint64_t(batch)};
  const uint64_t strides[3] = {uint64_t(sl) * sizeof(T), uint64_t(sh) * sizeof(T), uint64_t(sb) * sizeof(T)};
  const uint32_t box[4] = {uint32_t(BOX_C), uint32_t(rows), 1, 1};
  return encode_map(map, tma_dtype<T>(), 4, base, dims, strides, box);
}

// `n` contiguous f32 values as a 1-D map, box `rows`, no swizzle (per-row statistics such as a logsumexp)
inline cudaError_t encode_rows_f32(CUtensorMap* map, const float* base, long long n, int rows) {
  const uint64_t dims[1] = {uint64_t(n)};
  const uint64_t strides[1] = {0};  // a 1-D map has no strides
  const uint32_t box[1] = {uint32_t(rows)};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// raise kernel `Kernel`'s dynamic shared memory limit once per device, not on every launch
template <auto Kernel>
cudaError_t set_smem(int bytes) {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace sm90
}  // namespace cflearn
