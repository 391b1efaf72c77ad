// Hopper building blocks for the wide attention-block kernels
// (attention_block_wide_tc.cu): mbarriers, bulk copies between global and
// shared memory (cp.async.bulk, completed on an mbarrier), wgmma descriptors
// of swizzled shared-memory panels, and warpgroup products (wgmma.mma_async,
// m64n32k16 and m64n64k16, bf16 operands, float32 accumulators).
//
// Operand layout. A [rows, C] bf16 matrix is kept as panels of PW = C / 3
// columns (64 at C = 192, 32 at C = 96): panel p holds columns p PW .. p PW +
// PW - 1 of every row, PB = 2 PW bytes a row, and the 16-byte chunks of each
// row are swizzled the way wgmma's 128-byte (PB = 128) or 64-byte (PB = 64)
// layout reads them: byte o of a panel lies at swz(o) = o ^ ((o >> 3) & ((PB
// / 16 - 1) << 4)). Each panel starts on a multiple of 8 PB bytes. The same
// panel serves as a K-major operand (rows = M or N, columns = K) and, read
// transposed, as an MN-major one (rows = K, columns = M or N):
//   K-major:  k-step kk (16 columns) at panel kk / (PW / 16), byte 32 (kk %
//             (PW / 16)) of each row; 8-row groups SBO = 8 PB apart.
//   MN-major: k-step kk (16 rows) at byte 16 PB kk of the panel; 8-row groups
//             SBO = 8 PB apart, panels (PW values of M or N each) LBO apart.
//
// Accumulator fragment of m64nNk16 (thread i of the warpgroup, w = i / 32,
// g = (i % 32) / 4, t = i % 4): d[4j + 0..1] = row 16w + g, columns 8j + 2t,
// + 1; d[4j + 2..3] = row 16w + g + 8, the same columns. The A fragment from
// registers is that of mma.sync m16n8k16 for the warp's 16 rows, so two
// neighbouring 8-column blocks of an accumulator, rounded and packed
// (nbss_mma::pack_a), are the A operand of the next product.

#pragma once

#include "mma_bf16.cuh"

namespace nbss_wgmma {

using namespace nbss_mma;

// ---------------------------------------------------------------- barriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (bulk copies).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of bulk copies to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// Register budgets of a warp-specialised block of three warpgroups: the
// producer's warpgroup gives its registers up, the two consumers take them
// (24 x 128 + 2 x 240 x 128 <= 65536). Every thread of the warpgroup runs it.
__device__ __forceinline__ void regs_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}

__device__ __forceinline__ void regs_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

// ------------------------------------------------------------ bulk copies

// `bytes` (a multiple of 16) from global to shared memory, completed on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` from shared to global memory, in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until this thread's bulk stores are complete.
__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's ordinary shared-memory writes before later reads by
// the async proxy (wgmma operands, bulk stores).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------ descriptors

// Byte o of a swizzled panel of PB-byte rows.
template <int PB>
__host__ __device__ __forceinline__ uint32_t swz(uint32_t o) {
  static_assert(PB == 64 || PB == 128, "64- or 128-byte rows");
  return o ^ ((o >> 3) & ((PB / 16 - 1) << 4));
}

// The wgmma descriptor of a swizzled operand starting at p.
template <int PB>
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo_bytes) {
  constexpr uint64_t layout = PB == 128 ? 1 : 2;  // 128- or 64-byte swizzle
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(lbo_bytes >> 4) << 16) |
         (uint64_t(8 * PB >> 4) << 32) | (layout << 62);
}

// The descriptor d advanced by `off` bytes (a multiple of 16), formed where
// it is used: kept opaque so that the compiler does not hold every k-step's
// descriptor of a loop in registers.
__device__ __forceinline__ uint64_t desc_plus(uint64_t d, uint32_t off) {
  uint64_t r;
  asm volatile("add.s64 %0, %1, %2;\n" : "=l"(r) : "l"(d), "l"(uint64_t(off >> 4)));
  return r;
}

// --------------------------------------------------------------- products

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}


// Keeps the compiler from touching accumulator registers across the
// asynchronous products (call after wgmma_wait_all).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A B, m64n32k16, A and B from shared memory (descriptors).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (+)= A B, m64n32k16, A from registers (the fragment a), B from shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= A B, m64n64k16, A and B from shared memory (descriptors).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (+)= A B, m64n64k16, A from registers (the fragment a), B from shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// The product of width N (32 or 64): d (+)= A B with A in shared memory
// (TA = 1: MN-major) or registers, B in shared memory (TB = 1: MN-major).
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (N == 32)
    wgmma_ss_n32<TA, TB>(d, da, db, accumulate);
  else
    wgmma_ss_n64<TA, TB>(d, da, db, accumulate);
}

template <int N, int TB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  if constexpr (N == 32)
    wgmma_rs_n32<TB>(d, a, db, accumulate);
  else
    wgmma_rs_n64<TB>(d, a, db, accumulate);
}

}  // namespace nbss_wgmma
