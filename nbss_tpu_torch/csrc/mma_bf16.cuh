// Fragment helpers for the tensor-core kernels (narrowband_attention_tc.cu,
// narrowband_attention_bwd_tc.cu, attention_block_tc.cu,
// attention_block_bwd_tc.cu, attention_block_relpos_tc.cu,
// attention_block_wide_tc.cu, tconvffn_tc.cu):
// mma.sync m16n8k16 (and m16n8k8) with bf16 operands and a float32
// accumulator, ldmatrix from shared memory, movmatrix, cp.async staging.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4), as the PTX ISA
// gives it:
//   A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..2t+1),
//                           a[2] = (g, 2t+8..2t+9), a[3] = (g+8, 2t+8..2t+9)
//   B (16 x 8, k x n):      b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8..2t+9, n g)
//   C (16 x 8, float32):    c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1)
// and of m16n8k8: A (16 x 8) a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..2t+1);
// B (8 x 8) b = (k 2t..2t+1, n g); C as above.
// so the C fragments of two neighbouring n-tiles, rounded to bf16 and packed
// in pairs, are the A fragment of a product over those 16 columns
// (pack_a): a score tile becomes the weights of the next product without
// passing through memory.
//
// Each bf16x2 register holds its lower-indexed element in the low half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace nbss_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Two 8x8 matrices, transposed; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// Two 8x8 bf16 matrices; lanes 0-15 give the row addresses (lane l: row l % 8
// of matrix l / 8): the A fragment of an m16n8k8 product.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a b on the tensor cores: bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b over a depth of 8 (m16n8k8): bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// An 8x8 bf16 matrix held as one register a lane (lane l: row l / 4, columns
// 2 (l % 4) .. + 1, the layout of each quarter of an A or C fragment),
// transposed across the warp.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// The A fragment of X^T from the A fragment of a 16x16 tile X: quarter
// (r, c) of X^T is quarter (c, r) of X, transposed.
__device__ __forceinline__ void transpose_a(uint32_t (&t)[4], const uint32_t (&a)[4]) {
  t[0] = movmatrix_t(a[0]);
  t[1] = movmatrix_t(a[2]);
  t[2] = movmatrix_t(a[1]);
  t[3] = movmatrix_t(a[3]);
}

// Two floats rounded to bf16 (round to nearest even) in one register.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a product over the 16 columns of the C fragments c0
// (columns 0-7) and c1 (columns 8-15), each value rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Two consecutive bf16 values of global memory (4-byte aligned) as one register.
__device__ __forceinline__ uint32_t ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// 16 bytes from global to shared memory, asynchronously (both 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// 16 bytes from global to shared memory, asynchronously, marked for early
// eviction from L2 (pol: an evict_first policy).
__device__ __forceinline__ void cp_async16_ef(void* dst, const void* src, uint64_t pol) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "l"(pol));
}

// An L2 policy that marks every access it tags for early eviction.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// 4 bytes from global to shared memory, asynchronously (both 4-byte aligned).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// Wait for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 2^x on the special-function unit (inputs below -126 give 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Barrier `id` (1-15; 0 is __syncthreads) of `nthreads` threads, whole warps.
__device__ __forceinline__ void named_barrier(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// The four threads of a quad (lanes 4g..4g+3) hold one row of a C fragment.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

}  // namespace nbss_mma
