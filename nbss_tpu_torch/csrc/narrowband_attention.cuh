// Pieces shared by narrowband_attention.cu (forward) and
// narrowband_attention_bwd.cu (backward): element access, the score of one
// (query, key) pair in the narrow and the wide kernels, and the staging of
// head rows and of mask tiles in shared memory.
//
// Layout, as the JAX package's narrowband_attention takes it: q and k are
// [M, T, nh * dh], v [M, T, nh * dv]; head h is the slice [h * dh, (h+1) * dh)
// of a row. Rows may lie `ld` elements apart (a slice of a packed qkv
// projection). The mask, when given, is float32 [T, T] (one for every head)
// or [nh, T, T], added to the scaled scores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nbss_attn {

constexpr int DMAX = 64;  // largest head width of v, and of q/k in the narrow kernels

// The wide kernels take q/k head widths above DMAX (NBC's augmented heads,
// dh + d_model = 216): LANES threads share one row, each holding a CW-wide
// chunk of the q (or k) head in registers, and the partial dots of a row's
// chunks are added by group_sum. A chunk of a staged q/k row lies CWS floats
// after the previous one, so the LANES chunks start on different banks.
constexpr int DKMAX = 256;          // largest q/k head width the wide kernels take
constexpr int LANES = 4;            // threads per row in the wide kernels
constexpr int CW = DKMAX / LANES;   // q/k values a thread holds
constexpr int CWS = CW + 4;         // shared-memory stride of one chunk
constexpr int WROW = LANES * CWS;   // shared-memory stride of one staged q/k row

template <typename E> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

// a . b over D values (a multiple of 4): a in registers, b a row in shared
// memory read as float4, four partial sums over d % 4 added pairwise. An fma
// is the same for either order of its factors, so every kernel that forms
// q_i . k_j or g'_i . v_j this way gets the same bits, whichever of the two
// it holds in registers.
template <int D>
__device__ __forceinline__ float dot(const float (&a)[D], const float* b) {
  static_assert(D % 4 == 0, "head widths are padded to a multiple of 4");
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 w = b4[d / 4];
    s0 = fmaf(a[d], w.x, s0);
    s1 = fmaf(a[d + 1], w.y, s1);
    s2 = fmaf(a[d + 2], w.z, s2);
    s3 = fmaf(a[d + 3], w.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// The sum of the LANES partials of one row's group of threads, in every
// thread of the group: (p0 + p1) + (p2 + p3), by a butterfly; float addition
// commutes, so every thread of the group gets the same bits, and every wide
// kernel that sums a row's partials this way gets the same value.
__device__ __forceinline__ float group_sum(float p) {
  static_assert(LANES == 4, "the butterfly below adds four partials");
  p += __shfl_xor_sync(0xffffffffu, p, 1);
  p += __shfl_xor_sync(0xffffffffu, p, 2);
  return p;
}

// The score s_ij = (q_i . k_j) * scale (+ mask_ij), as the Pallas kernel
// forms it: the float32 product first, then the scale, then the mask.
template <int D>
__device__ __forceinline__ float score(const float (&a)[D], const float* b, float scale,
                                       const float* mask_ij) {
  float s = dot<D>(a, b) * scale;
  if (mask_ij != nullptr) s += *mask_ij;
  return s;
}

// The score of the wide kernels: as score(), with q_i . k_j the group_sum of
// the LANES chunk dots. `a` is this thread's chunk, `b` its chunk of the
// staged row (row + lane * CWS). Every thread of the warp must call it.
__device__ __forceinline__ float wide_score(const float (&a)[CW], const float* b, float scale,
                                            const float* mask_ij) {
  float s = group_sum(dot<CW>(a, b)) * scale;
  if (mask_ij != nullptr) s += *mask_ij;
  return s;
}

// Row r < nrows of a [ROWS][WROW] shared tile in the wide layout: element d
// of the head slice src[(row0 + r) * ld + col0 + d], d < width, at
// [r][(d / CW) * CWS + d % CW] as float32; the rest of each chunk 0.
template <typename E, int ROWS, int NT>
__device__ __forceinline__ void stage_wide(float (*dst)[WROW], const E* src, long long ld,
                                           size_t row0, int col0, int width, int nrows,
                                           int tid) {
  for (int idx = tid; idx < ROWS * DKMAX; idx += NT) {
    const int r = idx / DKMAX, d = idx % DKMAX;
    dst[r][(d / CW) * CWS + d % CW] =
        (r < nrows && d < width) ? Elem<E>::load(src + (row0 + r) * size_t(ld) + col0 + d)
                                 : 0.f;
  }
}

// Row r < nrows of a [ROWS][D] shared tile from the head slice
// src[(row0 + r) * ld + col0 + d], d < width, as float32; the rest 0.
template <typename E, int D, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(float (*dst)[D], const E* src, long long ld,
                                           size_t row0, int col0, int width, int nrows,
                                           int tid) {
  for (int idx = tid; idx < ROWS * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    dst[r][d] = (r < nrows && d < width)
                    ? Elem<E>::load(src + (row0 + r) * size_t(ld) + col0 + d) : 0.f;
  }
}

// The [R][C] tile of a [T, T] mask at (r0, c0) into dst (row stride LD),
// read along rows; outside the mask 0.
template <int R, int C, int LD, int NT>
__device__ __forceinline__ void stage_mask(float* dst, const float* mask, int T, int r0,
                                           int c0, int tid) {
  for (int idx = tid; idx < R * C; idx += NT) {
    const int r = idx / C, c = idx % C;
    dst[r * LD + c] = (r0 + r < T && c0 + c < T) ? mask[size_t(r0 + r) * T + c0 + c] : 0.f;
  }
}

// Head h's [T, T] slice of a [mask_heads, T, T] mask (mask_heads 1 or nh),
// or null without a mask.
__device__ __forceinline__ const float* head_mask(const float* mask, int mask_heads, int h,
                                                  int T) {
  return mask == nullptr ? nullptr : mask + size_t(mask_heads > 1 ? h : 0) * T * T;
}

// The padded head width a narrow launch is compiled for: the smallest of
// 16, 24, 32, 64 that holds both dh and dv.
inline int padded_width(int dh, int dv) {
  const int w = dh > dv ? dh : dv;
  return w <= 16 ? 16 : w <= 24 ? 24 : w <= 32 ? 32 : 64;
}

// The padded v head width a wide launch is compiled for: 16, 32 or 64, so
// that each of the LANES threads of a row holds a multiple of 4 values.
inline int padded_v_width(int dv) { return dv <= 16 ? 16 : dv <= 32 ? 32 : 64; }

}  // namespace nbss_attn
