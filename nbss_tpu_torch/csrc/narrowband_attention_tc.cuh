// Pieces shared by the narrow-band attention's tensor-core kernels,
// narrowband_attention_tc.cu (forward) and narrowband_attention_bwd_tc.cu
// (backward): staging head slices and mask rows in shared memory, and the
// score tile, so that the forward and the backward form s = q k^T * scale +
// mask with the same fragments and the same order of sums.

#pragma once

#include <cmath>

#include "mma_bf16.cuh"

namespace nbss_attn_tc {

using namespace nbss_mma;
using bf16 = __nv_bfloat16;

constexpr int KC = 256;             // keys (or queries) a chunk holds
constexpr int DKMAX = 256;          // largest q/k head width
constexpr int DVMAX = 64;           // largest v head width
constexpr int SMEM_MAX = 232448;    // shared memory a block may use
constexpr float LOG2E = 1.4426950408889634f;

// Row stride (elements) of a staged tile whose rows hold d values (a
// multiple of 8): an odd number of 16-byte units, so that the 8 rows an
// ldmatrix reads fall on 8 different bank groups.
__host__ __device__ constexpr int row_stride(int d) { return d + ((d / 8) % 2 == 0 ? 8 : 0); }

// Rows r0 .. r0 + n - 1 of a head slice into dst (stride ld, D columns):
// element c of row r is src[(grow0 + r) * lds + c0 + c] for r < nvalid and
// c < width, else 0. With vec, rows go 16 bytes at a time by cp.async.
__device__ __forceinline__ void stage(bf16* dst, int ld, int D, const bf16* src, long long lds,
                                      size_t grow0, int r0, int n, int nvalid, int c0,
                                      int width, bool vec, int tid, int nthreads) {
  const int chunks = D / 8;
  for (int idx = tid; idx < n * chunks; idx += nthreads) {
    const int r = idx / chunks, c = (idx - r * chunks) * 8;
    bf16* d = dst + r * ld + c;
    const int row = r0 + r;
    const bf16* s = src + (grow0 + row) * size_t(lds) + c0 + c;
    if (vec && row < nvalid && c < width) {
      cp_async16(d, s);
    } else {
      __align__(16) bf16 tmp[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        tmp[e] = (row < nvalid && c + e < width) ? s[e] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

// How a kernel reads the mask: none, the tile's rows staged in shared
// memory, or global memory at each score's position.
constexpr int MASK_NONE = 0, MASK_STAGED = 1, MASK_GLOBAL = 2;

// The scores of one warp's 16 query rows i0 .. i0 + 15 (Qw, staged, dp
// columns) against NP 16-key blocks of the staged keys Ks, of which the
// first np hold keys (np = NP when FULL): S[n][*] is the C fragment of keys
// j0 + 8n .. j0 + 8n + 7. s = (q k) * scale (+ mask); keys >= T get -inf.
// The products run over dp in k-steps of 16 from a zero accumulator, so any
// kernel that calls this gets the same bits for the same (query, key) pair:
// the backward's e = exp(s - m) is the forward's. MASK_STAGED reads mask
// element (i0 + r, j) at Mw[r * ldm + j - mj0]; MASK_GLOBAL reads the head's
// [T, T] mask at each score's position. Scores of rows past T are garbage
// that no caller keeps. KSTEPS = 0 runs the k-steps as a loop; KSTEPS > 0
// unrolls them, KSTEPS >= dp / 16 (the same products in the same order).
template <int NP, bool FULL, int MM, int KSTEPS = 0>
__device__ __forceinline__ void scores(float (&S)[2 * NP][4], const bf16* Qw, const bf16* Ks,
                                       int KS, int np, int dp, int T, float scale,
                                       const float* mask, const float* Mw, int ldm, int mj0,
                                       int i0, int j0, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) S[n][0] = S[n][1] = S[n][2] = S[n][3] = 0.f;
  auto kstep = [&](int kk) {
    uint32_t A[4];
    ldsm_x4(A, Qw + (lane & 15) * KS + kk + (lane >> 4) * 8);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (FULL || p < np) {
        uint32_t B[4];
        ldsm_x4(B, Ks + (p * 16 + (lane & 7) + (lane >> 4) * 8) * KS + kk + ((lane >> 3) & 1) * 8);
        mma(S[2 * p], A, B[0], B[1]);
        mma(S[2 * p + 1], A, B[2], B[3]);
      }
    }
  };
  if constexpr (KSTEPS == 0) {
#pragma unroll 1
    for (int kk = 0; kk < dp; kk += 16) kstep(kk);
  } else {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
      if (ks * 16 < dp) kstep(ks * 16);
  }
  if constexpr (MM == MASK_STAGED) {
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n * 8 + 2 * t4 + (e & 1);
        const float mv = Mw[(g + (e >> 1) * 8) * ldm + min(j, T - 1) - mj0];
        S[n][e] = j < T ? fmaf(S[n][e], scale, mv) : -INFINITY;
      }
    }
  } else if constexpr (MM == MASK_GLOBAL) {
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n * 8 + 2 * t4 + (e & 1);
        const float mv = __ldg(mask + size_t(min(i0 + g + (e >> 1) * 8, T - 1)) * T + min(j, T - 1));
        S[n][e] = j < T ? fmaf(S[n][e], scale, mv) : -INFINITY;
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n * 8 + 2 * t4 + (e & 1);
        S[n][e] = j < T ? S[n][e] * scale : -INFINITY;
      }
    }
  }
}

// e = exp(s - m) in float32, as every kernel of the family forms it.
__device__ __forceinline__ float exp_shifted(float s, float m) { return ex2((s - m) * LOG2E); }

// The mask rows i0 .. i0 + 15 (those < T) of one head into dst, row r at
// dst + r * T: one contiguous run of floats, copied 16 bytes at a time where
// aligned. Part `part` of `nparts` warps' share.
__device__ __forceinline__ void stage_mask_rows(float* dst, const float* mask, int T, int i0,
                                                int part, int nparts, int lane) {
  const size_t n = size_t(min(16, T - i0)) * T;
  const float* src = mask + size_t(i0) * T;
  size_t c = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const size_t n4 = n / 4;
    for (size_t v = lane + 32 * part; v < n4; v += 32 * nparts) cp_async16(dst + 4 * v, src + 4 * v);
    c = 4 * n4;
  }
  for (c += lane + 32 * part; c < n; c += 32 * nparts) cp_async4(dst + c, src + c);
}

}  // namespace nbss_attn_tc
