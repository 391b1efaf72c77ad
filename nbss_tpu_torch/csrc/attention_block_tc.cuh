// Pieces shared by the attention block's tensor-core kernels,
// attention_block_tc.cu (forward), attention_block_bwd_tc.cu (backward) and
// attention_block_wide_tc.cu (both, at H = 192 and any T): the channel
// widths, the bf16 weight layout that the prep kernel writes, the m16n8k16
// products over the channels of xa-like [*][LS] tiles in shared memory, and
// the backward's weight cotangents and fixed-order sums. Lanes H and H+1 of xa are 1 and 0 for every frame, so each
// product runs over the H channels (H / 16 k-steps) and the ones lane enters
// as a float32 bias. The helpers take the width as a template parameter,
// HH, 96 unless given (the backward is built for 96 only).

#pragma once

#include <cmath>

#include "mma_bf16.cuh"

namespace nbss_block {

using namespace nbss_mma;
using bf16 = __nv_bfloat16;

constexpr int TMAX = 256;      // longest sequence the shared tiles hold
constexpr float LOG2E = 1.4426950408889634f;

// bf16 weights per head, as the kernels read them (prepared by prep), for H
// channels (AT_N = H + 8):
//   AT [AT_N][H]  AT[n][k] = A[k][n]    (B of t = xa A; rows H+2.. zero)
//   WT [H][H]     WT[n][k] = Wvo[k][n]  (B of vo = xa Wvo)
//   Ab [H][H]     Ab[i][k] = A[i][k]    (B of dxa = dt A^T)
//   Wb [H][H]     Wb[i][k] = Wvo[i][k]  (B of dxa = dvo Wvo^T)
// and float32 vectors per head: abias [AT_N] = A[H][:], wbias [H] = Wvo[H][:],
// acol [H] = A[:H][H], each rounded to bf16.
template <int H_>
struct Width {
  static constexpr int H = H_;
  static constexpr int HA = H + 2;   // row stride of the folded operands
  static constexpr int LS = H + 8;   // row stride (elements) of the shared bf16 tiles:
                                     // an odd number of 16-byte units, free of bank conflicts
  static constexpr int KS = H / 16;  // k-steps over the channels
  static constexpr int NC = H / 8;   // n-tiles over the channels
  static constexpr int AT_N = H + 8;
  static constexpr int WTS_PER_HEAD = AT_N * H + 3 * H * H;
  static constexpr int VEC_PER_HEAD = AT_N + 2 * H;
  static_assert(H % 32 == 0 && (LS / 8) % 2 == 1, "H: a multiple of 32 lanes, odd 16-byte rows");
};

// The backward's width, and the helpers' default.
constexpr int H = 96;
constexpr int HA = Width<H>::HA, LS = Width<H>::LS, KS = Width<H>::KS, NC = Width<H>::NC;
constexpr int AT_N = Width<H>::AT_N, WTS_PER_HEAD = Width<H>::WTS_PER_HEAD;
constexpr int VEC_PER_HEAD = Width<H>::VEC_PER_HEAD;

template <int HH = H>
static __global__ void attention_block_tc_prep(const float* __restrict__ A, const float* __restrict__ Wvo,
                                               bf16* __restrict__ wts, float* __restrict__ vecs) {
  constexpr int H = HH, HA = Width<HH>::HA, AT_N = Width<HH>::AT_N;
  constexpr int WTS_PER_HEAD = Width<HH>::WTS_PER_HEAD, VEC_PER_HEAD = Width<HH>::VEC_PER_HEAD;
  const int h = blockIdx.x;
  const float* Ah = A + size_t(h) * HA * HA;
  const float* Wh = Wvo + size_t(h) * HA * HA;
  bf16* AT = wts + size_t(h) * WTS_PER_HEAD;
  bf16* WT = AT + AT_N * H;
  bf16* Ab = WT + H * H;
  bf16* Wb = Ab + H * H;
  float* abias = vecs + size_t(h) * VEC_PER_HEAD;
  float* wbias = abias + AT_N;
  float* acol = wbias + H;
  for (int idx = threadIdx.x; idx < AT_N * H; idx += blockDim.x) {
    const int n = idx / H, k = idx % H;
    AT[idx] = __float2bfloat16(n < HA ? Ah[k * HA + n] : 0.f);
  }
  for (int idx = threadIdx.x; idx < H * H; idx += blockDim.x) {
    const int n = idx / H, k = idx % H;
    WT[idx] = __float2bfloat16(Wh[k * HA + n]);
    Ab[idx] = __float2bfloat16(Ah[n * HA + k]);
    Wb[idx] = __float2bfloat16(Wh[n * HA + k]);
  }
  for (int n = threadIdx.x; n < AT_N; n += blockDim.x)
    abias[n] = n < HA ? round_bf16(Ah[H * HA + n]) : 0.f;
  for (int n = threadIdx.x; n < H; n += blockDim.x) {
    wbias[n] = round_bf16(Wh[H * HA + n]);
    acol[n] = round_bf16(Ah[n * HA + H]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A fragments of rows r0 .. r0 + 15 of a shared [*][LS] tile, all H / 16 k-steps.
template <int HH = H>
__device__ __forceinline__ void load_a(uint32_t (&F)[HH / 16][4], const bf16* tile, int r0,
                                       int lane) {
#pragma unroll
  for (int ks = 0; ks < HH / 16; ++ks)
    ldsm_x4(F[ks], tile + (r0 + (lane & 15)) * Width<HH>::LS + ks * 16 + (lane >> 4) * 8);
}

// c[u] (+)= F (16 rows) . rows r0 + 16u .. r0 + 16u + 15 of `tile` (over the
// channels), u < NK: the [16, 16] products whose B operand is the tile's
// rows as columns. The k-steps go outermost, so the 2 NK accumulators form
// independent chains.
template <int NK, bool ACCUMULATE = false, int HH = H>
__device__ __forceinline__ void mma_rows(float (&c)[NK][2][4], const uint32_t (&F)[HH / 16][4],
                                         const bf16* tile, int r0, int lane) {
  constexpr int KS = HH / 16, LS = Width<HH>::LS;
  if (!ACCUMULATE) {
#pragma unroll
    for (int u = 0; u < NK; ++u)
#pragma unroll
      for (int n = 0; n < 2; ++n) c[u][n][0] = c[u][n][1] = c[u][n][2] = c[u][n][3] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int u = 0; u < NK; ++u) {
      uint32_t B[4];
      ldsm_x4(B, tile + (r0 + 16 * u + (lane & 7) + (lane >> 4) * 8) * LS + ks * 16 +
                     ((lane >> 3) & 1) * 8);
      mma(c[u][0], F[ks], B[0], B[1]);
      mma(c[u][1], F[ks], B[2], B[3]);
    }
  }
}

// The scores of key tile kt for the query rows of F (t): s = t xa^T + t[:, H];
// keys >= T get -inf.
template <int HH = H>
__device__ __forceinline__ void score_tile(float (&s)[2][4], const uint32_t (&F)[HH / 16][4],
                                           const bf16* XA, int kt, int T, const float (&cq)[2],
                                           int lane) {
  const int t4 = lane & 3;
  float c[1][2][4];
  mma_rows<1, false, HH>(c, F, XA, kt * 16, lane);
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = kt * 16 + n * 8 + 2 * t4 + (e & 1) < T ? c[0][n][e] + cq[e >> 1] : -INFINITY;
}

// Rows [0, rows) of a [*][H] bf16 matrix in global memory into a shared
// [*][LS] tile, 16 bytes at a time; rows [rows, pad) zero. Thread tid of nthreads.
template <int HH = H>
__device__ __forceinline__ void stage_weights(bf16* dst, const bf16* __restrict__ src, int rows,
                                              int pad, int tid, int nthreads) {
  constexpr int H = HH, LS = Width<HH>::LS;
  for (int idx = tid; idx < pad * (H / 8); idx += nthreads) {
    const int r = idx / (H / 8), c = (idx % (H / 8)) * 8;
    if (r < rows)
      cp_async16(dst + r * LS + c, src + r * H + c);
    else
      *reinterpret_cast<uint4*>(dst + r * LS + c) = make_uint4(0, 0, 0, 0);
  }
}

// acc[NC] += P (16 x 16, A fragment over rows r0 .. r0 + 15 of `tile`) . tile
// rows r0 .. r0 + 15 (all channels): the B operand read transposed.
template <int HH = H>
__device__ __forceinline__ void mma_tile_t(float (&acc)[HH / 8][4], const uint32_t (&P)[4],
                                           const bf16* tile, int r0, int lane) {
  constexpr int NC = HH / 8, LS = Width<HH>::LS;
#pragma unroll
  for (int nn = 0; nn < NC / 2; ++nn) {
    uint32_t B[4];
    ldsm_x4_t(B, tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LS + nn * 16 + (lane >> 4) * 8);
    mma(acc[2 * nn], P, B[0], B[1]);
    mma(acc[2 * nn + 1], P, B[2], B[3]);
  }
}

// The A fragments of a [16, H] C-fragment tile, each value rounded to bf16.
template <int HH = H>
__device__ __forceinline__ void c_to_a(uint32_t (&D)[HH / 16][4], const float (&c)[HH / 8][4]) {
#pragma unroll
  for (int ks = 0; ks < HH / 16; ++ks) pack_a(D[ks], c[2 * ks], c[2 * ks + 1]);
}

// The backward kernels' weight cotangents dA_h = xa^T dt and dWvo_h = xa^T
// dvo, over every frame of every sequence, as fixed slices of the rows:
// part[s][y] = xa^T D over the rows of slice s (of `per`), for y = 2h (D =
// head h's dt rows, XW wide, lane H the row sum of dS) and y = 2h + 1 (its
// dvo rows, H wide): [XW][XW] float32, each of XW / 16 warps 16 columns, the
// rows staged GROWS at a time. xa rows are XW wide, lane H = 1.
template <int HH, int XW, int GROWS>
static __global__ void __launch_bounds__(XW / 16 * 32)
attention_block_bwd_weights(const bf16* __restrict__ xa_rows, const bf16* __restrict__ dt_rows,
                            const bf16* __restrict__ dvo_rows, float* __restrict__ part,
                            long long nrows, long long per) {
  constexpr int H = HH, GLS = XW + 8, NT = XW / 16 * 32;  // GLS: odd 16-byte rows
  static_assert(XW % 16 == 0 && (GLS / 8) % 2 == 1, "16-column warps, odd 16-byte rows");
  __shared__ __align__(16) bf16 xs[GROWS][GLS];
  __shared__ __align__(16) bf16 ds[GROWS][GLS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int y = blockIdx.y, h = y / 2;
  const bool is_dt = (y & 1) == 0;
  const int width = is_dt ? XW : H;
  const bf16* D = is_dt ? dt_rows + size_t(h) * nrows * XW : dvo_rows + size_t(h) * nrows * H;
  const long long r_begin = blockIdx.x * per, r_end = min(nrows, r_begin + per);
  const bool live = warp * 16 < width;
  float acc[XW / 16][2][4] = {};
  for (long long r0 = r_begin; r0 < r_end; r0 += GROWS) {
    __syncthreads();  // the previous rows are consumed
    for (int idx = tid; idx < GROWS * (XW / 8); idx += NT) {
      const int r = idx / (XW / 8), c = (idx % (XW / 8)) * 8;
      const long long row = r0 + r;
      if (row < r_end) {
        cp_async16(&xs[r][c], xa_rows + row * XW + c);
        if (c < width)
          cp_async16(&ds[r][c], D + row * width + c);
        else
          *reinterpret_cast<uint4*>(&ds[r][c]) = make_uint4(0, 0, 0, 0);
      } else {
        *reinterpret_cast<uint4*>(&xs[r][c]) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(&ds[r][c]) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (live) {
#pragma unroll
      for (int k0 = 0; k0 < GROWS; k0 += 16) {
        uint32_t B[4];
        ldsm_x4_t(B, &ds[k0 + (lane & 7) + ((lane >> 3) & 1) * 8][warp * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mt = 0; mt < XW / 16; ++mt) {
          uint32_t A[4];
          ldsm_x4_t(A, &xs[k0 + (lane & 7) + (lane >> 4) * 8][mt * 16 + ((lane >> 3) & 1) * 8]);
          mma(acc[mt][0], A, B[0], B[1]);
          mma(acc[mt][1], A, B[2], B[3]);
        }
      }
    }
  }
  float* out = part + (size_t(blockIdx.x) * gridDim.y + y) * XW * XW;
  const int g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < XW / 16; ++mt)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(mt * 16 + g4 + 8 * (e >> 1)) * XW + warp * 16 + n * 8 + 2 * t4 + (e & 1)] = acc[mt][n][e];
}

// out = [dA: nh HA HA][dWvo: nh HA HA][dln: 2H][dc: H], each the sum over
// slices (the weight partials) or blocks (part [nblocks][3H]) in order
template <int HH, int XW>
static __global__ void attention_block_bwd_reduce(const float* __restrict__ wpart,
                                                  const float* __restrict__ part,
                                                  float* __restrict__ out, int nslices,
                                                  int nblocks, int nh) {
  constexpr int H = HH, HA = H + 2;
  const size_t n_w = 2 * size_t(nh) * HA * HA, n = n_w + 3 * H;
  for (size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += size_t(gridDim.x) * blockDim.x) {
    float s = 0.f;
    if (e < n_w) {
      const size_t per = size_t(nh) * HA * HA;
      const int which = int(e / per);
      const size_t r = e % per;
      const int h = int(r / (HA * HA)), i = int(r % (HA * HA)) / HA, k = int(r % HA);
      const size_t y = 2 * h + which;
      for (int sl = 0; sl < nslices; ++sl)
        s += wpart[(size_t(sl) * 2 * nh + y) * XW * XW + i * XW + k];
    } else {
      for (int b = 0; b < nblocks; ++b) s += part[size_t(b) * 3 * H + (e - n_w)];
    }
    out[e] = s;
  }
}

}  // namespace nbss_block
