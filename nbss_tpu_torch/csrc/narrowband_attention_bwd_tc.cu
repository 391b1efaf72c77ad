// Narrow-band multi-head attention, backward, on Hopper's bf16 tensor cores
// (sm_90a, mma.sync). The bf16 counterpart of narrowband_attention_bwd.cu,
// which keeps the float32 inputs.
//
// The adjoint of narrowband_attention_tc.cu for a cotangent g of o. With the
// forward's row max m and rinv = 1 / sum(e) (its `stats`), and e = exp(s -
// m) recomputed from q, k and the mask:
//
//     g'  = round(g * rinv)                     dV = round(e)^T g'
//     dP' = g' V^T                              delta = rowsum(dP' o e) * rinv
//     dS  = round(e o (dP' - delta) * scale)    dQ = dS K,  dK = dS^T Q
//
// the rounding points of the Pallas TPU kernel _fused_backward (_bwd_kernel,
// _bwd_kernel_nomask) in nbss_tpu/ops/attention.py, which this replaces for
// bf16 inputs: g', e where it meets g' and dS are rounded to bf16 exactly
// where they become mma operands; dP', delta and the e in dS stay float32.
// The scores come from the forward's own score tile
// (narrowband_attention_tc.cuh: the same fragments, the same order of
// sums), so e here is the forward's e bit for bit.
//
// What bounds it on an H100: memory. At the mhsa(251) training shape (M =
// 1032, T = 251, nh = 4, dh = dv = 24, causal [T, T] mask) it reads q, k, v,
// g, the mask and the statistics and writes dq, dk, dv: 0.35 GB, 0.10 ms at
// 3.35 TB/s, against 62 GFLOP of products (63 us at 989 TFLOP/s); at NBC's
// post-LN shape (M = 514, T = 248, nh = 8, dh = 216, dv = 24, no mask) 1.9
// GB, 0.57 ms. The design:
//
// - Two kernels, a block per (sequence, head) each, no atomics, so two
//   launches give the same bits. The query kernel stages K and V (bf16,
//   zero-padded to multiples of 16: dh 24 -> 32, 216 -> 224) and walks 16-row
//   query tiles, a warp each; since m and rinv are given, no score row is
//   held: it sweeps the keys twice, 16 at a time, first for delta (written
//   to a [M, nh, T] float32 workspace), then for dS and dQ. The key kernel
//   stages Q, g' and the row statistics and walks 16-key tiles, a warp
//   each, recomputing e and dS per 16-query block and summing dV and dK.
// - Every product is mma.sync m16n8k16. The rounded e and dS pass from the
//   accumulator to the A fragment of the next product in registers, and to
//   the A fragment of their transpose (e^T g', dS^T Q) by movmatrix; K, g'
//   and Q enter as B operands through ldmatrix.trans.
// - A [T, T] mask is staged per tile: a query tile's 16 rows (one
//   contiguous run) and a key tile's 16 columns of every row, by cp.async,
//   where they fit in shared memory, else read at each score's position.
//   Longer T than 256 takes the staged keys (queries) in chunks of 256.
//
// What holds it back: e and dP' are formed twice in the query kernel and
// once more in the key kernel (five score-sized products against the two
// the function needs), and at dh 216 Q or K of one head (119 KB) leaves
// room for one block an SM.

#include <climits>
#include <type_traits>

#include "narrowband_attention_tc.cuh"

namespace {

using namespace nbss_attn_tc;

constexpr int NWMAX = 8;  // warps per block, at most
constexpr size_t SMEM_SM = 233472;  // shared memory of an SM
using One = std::integral_constant<int, 1>;

// 16-key blocks a step of the query kernel takes at once, as independent
// chains: four at head widths up to 64, two above (the dQ accumulators take
// the registers).
template <int DPT>
using Step = std::integral_constant<int, DPT <= 64 ? 4 : 2>;

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* mask;   // null, or [mask_heads, T, T]
  const bf16* g;       // [M, T, nh * dv], contiguous
  const float* stats;  // [2, M, nh, T]: row max, 1 / row sum
  bf16* dq;            // [M, T, nh * dh], contiguous
  bf16* dk;            // [M, T, nh * dh], contiguous
  bf16* dv;            // [M, T, nh * dv], contiguous
  float* delta;        // [M, nh, T] workspace
  long long ldq, ldk, ldv;
  int M, T, nh, dh, dvw, mask_heads;
  int dp, dvp;         // dh and dv padded to multiples of 16
  int vq, vk, vv;      // rows of q, k, v may be copied 16 bytes at a time
  float scale;
};

// Shared memory of the two kernels for nw warps, in bytes from the start.
struct Smem {
  size_t a, b, stat, warp, per_warp, total;
  // query kernel: a = K chunk, b = V chunk; per warp the q tile and, staged,
  // its 16 mask rows. key kernel: a = Q chunk, b = g' chunk, stat = row max
  // and delta; per warp the k and v tiles and, staged, the mask's 16 columns.
  __host__ __device__ Smem(const BwdArgs& x, bool keys, bool staged, int nw) {
    const size_t c16 = (min(x.T, KC) + 15) & ~15, t16 = (x.T + 15) & ~15;
    const size_t ks = row_stride(x.dp), vs = row_stride(x.dvp);
    a = 0;
    b = a + c16 * ks * 2;
    stat = b + c16 * vs * 2;
    warp = stat + (keys ? 2 * c16 * 4 : 0);
    per_warp = keys ? 16 * (ks + vs) * 2 + (staged ? t16 * 16 * 4 : 0)
                    : 16 * ks * 2 + (staged ? size_t(16) * x.T * 4 : 0);
    total = warp + nw * per_warp;
  }
};

// The mask's columns j0 .. j0 + 15 (those < T) of every row i < T into dst,
// element (i, j) at dst[i * 16 + j - j0], 4 bytes at a time (a row's run is
// 16-byte aligned only every few rows when T is odd); a warp instruction
// copies two rows' runs of 64 bytes.
__device__ __forceinline__ void stage_mask_cols(float* dst, const float* mask, int T, int j0,
                                                int lane) {
  const int w = min(16, T - j0);
  for (int idx = lane; idx < T * 16; idx += 32) {
    const int i = idx >> 4, c = idx & 15;
    if (c < w) cp_async4(dst + idx, mask + size_t(i) * T + j0 + c);
  }
}

// C (16 x 16, the two n-tiles c[0], c[1]) = A (16 rows of width 16 nk, A
// fragments F) . rows r0 .. r0 + 15 of tile (as the columns), over the first
// 16 nk columns of the tile.
template <int NK>
__device__ __forceinline__ void mma_rows_f(float (*c)[4], const uint32_t (&F)[NK][4], int nk,
                                           const bf16* tile, int ld, int r0, int lane) {
  c[0][0] = c[0][1] = c[0][2] = c[0][3] = c[1][0] = c[1][1] = c[1][2] = c[1][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    if (ks < nk) {
      uint32_t B[4];
      ldsm_x4(B, tile + (r0 + (lane & 7) + (lane >> 4) * 8) * ld + ks * 16 + ((lane >> 3) & 1) * 8);
      mma(c[0], F[ks], B[0], B[1]);
      mma(c[1], F[ks], B[2], B[3]);
    }
  }
}

// acc[0 .. 2 nn) += P (16 x 16) . tile rows r0 .. r0 + 15, first 16 nn
// columns: the B operand read transposed.
template <int NN>
__device__ __forceinline__ void mma_tile_t(float (&acc)[2 * NN][4], const uint32_t (&P)[4], int nn,
                                           const bf16* tile, int ld, int r0, int lane) {
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    if (n < nn) {
      uint32_t B[4];
      ldsm_x4_t(B, tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n * 16 + (lane >> 4) * 8);
      mma(acc[2 * n], P, B[0], B[1]);
      mma(acc[2 * n + 1], P, B[2], B[3]);
    }
  }
}

// Rows i0 + g, i0 + g + 8 of a [16, 8 NC] accumulator tile, columns < width,
// rounded to bf16 into out (row stride ld).
template <int NC>
__device__ __forceinline__ void store_tile(bf16* out, size_t ld, const float (&acc)[NC][4], int i0,
                                           int T, int width, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1), col = n * 8 + 2 * t4 + (e & 1);
      if (i < T && col < width) out[i * ld + col] = __float2bfloat16(acc[n][e]);
    }
}

// The query kernel: delta and dQ. A block per (sequence, head), nw warps, a
// 16-row query tile a warp; the keys staged 256 at a time.
template <int DPT, int MM>
__global__ void __launch_bounds__(NWMAX * 32) narrowband_attention_bwd_tc_dq(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nw = blockDim.x >> 5;
  const Smem L(a, false, MM == MASK_STAGED, nw);
  const int KS = row_stride(a.dp), VS = row_stride(a.dvp);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x % a.nh, m = blockIdx.x / a.nh;
  const int T = a.T;
  const size_t row0 = size_t(m) * T;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + L.a);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + L.b);
  unsigned char* mine = smem_raw + L.warp + warp * L.per_warp;
  bf16* Qw = reinterpret_cast<bf16*>(mine);
  float* Mw = reinterpret_cast<float*>(mine + 16 * KS * 2);
  const float* mask =
      a.mask == nullptr ? nullptr : a.mask + size_t(a.mask_heads > 1 ? h : 0) * T * T;
  const size_t srow = (size_t(m) * a.nh + h) * T;  // this head's row statistics
  const float* mrow = a.stats + srow;
  const float* rrow = a.stats + size_t(a.M) * a.nh * T + srow;
  const int nchunks = (T + KC - 1) / KC, ntiles = (T + 15) / 16;
  const int nkv = a.dvp / 16;  // k-steps over v's columns

  int staged = -1;
  auto ensure = [&](int c) {  // every warp calls it, in step
    if (staged == c) return;
    __syncthreads();  // every warp is done with the chunk staged before
    const int j0 = c * KC, n16 = (min(KC, T - j0) + 15) & ~15;
    stage(Ks, KS, a.dp, a.k, a.ldk, row0, j0, n16, T, h * a.dh, a.dh, a.vk, tid, blockDim.x);
    stage(Vs, VS, a.dvp, a.v, a.ldv, row0, j0, n16, T, h * a.dvw, a.dvw, a.vv, tid, blockDim.x);
    cp_async_wait_all();
    __syncthreads();
    staged = c;
  };

  for (int it = 0; it < (ntiles + nw - 1) / nw; ++it) {
    const int i0 = (it * nw + warp) * 16;
    const bool active = i0 < T;
    float mx[2] = {0.f, 0.f}, rinv[2] = {0.f, 0.f};
    uint32_t G[DVMAX / 16][4];  // g' = round(g rinv) of the tile's rows: A fragments over v's columns
    if (active) {
      __syncwarp();  // the warp is done with its previous tile
      stage(Qw, KS, a.dp, a.q, a.ldq, row0, i0, 16, T, h * a.dh, a.dh, a.vq, lane, 32);
      if constexpr (MM == MASK_STAGED) stage_mask_rows(Mw, mask, T, i0, 0, 1, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + g + 8 * r;
        if (i < T) {
          mx[r] = mrow[i];
          rinv[r] = rrow[i];
        }
      }
      const bf16* gm = a.g + row0 * size_t(a.nh) * a.dvw + size_t(h) * a.dvw;
#pragma unroll
      for (int ks = 0; ks < DVMAX / 16; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = q & 1, i = i0 + g + 8 * r, col = ks * 16 + 2 * t4 + 8 * (q >> 1);
          float v0 = 0.f, v1 = 0.f;
          if (i < T) {
            const bf16* gr = gm + size_t(i) * a.nh * a.dvw;
            if (col < a.dvw) v0 = __bfloat162float(gr[col]) * rinv[r];
            if (col + 1 < a.dvw) v1 = __bfloat162float(gr[col + 1]) * rinv[r];
          }
          G[ks][q] = pack(v0, v1);
        }
      cp_async_wait_all();
      __syncwarp();
    }

    // e, dP' for the 16 NB keys of blocks kb .. kb + NB - 1 of chunk c
    auto block = [&](auto nb, int c, int kb, float (&e)[2 * decltype(nb)::value][4],
                     float (&dp)[2 * decltype(nb)::value][4]) {
      constexpr int NB = decltype(nb)::value;
      scores<NB, true, MM, DPT / 16>(e, Qw, Ks + kb * 16 * KS, KS, NB, a.dp, T, a.scale, mask, Mw,
                                     T, 0, i0, c * KC + kb * 16, lane);
#pragma unroll
      for (int n = 0; n < 2 * NB; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) e[n][q] = exp_shifted(e[n][q], mx[q >> 1]);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        mma_rows_f<DVMAX / 16>(dp + 2 * b, G, nkv, Vs, VS, (kb + b) * 16, lane);
    };

    // sweep 1: delta = rowsum(dP' e) rinv
    float dsum[2] = {0.f, 0.f};
    for (int c = 0; c < nchunks; ++c) {
      ensure(c);
      if (!active) continue;
      const int nkb = (min(KC, T - c * KC) + 15) / 16;
      auto add = [&](const float (*e)[4], const float (*dp)[4]) {  // two n-tiles each
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) dsum[q >> 1] = fmaf(dp[n][q], e[n][q], dsum[q >> 1]);
      };
      constexpr int NB = Step<DPT>::value;
      int kb = 0;
      for (; kb + NB <= nkb; kb += NB) {
        float e[2 * NB][4], dp[2 * NB][4];
        block(Step<DPT>{}, c, kb, e, dp);
#pragma unroll
        for (int b = 0; b < NB; ++b) add(e + 2 * b, dp + 2 * b);
      }
      for (; kb < nkb; ++kb) {
        float e[2][4], dp[2][4];
        block(One{}, c, kb, e, dp);
        add(e, dp);
      }
    }
    float delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) delta[r] = quad_sum(dsum[r]) * rinv[r];
    if (active && t4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (i0 + g + 8 * r < T) a.delta[srow + i0 + g + 8 * r] = delta[r];
    }

    // sweep 2: dS = round(e (dP' - delta) scale), dQ += dS K
    float dq[DPT / 8][4] = {};
    for (int c = 0; c < nchunks; ++c) {
      ensure(c);
      if (!active) continue;
      const int nkb = (min(KC, T - c * KC) + 15) / 16;
      auto add = [&](int kb, float (*e)[4], const float (*dp)[4]) {  // two n-tiles each
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) e[n][q] = round_bf16((e[n][q] * (dp[n][q] - delta[q >> 1])) * a.scale);
        uint32_t P[4];
        pack_a(P, e[0], e[1]);
        mma_tile_t<DPT / 16>(dq, P, a.dp / 16, Ks, KS, kb * 16, lane);
      };
      constexpr int NB = Step<DPT>::value;
      int kb = 0;
      for (; kb + NB <= nkb; kb += NB) {
        float e[2 * NB][4], dp[2 * NB][4];
        block(Step<DPT>{}, c, kb, e, dp);
#pragma unroll
        for (int b = 0; b < NB; ++b) add(kb + b, e + 2 * b, dp + 2 * b);
      }
      for (; kb < nkb; ++kb) {
        float e[2][4], dp[2][4];
        block(One{}, c, kb, e, dp);
        add(kb, e, dp);
      }
    }
    if (active)
      store_tile<DPT / 8>(a.dq + row0 * size_t(a.nh) * a.dh + size_t(h) * a.dh,
                          size_t(a.nh) * a.dh, dq, i0, T, a.dh, lane);
  }
}

// The key kernel: dK and dV. A block per (sequence, head), nw warps, a
// 16-key tile a warp; the queries (with g' and their row statistics) staged
// 256 at a time.
template <int DPT, int MM>
__global__ void __launch_bounds__(NWMAX * 32) narrowband_attention_bwd_tc_dkdv(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nw = blockDim.x >> 5;
  const Smem L(a, true, MM == MASK_STAGED, nw);
  const int KS = row_stride(a.dp), VS = row_stride(a.dvp);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2;
  const int h = blockIdx.x % a.nh, m = blockIdx.x / a.nh;
  const int T = a.T;
  const size_t row0 = size_t(m) * T;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + L.a);
  bf16* Gs = reinterpret_cast<bf16*>(smem_raw + L.b);
  const int c16 = (min(T, KC) + 15) & ~15;
  float* ms = reinterpret_cast<float*>(smem_raw + L.stat);  // [c16] row max
  float* ds = ms + c16;                                     // [c16] delta
  unsigned char* mine = smem_raw + L.warp + warp * L.per_warp;
  bf16* Kw = reinterpret_cast<bf16*>(mine);
  bf16* Vw = Kw + 16 * KS;
  float* Mc = reinterpret_cast<float*>(Vw + 16 * VS);  // [16 ceil(T / 16)][16] mask columns
  const float* mask =
      a.mask == nullptr ? nullptr : a.mask + size_t(a.mask_heads > 1 ? h : 0) * T * T;
  const size_t srow = (size_t(m) * a.nh + h) * T;
  const float* mrow = a.stats + srow;
  const float* rrow = a.stats + size_t(a.M) * a.nh * T + srow;
  const int nchunks = (T + KC - 1) / KC, ntiles = (T + 15) / 16;
  const int nkv = a.dvp / 16;
  const bf16* gm = a.g + row0 * size_t(a.nh) * a.dvw + size_t(h) * a.dvw;

  int staged = -1;
  auto ensure = [&](int c) {  // every warp calls it, in step
    if (staged == c) return;
    __syncthreads();
    const int i0 = c * KC, n16 = (min(KC, T - i0) + 15) & ~15;
    stage(Qs, KS, a.dp, a.q, a.ldq, row0, i0, n16, T, h * a.dh, a.dh, a.vq, tid, blockDim.x);
    const int pairs = a.dvp / 2;
    for (int idx = tid; idx < n16 * pairs; idx += blockDim.x) {
      const int r = idx / pairs, col = (idx - r * pairs) * 2, i = i0 + r;
      float v0 = 0.f, v1 = 0.f;
      if (i < T) {
        const float ri = rrow[i];
        const bf16* gr = gm + size_t(i) * a.nh * a.dvw;
        if (col < a.dvw) v0 = __bfloat162float(gr[col]) * ri;
        if (col + 1 < a.dvw) v1 = __bfloat162float(gr[col + 1]) * ri;
      }
      *reinterpret_cast<uint32_t*>(Gs + r * VS + col) = pack(v0, v1);
    }
    for (int r = tid; r < n16; r += blockDim.x) {
      const int i = i0 + r;
      ms[r] = i < T ? mrow[i] : 0.f;
      ds[r] = i < T ? a.delta[srow + i] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    staged = c;
  };

  for (int it = 0; it < (ntiles + nw - 1) / nw; ++it) {
    const int j0 = (it * nw + warp) * 16;
    const bool active = j0 < T;
    if (active) {
      __syncwarp();
      stage(Kw, KS, a.dp, a.k, a.ldk, row0, j0, 16, T, h * a.dh, a.dh, a.vk, lane, 32);
      stage(Vw, VS, a.dvp, a.v, a.ldv, row0, j0, 16, T, h * a.dvw, a.dvw, a.vv, lane, 32);
      if constexpr (MM == MASK_STAGED) stage_mask_cols(Mc, mask, T, j0, lane);
      cp_async_wait_all();
      __syncwarp();
    }
    float dk[DPT / 8][4] = {}, dv[DVMAX / 8][4] = {};
    for (int c = 0; c < nchunks; ++c) {
      ensure(c);
      if (!active) continue;
      const int nqb = (min(KC, T - c * KC) + 15) / 16;
      // e and dS of query block qb against this warp's keys
      auto front = [&](int qb, float (&e)[2][4], float (&d)[2][4]) {
        const int i0 = c * KC + qb * 16;
        float S[2][4];
        scores<1, true, MM, DPT / 16>(S, Qs + qb * 16 * KS, Kw, KS, 1, a.dp, T, a.scale, mask,
                                      Mc + i0 * 16, 16, j0, i0, j0, lane);
        // dP' = g' V^T for these queries and keys
        uint32_t F[DVMAX / 16][4];
#pragma unroll
        for (int ks = 0; ks < DVMAX / 16; ++ks)
          if (ks < nkv) ldsm_x4(F[ks], Gs + (qb * 16 + (lane & 15)) * VS + ks * 16 + (lane >> 4) * 8);
        float dp[2][4];
        mma_rows_f<DVMAX / 16>(dp, F, nkv, Vw, VS, 0, lane);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = qb * 16 + g + 8 * (q >> 1);  // the row in the chunk
          const bool live = c * KC + r < T;
          const float mq = ms[r], dq = ds[r];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            e[n][q] = live ? exp_shifted(S[n][q], mq) : 0.f;
            d[n][q] = round_bf16((e[n][q] * (dp[n][q] - dq)) * a.scale);
          }
        }
      };
      // dV += round(e)^T g', dK += dS^T Q
      auto back = [&](int qb, const float (&e)[2][4], const float (&d)[2][4]) {
        uint32_t P[4], PT[4];
        pack_a(P, e[0], e[1]);  // round(e)
        transpose_a(PT, P);
        mma_tile_t<DVMAX / 16>(dv, PT, nkv, Gs, VS, qb * 16, lane);
        pack_a(P, d[0], d[1]);  // dS
        transpose_a(PT, P);
        mma_tile_t<DPT / 16>(dk, PT, a.dp / 16, Qs, KS, qb * 16, lane);
      };
      constexpr int NB = 2;  // (four measured slower here than two on an H100)
      int qb = 0;
      for (; qb + NB <= nqb; qb += NB) {  // NB query blocks at a time: independent chains
        float e[NB][2][4], d[NB][2][4];
#pragma unroll
        for (int b = 0; b < NB; ++b) front(qb + b, e[b], d[b]);
#pragma unroll
        for (int b = 0; b < NB; ++b) back(qb + b, e[b], d[b]);
      }
      for (; qb < nqb; ++qb) {
        float e[2][4], d[2][4];
        front(qb, e, d);
        back(qb, e, d);
      }
    }
    if (active) {
      store_tile<DPT / 8>(a.dk + row0 * size_t(a.nh) * a.dh + size_t(h) * a.dh,
                          size_t(a.nh) * a.dh, dk, j0, T, a.dh, lane);
      store_tile<DVMAX / 8>(a.dv + row0 * size_t(a.nh) * a.dvw + size_t(h) * a.dvw,
                            size_t(a.nh) * a.dvw, dv, j0, T, a.dvw, lane);
    }
  }
}

// Warps an SM holds, as far as shared memory goes, in blocks of nw warps.
int resident_warps(size_t smem, int nw) { return int(SMEM_SM / (smem + 1024)) * nw; }

// The warps of a block (8, 4, 2 or 1) and whether the mask is staged: staged
// with 8 or 4 warps where that fits, whichever keeps more warps on an SM (4
// on a tie: more blocks, whose staging overlaps the others' work), else read
// from global memory. 0 warps: nothing fits.
int plan(const BwdArgs& a, bool keys, bool& staged) {
  staged = a.mask != nullptr;
  if (staged) {
    int best = 0;
    for (int nw = NWMAX; nw >= 4; nw /= 2) {
      const size_t smem = Smem(a, keys, true, nw).total;
      if (smem <= size_t(SMEM_MAX) &&
          (best == 0 || resident_warps(smem, nw) >=
                            resident_warps(Smem(a, keys, true, best).total, best)))
        best = nw;
    }
    if (best > 0) return best;
  }
  staged = false;
  for (int nw = NWMAX; nw >= 1; nw /= 2)
    if (Smem(a, keys, false, nw).total <= size_t(SMEM_MAX)) return nw;
  return 0;
}

template <int DPT, int MM>
int launch_pair(const BwdArgs& a, bool keys, int nw, cudaStream_t stream) {
  auto kernel = keys ? narrowband_attention_bwd_tc_dkdv<DPT, MM> : narrowband_attention_bwd_tc_dq<DPT, MM>;
  const size_t smem = Smem(a, keys, MM == MASK_STAGED, nw).total;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<a.M * a.nh, nw * 32, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <int DPT>
int launch_one(const BwdArgs& a, bool keys, cudaStream_t stream) {
  bool staged;
  const int nw = plan(a, keys, staged);
  if (nw == 0) return int(cudaErrorInvalidValue);
  if (a.mask == nullptr) return launch_pair<DPT, MASK_NONE>(a, keys, nw, stream);
  return staged ? launch_pair<DPT, MASK_STAGED>(a, keys, nw, stream)
                : launch_pair<DPT, MASK_GLOBAL>(a, keys, nw, stream);
}

template <int DPT>
int launch(const BwdArgs& a, cudaStream_t stream) {
  const int err = launch_one<DPT>(a, false, stream);
  return err != 0 ? err : launch_one<DPT>(a, true, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// (dq, dk, dv) of the attention for the cotangent g, in bf16, on `stream`.
// stats: the [2, M, nh, T] row max and 1 / row sum that
// nbss_narrowband_attention_tc_fwd wrote for the same q, k and mask; delta:
// a [M, nh, T] float32 workspace. q, k, v rows lie ldq, ldk, ldv elements
// apart; g, dq, dk, dv are contiguous; mask is null or float32 [mask_heads,
// T, T]. Returns the CUDA error of the launches (0 on success); shapes the
// kernels do not take return cudaErrorInvalidValue without launching.
extern "C" int nbss_narrowband_attention_bwd_tc(const void* q, const void* k, const void* v,
                                                const void* mask, const void* g,
                                                const void* stats, void* dq, void* dk, void* dv,
                                                void* delta, long long ldq, long long ldk,
                                                long long ldv, int M, int T, int nh, int dh,
                                                int dvw, int mask_heads, float scale,
                                                void* stream) {
  if (M < 1 || T < 1 || nh < 1 || dh < 1 || dvw < 1 || dh > DKMAX || dvw > DVMAX ||
      (long long)M * nh > INT_MAX || (mask != nullptr && mask_heads != 1 && mask_heads != nh))
    return int(cudaErrorInvalidValue);
  auto vec = [](const void* p, long long ld, int d) {
    return int(aligned16(p) && ld % 8 == 0 && d % 8 == 0);
  };
  const BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const float*>(mask),
                  static_cast<const bf16*>(g), static_cast<const float*>(stats),
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                  static_cast<float*>(delta), ldq, ldk, ldv, M, T, nh, dh, dvw, mask_heads,
                  (dh + 15) & ~15, (dvw + 15) & ~15, vec(q, ldq, dh), vec(k, ldk, dh),
                  vec(v, ldv, dvw), scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.dp <= 32) return launch<32>(a, s);
  if (a.dp <= 64) return launch<64>(a, s);
  return launch<256>(a, s);
}
