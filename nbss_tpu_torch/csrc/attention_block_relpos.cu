// NBC's attention block with Transformer-XL relative positions, forward, for
// Hopper (sm_90a), float32: fp32 FMA on the CUDA cores, since no tensor-core
// product keeps float32's digits. bf16 inputs take attention_block_relpos_tc.cu
// (bf16 tensor cores).
//
// For each of M sequences x[m] of T frames by H = 192 channels, with the
// folded operands of fold_weights_nbc (per head h: A_h, Wvo_h [H+2, H+2],
// Gs_h, Gc_h [H+2, H/2]; c [H]) and the absolute-position tables sin, cos
// [T, H/2], and rnd() rounding to x's type (the identity in float32, the
// only type this kernel now takes; the points name the Pallas kernel's):
//
//     xa = rnd([LayerNorm(x), 1, 0])
//     t  = rnd(xa rnd(A_h)),  gs = rnd(xa rnd(Gs_h)),  gc = rnd(xa rnd(Gc_h))
//     Aq = rnd(rnd(gs sin_i) + rnd(gc cos_i)),  Bq = rnd(rnd(gc sin_i) - rnd(gs cos_i))
//     s_ij = t_i . xa_j + Aq_i . cos_j + Bq_i . sin_j          (float32)
//     e  = rnd(exp(s - rowmax s)),  vo = rnd(xa rnd(Wvo_h))
//     pv = e vo (float32),  o_h = pv[:, :H] / pv[:, H]          (the ones lane)
//     y  = rnd(((o_0 + o_1 + ...) + c) + x)
//
// with the sin/cos tables rounded to x's type. These are the rounding points
// of the Pallas kernel it replaces: _fused_block_relpos / _kernel_relpos in
// nbss_tpu/ops/attention_block.py. Lane H+1 of xa is 0 for every real frame
// (the Pallas kernel sets it only on padded rows, to mask them with
// A[:, H, H+1] = -1e30), so here the ragged key edge is masked by index and
// lane H+1 never enters a score; t_i[H] multiplies xa_j[H] = 1 and is added
// to each score of row i.
//
// What bounds it on an H100: arithmetic. At NBC's serving shape (M = 16 *
// 257 = 4112, T = 248, 8 heads) the folded function does about 4.2 TFLOP
// (4.2 ms at the 989 TFLOP/s bf16 tensor-core rate) and moves 0.78 GB in
// bf16 (0.23 ms at 3.35 TB/s). This kernel runs it as float32 FMA on the
// CUDA cores, in four kernels per chunk of sequences:
//
//   1. relpos_ln: the key rows [xa_j[:H], rnd(cos_j), rnd(sin_j)] of the
//      chunk into a workspace of x's type (exact, since each value is rounded
//      to that type anyway), a warp per frame;
//   2. relpos_proj: one tiled product P = rnd(xa W) into a second workspace,
//      [rows, nh * 584], where W = rnd([A_h | Gs_h | Gc_h | Wvo_h] for every
//      h) (each head's four parts start on a multiple of 4 columns; relpos_wcat
//      lays it out once a call) and xa's lanes H and H+1 (1 and 0) are
//      supplied by the loader;
//   3. relpos_qpos: Aq and Bq from gs and gc, in place in P;
//   4. relpos_attn: a block per (sequence, 16 query rows), eight threads to a
//      row, walking the heads in order: each thread holds 48 of the 384
//      values of q'_i = [t_i[:H], Aq_i, Bq_i] and 24 of the H output lanes;
//      key rows [xa_j[:H], cos_j, sin_j] and vo_j pass through shared memory
//      16 at a time; a score is the sum of the eight partial dots in one
//      fixed order. A first pass over the keys forms the scores (two keys a
//      step), keeps them in a float32 workspace and finds the row max; a
//      second forms e with the final max from them (so rnd(e) is the Pallas
//      kernel's for any T) and e vo_j; each thread sums its 24 lanes of o_h
//      over the heads in order in a float32 workspace and writes y after the
//      last head.
//
// Rows of a chunk are processed in full before the next chunk, so the
// workspaces hold one chunk (the wrapper sizes it). No atomics: two calls on
// the same inputs give the same bits. H = 192 only; any nh that divides H,
// any T >= 1 and M >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int H = 192;                // channels the kernel is built for
constexpr int HA = H + 2;             // rows (and A / Wvo columns) of the folded operands
constexpr int D2 = H / 2;             // position frequencies
constexpr int KLD = 2 * H;            // row stride of the key workspace: [xa[:H], cos, sin]
constexpr int OGS = HA + 2, OGC = OGS + D2, OVO = OGC + D2;  // head column offsets in P
constexpr int PW = OVO + HA + 2;      // 584: columns of one head in P (t, gs, gc, vo, padded)

// relpos_proj: 128 x 128 output tiles, 16 of K at a time, 256 threads, 8 x 8 each
constexpr int BM = 128, BN = 128, BK = 16, GT = 256;
constexpr int XSLD = BM + 4;          // the X tile's stride: spreads its stores over the banks

// relpos_attn
constexpr int LANES = 8;              // threads per query row
constexpr int QR = 16;                // query rows per block
constexpr int AT = QR * LANES;        // 128 threads
constexpr int KT = 16;                // keys staged at a time
constexpr int SW = 2 * H / LANES;     // 48 score values per thread
constexpr int SWS = SW + 4;           // stride of a thread's chunk of a staged key row
constexpr int VW = H / LANES;         // 24 output lanes per thread
constexpr int VWS = VW + 4;           // stride of a thread's chunk of a staged vo row
static_assert(SW % 4 == 0 && VW % 4 == 0, "chunks are read as float4");
static_assert(KT == 2 * LANES, "pass 2 forms a tile's e two keys a thread");

template <typename E> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Key rows xk = [rnd(LayerNorm(x)), rnd(cos_t), rnd(sin_t)] for `rows`
// frames of a chunk (frame t = row % T), a warp per frame.
template <typename E>
__global__ void __launch_bounds__(256) relpos_ln(const E* __restrict__ x,
                                                 const float* __restrict__ ln,
                                                 const float* __restrict__ sin,
                                                 const float* __restrict__ cos,
                                                 E* __restrict__ xk, int rows, int T, float eps) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (warp >= rows) return;
  const E* xr = x + size_t(warp) * H;
  float v[H / 32];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < H / 32; ++k) {
    v[k] = Elem<E>::load(xr + lane + 32 * k);
    s += v[k];
  }
  const float mu = warp_sum(s) / H;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < H / 32; ++k) {
    v[k] -= mu;
    q += v[k] * v[k];
  }
  const float rs = rsqrtf(warp_sum(q) / H + eps);
  E* out = xk + size_t(warp) * KLD;
  const size_t t = size_t(warp % T) * D2;
#pragma unroll
  for (int k = 0; k < H / 32; ++k) {
    const int col = lane + 32 * k;
    Elem<E>::store(out + col, v[k] * rs * ln[col] + ln[H + col]);
    Elem<E>::store(out + H + col, col < D2 ? cos[t + col] : sin[t + col - D2]);
  }
}

// Four values of a row at p (16-byte aligned) as float4.
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// W[k][col] = rnd(the folded weight) for the nh * PW columns of P: column
// h * PW + cc is A_h[k, cc], Gs_h, Gc_h or Wvo_h by the offsets above, and 0 in
// the two pad columns after A_h and after Wvo_h. Once per call, for relpos_proj.
template <typename E>
__global__ void __launch_bounds__(256) relpos_wcat(const float* __restrict__ A,
                                                   const float* __restrict__ Gs,
                                                   const float* __restrict__ Gc,
                                                   const float* __restrict__ Wvo,
                                                   float* __restrict__ W, int nh) {
  const int ncols = nh * PW;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= HA * ncols) return;
  const int k = idx / ncols, col = idx % ncols, h = col / PW, cc = col % PW;
  float w = 0.f;
  if (cc < HA) w = A[(size_t(h) * HA + k) * HA + cc];
  else if (cc < OGS) w = 0.f;
  else if (cc < OGC) w = Gs[(size_t(h) * HA + k) * D2 + cc - OGS];
  else if (cc < OVO) w = Gc[(size_t(h) * HA + k) * D2 + cc - OGC];
  else if (cc < OVO + HA) w = Wvo[(size_t(h) * HA + k) * HA + cc - OVO];
  W[idx] = Elem<E>::round(w);
}

// P[rows, ncols] = rnd(xa[rows, HA] W), xa = [xk[:, :H], 1, 0]: a tiled float32
// product, each thread an 8 x 8 block of outputs (two 4-row by two 4-column
// quads), the K sum in one fixed order; two shared-memory buffers, the next K
// slice fetched into registers while the current one is used.
template <typename E>
__global__ void __launch_bounds__(GT, 2) relpos_proj(const E* __restrict__ xk,
                                                     const float* __restrict__ W,
                                                     E* __restrict__ P, int rows, int ncols) {
  __shared__ __align__(16) float xs[2][BK][XSLD];
  __shared__ __align__(16) float ws[2][BK][BN];
  constexpr int NX = BM * BK / GT, NW = BN * BK / GT;  // values a thread fetches a slice
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t r0 = size_t(blockIdx.y) * BM;
  const int c0 = blockIdx.x * BN;
  float xr[NX], wr[NW];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int n = 0; n < NX; ++n) {
      const int e = tid + n * GT, m = e / BK, kk = k0 + e % BK;
      xr[n] = r0 + m >= size_t(rows) || kk > H ? 0.f
              : kk == H                        ? 1.f
                                               : Elem<E>::load(xk + (r0 + m) * KLD + kk);
    }
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const int e = tid + n * GT, kk = k0 + e / BN, c = c0 + e % BN;
      wr[n] = c < ncols && kk < HA ? W[size_t(kk) * ncols + c] : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int n = 0; n < NX; ++n) {
      const int e = tid + n * GT;
      xs[buf][e % BK][e / BK] = xr[n];
    }
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const int e = tid + n * GT;
      ws[buf][e / BN][e % BN] = wr[n];
    }
  };
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int k0 = 0, buf = 0; k0 < HA; k0 += BK, buf ^= 1) {
    if (k0 + BK < HA) fetch(k0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[buf][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    if (k0 + BK < HA) stash(buf ^ 1);  // the other buffer: its last readers passed the sync below
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const size_t r = r0 + (a < 4 ? ty * 4 + a : 64 + ty * 4 + a - 4);
    if (r >= size_t(rows)) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int c = c0 + (b < 4 ? tx * 4 + b : 64 + tx * 4 + b - 4);
      if (c < ncols) Elem<E>::store(P + r * ncols + c, acc[a][b]);
    }
  }
}

// In P, each head's gs and gc columns become Aq = rnd(rnd(gs sin_i) + rnd(gc cos_i))
// and Bq = rnd(rnd(gc sin_i) - rnd(gs cos_i)), elementwise in E as the Pallas kernel
// rounds them, with the rounded tables of the key rows (frame i = row % T).
template <typename E>
__global__ void __launch_bounds__(256) relpos_qpos(E* __restrict__ P, const E* __restrict__ xk,
                                                   int rows, int nh) {
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= size_t(rows) * nh * D2) return;
  const int f = idx % D2, h = (idx / D2) % nh;
  const size_t r = idx / D2 / nh;
  E* p = P + r * nh * PW + size_t(h) * PW;
  const float gs = Elem<E>::load(p + OGS + f), gc = Elem<E>::load(p + OGC + f);
  const float co = Elem<E>::load(xk + r * KLD + H + f), si = Elem<E>::load(xk + r * KLD + H + D2 + f);
  Elem<E>::store(p + OGS + f, Elem<E>::round(__fadd_rn(Elem<E>::round(__fmul_rn(gs, si)),
                                                       Elem<E>::round(__fmul_rn(gc, co)))));
  Elem<E>::store(p + OGC + f, Elem<E>::round(__fsub_rn(Elem<E>::round(__fmul_rn(gc, si)),
                                                       Elem<E>::round(__fmul_rn(gs, co)))));
}

struct AttnArgs {
  const void* x;     // [mc, T, H] of this chunk
  const void* xk;    // [mc * T, KLD] key rows
  const void* P;     // [mc * T, nh * PW]
  const float* c;    // [H]
  void* y;           // [mc, T, H]
  float* acc;        // [mc * T, H]: the sum of the heads so far, float32
  float* s;          // [mc * T, T]: one head's scores, float32
  int T, nh;
};

template <typename E>
__global__ void __launch_bounds__(AT, 4) relpos_attn(const AttnArgs a) {
  __shared__ __align__(16) float sk[KT][LANES * SWS];  // key rows [xa_j[:H], cos_j, sin_j]
  __shared__ __align__(16) float sv[KT][LANES * VWS];  // vo_j[:H]
  __shared__ float sden[KT];                           // vo_j[H], the ones lane
  static_assert(KT % 2 == 0, "pass 1 takes keys two at a time");
  const int ntiles = (a.T + QR - 1) / QR;
  const int tile = blockIdx.x % ntiles, m = blockIdx.x / ntiles;
  const int tid = threadIdx.x, lane = tid % LANES, row = tid / LANES;
  const int i = tile * QR + row;
  const bool live = i < a.T;
  const size_t row0 = size_t(m) * a.T;
  const size_t ldp = size_t(a.nh) * PW;
  const E* xk = static_cast<const E*>(a.xk);
  const E* P = static_cast<const E*>(a.P);
  float* acc = a.acc + (row0 + (live ? i : 0)) * H + lane * VW;  // this thread's 24 lanes

  for (int h = 0; h < a.nh; ++h) {
    // this thread's 48 values of q'_i = [t_i[:H], Aq_i, Bq_i] (Aq and Bq lie where
    // relpos_qpos left them, in P's gs and gc columns), and t_i[H]
    const E* pq = P + (row0 + (live ? i : 0)) * ldp + size_t(h) * PW;
    const E* qsrc = pq + (lane < H / SW ? lane * SW : OGS + (lane - H / SW) * SW);
    float qr[SW];
#pragma unroll
    for (int d = 0; d < SW; d += 4) {
      const float4 v = live ? load4(qsrc + d) : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[d] = v.x;
      qr[d + 1] = v.y;
      qr[d + 2] = v.z;
      qr[d + 3] = v.w;
    }
    const float tH = live ? Elem<E>::load(pq + H) : 0.f;

    // pass 1: the scores, two keys at a time (two independent chains of products and
    // shuffles), kept in the score workspace, and the row max
    float* sr = a.s + (row0 + (live ? i : 0)) * a.T;  // this row's scores
    float mx = -INFINITY;
    for (int j0 = 0; j0 < a.T; j0 += KT) {
      const int kc = min(KT, a.T - j0);
      __syncthreads();  // the previous tile is consumed
      for (int idx = tid; idx < KT * KLD / 4; idx += AT) {
        const int jj = idx / (KLD / 4), col = 4 * (idx % (KLD / 4));
        const float4 v = jj < kc ? load4(xk + (row0 + j0 + jj) * KLD + col)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(&sk[jj][(col / SW) * SWS + col % SW]) = v;
      }
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < kc; j += 2) {
        const bool two = j + 1 < kc;  // key j + 1 of a ragged tile is staged as zeros
        const float4* k0 = reinterpret_cast<const float4*>(&sk[j][lane * SWS]);
        const float4* k1 = reinterpret_cast<const float4*>(&sk[j + 1][lane * SWS]);
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll
        for (int d = 0; d < SW; d += 4) {
          const float4 u = k0[d / 4], w = k1[d / 4];
          a0 = fmaf(qr[d], u.x, a0);
          a1 = fmaf(qr[d + 1], u.y, a1);
          a2 = fmaf(qr[d + 2], u.z, a2);
          a3 = fmaf(qr[d + 3], u.w, a3);
          b0 = fmaf(qr[d], w.x, b0);
          b1 = fmaf(qr[d + 1], w.y, b1);
          b2 = fmaf(qr[d + 2], w.z, b2);
          b3 = fmaf(qr[d + 3], w.w, b3);
        }
        float s0 = (a0 + a1) + (a2 + a3), s1 = (b0 + b1) + (b2 + b3);
#pragma unroll
        for (int o = 1; o < LANES; o <<= 1) {  // the row's eight partials, by a butterfly:
          // ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)) in each of its threads (float
          // addition commutes), for both keys at once
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        s0 += tH;
        s1 += tH;
        mx = fmaxf(mx, s0);
        if (two) mx = fmaxf(mx, s1);
        if (live && lane == 0) {
          sr[j0 + j] = s0;
          if (two) sr[j0 + j + 1] = s1;
        }
      }
    }

    // pass 2: rnd(e) with the final max, pv and its ones lane, from the kept scores
    float den = 0.f, pv[VW];
#pragma unroll
    for (int d = 0; d < VW; ++d) pv[d] = 0.f;
    for (int j0 = 0; j0 < a.T; j0 += KT) {
      const int kc = min(KT, a.T - j0);
      __syncthreads();  // the previous tile is consumed; the scores are written
      for (int idx = tid; idx < KT * H / 4; idx += AT) {
        const int jj = idx / (H / 4), col = 4 * (idx % (H / 4));
        const float4 v = jj < kc ? load4(P + (row0 + j0 + jj) * ldp + size_t(h) * PW + OVO + col)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(&sv[jj][(col / VW) * VWS + col % VW]) = v;
      }
      if (tid < KT)
        sden[tid] = tid < kc ? Elem<E>::load(P + (row0 + j0 + tid) * ldp + size_t(h) * PW + OVO + H)
                             : 0.f;
      __syncthreads();
      // rnd(e) of keys j0 + lane and j0 + LANES + lane, one exp a thread; each key's
      // from its thread by a shuffle within the row's eight
      const float eA = live && lane < kc ? Elem<E>::round(expf(sr[j0 + lane] - mx)) : 0.f;
      const float eB =
          live && LANES + lane < kc ? Elem<E>::round(expf(sr[j0 + LANES + lane] - mx)) : 0.f;
#pragma unroll 2
      for (int j = 0; j < kc; ++j) {
        const float e = __shfl_sync(0xffffffffu, j < LANES ? eA : eB, j % LANES, LANES);
        const float4* v4 = reinterpret_cast<const float4*>(&sv[j][lane * VWS]);
#pragma unroll
        for (int d = 0; d < VW; d += 4) {
          const float4 u = v4[d / 4];
          pv[d] = fmaf(e, u.x, pv[d]);
          pv[d + 1] = fmaf(e, u.y, pv[d + 1]);
          pv[d + 2] = fmaf(e, u.z, pv[d + 2]);
          pv[d + 3] = fmaf(e, u.w, pv[d + 3]);
        }
        den = fmaf(e, sden[j], den);
      }
    }
    // o_h = pv / den, summed over the heads in order; after the last, y
    if (live) {
      if (h + 1 < a.nh) {
#pragma unroll
        for (int d = 0; d < VW; ++d) acc[d] = h == 0 ? pv[d] / den : acc[d] + pv[d] / den;
      } else {
        const E* xr = static_cast<const E*>(a.x) + (row0 + i) * H + lane * VW;
        E* yr = static_cast<E*>(a.y) + (row0 + i) * H + lane * VW;
#pragma unroll
        for (int d = 0; d < VW; ++d) {
          const float sum = h == 0 ? pv[d] / den : acc[d] + pv[d] / den;
          Elem<E>::store(yr + d, (sum + a.c[lane * VW + d]) + Elem<E>::load(xr + d));
        }
      }
    }
  }
}

template <typename E>
int launch(const E* x, const float* ln, const float* A, const float* Gs, const float* Gc,
           const float* Wvo, const float* c, const float* sin, const float* cos, E* y, E* xk,
           E* P, float* acc, float* S, float* W, int M, int T, int nh, int chunk, float eps,
           cudaStream_t stream) {
  const int ncols = nh * PW;
  relpos_wcat<E><<<(HA * ncols + 255) / 256, 256, 0, stream>>>(A, Gs, Gc, Wvo, W, nh);
  if (const int err = int(cudaGetLastError())) return err;
  for (int m0 = 0; m0 < M; m0 += chunk) {
    const int mc = M - m0 < chunk ? M - m0 : chunk;
    const int rows = mc * T;
    const E* xc = x + size_t(m0) * T * H;
    relpos_ln<E><<<(rows + 7) / 8, 256, 0, stream>>>(xc, ln, sin, cos, xk, rows, T, eps);
    int err = int(cudaGetLastError());
    if (err != 0) return err;
    const dim3 grid((ncols + BN - 1) / BN, (rows + BM - 1) / BM);
    relpos_proj<E><<<grid, GT, 0, stream>>>(xk, W, P, rows, ncols);
    err = int(cudaGetLastError());
    if (err != 0) return err;
    const long long npos = (long long)rows * nh * D2;
    relpos_qpos<E><<<int((npos + 255) / 256), 256, 0, stream>>>(P, xk, rows, nh);
    err = int(cudaGetLastError());
    if (err != 0) return err;
    const AttnArgs args{xc, xk, P, c, y + size_t(m0) * T * H, acc, S, T, nh};
    relpos_attn<E><<<mc * ((T + QR - 1) / QR), AT, 0, stream>>>(args);
    err = int(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// y = the folded NBC attention block of x, on `stream`. x, y [M, T, H], the
// workspaces xk [chunk * T, 2H], P [chunk * T, nh * 584], acc [chunk * T,
// H], S [chunk * T, T] and W [H+2, nh * 584], ln [2, H], A, Wvo [nh, H+2,
// H+2], Gs, Gc [nh, H+2, H/2], c [H], sin, cos [T, H/2]: float32,
// contiguous (bf16 inputs take attention_block_relpos_tc.cu).
// Sequences are processed `chunk` at a time. Returns the CUDA error of the
// launches (0 on success).
extern "C" int nbss_attention_block_relpos_fwd(const void* x, const void* ln, const void* A,
                                               const void* Gs, const void* Gc, const void* Wvo,
                                               const void* c, const void* sin, const void* cos,
                                               void* y, void* xk, void* P, void* acc, void* S,
                                               void* W, int M, int T, int Hx, int nh, int chunk,
                                               float eps, void* stream) {
  if (M < 1 || T < 1 || Hx != H || nh < 1 || H % nh != 0 || chunk < 1 ||
      (long long)chunk * T * nh * PW > (1LL << 62) || (long long)chunk * ((T + QR - 1) / QR) > 2147483647LL)
    return int(cudaErrorInvalidValue);
  return launch<float>(static_cast<const float*>(x), static_cast<const float*>(ln),
                       static_cast<const float*>(A), static_cast<const float*>(Gs),
                       static_cast<const float*>(Gc), static_cast<const float*>(Wvo),
                       static_cast<const float*>(c), static_cast<const float*>(sin),
                       static_cast<const float*>(cos), static_cast<float*>(y),
                       static_cast<float*>(xk), static_cast<float*>(P), static_cast<float*>(acc),
                       static_cast<float*>(S), static_cast<float*>(W), M, T, nh, chunk, eps,
                       static_cast<cudaStream_t>(stream));
}

// Columns of one head in the projection workspace P.
extern "C" int nbss_attention_block_relpos_head_cols() { return PW; }

// Row stride of the key workspace xk.
extern "C" int nbss_attention_block_relpos_key_cols() { return KLD; }
