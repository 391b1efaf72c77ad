// Narrow-band attention block, forward and backward, on Hopper's bf16 tensor
// cores (sm_90a, mma.sync), for the shapes attention_block_tc.cu and
// attention_block_bwd_tc.cu cannot hold: H = 192 (SpatialNet-large,
// NBC2-large) at any T, and H = 96 at T > 256. Those two keep H = 96 with T
// <= 256; float32 inputs at these shapes take attention_block_wide.cu.
//
// Replaces, for bf16 inputs, the Pallas TPU kernels _fused_block / _kernel
// and _fused_block_bwd / _bwd_kernel in nbss_tpu/ops/attention_block.py (which
// pad T to a multiple of 128 and mask the padding through the pad lane; here
// the ragged key edge is masked by index). The rounding points are those of
// ops/attention_block.py reference and reference_bwd:
//
//   forward:  xa, t = xa A_h, vo = xa Wvo_h and e = exp(s - rowmax s) rounded
//             to bf16; pv summed in float32 and divided by the float32 sum of
//             the rounded e; the heads summed in float32 in head order; y =
//             rnd(acc + c + x).
//   backward: t, vo, g' = rnd(g / sum(e)) with the sum of the UNROUNDED e (the
//             backward's own statistics, not the forward's), rnd(e) where it
//             meets g', dvo, dS = rnd(e (dP - delta)) with delta = sum(dP e) /
//             sum(e) over the unrounded e, and dt rounded; dP, delta, dxa and
//             the weight cotangents float32.
//
// What bounds it on an H100: arithmetic. At SpatialNet-large's serving shape
// (M = 2064, T = 251, H = 192, 4 heads) the folded forward is about 0.7
// TFLOP (a 0.72 ms floor at 989 TFLOP/s), x and y 398 MB (0.12 ms).
//
// The design is that of attention_block_relpos_tc.cu without the position
// terms. Shared memory cannot hold a sequence's xa, t and vo tiles at H = 192
// ([256, 192] bf16 is 100 KB each), so the operands go through device memory
// once, as bf16 rows, and the attention streams them in 32-row tiles:
//
//   wide_keys   xa = rnd(LN(x)) rows [rows, H + 16] (lane H = 1, the rest 0)
//               and every head's t[:, H] = rnd(xa . A_h[:, H] + A_h[H, H]),
//               a warp per frame.
//   wide_proj   one tensor-core product of xa by every head's [A_h | Wvo_h]
//               columns (2H a head; row H of each added as a float32 bias),
//               a block of 16 warps holding 256 rows of xa in registers and
//               streaming the columns H / 3 at a time; t[:, :H] and vo rows out.
//   wide_attn   a persistent grid over (sequence, 128 queries), a warp a
//               16-query tile with its t fragments in registers, walking the
//               heads in order: pass 1 streams key tiles and keeps each
//               thread's own scores (in its warp's slice of shared memory up
//               to T = 384, in a global workspace beyond), so the row max is
//               exact before any e is formed; pass 2 streams vo tiles and forms
//               rnd(e) straight into the A fragments of pv = e vo. The head sum
//               lives in a per-block float32 slot; y is written at the last head.
//
// The backward reuses wide_keys and wide_proj, then:
//
//   wide_bwd_query  per (sequence, 128 queries) and head: pass 1 the kept
//               scores and exact row max, their sum of exp (unrounded), g';
//               pass 2 streams vo for delta; pass 3 streams vo and xa, forms
//               dS and dt = dS xa (dt[:, H] the row sum of dS). Writes g', the
//               row max, delta and the dt rows.
//   wide_bwd_key    per (sequence, 128 keys) and head, a warp a 16-key tile
//               with its xa fragments in registers, streaming t and g' tiles
//               of the queries twice: dvo = rnd(e)^T g', then dS^T t into the
//               float32 dxa (the same thread owns the same elements in every
//               head, so no barrier or atomic).
//   wide_bwd_dxa    dxa += dt A_h^T + dt[:, H] A_h[:H, H] + dvo Wvo_h^T.
//   wide_ln_bwd     the LayerNorm adjoint: dx, and dln, dc per block.
//   attention_block_bwd_weights / _reduce (attention_block_tc.cuh, shared with
//               attention_block_bwd_tc.cu)   dA_h = xa^T dt, dWvo_h = xa^T dvo
//               over fixed row slices, every float32 partial summed in a
//               fixed order.
//
// No atomics anywhere: two launches give the same bits. H = 96 or 192; any nh
// that divides H, T >= 1 and M >= 1.

#include <algorithm>

#include "attention_block_tc.cuh"

namespace {

using namespace nbss_mma;
using nbss_block::attention_block_tc_prep;
using nbss_block::bf16;
using nbss_block::load_a;
using nbss_block::LOG2E;
using nbss_block::mma_rows;
using nbss_block::mma_tile_t;
using nbss_block::stage_weights;
using nbss_block::warp_sum;
using nbss_block::Width;

constexpr int NT = 256;                // threads of the attention blocks
constexpr int NW = NT / 32;
constexpr int QT = NW;                 // 16-row tiles a block, a warp each
constexpr int KT = 32;                 // rows a streamed stage
constexpr int KU = KT / 16;            // 16-row blocks a stage
constexpr int PW = 16;                 // warps of a projection block, 16 rows each
constexpr int PM = PW * 16;            // rows a projection block
constexpr int SMEM_MAX = 232448;

template <int H_>
struct Wide : Width<H_> {
  static constexpr int H = H_;
  using Width<H_>::LS;
  static constexpr int XW = H + 16;           // xa and dt rows: lane H, then zeros
  static constexpr int PN = H / 3;            // projection columns a stage
  static constexpr int SPP = H / PN;          // stages a part (t or vo) of a head
  static constexpr int ST_HEAD = 2 * SPP;     // stages a head
  static constexpr int OLS = PN + 8;          // row stride of a warp's output stage
  static constexpr int PROJ_SMEM = (PM + 2 * PN) * LS * 2 + PW * 16 * OLS * 2;
  static constexpr int TILE = KT * LS;        // bf16 elements of a streamed tile
  static constexpr int QSTAGE = 16 * LS * 2;  // bytes of a warp's staged 16-row tile
  static constexpr int WTS = Width<H_>::WTS_PER_HEAD, VEC = Width<H_>::VEC_PER_HEAD;
  static constexpr int AT_N = Width<H_>::AT_N;
  static constexpr int GROWS = 32;            // rows the weight product stages at a time
  static_assert(H % 48 == 0 && PN % 16 == 0, "three column stages a part, 16-column blocks");
  static_assert(PROJ_SMEM <= SMEM_MAX, "over the 227 KB a block may use");
  static_assert((OLS / 8) % 2 == 1, "odd 16-byte rows");
};

size_t align256(size_t b) { return (b + 255) & ~size_t(255); }

// Rows j0 .. j0 + KT - 1 of a [*][stride] bf16 matrix (first H columns) into
// a shared [KT][LS] tile; rows >= T zero. All threads of the block.
template <int H>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, size_t stride, int j0,
                                           int T, int tid, uint64_t pol) {
  constexpr int LS = Wide<H>::LS;
  for (int idx = tid; idx < KT * (H / 8); idx += NT) {
    const int r = idx / (H / 8), cc = (idx % (H / 8)) * 8, j = j0 + r;
    if (j < T)
      cp_async16_ef(dst + r * LS + cc, src + size_t(j) * stride + cc, pol);
    else
      *reinterpret_cast<uint4*>(dst + r * LS + cc) = make_uint4(0, 0, 0, 0);
  }
}

// The same for a warp's 16 rows r0 .. r0 + 15.
template <int H>
__device__ __forceinline__ void stage_rows16(bf16* dst, const bf16* src, size_t stride, int r0,
                                             int T, int lane, uint64_t pol) {
  constexpr int LS = Wide<H>::LS;
  for (int idx = lane; idx < 16 * (H / 8); idx += 32) {
    const int r = idx / (H / 8), cc = (idx % (H / 8)) * 8;
    if (r0 + r < T)
      cp_async16_ef(dst + r * LS + cc, src + size_t(r0 + r) * stride + cc, pol);
    else
      *reinterpret_cast<uint4*>(dst + r * LS + cc) = make_uint4(0, 0, 0, 0);
  }
}

// xa rows [rows][XW] = [rnd(LN(x)), 1, 0 ...] and tq[h][row] = t[:, H] =
// rnd(xa . rnd(A_h[:H, H]) + rnd(A_h[H, H])) for every head, a warp per frame.
template <int H>
__global__ void __launch_bounds__(256) wide_keys(const bf16* __restrict__ x,
                                                 const float* __restrict__ ln,
                                                 const float* __restrict__ vecs,
                                                 bf16* __restrict__ xk, float* __restrict__ tq,
                                                 int rows, int nh, float eps) {
  using W = Wide<H>;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (warp >= rows) return;
  const bf16* xr = x + size_t(warp) * H;
  float v[H / 32];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < H / 32; ++k) {
    v[k] = __bfloat162float(xr[lane + 32 * k]);
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
  bf16* out = xk + size_t(warp) * W::XW;
#pragma unroll
  for (int k = 0; k < H / 32; ++k) {
    const int col = lane + 32 * k;
    v[k] = round_bf16(v[k] * rs * ln[col] + ln[H + col]);
    out[col] = __float2bfloat16(v[k]);
  }
  if (lane < W::XW - H) out[H + lane] = __float2bfloat16(lane == 0 ? 1.f : 0.f);
  for (int h = 0; h < nh; ++h) {
    const float* abias = vecs + size_t(h) * W::VEC;
    const float* acol = abias + W::AT_N + H;
    float d = 0.f;
#pragma unroll
    for (int k = 0; k < H / 32; ++k) d = fmaf(v[k], acol[lane + 32 * k], d);
    d = warp_sum(d);
    if (lane == 0) tq[size_t(h) * rows + warp] = round_bf16(d + abias[H]);
  }
}

struct ProjArgs {
  const bf16* xk;     // [rows][XW]
  const bf16* wts;    // the prep kernel's bf16 weights
  const float* vecs;  // and float32 vectors
  bf16* qw;           // [nh][rows][H]: t[:, :H]
  bf16* vw;           // [nh][rows][H]: vo[:, :H]
  int rows, nh;
};

// t = rnd(xa A_h + A_h[H]) and vo = rnd(xa Wvo_h + Wvo_h[H]) for every head:
// xa (256 rows a block) in registers, the columns staged PN at a time
// (double-buffered cp.async, each block starting at another stage), each
// warp's rounded [16, PN] outputs written out as whole rows through shared
// memory.
template <int H>
__global__ void __launch_bounds__(PW * 32, 1) wide_proj(const ProjArgs a) {
  using W = Wide<H>;
  constexpr int LS = W::LS, PN = W::PN, OLS = W::OLS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* XS = reinterpret_cast<bf16*>(smem_raw);  // [PM][LS] xa rows
  bf16* WS = XS + PM * LS;                       // [2][PN][LS] weight columns
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  bf16* OS = WS + 2 * PN * LS + warp * 16 * OLS;  // [16][OLS] this warp's outputs
  const int r0 = blockIdx.x * PM;
  const int nct = a.nh * W::ST_HEAD;

  auto stage_w = [&](int ct, int buf) {
    const int h = ct / W::ST_HEAD, part = (ct % W::ST_HEAD) / W::SPP, j = ct % W::SPP;
    const bf16* src = a.wts + size_t(h) * W::WTS + (part ? W::AT_N * H : 0) + size_t(j) * PN * H;
    bf16* dst = WS + buf * PN * LS;
    for (int idx = tid; idx < PN * (H / 8); idx += PW * 32) {
      const int r = idx / (H / 8), c = (idx % (H / 8)) * 8;
      cp_async16(dst + r * LS + c, src + size_t(r) * H + c);
    }
  };
  for (int idx = tid; idx < PM * (H / 8); idx += PW * 32) {
    const int r = idx / (H / 8), c = (idx % (H / 8)) * 8;
    if (r0 + r < a.rows)
      cp_async16(XS + r * LS + c, a.xk + size_t(r0 + r) * W::XW + c);
    else
      *reinterpret_cast<uint4*>(XS + r * LS + c) = make_uint4(0, 0, 0, 0);
  }
  stage_w(blockIdx.x % nct, 0);
  cp_async_wait_all();
  __syncthreads();
  uint32_t F[H / 16][4];
  load_a<H>(F, XS, warp * 16, lane);

  for (int it = 0; it < nct; ++it) {
    const int buf = it & 1, ct = (blockIdx.x + it) % nct;
    if (it > 0) {
      cp_async_wait_all();
      __syncthreads();  // stage it is in; every warp is done with stage it - 1
    }
    if (it + 1 < nct) stage_w((blockIdx.x + it + 1) % nct, buf ^ 1);
    float c[PN / 16][2][4];
    mma_rows<PN / 16, false, H>(c, F, WS + buf * PN * LS, 0, lane);
    const int h = ct / W::ST_HEAD, part = (ct % W::ST_HEAD) / W::SPP, j = ct % W::SPP;
    const float* bias = a.vecs + size_t(h) * W::VEC + (part ? W::AT_N : 0);
#pragma unroll
    for (int u = 0; u < PN / 16; ++u)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int cl = u * 16 + n * 8 + 2 * t4, col = j * PN + cl;
        const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<uint32_t*>(OS + (g4 + 8 * hf) * OLS + cl) =
              pack(c[u][n][2 * hf] + b0, c[u][n][2 * hf + 1] + b1);
      }
    __syncwarp();
    bf16* dst0 = (part ? a.vw : a.qw) + size_t(h) * a.rows * H + j * PN;
#pragma unroll
    for (int i = 0; i < 16 * PN / 8 / 32; ++i) {
      const int idx = lane + 32 * i, rl = idx / (PN / 8), ch = idx % (PN / 8);
      const int r = r0 + warp * 16 + rl;
      if (r < a.rows)
        *reinterpret_cast<uint4*>(dst0 + size_t(r) * H + ch * 8) =
            *reinterpret_cast<const uint4*>(OS + rl * OLS + ch * 8);
    }
    __syncwarp();
  }
}

// The kept scores: a warp's 16 rows by every key, each thread its own C
// fragments, in the warp's slice of shared memory when every slice fits
// beside `fixed` bytes of staged tiles, else in a global workspace.
__host__ __device__ inline int keys_padded(int T) { return (T + KT - 1) / KT * KT; }

template <int H>
bool scores_in_smem(int T, int fixed) {
  return fixed + QT * std::max<size_t>(Wide<H>::QSTAGE, size_t(keys_padded(T)) * 64) <= SMEM_MAX;
}

template <int H>
int region_bytes(int T, int fixed) {
  return scores_in_smem<H>(T, fixed) ? std::max(Wide<H>::QSTAGE, keys_padded(T) * 64)
                                     : Wide<H>::QSTAGE;
}

__device__ __forceinline__ float4* kept(float* sc, int kt, int u, int n, int lane) {
  return reinterpret_cast<float4*>(sc + (((kt * KU + u) * 2 + n) * 32 + lane) * 4);
}

struct AttnArgs {
  const bf16* xk;   // [rows][XW] this chunk's xa rows
  const bf16* qw;   // [nh][rows][H]
  const float* tq;  // [nh][rows]
  const bf16* vw;   // [nh][rows][H]
  const bf16* x;    // [mc][T][H] this chunk's input
  const float* c;   // [H]
  bf16* y;          // [mc][T][H]
  float* acc;       // [gridDim.x][QT * 16][H] head sums
  float* sg;        // [gridDim.x][QT][Tk * 16] kept scores, or null
  int mc, T, nh, rows, region;
};

template <int H>
__global__ void __launch_bounds__(NT, 1) wide_attn(const AttnArgs a) {
  using W = Wide<H>;
  constexpr int LS = W::LS, TILE = W::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* KB = reinterpret_cast<bf16*>(smem_raw);  // [2][TILE] key or vo tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  unsigned char* mine = smem_raw + 2 * TILE * 2 + size_t(warp) * a.region;
  bf16* QS = reinterpret_cast<bf16*>(mine);  // [16][LS] this warp's t tile
  const int T = a.T;
  const int nkt = keys_padded(T) / KT;
  float* sc = a.sg ? a.sg + (size_t(blockIdx.x) * QT + warp) * keys_padded(T) * 16
                   : reinterpret_cast<float*>(mine);
  const int ntile = (T + 15) / 16, ngroups = (ntile + QT - 1) / QT;
  float* acc = a.acc + (size_t(blockIdx.x) * QT * 16 + warp * 16) * H;
  const uint64_t pol = evict_first();

  for (int item = blockIdx.x; item < a.mc * ngroups; item += gridDim.x) {
    const int m = item / ngroups, qt = (item % ngroups) * QT + warp;
    const bool active = qt < ntile;  // warp-uniform
    const int q0 = qt * 16;
    const size_t rb = size_t(m) * T;
    for (int h = 0; h < a.nh; ++h) {
      const bf16* qh = a.qw + (size_t(h) * a.rows + rb) * H;
      const bf16* vh = a.vw + (size_t(h) * a.rows + rb) * H;
      __syncthreads();  // the last head is done with the key buffers and the warp slices
      if (active) stage_rows16<H>(QS, qh, H, q0, T, lane, pol);
      stage_tile<H>(KB, a.xk + rb * W::XW, W::XW, 0, T, tid, pol);
      float cq[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = q0 + g4 + 8 * hf;
        cq[hf] = active && i < T ? a.tq[size_t(h) * a.rows + rb + i] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();
      uint32_t QF[H / 16][4];
      if (active) load_a<H>(QF, QS, 0, lane);
      __syncwarp();  // the t tile is in registers; the slice now keeps scores

      // pass 1: the scores of every key, kept, and the row max
      float mx[2] = {-INFINITY, -INFINITY};
      for (int kt = 0; kt < nkt; ++kt) {
        if (kt > 0) {
          cp_async_wait_all();
          __syncthreads();
        }
        if (kt + 1 < nkt)
          stage_tile<H>(KB + ((kt + 1) & 1) * TILE, a.xk + rb * W::XW, W::XW, (kt + 1) * KT, T,
                        tid, pol);
        if (!active) continue;
        float s[KU][2][4];
        mma_rows<KU, false, H>(s, QF, KB + (kt & 1) * TILE, 0, lane);
#pragma unroll
        for (int u = 0; u < KU; ++u)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = kt * KT + u * 16 + n * 8 + 2 * t4 + (e & 1);
              s[u][n][e] = j < T ? s[u][n][e] + cq[e >> 1] : -INFINITY;
              mx[e >> 1] = fmaxf(mx[e >> 1], s[u][n][e]);
            }
            *kept(sc, kt, u, n, lane) = make_float4(s[u][n][0], s[u][n][1], s[u][n][2], s[u][n][3]);
          }
      }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);

      // pass 2: e = rnd(exp(s - m)) from the kept scores, pv = e vo and sum(e)
      __syncthreads();  // every warp is done with the last key tile
      stage_tile<H>(KB, vh, H, 0, T, tid, pol);
      const bool first = h == 0, last = h == a.nh - 1;
      float O[H / 8][4];
#pragma unroll
      for (int n = 0; n < H / 8; ++n) O[n][0] = O[n][1] = O[n][2] = O[n][3] = 0.f;
      float l[2] = {0.f, 0.f};
      for (int kt = 0; kt < nkt; ++kt) {
        cp_async_wait_all();
        __syncthreads();
        if (kt + 1 < nkt) stage_tile<H>(KB + ((kt + 1) & 1) * TILE, vh, H, (kt + 1) * KT, T, tid, pol);
        if (!active) continue;
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          float e[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float4 sv = *kept(sc, kt, u, n, lane);
            const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              e[n][q] = round_bf16(ex2((s4[q] - mx[q >> 1]) * LOG2E));
              l[q >> 1] += e[n][q];
            }
          }
          uint32_t P[4];
          pack_a(P, e[0], e[1]);
          mma_tile_t<H>(O, P, KB + (kt & 1) * TILE, u * 16, lane);
        }
      }
      if (!active) continue;
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);

      // acc += pv / sum(e); at the last head y = rnd(acc + c + x)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = q0 + g4 + 8 * hf;
        if (i >= T) continue;
        float* ar = acc + (g4 + 8 * hf) * H;
#pragma unroll
        for (int n = 0; n < H / 8; ++n) {
          const int col = n * 8 + 2 * t4;
          float2 v = make_float2(O[n][2 * hf] / l[hf], O[n][2 * hf + 1] / l[hf]);
          float2* pa = reinterpret_cast<float2*>(ar + col);
          if (!first) {
            const float2 p = *pa;
            v = make_float2(p.x + v.x, p.y + v.y);
          }
          if (!last) {
            *pa = v;
          } else {
            const size_t o = (rb + i) * H + col;
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(a.x + o);
            const float2 cc = *reinterpret_cast<const float2*>(a.c + col);
            *reinterpret_cast<__nv_bfloat162*>(a.y + o) = __floats2bfloat162_rn(
                (v.x + cc.x) + __bfloat162float(xv.x), (v.y + cc.y) + __bfloat162float(xv.y));
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  bf16* xk;         // [rows][XW] xa rows
  bf16* qw;         // [nh][rows][H] t[:, :H]
  float* tq;        // [nh][rows] t[:, H]
  bf16* vw;         // [nh][rows][H] vo
  const bf16* g;    // [rows][H]
  bf16* gpw;        // [nh][rows][H] g'
  float* ms;        // [nh][rows] row max of the scores
  float* dl;        // [nh][rows] delta
  bf16* dtw;        // [nh][rows][XW] dt (lane H: the row sum of dS)
  bf16* dvow;       // [nh][rows][H] dvo
  float* dxa;       // [rows][H]
  float* sg;        // [gridDim.x][QT][Tk * 16] the query kernel's kept scores, or null
  int M, T, nh, rows, region;
};

// per (sequence, 128 queries) and head: g', the row max, delta and the dt rows
template <int H>
__global__ void __launch_bounds__(NT, 1) wide_bwd_query(const BwdArgs a) {
  using W = Wide<H>;
  constexpr int LS = W::LS, TILE = W::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* KB = reinterpret_cast<bf16*>(smem_raw);  // [2 stages][xa, vo][TILE]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  unsigned char* mine = smem_raw + 4 * TILE * 2 + size_t(warp) * a.region;
  bf16* QS = reinterpret_cast<bf16*>(mine);
  const int T = a.T;
  const int nkt = keys_padded(T) / KT;
  float* sc = a.sg ? a.sg + (size_t(blockIdx.x) * QT + warp) * keys_padded(T) * 16
                   : reinterpret_cast<float*>(mine);
  const int ntile = (T + 15) / 16, ngroups = (ntile + QT - 1) / QT;
  const uint64_t pol = evict_first();
  auto xa_tile = [&](int buf) { return KB + (2 * buf) * TILE; };
  auto vo_tile = [&](int buf) { return KB + (2 * buf + 1) * TILE; };

  for (int item = blockIdx.x; item < a.M * ngroups; item += gridDim.x) {
    const int m = item / ngroups, qt = (item % ngroups) * QT + warp;
    const bool active = qt < ntile;
    const int q0 = qt * 16;
    const size_t rb = size_t(m) * T;
    const bf16* xs = a.xk + rb * W::XW;
    for (int h = 0; h < a.nh; ++h) {
      const size_t hb = size_t(h) * a.rows + rb;  // this head's and sequence's first row
      const bf16* vh = a.vw + hb * H;
      __syncthreads();
      if (active) stage_rows16<H>(QS, a.qw + hb * H, H, q0, T, lane, pol);
      stage_tile<H>(xa_tile(0), xs, W::XW, 0, T, tid, pol);
      float cq[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = q0 + g4 + 8 * hf;
        cq[hf] = active && i < T ? a.tq[hb + i] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();
      uint32_t F[H / 16][4];
      if (active) load_a<H>(F, QS, 0, lane);
      __syncwarp();

      // pass 1: the kept scores and the exact row max
      float mx[2] = {-INFINITY, -INFINITY};
      for (int kt = 0; kt < nkt; ++kt) {
        if (kt > 0) {
          cp_async_wait_all();
          __syncthreads();
        }
        if (kt + 1 < nkt) stage_tile<H>(xa_tile((kt + 1) & 1), xs, W::XW, (kt + 1) * KT, T, tid, pol);
        if (!active) continue;
        float s[KU][2][4];
        mma_rows<KU, false, H>(s, F, xa_tile(kt & 1), 0, lane);
#pragma unroll
        for (int u = 0; u < KU; ++u)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = kt * KT + u * 16 + n * 8 + 2 * t4 + (e & 1);
              s[u][n][e] = j < T ? s[u][n][e] + cq[e >> 1] : -INFINITY;
              mx[e >> 1] = fmaxf(mx[e >> 1], s[u][n][e]);
            }
            *kept(sc, kt, u, n, lane) = make_float4(s[u][n][0], s[u][n][1], s[u][n][2], s[u][n][3]);
          }
      }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);

      // sum(e) over the unrounded e, and g' = rnd(g / sum(e)): the A fragments of dP = g' vo^T
      uint32_t G[H / 16][4];
      float rinv[2] = {0.f, 0.f};
      if (active) {
        float l[2] = {0.f, 0.f};
        for (int kt = 0; kt < nkt; ++kt)
#pragma unroll
          for (int u = 0; u < KU; ++u)
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const float4 sv = *kept(sc, kt, u, n, lane);
              l[0] += ex2((sv.x - mx[0]) * LOG2E) + ex2((sv.y - mx[0]) * LOG2E);
              l[1] += ex2((sv.z - mx[1]) * LOG2E) + ex2((sv.w - mx[1]) * LOG2E);
            }
        rinv[0] = 1.f / quad_sum(l[0]);
        rinv[1] = 1.f / quad_sum(l[1]);
        bf16* gp = a.gpw + hb * H;
#pragma unroll
        for (int ks = 0; ks < H / 16; ++ks)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = q & 1, i = q0 + g4 + 8 * r, col = ks * 16 + 2 * t4 + 8 * (q >> 1);
            uint32_t v = 0u;
            if (i < T) {
              const __nv_bfloat162 gv =
                  *reinterpret_cast<const __nv_bfloat162*>(a.g + (rb + i) * H + col);
              v = pack(__bfloat162float(gv.x) * rinv[r], __bfloat162float(gv.y) * rinv[r]);
              *reinterpret_cast<uint32_t*>(gp + size_t(i) * H + col) = v;
            }
            G[ks][q] = v;
          }
      }

      // pass 2: delta = sum(dP e) / sum(e)
      __syncthreads();  // every warp is done with the last xa tile
      stage_tile<H>(vo_tile(0), vh, H, 0, T, tid, pol);
      float dsum[2] = {0.f, 0.f};
      for (int kt = 0; kt < nkt; ++kt) {
        cp_async_wait_all();
        __syncthreads();
        if (kt + 1 < nkt) stage_tile<H>(vo_tile((kt + 1) & 1), vh, H, (kt + 1) * KT, T, tid, pol);
        if (!active) continue;
        float dp[KU][2][4];
        mma_rows<KU, false, H>(dp, G, vo_tile(kt & 1), 0, lane);
#pragma unroll
        for (int u = 0; u < KU; ++u)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float4 sv = *kept(sc, kt, u, n, lane);
            const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
            for (int q = 0; q < 4; ++q)
              dsum[q >> 1] = fmaf(dp[u][n][q], ex2((s4[q] - mx[q >> 1]) * LOG2E), dsum[q >> 1]);
          }
      }
      float delta[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) delta[r] = quad_sum(dsum[r]) * rinv[r];

      // pass 3: dS = rnd(e (dP - delta)), dt = dS xa and its row sum
      __syncthreads();
      stage_tile<H>(xa_tile(0), xs, W::XW, 0, T, tid, pol);
      stage_tile<H>(vo_tile(0), vh, H, 0, T, tid, pol);
      float dt[H / 8][4];
#pragma unroll
      for (int n = 0; n < H / 8; ++n) dt[n][0] = dt[n][1] = dt[n][2] = dt[n][3] = 0.f;
      float dsrow[2] = {0.f, 0.f};
      for (int kt = 0; kt < nkt; ++kt) {
        cp_async_wait_all();
        __syncthreads();
        if (kt + 1 < nkt) {
          stage_tile<H>(xa_tile((kt + 1) & 1), xs, W::XW, (kt + 1) * KT, T, tid, pol);
          stage_tile<H>(vo_tile((kt + 1) & 1), vh, H, (kt + 1) * KT, T, tid, pol);
        }
        if (!active) continue;
        float dp[KU][2][4];
        mma_rows<KU, false, H>(dp, G, vo_tile(kt & 1), 0, lane);
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          float d[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float4 sv = *kept(sc, kt, u, n, lane);
            const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              d[n][q] = round_bf16(ex2((s4[q] - mx[q >> 1]) * LOG2E) *
                                   (dp[u][n][q] - delta[q >> 1]));
              dsrow[q >> 1] += d[n][q];
            }
          }
          uint32_t P[4];
          pack_a(P, d[0], d[1]);
          mma_tile_t<H>(dt, P, xa_tile(kt & 1), u * 16, lane);
        }
      }
      if (!active) continue;
      float dtH[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) dtH[r] = round_bf16(quad_sum(dsrow[r]));
      bf16* out = a.dtw + hb * W::XW;
#pragma unroll
      for (int n = 0; n < H / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = q0 + g4 + 8 * r;
          if (i < T)
            *reinterpret_cast<uint32_t*>(out + size_t(i) * W::XW + n * 8 + 2 * t4) =
                pack(dt[n][2 * r], dt[n][2 * r + 1]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = q0 + g4 + 8 * r;
        if (i < T) {
          const bf16 z = __float2bfloat16(0.f);
          bf16* tail = out + size_t(i) * W::XW + H + 4 * t4;
          tail[0] = t4 == 0 ? __float2bfloat16(dtH[r]) : z;
          tail[1] = tail[2] = tail[3] = z;
          if (t4 == 0) {
            a.ms[hb + i] = mx[r];
            a.dl[hb + i] = delta[r];
          }
        }
      }
    }
  }
}

// per (sequence, 128 keys) and head: dvo = rnd(rnd(e)^T g') and dxa += dS^T t
template <int H>
__global__ void __launch_bounds__(NT, 1) wide_bwd_key(const BwdArgs a) {
  using W = Wide<H>;
  constexpr int LS = W::LS, TILE = W::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* QB = reinterpret_cast<bf16*>(smem_raw);                   // [2 stages][t, g'][TILE]
  float* QSTAT = reinterpret_cast<float*>(smem_raw + 4 * TILE * 2);  // [2 stages][cq, m, delta][KT]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  bf16* XK = reinterpret_cast<bf16*>(smem_raw + 4 * TILE * 2 + 6 * KT * 4) + warp * 32 * LS;
  bf16* VK = XK + 16 * LS;  // this warp's 16 keys: xa rows, vo rows
  const int T = a.T;
  const int nqt = keys_padded(T) / KT;
  const int ntile = (T + 15) / 16, ngroups = (ntile + QT - 1) / QT;
  const uint64_t pol = evict_first();
  auto t_tile = [&](int buf) { return QB + (2 * buf) * TILE; };
  auto g_tile = [&](int buf) { return QB + (2 * buf + 1) * TILE; };

  for (int item = blockIdx.x; item < a.M * ngroups; item += gridDim.x) {
    const int m = item / ngroups, kq = (item % ngroups) * QT + warp;
    const bool active = kq < ntile;
    const int k0 = kq * 16;
    const size_t rb = size_t(m) * T;
    for (int h = 0; h < a.nh; ++h) {
      const size_t hb = size_t(h) * a.rows + rb;
      const bf16* th = a.qw + hb * H;
      const bf16* gh = a.gpw + hb * H;
      // the query tiles and their statistics (cq, row max, delta) of stage q into buffer buf
      auto stage = [&](int q, int buf) {
        stage_tile<H>(t_tile(buf), th, H, q * KT, T, tid, pol);
        stage_tile<H>(g_tile(buf), gh, H, q * KT, T, tid, pol);
        if (tid < 3 * KT) {
          const int w = tid / KT, i = q * KT + tid % KT;
          const float* src = w == 0 ? a.tq : w == 1 ? a.ms : a.dl;
          QSTAT[(buf * 3 + w) * KT + tid % KT] = i < T ? src[hb + i] : 0.f;
        }
      };
      __syncthreads();
      if (active) {
        stage_rows16<H>(XK, a.xk + rb * W::XW, W::XW, k0, T, lane, pol);
        stage_rows16<H>(VK, a.vw + hb * H, H, k0, T, lane, pol);
      }
      stage(0, 0);
      cp_async_wait_all();
      __syncthreads();
      uint32_t FX[H / 16][4];
      if (active) load_a<H>(FX, XK, 0, lane);

      // e^T of 16 keys by the 16 queries of block u of the staged tile (0 off the edges)
      auto scores_t = [&](float (&s)[2][4], int q, int buf, int u) {
        float c[1][2][4];
        mma_rows<1, false, H>(c, FX, t_tile(buf), u * 16, lane);
        const float* st = QSTAT + buf * 3 * KT;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int il = u * 16 + n * 8 + 2 * t4 + cc, i = q * KT + il;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int j = k0 + g4 + 8 * r;
              s[n][2 * r + cc] = i < T && j < T
                                     ? ex2((c[0][n][2 * r + cc] + st[il] - st[KT + il]) * LOG2E)
                                     : 0.f;
            }
          }
      };

      // pass A: dvo = rnd(e)^T g'
      float acc[H / 8][4];
#pragma unroll
      for (int n = 0; n < H / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      for (int q = 0; q < nqt; ++q) {
        if (q > 0) {
          cp_async_wait_all();
          __syncthreads();
        }
        if (q + 1 < nqt) stage(q + 1, (q + 1) & 1);
        if (!active) continue;
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          float e[2][4];
          scores_t(e, q, q & 1, u);
          uint32_t P[4];
          pack_a(P, e[0], e[1]);
          mma_tile_t<H>(acc, P, g_tile(q & 1), u * 16, lane);
        }
      }
      if (active) {
        bf16* out = a.dvow + hb * H;
#pragma unroll
        for (int n = 0; n < H / 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = k0 + g4 + 8 * r;
            if (j < T)
              *reinterpret_cast<uint32_t*>(out + size_t(j) * H + n * 8 + 2 * t4) =
                  pack(acc[n][2 * r], acc[n][2 * r + 1]);
          }
      }

      // pass B: dS^T = rnd(e^T (vo g'^T - delta)), dxa += dS^T t
      __syncthreads();
      stage(0, 0);
#pragma unroll
      for (int n = 0; n < H / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      for (int q = 0; q < nqt; ++q) {
        cp_async_wait_all();
        __syncthreads();
        if (q + 1 < nqt) stage(q + 1, (q + 1) & 1);
        if (!active) continue;
        const float* st = QSTAT + (q & 1) * 3 * KT;
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          float e[2][4], dp[2][4] = {};
#pragma unroll
          for (int ks = 0; ks < H / 16; ++ks) {
            uint32_t A[4], B[4];
            ldsm_x4(A, VK + (lane & 15) * LS + ks * 16 + (lane >> 4) * 8);
            ldsm_x4(B, g_tile(q & 1) + (u * 16 + (lane & 7) + (lane >> 4) * 8) * LS + ks * 16 +
                           ((lane >> 3) & 1) * 8);
            mma(dp[0], A, B[0], B[1]);
            mma(dp[1], A, B[2], B[3]);
          }
          scores_t(e, q, q & 1, u);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              e[n][v] = round_bf16(e[n][v] * (dp[n][v] - st[2 * KT + u * 16 + n * 8 + 2 * t4 + (v & 1)]));
          uint32_t P[4];
          pack_a(P, e[0], e[1]);
          mma_tile_t<H>(acc, P, t_tile(q & 1), u * 16, lane);
        }
      }
      if (!active) continue;
#pragma unroll
      for (int n = 0; n < H / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = k0 + g4 + 8 * r;
          if (j < T) {
            float2* p = reinterpret_cast<float2*>(a.dxa + (rb + j) * H + n * 8 + 2 * t4);
            float2 v = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
            if (h > 0) {
              const float2 o = *p;
              v = make_float2(o.x + v.x, o.y + v.y);
            }
            *p = v;
          }
        }
    }
  }
}

// dxa += dt A_h^T + dt[:, H] A_h[:H, H] + dvo Wvo_h^T for every head, a warp
// per 16 rows, with rnd(A_h) and rnd(Wvo_h) staged in shared memory
template <int H>
__global__ void __launch_bounds__(NT, 1) wide_bwd_dxa(const bf16* __restrict__ wts,
                                                      const float* __restrict__ vecs,
                                                      const bf16* __restrict__ dtw,
                                                      const bf16* __restrict__ dvow,
                                                      float* __restrict__ dxa, int rows, int nh) {
  using W = Wide<H>;
  constexpr int LS = W::LS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Abs = reinterpret_cast<bf16*>(smem_raw);  // [H][LS] Ab[i][k] = A[i][k]
  bf16* Wbs = Abs + H * LS;                       // [H][LS] Wb[i][k] = Wvo[i][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int r0 = blockIdx.x * NW * 16 + warp * 16;
  for (int h = 0; h < nh; ++h) {
    const bf16* w = wts + size_t(h) * W::WTS;
    const float* acol = vecs + size_t(h) * W::VEC + W::AT_N + H;
    __syncthreads();
    stage_weights<H>(Abs, w + W::AT_N * H + H * H, H, H, tid, NT);
    stage_weights<H>(Wbs, w + W::AT_N * H + 2 * H * H, H, H, tid, NT);
    cp_async_wait_all();
    __syncthreads();
    const bf16* dtr = dtw + size_t(h) * rows * W::XW;
    const bf16* dvr = dvow + size_t(h) * rows * H;
    uint32_t D[H / 16][4], V[H / 16][4];
#pragma unroll
    for (int ks = 0; ks < H / 16; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = r0 + g4 + 8 * (q & 1), col = ks * 16 + 2 * t4 + 8 * (q >> 1);
        D[ks][q] = i < rows ? *reinterpret_cast<const uint32_t*>(dtr + size_t(i) * W::XW + col) : 0u;
        V[ks][q] = i < rows ? *reinterpret_cast<const uint32_t*>(dvr + size_t(i) * H + col) : 0u;
      }
    float dtH[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + g4 + 8 * r;
      dtH[r] = i < rows ? __bfloat162float(dtr[size_t(i) * W::XW + H]) : 0.f;
    }
#pragma unroll 1
    for (int n0 = 0; n0 < H / 8; n0 += 4) {
      float c[2][2][4];
      mma_rows<2, false, H>(c, D, Abs, n0 * 8, lane);
      mma_rows<2, true, H>(c, V, Wbs, n0 * 8, lane);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = (n0 + u) * 8 + 2 * t4;
        const float a0 = acol[col], a1 = acol[col + 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = r0 + g4 + 8 * r;
          if (i < rows) {
            float2* p = reinterpret_cast<float2*>(dxa + size_t(i) * H + col);
            float2 v = *p;
            v.x += fmaf(dtH[r], a0, c[u / 2][u % 2][2 * r]);
            v.y += fmaf(dtH[r], a1, c[u / 2][u % 2][2 * r + 1]);
            *p = v;
          }
        }
      }
    }
  }
}

// LayerNorm adjoint, a warp per row: dx = g + rsig (dxhat - mean(dxhat) -
// xhat mean(dxhat xhat)), dxhat = dxa ln[0]; the block's sums of dxa xhat,
// dxa and g (dln, dc) over its rows, its warps added in a fixed order.
template <int H>
__global__ void __launch_bounds__(NT) wide_ln_bwd(const bf16* __restrict__ x,
                                                  const bf16* __restrict__ g,
                                                  const float* __restrict__ ln,
                                                  const float* __restrict__ dxa,
                                                  bf16* __restrict__ dx, float* __restrict__ part,
                                                  int rows, float eps) {
  constexpr int C = H / 32;
  __shared__ float red[NW][3 * H];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float a0[C] = {}, a1[C] = {}, a2[C] = {};
  for (int j = blockIdx.x * NW + warp; j < rows; j += gridDim.x * NW) {
    float v[C], gv[C], dl[C], s = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t o = size_t(j) * H + lane + 32 * c;
      v[c] = __bfloat162float(x[o]);
      gv[c] = __bfloat162float(g[o]);
      dl[c] = dxa[o];
      s += v[c];
    }
    const float mu = warp_sum(s) / float(H);
    float d2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] -= mu;
      d2 = fmaf(v[c], v[c], d2);
    }
    const float rs = rsqrtf(warp_sum(d2) / float(H) + eps);
    float xh[C], dxh[C], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = lane + 32 * c;
      xh[c] = v[c] * rs;
      dxh[c] = dl[c] * ln[k];
      s1 += dxh[c];
      s2 = fmaf(dxh[c], xh[c], s2);
      a0[c] = fmaf(dl[c], xh[c], a0[c]);
      a1[c] += dl[c];
      a2[c] += gv[c];
    }
    const float m1 = warp_sum(s1) / float(H), m2 = warp_sum(s2) / float(H);
#pragma unroll
    for (int c = 0; c < C; ++c)
      dx[size_t(j) * H + lane + 32 * c] = __float2bfloat16(gv[c] + rs * (dxh[c] - m1 - xh[c] * m2));
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    red[warp][lane + 32 * c] = a0[c];
    red[warp][H + lane + 32 * c] = a1[c];
    red[warp][2 * H + lane + 32 * c] = a2[c];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 3 * H; k += NT) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += red[w][k];
    part[size_t(blockIdx.x) * 3 * H + k] = s;
  }
}

// The forward's workspace, in bytes, in order.
template <int H>
struct FwdLayout {
  size_t wts, vecs, xk, qw, tq, vw, acc, sg, total;
  FwdLayout(int chunk, int T, int nh, int nblocks) {
    using W = Wide<H>;
    size_t off = 0;
    auto take = [&](size_t bytes) { const size_t at = off; off += align256(bytes); return at; };
    const size_t rows = size_t(chunk) * T;
    wts = take(size_t(nh) * W::WTS * 2);
    vecs = take(size_t(nh) * W::VEC * 4);
    xk = take(rows * W::XW * 2);
    qw = take(size_t(nh) * rows * H * 2);
    tq = take(size_t(nh) * rows * 4);
    vw = take(size_t(nh) * rows * H * 2);
    acc = take(size_t(nblocks) * QT * 16 * H * 4);
    sg = take(scores_in_smem<H>(T, 2 * W::TILE * 2) ? 0
                                                     : size_t(nblocks) * QT * keys_padded(T) * 16 * 4);
    total = off;
  }
};

template <int H>
int forward(const void* x, const void* ln, const void* A, const void* Wvo, const void* c, void* y,
            void* ws, int M, int T, int nh, int chunk, int nblocks, float eps, cudaStream_t s) {
  using W = Wide<H>;
  const FwdLayout<H> L(chunk, T, nh, nblocks);
  unsigned char* base = static_cast<unsigned char*>(ws);
  bf16* wts = reinterpret_cast<bf16*>(base + L.wts);
  float* vecs = reinterpret_cast<float*>(base + L.vecs);
  bf16* xk = reinterpret_cast<bf16*>(base + L.xk);
  bf16* qw = reinterpret_cast<bf16*>(base + L.qw);
  float* tq = reinterpret_cast<float*>(base + L.tq);
  bf16* vw = reinterpret_cast<bf16*>(base + L.vw);
  float* acc = reinterpret_cast<float*>(base + L.acc);
  const int fixed = 2 * W::TILE * 2;
  float* sg = scores_in_smem<H>(T, fixed) ? nullptr : reinterpret_cast<float*>(base + L.sg);
  attention_block_tc_prep<H><<<nh, 256, 0, s>>>(static_cast<const float*>(A),
                                                static_cast<const float*>(Wvo), wts, vecs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int region = region_bytes<H>(T, fixed);
  const int attn_smem = fixed + QT * region;
  if ((err = cudaFuncSetAttribute(wide_proj<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  W::PROJ_SMEM)) != cudaSuccess)
    return int(err);
  if ((err = cudaFuncSetAttribute(wide_attn<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  attn_smem)) != cudaSuccess)
    return int(err);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  const int ngroups = ((T + 15) / 16 + QT - 1) / QT;
  for (int m0 = 0; m0 < M; m0 += chunk) {
    const int mc = M - m0 < chunk ? M - m0 : chunk;
    const int rows = mc * T;
    const bf16* xc = xb + size_t(m0) * T * H;
    wide_keys<H><<<(rows + 7) / 8, 256, 0, s>>>(xc, static_cast<const float*>(ln), vecs, xk, tq,
                                                rows, nh, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    wide_proj<H><<<(rows + PM - 1) / PM, PW * 32, W::PROJ_SMEM, s>>>(
        ProjArgs{xk, wts, vecs, qw, vw, rows, nh});
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    const int items = mc * ngroups;
    const AttnArgs aa{xk, qw, tq, vw, xc, static_cast<const float*>(c), yb + size_t(m0) * T * H,
                      acc, sg, mc, T, nh, rows, region};
    wide_attn<H><<<std::min(items, nblocks), NT, attn_smem, s>>>(aa);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  return 0;
}

// The backward's shared memory: the query kernel's four streamed tiles and
// the key kernel's four, its query statistics and each warp's key rows.
template <int H>
constexpr int query_fixed() { return 4 * Wide<H>::TILE * 2; }
template <int H>
constexpr int key_smem() { return 4 * Wide<H>::TILE * 2 + 6 * KT * 4 + NW * 32 * Wide<H>::LS * 2; }
template <int H>
constexpr int dxa_smem() { return 2 * H * Wide<H>::LS * 2; }

// The backward's workspace, in bytes, in order.
template <int H>
struct BwdLayout {
  size_t wts, vecs, xk, qw, tq, vw, gpw, ms, dl, dtw, dvow, dxa, sg, part, wpart, total;
  BwdLayout(int M, int T, int nh, int nblocks, int nslices) {
    using W = Wide<H>;
    size_t off = 0;
    auto take = [&](size_t bytes) { const size_t at = off; off += align256(bytes); return at; };
    const size_t rows = size_t(M) * T;
    wts = take(size_t(nh) * W::WTS * 2);
    vecs = take(size_t(nh) * W::VEC * 4);
    xk = take(rows * W::XW * 2);
    qw = take(size_t(nh) * rows * H * 2);
    tq = take(size_t(nh) * rows * 4);
    vw = take(size_t(nh) * rows * H * 2);
    gpw = take(size_t(nh) * rows * H * 2);
    ms = take(size_t(nh) * rows * 4);
    dl = take(size_t(nh) * rows * 4);
    dtw = take(size_t(nh) * rows * W::XW * 2);
    dvow = take(size_t(nh) * rows * H * 2);
    dxa = take(rows * H * 4);
    sg = take(scores_in_smem<H>(T, query_fixed<H>())
                  ? 0
                  : size_t(nblocks) * QT * keys_padded(T) * 16 * 4);
    part = take(size_t(nblocks) * 3 * H * 4);
    wpart = take(size_t(nslices) * 2 * nh * W::XW * W::XW * 4);
    total = off;
  }
};

template <int H>
int backward(const void* x, const void* ln, const void* A, const void* Wvo, const void* g,
             void* dx, void* out, void* ws, int nblocks, int nslices, int M, int T, int nh,
             float eps, cudaStream_t s) {
  using W = Wide<H>;
  const BwdLayout<H> L(M, T, nh, nblocks, nslices);
  unsigned char* base = static_cast<unsigned char*>(ws);
  auto at = [&](size_t off) { return static_cast<void*>(base + off); };
  bf16* wts = static_cast<bf16*>(at(L.wts));
  float* vecs = static_cast<float*>(at(L.vecs));
  const int rows = M * T;
  const bool smem_scores = scores_in_smem<H>(T, query_fixed<H>());
  BwdArgs b{static_cast<bf16*>(at(L.xk)), static_cast<bf16*>(at(L.qw)),
            static_cast<float*>(at(L.tq)), static_cast<bf16*>(at(L.vw)),
            static_cast<const bf16*>(g), static_cast<bf16*>(at(L.gpw)),
            static_cast<float*>(at(L.ms)), static_cast<float*>(at(L.dl)),
            static_cast<bf16*>(at(L.dtw)), static_cast<bf16*>(at(L.dvow)),
            static_cast<float*>(at(L.dxa)), smem_scores ? nullptr : static_cast<float*>(at(L.sg)),
            M, T, nh, rows, region_bytes<H>(T, query_fixed<H>())};
  float* part = static_cast<float*>(at(L.part));
  float* wpart = static_cast<float*>(at(L.wpart));

  attention_block_tc_prep<H><<<nh, 256, 0, s>>>(static_cast<const float*>(A),
                                                static_cast<const float*>(Wvo), wts, vecs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int q_smem = query_fixed<H>() + QT * b.region;
  if ((err = cudaFuncSetAttribute(wide_proj<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  W::PROJ_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(wide_bwd_query<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  q_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(wide_bwd_key<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  key_smem<H>())) != cudaSuccess ||
      (err = cudaFuncSetAttribute(wide_bwd_dxa<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dxa_smem<H>())) != cudaSuccess)
    return int(err);
  wide_keys<H><<<(rows + 7) / 8, 256, 0, s>>>(static_cast<const bf16*>(x),
                                              static_cast<const float*>(ln), vecs, b.xk, b.tq,
                                              rows, nh, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  wide_proj<H><<<(rows + PM - 1) / PM, PW * 32, W::PROJ_SMEM, s>>>(
      ProjArgs{b.xk, wts, vecs, b.qw, b.vw, rows, nh});
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const int items = M * (((T + 15) / 16 + QT - 1) / QT);
  const int grid = std::min(items, nblocks);
  wide_bwd_query<H><<<grid, NT, q_smem, s>>>(b);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  wide_bwd_key<H><<<grid, NT, key_smem<H>(), s>>>(b);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  wide_bwd_dxa<H><<<(rows + NW * 16 - 1) / (NW * 16), NT, dxa_smem<H>(), s>>>(
      wts, vecs, b.dtw, b.dvow, b.dxa, rows, nh);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  wide_ln_bwd<H><<<nblocks, NT, 0, s>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                                        static_cast<const float*>(ln), b.dxa,
                                        static_cast<bf16*>(dx), part, rows, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const long long per =
      (((long long)rows + nslices - 1) / nslices + W::GROWS - 1) / W::GROWS * W::GROWS;
  nbss_block::attention_block_bwd_weights<H, W::XW, W::GROWS>
      <<<dim3(nslices, 2 * nh), W::XW / 16 * 32, 0, s>>>(b.xk, b.dtw, b.dvow, wpart, rows, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const int n = int(2 * nh * (H + 2) * (H + 2) + 3 * H);
  nbss_block::attention_block_bwd_reduce<H, W::XW><<<(n + 255) / 256, 256, 0, s>>>(
      wpart, part, static_cast<float*>(out), nslices, nblocks, nh);
  return int(cudaGetLastError());
}

bool takes(int M, int T, int H, int nh) {
  return M >= 1 && T >= 1 && (H == 96 || H == 192) && nh >= 1 && H % nh == 0;
}

}  // namespace

// Bytes of workspace the forward needs for chunks of `chunk` sequences of T
// frames, H channels, nh heads and nblocks persistent attention blocks.
extern "C" long long nbss_attention_block_wide_tc_workspace_bytes(int chunk, int T, int H, int nh,
                                                                 int nblocks) {
  if (H == 96) return static_cast<long long>(FwdLayout<96>(chunk, T, nh, nblocks).total);
  if (H == 192) return static_cast<long long>(FwdLayout<192>(chunk, T, nh, nblocks).total);
  return -1;
}

// y = the folded attention block of x, bf16, on `stream`. x, y [M, T, H]
// bfloat16; ln [2, H], A and Wvo [nh, H+2, H+2], c [H] float32; all
// contiguous. ws: the workspace's bytes for (chunk, T, H, nh, nblocks),
// 256-byte aligned, any content. Sequences go through it `chunk` at a time.
// Returns the CUDA error of the launches (0 on success); shapes it is not
// built for return cudaErrorInvalidValue without launching.
extern "C" int nbss_attention_block_wide_tc_fwd(const void* x, const void* ln, const void* A,
                                                const void* Wvo, const void* c, void* y, void* ws,
                                                int M, int T, int H, int nh, int chunk,
                                                int nblocks, float eps, void* stream) {
  if (!takes(M, T, H, nh) || chunk < 1 || nblocks < 1 ||
      (long long)chunk * T * (H + 16) > 2147483647LL ||
      (reinterpret_cast<uintptr_t>(ws) & 255) != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 96) return forward<96>(x, ln, A, Wvo, c, y, ws, M, T, nh, chunk, nblocks, eps, s);
  return forward<192>(x, ln, A, Wvo, c, y, ws, M, T, nh, chunk, nblocks, eps, s);
}

// Bytes of workspace the backward needs (every sequence at once), nblocks
// persistent blocks and nslices row slices of the weight products.
extern "C" long long nbss_attention_block_wide_bwd_tc_workspace_bytes(int M, int T, int H, int nh,
                                                                     int nblocks, int nslices) {
  if (H == 96) return static_cast<long long>(BwdLayout<96>(M, T, nh, nblocks, nslices).total);
  if (H == 192) return static_cast<long long>(BwdLayout<192>(M, T, nh, nblocks, nslices).total);
  return -1;
}

// The adjoint, bf16: x, g, dx [M, T, H] bfloat16; ln, A, Wvo float32 as the
// forward's; out float32 [2 nh (H+2)^2 + 3H] = dA, dWvo, dln, dc one after
// another. ws: the workspace's bytes, 256-byte aligned, any content. Returns
// the CUDA error of the launches (0 on success).
extern "C" int nbss_attention_block_wide_bwd_tc(const void* x, const void* ln, const void* A,
                                                const void* Wvo, const void* g, void* dx,
                                                void* out, void* ws, int nblocks, int nslices,
                                                int M, int T, int H, int nh, float eps,
                                                void* stream) {
  if (!takes(M, T, H, nh) || nblocks < 1 || nslices < 1 ||
      (long long)M * T * (H + 16) > 2147483647LL || (reinterpret_cast<uintptr_t>(ws) & 255) != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 96) return backward<96>(x, ln, A, Wvo, g, dx, out, ws, nblocks, nslices, M, T, nh, eps, s);
  return backward<192>(x, ln, A, Wvo, g, dx, out, ws, nblocks, nslices, M, T, nh, eps, s);
}
